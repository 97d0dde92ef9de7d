"""Context parallelism: ring attention over the ``sep`` mesh axis (port of
``paddle_tpu/distributed/sequence_parallel.py``).

Q stays put while K/V blocks rotate around the ``sep`` ring, and each
step's partial attention is merged through its log-sum-exp: the online
softmax carried across ranks instead of across tiles. Layouts, as in the
reference:

* ``"contig"``: rank ``i`` holds rows ``[i*s/sp, (i+1)*s/sp)``; step 0 is
  the causal diagonal (#1), step ``t`` a full block (#1) for ranks
  ``>= t`` and discarded (``lse = -inf``) below the diagonal. The
  backward runs #2 every step.
* ``"zigzag"``: rank ``i`` holds chunks ``(i, 2*sp-1-i)`` of ``2*sp``
  equal chunks, so every rank owns the same slice of the causal triangle.
  Step 0 runs the segment-causal kernel #3 over the rank's two chunks;
  every later step is a dense rectangle of half the area (#1 on half
  slices). The backward runs the segment-causal kernel #4 every step.
  Every rank holds the global q, k and v, so it takes its two chunks
  straight from them and puts the gathered output back in order: the
  reference's conversion hops between a contiguous and a zig-zag shard
  (``_to_zigzag``) have nothing to do here.
* ``"zigzag_pre"``: the caller already holds the sequence in zig-zag
  order (:func:`zigzag_order`); a rank's chunks are its contiguous shard.

The reference's ``shard_map`` takes and returns global ``[b, s, h, d]``
arrays; here every rank of the sep group holds the same global q, k and
v (the rest of the model runs replicated). :class:`_RingAttention` slices
the rank's rows, runs the ring with its peers, and returns the global
output through ``all_gather``; its backward takes the rank's rows of the
global cotangent, runs the backward ring with the MERGED lse
and output of its rows (the reference's ``:462-464``), and all-gathers
dq, dk and dv. Every rank's loss and gradients are then the same bits,
and no gradient all-reduce is needed (the loss is replicated, not
partial: a reduction would multiply the gradients by sp).

Each KV hop is issued before the step's kernel, as in the reference, and
goes through :func:`~paddle_tpu_torch.ops.kernels.async_collectives.ring_kv_rotate`
(the port of the reference's remote-DMA rotation kernel: device to device
through CUDA IPC on the card, a stacked ``ppermute`` on CPU tensors). The
dk/dv accumulators rotate through it too; the reference rotates them with
a plain ``ppermute``, which on ranks sharing a card would stage every hop
through the host. The ring gauges wait for the observability plane
(ROADMAP.md A.12).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed.process_mesh import ProcessMesh, get_mesh
from paddle_tpu_torch.ops.kernels import async_collectives as hops
from paddle_tpu_torch.ops.kernels import flash_attention as fa

__all__ = ["sequence_scatter", "sequence_gather", "ring_attention",
           "zigzag_ring_attention", "ulysses_attention", "zigzag_scatter",
           "zigzag_gather", "zigzag_order", "ring_attention_flops"]

_LAYOUTS = ("contig", "zigzag", "zigzag_pre")


def _resolve(mesh: Optional[ProcessMesh], axis: str) -> ProcessMesh:
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        raise ValueError("sequence parallel needs a mesh "
                         "(set_mesh() or pass mesh=)")
    if axis not in mesh.dim_names:
        raise ValueError(f"mesh {mesh} has no '{axis}' axis")
    return mesh


def _not_ported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet: placements and resharding come with "
            f"ROADMAP.md A.10")
    fn.__name__ = name
    return fn


sequence_scatter = _not_ported("sequence_scatter")
sequence_gather = _not_ported("sequence_gather")
zigzag_scatter = _not_ported("zigzag_scatter")
zigzag_gather = _not_ported("zigzag_gather")
ulysses_attention = _not_ported("ulysses_attention")


# ---------------------------------------------------------------------------
# zig-zag layout
# ---------------------------------------------------------------------------
def zigzag_order(seq_len: int, sp: int) -> np.ndarray:
    """Global row order of the zig-zag layout (``seq_len % 2*sp == 0``):
    position ``j`` of the reordered sequence reads global row
    ``zigzag_order(s, sp)[j]``; rank ``r``'s contiguous shard of the
    reordered sequence is then exactly chunks ``(r, 2*sp-1-r)``."""
    c = seq_len // (2 * sp)
    order = []
    for r in range(sp):
        order.extend(range(r * c, (r + 1) * c))
        order.extend(range((2 * sp - 1 - r) * c, (2 * sp - r) * c))
    return np.asarray(order, dtype=np.int32)


def _zigzag_rows(x: torch.Tensor, sp: int, idx: int) -> torch.Tensor:
    """Rank ``idx``'s rows of the zig-zag layout, chunks ``(idx,
    2*sp-1-idx)`` of the global sequence (axis 1)."""
    c = x.shape[1] // (2 * sp)
    return torch.cat([x[:, idx * c:(idx + 1) * c],
                      x[:, (2 * sp - 1 - idx) * c:(2 * sp - idx) * c]],
                     dim=1)


def _unzigzag(x: torch.Tensor, sp: int) -> torch.Tensor:
    """The global sequence from every rank's zig-zag rows gathered in rank
    order (axis 1): chunk ``g`` is rank ``g``'s first chunk when ``g <
    sp``, else rank ``2*sp-1-g``'s second."""
    parts = x.chunk(2 * sp, dim=1)
    return torch.cat([parts[2 * g] if g < sp else parts[4 * sp - 1 - 2 * g]
                      for g in range(2 * sp)], dim=1)


def _tri(a: int, b: int) -> float:
    """Sum of (g+1) for g in [a, b): useful score entries of causal rows."""
    return (b * (b + 1) - a * (a + 1)) / 2.0


def ring_attention_flops(seq: int, sp: int, causal: bool = True,
                         layout: str = "zigzag") -> List[float]:
    """Per-rank useful attention work (score entries that reach the
    output) for one ring pass."""
    if sp <= 1:
        return [_tri(0, seq) if causal else float(seq) * seq]
    if not causal:
        return [float(seq) * seq / sp] * sp
    if layout.startswith("zigzag"):
        c = seq // (2 * sp)
        return [_tri(r * c, (r + 1) * c)
                + _tri((2 * sp - 1 - r) * c, (2 * sp - r) * c)
                for r in range(sp)]
    n = seq // sp
    return [_tri(r * n, (r + 1) * n) for r in range(sp)]


def _zigzag_seg(idx: int, src: int, c: int, sp: int) -> List[int]:
    """The segment descriptor of a ring step: rank ``idx`` queries chunks
    ``(idx, 2*sp-1-idx)``, the resident KV (rotated in from rank ``src``)
    is chunks ``(src, 2*sp-1-src)``; both maps are monotone."""
    return [idx * c, (2 * sp - 1 - idx) * c, c,
            src * c, (2 * sp - 1 - src) * c, c]


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------
def _merge(o_acc, lse_acc, o_t, lse_t):
    """Online-softmax combine of two partial results (lse [b, h, n], o
    [b, n, h, d]); a row with nothing visible on either side stays 0."""
    lse_new = torch.logaddexp(lse_acc, lse_t)
    dead = torch.isneginf(lse_new)
    w_acc = torch.where(dead, 0.0, torch.exp(lse_acc - lse_new))
    w_t = torch.where(dead, 0.0, torch.exp(lse_t - lse_new))
    o_acc = (o_acc * w_acc.transpose(1, 2)[..., None]
             + o_t.float() * w_t.transpose(1, 2)[..., None])
    return o_acc, lse_new


def _ring_fwd(ql, kl, vl, causal: bool, group, sp: int, idx: int,
              layout: str):
    """``_ring_fwd_arrays``'s per-rank body (``sequence_parallel.py:
    324-405``): the rank's output rows and their merged lse."""
    perm = [(j, (j + 1) % sp) for j in range(sp)]
    zigzag = layout in ("zigzag", "zigzag_pre") and causal
    b, nq, h, d = ql.shape
    c = nq // 2
    o_acc = torch.zeros((b, nq, h, d), dtype=torch.float32, device=ql.device)
    lse_acc = torch.full((b, h, nq), float("-inf"), dtype=torch.float32,
                         device=ql.device)
    kc, vc = kl, vl
    for t in range(sp):
        # step t+1's hop is issued before step t's kernel
        nxt = (hops.ring_kv_rotate(kc, vc, perm, group) if t < sp - 1
               else None)
        if zigzag and t == 0:
            # each diagonal chunk against itself: the only masked step
            o_t, lse_t = fa.flash_attention_seg_with_lse(
                ql, kc, vc, _zigzag_seg(idx, idx, c, sp))
        elif zigzag:
            # KV from an earlier rank: its low chunk is visible to both q
            # chunks (its high chunk is dead); from a later rank: only the
            # high q chunk sees it, both of its chunks
            src = (idx - t) % sp
            if src < idx:
                o_t, lse_t = fa.flash_attention_with_lse(
                    ql, kc[:, :c].contiguous(), vc[:, :c].contiguous(),
                    False)
            else:
                oh, lh = fa.flash_attention_with_lse(
                    ql[:, c:].contiguous(), kc, vc, False)
                o_t = torch.cat([torch.zeros_like(oh), oh], dim=1)
                lse_t = torch.cat([torch.full_like(lh, float("-inf")), lh],
                                  dim=2)
        else:
            # contig: t > 0 is a full block when idx >= t and entirely
            # above the diagonal otherwise (computed, then discarded)
            o_t, lse_t = fa.flash_attention_with_lse(
                ql, kc, vc, causal and t == 0)
            if causal and t > 0 and idx < t:
                lse_t = torch.full_like(lse_t, float("-inf"))
        o_acc, lse_acc = _merge(o_acc, lse_acc, o_t, lse_t)
        if nxt is not None:
            kc, vc = nxt
    return o_acc.to(ql.dtype), lse_acc


def _ring_bwd(ql, kl, vl, ol, lsel, dol, causal: bool, group, sp: int,
              idx: int, layout: str):
    """``_ring_bwd_arrays``'s per-rank body (``sequence_parallel.py:
    427-520``): dq of the rank's rows and dk/dv of its KV rows. The
    MERGED lse and output of the rank's rows drive every step (p =
    exp(s - lse_global)); the dk/dv accumulators rotate with the KV they
    describe and are home after sp hops."""
    perm = [(j, (j + 1) % sp) for j in range(sp)]
    zigzag = layout in ("zigzag", "zigzag_pre") and causal
    c = ql.shape[1] // 2
    dq_acc = torch.zeros(ql.shape, dtype=torch.float32, device=ql.device)
    dk_acc = torch.zeros(kl.shape, dtype=torch.float32, device=kl.device)
    dv_acc = torch.zeros(vl.shape, dtype=torch.float32, device=vl.device)
    kc, vc = kl, vl
    for t in range(sp):
        # the last step's KV is dead afterwards: it never rotates at
        # t == sp-1 (the dk/dv accumulators do)
        nxt = (hops.ring_kv_rotate(kc, vc, perm, group) if t < sp - 1
               else None)
        if zigzag:
            src = (idx - t) % sp
            dq_t, dk_t, dv_t = fa.flash_attention_seg_bwd(
                ql, kc, vc, ol, lsel, dol, _zigzag_seg(idx, src, c, sp))
        else:
            dq_t, dk_t, dv_t = fa.flash_attention_bwd(
                ql, kc, vc, ol, lsel, dol, causal and t == 0)
            if causal and t > 0 and idx < t:
                dq_t, dk_t, dv_t = (x.float() * 0.0
                                    for x in (dq_t, dk_t, dv_t))
        dq_acc += dq_t.float()
        dk_acc += dk_t.float()
        dv_acc += dv_t.float()
        dk_acc, dv_acc = hops.ring_kv_rotate(dk_acc, dv_acc, perm, group)
        if nxt is not None:
            kc, vc = nxt
    return dq_acc.to(ql.dtype), dk_acc.to(kl.dtype), dv_acc.to(vl.dtype)


class _RingAttention(torch.autograd.Function):
    """Global q, k, v in, global output out, on every rank of the sep
    group; the ring runs on the rank's rows: its zig-zag chunks for a
    causal ``"zigzag"`` ring, its contiguous shard otherwise."""

    @staticmethod
    def forward(ctx, query, key, value, causal, mesh, sp_axis, layout):
        group = mesh.group(sp_axis)
        sp = mesh.get_dim_size(sp_axis)
        idx = mesh.axis_index(sp_axis)
        zigzag = causal and layout == "zigzag"
        n = query.shape[1] // sp

        def rows(x):
            if zigzag:
                return _zigzag_rows(x, sp, idx)
            return x[:, idx * n:(idx + 1) * n].contiguous()

        ql, kl, vl = (rows(x) for x in (query, key, value))
        o, lse = _ring_fwd(ql, kl, vl, causal, group, sp, idx, layout)
        ctx.save_for_backward(ql, kl, vl, o, lse)
        ctx.ring = (causal, group, sp, idx, layout, rows, zigzag)
        out = collective.all_gather(o, group, axis=1)
        return _unzigzag(out, sp) if zigzag else out

    @staticmethod
    def backward(ctx, d_out):
        ql, kl, vl, o, lse = ctx.saved_tensors
        causal, group, sp, idx, layout, rows, zigzag = ctx.ring
        dol = rows(d_out.to(o.dtype))
        grads = _ring_bwd(ql, kl, vl, o, lse, dol, causal, group, sp, idx,
                          layout)
        dq, dk, dv = (collective.all_gather(g, group, axis=1) for g in grads)
        if zigzag:
            dq, dk, dv = (_unzigzag(g, sp) for g in (dq, dk, dv))
        return dq, dk, dv, None, None, None, None


def ring_attention(query: torch.Tensor, key: torch.Tensor,
                   value: torch.Tensor, causal: bool = False,
                   mesh: Optional[ProcessMesh] = None,
                   sp_axis: str = "sep",
                   layout: str = "contig") -> torch.Tensor:
    """Context-parallel attention over the ``sp_axis`` mesh axis.

    ``query/key/value``: global ``[batch, seq, heads, head_dim]``, the
    same on every rank of the axis; GQA when kv heads divide q heads.
    Returns the global output on every rank; differentiable (the
    backward is its own ring, see the module docstring). ``layout``:
    ``"contig"``, ``"zigzag"`` (needs ``seq % (2*sp) == 0``) or
    ``"zigzag_pre"`` (the caller's sequence is already in
    :func:`zigzag_order`; the output comes back in the same order). With
    ``sp == 1`` it is plain attention."""
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
    mesh = _resolve(mesh, sp_axis)
    sp = mesh.get_dim_size(sp_axis)
    if sp == 1:
        return scaled_dot_product_attention(query, key, value,
                                            is_causal=causal)
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown ring layout {layout!r} (expected "
                         "'contig', 'zigzag' or 'zigzag_pre')")
    seq = int(query.shape[1])
    if layout.startswith("zigzag") and seq % (2 * sp):
        raise ValueError(
            f"zig-zag ring attention needs seq ({seq}) divisible by "
            f"2*sp ({2 * sp}); pad the sequence or use layout='contig'")
    if seq % sp:
        raise ValueError(f"ring attention needs seq ({seq}) divisible by "
                         f"sp ({sp})")
    return _RingAttention.apply(query, key, value, bool(causal), mesh,
                                sp_axis, layout)


def zigzag_ring_attention(query: torch.Tensor, key: torch.Tensor,
                          value: torch.Tensor, causal: bool = False,
                          mesh: Optional[ProcessMesh] = None,
                          sp_axis: str = "sep") -> torch.Tensor:
    """:func:`ring_attention` with the balanced zig-zag causal layout."""
    return ring_attention(query, key, value, causal=causal, mesh=mesh,
                          sp_axis=sp_axis, layout="zigzag")
