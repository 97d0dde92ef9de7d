"""The launch plans of the port's quantized-page attention (#10,
``csrc/quant.cuh``) and chunked scan (#14, ``csrc/selective_scan.cu``), and
the port's functions against the JAX package's at the shapes where those
plans branch.

The plans are pure Python mirrors of the C++ launch code
(``ops/kernels/quant.py:launch_plan``, ``ops/kernels/selective_scan.py:
launch_plan``): how many query heads a block of #10 takes, how deep its
page ring is and the shared memory that needs; the scan's head groups,
grids and shared memory for its chunk-state and chunk-out launches. Here
they are held to the layouts written out once more, term by term, and to
the shapes each refuses. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``); on the CPU the wrappers run their plain
twins, which are compared with the JAX package (its Pallas kernels in
interpret mode where they take the shape, else its composed path) at the
same seeded inputs. Tolerances follow ``tests/op_harness.py``: fp32 rtol
1e-5 with atol 1e-6 (x the tensor's largest magnitude for the scan's
sums over a chunk and the carry), bf16 2e-2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu import flags as jax_flags
from paddle_tpu.inference.attention import \
    ragged_attention_xla as jax_ragged_xla
from paddle_tpu.ops.pallas import quant as jax_qp
from paddle_tpu.ops.pallas import selective_scan as jss
from paddle_tpu.quantization import kv as jkv
from paddle_tpu_torch.ops.kernels import _launch
from paddle_tpu_torch.ops.kernels import quant as pq
from paddle_tpu_torch.ops.kernels import selective_scan as pss

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
SMEM = 232448                      # dynamic shared memory a block may use


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _a16(n):
    return -(-n // 16) * 16


# ------------------------------------------------------------ #10's plan
@pytest.mark.parametrize("t,hq,hkv,want", [
    (72, 32, 8, 4),     # phase_quant (a): 576 blocks of 4 heads
    (128, 16, 8, 2),    # (b) serve-quant's step: group 2
    (8, 32, 8, 1),      # (e) the serve decode step: 256 blocks of 1
    (1, 32, 8, 1),      # a decode row alone
    (33, 32, 8, 4),     # 33 x 8 = 264 items: exactly two blocks an SM
    (32, 32, 8, 2),     # 256 items of 4 heads are too few; 512 of 2
    (40, 256, 8, 4),    # group 32: 8 blocks an item
    (200, 12, 4, 1),    # group 3: neither 4 nor 2 divides it
    (300, 8, 8, 1)])    # group 1
def test_quant_heads_per_block(t, hq, hkv, want):
    """The pipelined schedule's query heads a block: the widest of 4, 2 and
    1 that divides the group and still gives two blocks an SM, else 1; a
    launch of more than 264 (token, kv head) items takes the wide schedule,
    one block an item."""
    assert pq.heads_per_block(t, hq, hkv) == want
    plan = pq.launch_plan(t, hq, hkv, 128, 64, 32)
    if t * hkv > 264:
        assert plan["schedule"] == "wide"
        assert plan["grid"] == (t, hkv, 1) and plan["heads"] == hq // hkv
        assert plan["threads"] == max(hq // hkv, 4) * 32
        return
    assert plan["schedule"] == "pipelined" and plan["heads"] == want
    grid = plan["grid"]
    assert grid == (t, hkv, hq // hkv // want)
    assert grid[0] * grid[1] * grid[2] * want == t * hq
    assert plan["threads"] == (4 + 1 + (4 if want == 1 else 2)) * 32


@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("d", [16, 64, 96, 128, 256])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_quant_smem_is_the_layout(bs, d, heads):
    """Shared memory of a block, written out: a stage holds a K page with
    rows padded by 16 bytes, a V page and two fp32 scale columns (rounded
    up to 16 bytes); three 8-byte mbarriers a stage; a score row of bs
    floats a stage and head; a q row of the padded head dim a head; a row of
    bs softmax weights a consumer warp (4 of them); 4 scoring-warp maxima a
    stage and head; the token's table row (2048 keys' worth here). Alone on
    the card the ring takes the most stages, up to 4, that fit the 227
    KB."""
    dp = _launch.head_dim_bucket(d)
    width = 2048 // bs
    stage = _a16(bs * (dp + 16) + bs * dp + 2 * 4 * bs)
    for ns in (2, 3, 4):
        assert pq.smem_bytes(bs, d, heads, ns, width) == (
            ns * stage + ns * 3 * 8 + ns * heads * bs * 4 + heads * dp * 4
            + 4 * bs * 4 + ns * heads * 16 + width * 4)
    ns = pq.ring_stages(bs, d, heads, width)
    assert ns in (2, 3, 4)
    assert pq.smem_bytes(bs, d, heads, ns, width) <= SMEM
    if ns < 4:
        assert pq.smem_bytes(bs, d, heads, ns + 1, width) > SMEM


@pytest.mark.parametrize("bs,stages,threads,groups", [
    (8, 4, 128, 4), (16, 4, 128, 4), (32, 4, 128, 4), (48, 4, 128, 2),
    (64, 4, 128, 2), (128, 4, 128, 1), (256, 4, 128, 1), (16, 3, 128, 1),
    (64, 3, 128, 1), (16, 2, 128, 2), (64, 2, 128, 2), (128, 2, 128, 1),
    (32, 2, 64, 2), (64, 2, 64, 1), (16, 4, 64, 4)])
def test_quant_score_groups(bs, stages, threads, groups):
    """The scoring threads take a row each, every head of the block, so
    they score up to threads // bs pages at once, a count that divides the
    ring's depth: a group then waits on its own stages' mbarriers one phase
    after the other, never on a phase two ahead (whose parity would read as
    done). Every head's score row stays one thread's in-order chain; only
    who computes it and when moves."""
    assert pq.score_groups(bs, stages, threads) == groups
    assert stages % groups == 0 and (groups == 1 or groups * bs <= threads)


@pytest.mark.parametrize("heads,scorers", [(1, 4), (2, 2), (4, 2)])
def test_quant_warps(heads, scorers):
    """4 consumer warps (4 // heads a head, each accumulating its share of
    a lane's 16 columns: every column one chain in the fixed order), a
    copy warp, and 4 scoring warps for one head (a decode step's small
    grid) or 2 (large grids)."""
    assert pq.scorer_warps(heads) == scorers
    plan = pq.launch_plan(33, 8 * heads, 8, 128, 64, 32)
    assert plan["schedule"] == "pipelined" and plan["heads"] == heads
    assert plan["threads"] == (4 + 1 + scorers) * 32 and 16 % (4 // heads) == 0


@pytest.mark.parametrize("t,hkv,wide", [
    (8, 8, False), (33, 8, False), (34, 8, True), (72, 8, True),
    (128, 8, True), (264, 1, False), (265, 1, True)])
def test_quant_schedule_choice(t, hkv, wide):
    """The wide schedule (one block a (token, kv head), two stages) takes
    a launch of more than two items an SM, such as phase_quant's (a) and
    (b) and a prefill chunk; the pipelined one a
    decode step. Both give a token the same bits (checked on the card:
    every decode row alone, a pipelined launch, against the full step)."""
    assert pq.wide_schedule(t, hkv) == wide
    plan = pq.launch_plan(t, 4 * hkv, hkv, 128, 64, 32)
    assert plan["schedule"] == ("wide" if wide else "pipelined")


@pytest.mark.parametrize("bs", [16, 64, 128])
@pytest.mark.parametrize("d", [16, 96, 256])
@pytest.mark.parametrize("group", [1, 4, 32])
def test_quant_wide_smem_is_the_layout(bs, d, group):
    """The wide schedule's shared memory, written out: two stages of a
    padded K page, a V page and two scale columns, then the group's q and
    p rows in fp32 at the padded head dim."""
    dp = _launch.head_dim_bucket(d)
    stage = _a16(bs * (dp + 16) + bs * dp + 2 * 4 * bs)
    smem = pq.wide_smem_bytes(bs, d, group)
    assert smem == 2 * stage + group * dp * 4 + group * bs * 4
    plan = pq.launch_plan(300, 8 * group, 8, d, bs, 16)
    assert plan["schedule"] == "wide" and plan["smem"] == smem
    assert plan["stages"] == (2 if smem <= SMEM else 0)


@pytest.mark.parametrize("bs,d,heads,stages", [
    (64, 128, 4, 4), (128, 256, 1, 3), (128, 256, 4, 3), (256, 256, 1, 0),
    (256, 128, 4, 2), (512, 64, 1, 2), (512, 256, 1, 0)])
def test_quant_ring_depth_and_refusal(bs, d, heads, stages):
    """The ring's depth alone on the card at large pages, and 0 (the
    wrapper refuses the shape) where not even 2 stages fit."""
    assert pq.ring_stages(bs, d, heads, 16) == stages


@pytest.mark.parametrize("t,hq,hkv,d,width,stages,heads", [
    (8, 32, 8, 128, 32, 4, 1),     # (e), the serve decode step: 256 blocks
    (8, 16, 8, 64, 16, 4, 1),      # serve-quant's decode step: 128 blocks
    (30, 64, 8, 128, 32, 2, 4)])   # 480 blocks of 4 heads, 2 an SM at 4 stages
def test_quant_ring_depth_follows_the_grid(t, hq, hkv, d, width, stages,
                                           heads):
    """Where the pipelined grid is more than the card holds at 4 stages,
    the ring drops to 2 so that more blocks share an SM. A decode step's
    small grid keeps the 4-stage ring and fits on the card."""
    plan = pq.launch_plan(t, hq, hkv, d, 64, width)
    assert plan["schedule"] == "pipelined"
    assert (plan["stages"], plan["heads"]) == (stages, heads)
    blocks = plan["grid"][0] * plan["grid"][1] * plan["grid"][2]
    per_sm = pq.blocks_per_sm(plan["smem"], plan["threads"])
    assert per_sm == min(233472 // (plan["smem"] + 1024),
                         2048 // plan["threads"])
    deep = pq.blocks_per_sm(pq.smem_bytes(64, d, heads, 4, width),
                            plan["threads"])
    if stages == 2:
        assert blocks > 132 * deep and per_sm > deep
    else:
        assert blocks <= 132 * per_sm


# ------------------------------------------------------------ #14's plan
@pytest.mark.parametrize("h,base,want", [
    (64, 8, 64), (64, 16, 32), (48, 32, 12), (48, 128, 3), (48, 264, 1),
    (5, 1, 5), (7, 40, 7), (6, 50, 6), (6, 66, 6), (6, 132, 2)])
def test_scan_head_groups(h, base, want):
    """The fewest groups (a divisor of h) giving two blocks an SM."""
    assert pss.head_groups(h, base) == want


def _state_layout(L, dh, ds, hg, esize):
    if esize == 4:
        return [L * (ds + 1) * 4, L * ds * 4, L * dh * 4, hg * L * 4, L * 4]
    d16 = -(-ds // 16) * 16
    return [L * (d16 + 8) * 2, hg * L * 4, L * 4, L * (dh + 8) * 2]


def _out_layout(L, dh, ds, esize):
    if esize == 4:
        R = min(L, 64)
        return [L * (ds + 1) * 4, ds * R * 4, ds * R * 4, L * R * 4,
                L * R * 4, L * dh * 4, ds * dh * 4, L * 4, R * 4]
    d16 = -(-ds // 16) * 16
    return [L * (d16 + 8) * 2, L * (dh + 8) * 2, d16 * (dh + 4) * 4, L * 4]


@pytest.mark.parametrize("b,lp,h,dh,ds,L,esize,grids,heads", [
    # serve-ssm's prefill: fp32 x [1, 1023 -> 1024, 64, 32], d_state 16
    (1, 1024, 64, 32, 16, 128, 4, ((8, 1, 64), (2, 8, 32)), (1, 2)),
    # bench_ssm_pretrain's widths: bf16 x [4, 2048, 48, 64], d_state 64
    (4, 2048, 48, 64, 64, 256, 2, ((8, 4, 12), (8, 4, 48)), (4, 1)),
    # a chunk under one row tile, one chunk
    (1, 48, 3, 32, 16, 48, 4, ((1, 1, 3), (1, 1, 3)), (1, 1)),
    # a chunk of a tile and a half (the last fp32 tile 16 rows)
    (2, 160, 4, 24, 24, 80, 4, ((2, 2, 4), (2, 2, 8)), (1, 1)),
    # bf16: a block a (chunk, batch, head) whatever the chunk
    (2, 160, 4, 24, 24, 80, 2, ((2, 2, 4), (2, 2, 4)), (1, 1))])
def test_scan_launch_plan(b, lp, h, dh, ds, L, esize, grids, heads):
    """Grids (x, y, z), heads a block and shared memory of the chunk-state
    and chunk-out launches, and the state pass's grid (an entry of the
    state a thread), against the layouts written out term by term."""
    plan = pss.launch_plan(b, lp, h, dh, ds, L, esize)
    assert (plan["state"]["grid"], plan["out"]["grid"]) == grids
    assert (plan["state"]["heads"], plan["out"]["heads"]) == heads
    assert plan["passes"]["grid"] == (-(-b * h * ds * dh // 256), 1, 1)
    assert plan["state"]["smem"] == sum(
        _a16(n) for n in _state_layout(L, dh, ds, heads[0], esize))
    assert plan["out"]["smem"] == sum(
        _a16(n) for n in _out_layout(L, dh, ds, esize))
    assert max(plan["state"]["smem"], plan["out"]["smem"]) <= SMEM
    nc = lp // L
    assert plan["state"]["grid"][2] * heads[0] == h
    if esize == 4:
        assert plan["out"]["grid"][2] * heads[1] == b * h
        assert plan["out"]["grid"][:2] == (-(-L // min(L, 64)), nc)
    else:
        assert plan["out"]["grid"] == (nc, b, h)
    assert plan["out"]["threads"] == 256


@pytest.mark.parametrize("shape,ds,chunk,dtype,match", [
    ((1, 64, 4, 136), 16, 64, torch.bfloat16, "head_dim 136 or d_state 16 > 128"),
    ((2, 2048, 3, 128), 256, 256, torch.bfloat16, "d_state 256 > 128"),
    ((2, 512, 3, 128), 128, 128, torch.float32, "shared memory"),
    ((2, 2048, 3, 64), 64, 256, torch.float32, "shared memory"),
    ((1, 64, 4, 16), 16, 8, torch.float32, "chunk 8")])
def test_scan_refuses(shape, ds, chunk, dtype, match):
    """What the kernel refuses: a bf16 head dim or d_state past 128 (the
    tensor-core tiles), shared memory past 227 KB, a chunk under 16."""
    assert match in pss.ineligible_reason(shape, ds, chunk, dtype)


@pytest.mark.parametrize("shape,ds,chunk,dtype", [
    ((1, 1023, 64, 32), 16, 128, torch.float32),
    ((4, 2048, 48, 64), 64, 256, torch.bfloat16),
    ((2, 300, 3, 64), 64, 128, torch.float32),
    ((2, 100, 3, 32), 16, 32, torch.float32),
    ((2, 512, 3, 128), 128, 128, torch.bfloat16),
    ((2, 2048, 3, 128), 128, 256, torch.bfloat16),
    ((2, 2048, 3, 32), 16, 256, torch.float32),
    ((1, 64, 4, 256), 16, 64, torch.float32)])
def test_scan_takes(shape, ds, chunk, dtype):
    """The path shapes, the card tests' and an fp32 head dim of 256."""
    assert pss.ineligible_reason(shape, ds, chunk, dtype) is None


# ----------------------------------------------- 14b, the scan's backward
def _bwd_layouts(L, dh, ds, R, esize):
    """The backward's three tiled kernels' shared memory, term by term
    (``csrc/selective_scan.cu``: ``bwd_u_smem``, ``bwd_rows_smem``,
    ``bwd_cols_smem``)."""
    p = 16 // esize
    u = [L * 4, L * 4, R * (ds + p) * esize, R * (dh + p) * esize,
         ds * (dh + 4) * 4]
    rows = [L * 4, R * 4, R * 4, R * (dh + p) * esize, R * (dh + p) * esize,
            R * (ds + p) * esize, R * (ds + p) * esize, ds * (dh + 4) * 4,
            R * (R + 4) * 4, R * (R + 4) * 4, R * (ds + 4) * 4]
    cols = [L * 4, R * 4, R * 4, R * 4, R * (dh + p) * esize,
            R * (dh + p) * esize, R * (ds + p) * esize, R * (ds + p) * esize,
            ds * (dh + 4) * 4, R * (R + p) * esize, R * (R + 4) * 4,
            R * (R + 4) * 4, R * (dh + 4) * 4, R * (ds + 4) * 4]
    return [sum(_a16(n) for n in t) for t in (u, rows, cols)]


def _wg_layouts(dh, ds, L, g):
    """The wgmma route's two tiled launches' shared memory, term by term
    (``csrc/selective_scan.cu``, ``wgb::smem_rows`` / ``smem_cols``)."""
    S = 3 if (dh, ds) == (128, 128) else 4
    bars = (5 + 2 * S) * 8
    rows = [64 * ds * 2, 2 * 64 * ds * 2, S * 64 * dh * 2, S * ds * dh * 2,
            g * L * 4, g * 64 * 4, bars, 1024]
    cols = [64 * ds * 2, 2 * 64 * dh * 2, S * 64 * dh * 2, S * ds * dh * 2,
            g * L * 4, bars, 1024]
    return sum(rows), sum(cols)


# (heads a block, groups) of the wgmma route's tiled launches at the plan
# shapes that take it: bench_ssm_pretrain's 5 groups (10 heads a block, the
# last 8) and a head a block at the widest tiles
_WG_GROUPS = {(4, 2048, 48, 64, 64, 256, 2): (10, 5),
              (2, 2048, 3, 128, 128, 256, 2): (1, 3)}


@pytest.mark.parametrize("b,lp,h,dh,ds,L,esize,rows", [
    # the smoke's two shapes: serve-ssm's prefill (fp32) and
    # bench_ssm_pretrain's (bf16)
    (1, 1024, 64, 32, 16, 128, 4, 64),
    (4, 2048, 48, 64, 64, 256, 2, 64),
    # bf16 at the widest tiles: 64-row edge tiles do not fit, 32 do
    (2, 2048, 3, 128, 128, 256, 2, 32),
    # a chunk under one tile; a chunk of a tile and a quarter
    (1, 48, 3, 32, 16, 48, 4, 32),
    (2, 160, 4, 24, 24, 80, 2, 64),
    # fp32 at a wide head: 8-row tiles (no tensor-core tile in fp32)
    (1, 16, 2, 392, 104, 16, 4, 8)])
def test_scan_bwd_launch_plan(b, lp, h, dh, ds, L, esize, rows):
    """Route, tile rows, grids and shared memory of the backward's six
    launches, against the layouts written out term by term; each under
    227 KB. The edge route (``rows``: its tiles): a block a (tile, chunk,
    batch x head); the wgmma route (bf16 at 64 / 128 widths, 64-row
    tiles): a block a (batch x chunk x head group, tile), the longest
    tiles first, the dB / dC partials a group's."""
    group = _WG_GROUPS.get((b, lp, h, dh, ds, L, esize))
    route = "edge" if group is None else "wgmma"
    assert pss.bwd_tile_rows(L, dh, ds, esize) == rows
    if route == "wgmma":
        rows = 64
    plan = pss.bwd_launch_plan(b, lp, h, dh, ds, L, esize)
    assert plan["route"] == route
    assert plan["rows"] == rows
    nc = lp // L
    if route == "wgmma":
        gu, groups_u = pss.bwd_head_group(h, b * nc)
        u = (L * ds * 2 + 4 * 64 * dh * 2 + 2 * 2 * 64 * dh * 2 + gu * L * 4
             + 9 * 8 + 1024)
        assert plan["chunk_u"]["grid"] == (b * nc * groups_u, 1, 1)
        assert plan["chunk_u"]["threads"] == 160
    else:
        u = _bwd_layouts(L, dh, ds, rows, esize)[0]
        assert plan["chunk_u"]["grid"] == (nc, b, h)
    assert plan["chunk_u"]["smem"] == u and u <= SMEM
    assert plan["passes"]["grid"] == (-(-b * h * ds * dh // 256), 1, 1)
    assert plan["dla"]["grid"] == (nc, b * h, 1)
    assert plan["dbc"]["grid"] == (-(-b * lp * ds // 256), 1, 1)
    n_cs, n_st = b * h * lp, nc * b * h * ds * dh
    if route == "wgmma":
        g, groups = group
        nrt = L // 64
        assert (plan["heads"], plan["groups"]) == (g, groups)
        r, c = _wg_layouts(dh, ds, L, g)
        assert (plan["rows_kernel"]["smem"], plan["cols_kernel"]["smem"]) \
            == (r, c)
        for k in ("rows_kernel", "cols_kernel"):
            assert plan[k]["grid"] == (b * nc * groups, nrt, 1)
            assert plan[k]["threads"] == 160
        assert plan["dbc"]["parts"] == groups
        assert plan["partial_bytes"] == 16 * b * groups * lp * ds
        assert pss.bwd_scratch_floats(b, lp, h, dh, ds, L, route) == \
            4 * n_cs + n_st + 2 * b * groups * lp * ds + 2 * n_st
    else:
        _, r, c = _bwd_layouts(L, dh, ds, rows, esize)
        assert (plan["rows_kernel"]["smem"], plan["cols_kernel"]["smem"]) \
            == (r, c)
        nrt = -(-L // rows)
        assert plan["rows_kernel"]["grid"] == plan["cols_kernel"]["grid"] \
            == (nrt, nc, b * h)
        assert (plan["heads"], plan["groups"], plan["dbc"]["parts"]) \
            == (1, h, h)
        assert plan["partial_bytes"] == 16 * b * h * lp * ds
    assert max(r, c) <= SMEM
    assert pss.bwd_scratch_floats(b, lp, h, dh, ds, L) == \
        5 * n_cs + n_st + 2 * n_cs * ds


@pytest.mark.parametrize("shape,ds,chunk,dtype,aligned,route", [
    ((4, 2048, 48, 64), 64, 256, torch.bfloat16, True, "wgmma"),
    ((2, 512, 3, 128), 64, 128, torch.bfloat16, True, "wgmma"),
    ((2, 512, 3, 64), 128, 64, torch.bfloat16, True, "wgmma"),
    ((4, 2048, 48, 64), 64, 256, torch.bfloat16, False, "edge"),
    ((4, 2048, 48, 64), 64, 256, torch.float32, True, "edge"),
    ((2, 512, 3, 96), 64, 128, torch.bfloat16, True, "edge"),
    ((2, 512, 3, 32), 32, 128, torch.bfloat16, True, "edge"),
    ((2, 512, 3, 64), 16, 128, torch.bfloat16, True, "edge"),
    ((2, 512, 3, 64), 64, 96, torch.bfloat16, True, "edge"),
    ((2, 512, 3, 64), 64, 32, torch.bfloat16, True, "edge")])
def test_scan_bwd_route(shape, ds, chunk, dtype, aligned, route):
    """The route rule (``wgmma_ok`` in the .cu): bf16 at head dim and
    d_state 64 or 128, a chunk of whole 64-row tiles, aligned bases;
    every other call the edge route. The plan names the same route."""
    assert pss.bwd_route(shape, ds, chunk, dtype, aligned) == route
    b, l, h, dh = shape
    esize = 2 if dtype == torch.bfloat16 else 4
    plan = pss.bwd_launch_plan(b, l, h, dh, ds, chunk, esize,
                               route=None if aligned else "edge")
    assert plan["route"] == route


@pytest.mark.parametrize("h,base,group", [
    (48, 128, (10, 5)),    # the train shape: 5 groups do not divide 48
    (7, 128, (2, 4)),      # groups of 2, 2, 2 and 1
    (17, 100, (3, 6)),     # the last group 2 heads
    (3, 8, (1, 3)),        # few blocks: a head a block
    (48, 1000, (16, 3)),   # the grid fills at one group: 16 heads at most
    (64, 1, (1, 64))])
def test_scan_bwd_head_group(h, base, group):
    """Heads a block and groups (``heads_a_block``): the fewest groups
    with base x groups >= 4 x 132 blocks, at most 16 heads a block, no more
    groups than heads; every head in exactly one group."""
    g, groups = pss.bwd_head_group(h, base)
    assert (g, groups) == group
    assert g <= 16 and (groups - 1) * g < h <= groups * g


def test_scan_bwd_wgmma_smem_fits():
    """The wgmma route's launches (chunk U and the two tiled launches) fit
    a block's shared memory at every (head dim, d_state) it takes, every
    chunk of whole 64-row tiles and every group size; at 64 / 64 two tiled
    blocks fit an SM (228 KB, 1 KB a block reserved), as
    ``__launch_bounds__`` asks."""
    for dh in (64, 128):
        for ds in (64, 128):
            for L in (64, 128, 192, 256):
                for g in range(1, 17):
                    r, c = _wg_layouts(dh, ds, L, g)
                    assert max(r, c) <= SMEM, (dh, ds, L, g)
                    u = (L * ds * 2 + 8 * 64 * dh * 2 + g * L * 4 + 9 * 8
                         + 1024)
                    assert u <= SMEM, (dh, ds, L, g)
                    if (dh, ds) == (64, 64):
                        assert 2 * (max(r, c) + 1024) <= 228 * 1024


@pytest.mark.parametrize("shape,ds,chunk,dtype,match", [
    ((1, 64, 4, 136), 16, 64, torch.bfloat16, "head_dim 136 or d_state 16 > 128"),
    ((2, 2048, 3, 128), 256, 256, torch.bfloat16, "d_state 256 > 128"),
    ((2, 512, 3, 128), 128, 128, torch.float32, "shared memory"),
    ((2, 2048, 3, 64), 64, 256, torch.float32, "shared memory"),
    ((1, 64, 4, 16), 16, 8, torch.float32, "chunk 8")])
def test_scan_refuses(shape, ds, chunk, dtype, match):
    """What the kernel refuses: a bf16 head dim or d_state past 128 (the
    tensor-core tiles), shared memory past 227 KB, a chunk under 16."""
    assert match in pss.ineligible_reason(shape, ds, chunk, dtype)


@pytest.mark.parametrize("shape,ds,chunk,dtype", [
    ((1, 1023, 64, 32), 16, 128, torch.float32),
    ((4, 2048, 48, 64), 64, 256, torch.bfloat16),
    ((2, 300, 3, 64), 64, 128, torch.float32),
    ((2, 100, 3, 32), 16, 32, torch.float32),
    ((2, 512, 3, 128), 128, 128, torch.bfloat16),
    ((2, 2048, 3, 128), 128, 256, torch.bfloat16),
    ((2, 2048, 3, 32), 16, 256, torch.float32),
    ((1, 64, 4, 256), 16, 64, torch.float32)])
def test_scan_takes(shape, ds, chunk, dtype):
    """The path shapes, the card tests' and an fp32 head dim of 256."""
    assert pss.ineligible_reason(shape, ds, chunk, dtype) is None


@pytest.mark.parametrize("shape,ds,chunk,dtype,match", [
    ((1, 64, 4, 136), 16, 64, torch.bfloat16, "head_dim 136"),
    ((1, 64, 4, 16), 16, 8, torch.float32, "chunk 8"),
    ((1, 16, 4, 464), 96, 16, torch.float32, "backward shared memory"),
    ((1, 16, 4, 1024), 32, 16, torch.float32, "backward shared memory"),
    ((300, 64, 300, 16), 16, 64, torch.float32, "backward grid")])
def test_scan_bwd_refuses(shape, ds, chunk, dtype, match):
    """The backward refuses the forward's refusals and, by name, the fp32
    shapes at chunk 16 with a head dim of 432 and more whose tiles do not
    fit (the forward takes those) and a batch x heads past the grid."""
    assert match in pss.bwd_ineligible_reason(shape, ds, chunk, dtype)


def test_scan_bwd_takes_what_the_forward_takes():
    """Every shape the forward takes at head dims and d_state up to 256 in
    steps of 8 and every chunk, the backward takes too, but fp32 at chunk
    16 with a head dim of 432 or more."""
    for dtype in (torch.float32, torch.bfloat16):
        for L in range(16, 257, 16):
            for dh in range(8, 257, 8):
                for ds in range(8, 257, 8):
                    shape = (2, L, 4, dh)
                    if pss.ineligible_reason(shape, ds, L, dtype) is None:
                        assert pss.bwd_ineligible_reason(
                            shape, ds, L, dtype) is None, (dtype, L, dh, ds)


# ------------------------------------- the port against JAX at the branches
def _quant_inputs(mode, t, max_seqs, width, bs, kv, hq, d, seed,
                  q_dtype="float32"):
    """Pages quantized by the JAX package from seeded fp32 rows, tables,
    rows and valids (lengths of 0, 1, a page, a page and one and more
    pages than #10's ring holds): the same values for both frameworks."""
    rs = np.random.RandomState(seed)
    n_rows = (max_seqs * width + 1) * bs
    kq, ks = jkv.quantize_kv(jnp.asarray(
        rs.randn(n_rows, kv, d).astype(np.float32)), mode)
    vq, vs = jkv.quantize_kv(jnp.asarray(
        rs.randn(n_rows, kv, d).astype(np.float32)), mode)
    tables = (1 + rs.permutation(max_seqs * width)).reshape(
        max_seqs, width).astype(np.int32)
    rows = rs.randint(0, max_seqs, size=t).astype(np.int32)
    lens = [0, 1, bs, bs + 1, min(5 * bs + 1, width * bs), width * bs]
    valids = np.array([lens[i % len(lens)] for i in range(t)], np.int32)
    q = rs.randn(t, hq, d).astype(np.float32)
    jd = jnp.bfloat16 if q_dtype == "bfloat16" else jnp.float32

    def tt(a):
        a = np.asarray(a)
        if a.dtype.name == "float8_e4m3fn":
            return torch.from_numpy(a.view(np.uint8).copy()).view(
                torch.float8_e4m3fn)
        return torch.from_numpy(a.copy())
    jargs = (jnp.asarray(q, jd), kq, vq, ks, vs, jnp.asarray(tables),
             jnp.asarray(rows), jnp.asarray(valids))
    pargs = (torch.from_numpy(q).to(getattr(torch, q_dtype)), tt(kq), tt(vq),
             tt(ks), tt(vs), torch.from_numpy(tables),
             torch.from_numpy(rows), torch.from_numpy(valids))
    return jargs, pargs, valids


@pytest.mark.parametrize("mode,d,kv,hq,bs,q_dtype", [
    ("int8", 64, 2, 2, 16, "float32"),     # group 1: a head a block
    ("int8", 64, 2, 4, 16, "float32"),     # group 2
    ("fp8", 128, 2, 8, 32, "float32"),     # group 4
    ("int8", 16, 1, 8, 8, "float32"),      # group 8, the smallest head dim
    ("fp8", 256, 1, 4, 16, "bfloat16"),    # the largest bucket, bf16 q
    ("int8", 96, 2, 4, 64, "bfloat16")])   # a masked head dim
def test_quant_twin_matches_jax_at_the_plan_branches(mode, d, kv, hq, bs,
                                                     q_dtype):
    """The port's wrapper (its twin on the CPU) against the reference's
    composed dequant path at groups 1-8, head dims 16-256 and block sizes
    8-64; live tokens only (the reference's composed path averages a pad,
    the port gives 0, checked here too)."""
    jargs, pargs, valids = _quant_inputs(mode, 12, 4, 6, bs, kv, hq, d,
                                         seed=d + hq + bs, q_dtype=q_dtype)
    q, kq, vq, ks, vs, tables, rows, vl = jargs
    want = jax_ragged_xla(q, kq, vq, tables, rows, vl, bs, k_scale=ks,
                          v_scale=vs)
    got = pq.ragged_paged_attention_quant(*pargs, bs)
    live = valids > 0
    tol = FP32 if q_dtype == "float32" else BF16
    assert got.dtype == pargs[0].dtype and tuple(got.shape) == (12, hq, d)
    np.testing.assert_allclose(_f64(got)[live], _f64(want)[live], **tol)
    assert float(got[torch.from_numpy(~live)].abs().max()) == 0.0


def test_quant_twin_matches_jax_pallas_kernel_group_4():
    """int8 pages at head dim 128 (where the reference runs its Pallas
    kernel, interpreted here), group 4 (a block of 4 heads on the card)."""
    jargs, pargs, valids = _quant_inputs("int8", 8, 3, 4, 16, 2, 8, 128,
                                         seed=4)
    assert jax_qp.eligible(jargs[0].shape, 2, 128, jargs[1].dtype)
    want = jax_qp.ragged_paged_attention_quant(*jargs, 16)
    got = pq.ragged_paged_attention_quant(*pargs, 16)
    live = valids > 0
    np.testing.assert_allclose(_f64(got)[live], _f64(want)[live], **FP32)


@pytest.fixture
def _jax_chunked_scan():
    """The JAX scan through its Pallas kernel (interpreted on the CPU)."""
    old = jax_flags.flag("pallas_selective_scan")
    jax_flags.set_flags({"pallas_selective_scan": "on"})
    yield
    jax_flags.set_flags({"pallas_selective_scan": old})
    jss.reset_scan_path_counts()


@pytest.mark.parametrize("b,l,h,dh,ds,chunk,dtype", [
    (1, 40, 2, 8, 8, 16, "float32"),      # d_state under one 16-wide tile
    (2, 70, 3, 24, 24, 48, "float32"),    # a chunk under one row tile
    (1, 150, 2, 16, 16, 80, "float32"),   # a tile and a half, padded tail
    (1, 200, 2, 16, 16, 128, "float32"),  # two row tiles, padded tail
    (2, 96, 3, 16, 16, 32, "bfloat16"),   # three chunks
    (1, 100, 2, 24, 24, 64, "bfloat16")])  # ds padded to 32 on the card
def test_scan_twin_matches_jax_at_the_plan_branches(_jax_chunked_scan, b, l,
                                                    h, dh, ds, chunk, dtype):
    """The port's scan (its chunked twin on the CPU) against the JAX
    package's Pallas kernel at the chunks, row tiles and widths where the
    card's launch plan branches: y and the final state."""
    rs = np.random.RandomState(l + dh)
    x = rs.randn(b, l, h, dh).astype(np.float32)
    dt = (np.abs(rs.randn(b, l, h)) * 0.1 + 0.01).astype(np.float32)
    A = (-np.abs(rs.randn(h)) - 0.1).astype(np.float32)
    B = rs.randn(b, l, ds).astype(np.float32)
    C = rs.randn(b, l, ds).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    yj, sj = jss.selective_scan(jnp.asarray(x, jd), jnp.asarray(dt),
                                jnp.asarray(A), jnp.asarray(B, jd),
                                jnp.asarray(C, jd), chunk=chunk)
    yp, sp = pss.selective_scan(torch.from_numpy(x).to(td),
                                torch.from_numpy(dt), torch.from_numpy(A),
                                torch.from_numpy(B).to(td),
                                torch.from_numpy(C).to(td), chunk=chunk)
    assert yp.dtype == td and sp.dtype == torch.float32
    assert tuple(yp.shape) == (b, l, h, dh) and tuple(sp.shape) == (b, h, ds,
                                                                    dh)
    tol = FP32 if dtype == "float32" else BF16
    for got, want in ((yp, yj), (sp, sj)):
        w = _f64(want)
        np.testing.assert_allclose(_f64(got), w, rtol=tol["rtol"],
                                   atol=tol["atol"] * np.abs(w).max())
