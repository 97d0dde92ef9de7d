"""``to_static``: the decorated step as one CUDA graph (port of
``paddle_tpu/jit/api.py``).

The reference traces the decorated function into one XLA executable and
replays it. The port's counterpart of "trace once, run the executable" is
"capture once into a ``torch.cuda.CUDAGraph``, replay it": a replay
launches the whole step, every hand-written kernel and library call in
it, with no Python and no per-op host work.

A program is one specialization of the function. Its key follows the
reference's ``_sig``: the input tree, each tensor's shape, dtype, device
and ``requires_grad``, the static Python values, the grad mode, and here
the flag registry (a flag picks a path on the host). The reference's key
also holds the AMP state and whether the numerics plane is armed; neither
is ported (ROADMAP.md A.1, A.12), so neither is in the port's key.

A program also carries host guards, each a value that must be the same
at every replay as it was at capture, else the call selects or makes
another program:

* the ``training`` flag of every module that ran in the step (the
  reference's ``guard_ok``);
* the values of the guards that code registers with :func:`host_guard`
  (``GradientMergeOptimizer`` registers its window's phase);
* the storage of every tensor the step reads from outside: the
  parameters and buffers of the modules that ran, the state of the
  optimizers that stepped, the tensors in the function's closure and
  globals (identity and ``data_ptr``; for a step that updates, each
  parameter's gradient too), and the identity of the modules, optimizers,
  schedulers and generators reached from the closure and globals.

So ``p.data = ...``, ``.to()`` or a new optimizer re-captures, and a
replay never runs over a storage that is gone. ``load_jax_state`` and
``set_state_dict`` copy in place and need no re-capture.

The life of a program on CUDA:

1. its first call runs eagerly, as a real step, recording the modules,
   guards and state it touches (an optimizer makes its accumulators and
   masters here);
2. its second call captures the step into a graph on a side stream, then
   replays it once;
3. every later call copies its tensor inputs into the program's static
   input buffers, runs the host effects recorded at capture in their
   order, replays the graph, and returns outputs cloned from the static
   output buffers (a kept output never changes under a later replay).

Host values that change every step are staged, never baked. Code that
updates host state inside a step says so with :func:`host_effect` (the
scheduler's epoch arithmetic, gradient merge's window count): the effect
runs at capture and again before every replay. A device tensor filled
from a host value goes through :func:`staged_fill` (the LR tensor): the
graph copies it from a per-program staging scalar, written before each
replay by a stream-ordered copy from freshly allocated pinned memory, so
a replay that the host runs ahead of never reads a later step's value.

A step that updates parameters, clears gradients or runs under
``no_grad`` is self-contained: one graph. A function whose outputs carry
gradients back to its inputs and parameters (``to_static(model)`` with
``backward()`` outside, the reference's differentiable region) becomes a
``torch.autograd.Function`` whose forward replays a forward graph and
whose backward replays a backward graph.

What cannot be captured runs eagerly, loudly: a step that calls
:func:`uncapturable` (host-staged collectives, the exchanges' barrier,
LBFGS, ``ReduceOnPlateau.step(metrics)``), or whose capture fails (a host
sync), ends any capture cleanly and runs eagerly from then on, with one
warning naming the cause; ``concrete_programs()`` says for each program
whether it is captured and why not. Every kernel still runs on the card.

The kernel wrappers' launch counters are Python integers, which a replay
does not touch: a program records each counter's change over its capture
and adds it at every replay, so ``launch_counts()`` counts launches
whether issued or replayed.

On the CPU there are no graphs: the same cache, guards and host effects
run, and each call runs the function eagerly (the second call records
what a capture would; later calls run the recorded staging slots).

Steps may run in several threads (a serving engine a thread): each thread
records only what it runs, and a capture waits until no other thread is
inside :func:`device_work` (a serving engine's step, admission and
handoffs), which in turn waits while a capture runs. A ``StaticFunction``
made with ``shared_pool=True`` (the serving engine's step) captures all its
programs into one graph pool.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import logging
import threading
import time
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from paddle_tpu_torch import flags as _flags
from paddle_tpu_torch.framework.dtype import to_torch_dtype

__all__ = ["to_static", "not_to_static", "enable_to_static", "ignore_module",
           "StaticFunction", "InputSpec", "uncapturable", "host_effect",
           "host_guard", "staged_fill", "note_state", "device_work"]

_log = logging.getLogger("paddle_tpu_torch.jit")

_jit_enabled = [True]


def enable_to_static(flag: bool = True) -> None:
    """Globally toggle capture (``paddle.jit.enable_to_static``): when
    off, decorated functions run eagerly and cache nothing."""
    _jit_enabled[0] = bool(flag)


def ignore_module(modules) -> None:
    """The reference's API; it keeps no module skip-list, nor does the
    port."""


def not_to_static(fn=None):
    """The reference's API: ``fn`` unchanged (everything a captured step
    calls is captured with it)."""
    if fn is None:
        return lambda f: f
    return fn


class InputSpec:
    """Shape and dtype of an input (``paddle.static.InputSpec``). ``None``
    dims mean any; ``to_static`` specializes per concrete shape seen."""

    def __init__(self, shape: Sequence[Optional[int]], dtype="float32",
                 name: Optional[str] = None, stop_gradient: bool = False):
        self.shape = tuple(shape)
        self.dtype = to_torch_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


# --------------------------------------------------------------- recording
class _Uncapturable(Exception):
    """Raised by :func:`uncapturable` inside a capture, before the caller
    touches the host, so that the capture ends cleanly."""

    def __init__(self, what: str):
        super().__init__(what)
        self.what = what


class _Recorder:
    """What one run of a step touched. ``mode`` is ``eager`` (the first
    call), ``capture`` (the call that captures) or ``replay`` (a CPU call
    after capture, which runs the recorded staging slots)."""

    def __init__(self, mode: str, program=None, graph: bool = False):
        self.mode = mode
        self.program = program
        self.graph = graph                     # a CUDA graph is capturing
        self.modules: Dict[int, Any] = {}      # id -> (module, training)
        self.grads: Dict[int, Any] = {}        # id -> (param, grad, version)
        self.guards: List = []                 # (fn, value)
        self.state_fns: List[Callable] = []
        self.uncapturable: Optional[str] = None
        self.effects: List = []                # (fn, slot or None)
        self.fill_values: List[float] = []
        self.fill_specs: List = []             # (dtype, device), eager run
        self.snapshots: Dict[int, Any] = {}    # id(owner) -> (owner, state)
        self.optimizers = 0
        self.depth = 0                         # inside a host effect
        self.fill_index = 0

    def see_module(self, module) -> None:
        if id(module) in self.modules:
            return
        self.modules[id(module)] = (module, bool(module.training))
        for p in module.parameters(recurse=False):
            if id(p) not in self.grads:
                g = p.grad
                self.grads[id(p)] = (p, g, None if g is None else g._version)


# each thread's stack of recorders: steps run in several threads (one
# serving engine a thread) record only what their own thread runs
_tls = threading.local()
_hook_lock = threading.Lock()
_hook_handle = [None, 0]        # the global pre-hook, its recording threads


def _stack() -> List[_Recorder]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _current() -> Optional[_Recorder]:
    """The recorder that hooks report to, or None (no step runs in this
    thread, or the caller is inside a host effect, whose work is plain
    host work)."""
    stack = _stack()
    if not stack:
        return None
    rec = stack[-1]
    return None if rec.depth else rec


def _pre_hook(module, args):
    rec = _current()
    if rec is not None:
        rec.see_module(module)


class _recording:
    """Push a recorder and, while any is active, the global module
    pre-hook that notes every module that runs."""

    def __init__(self, rec: _Recorder):
        self.rec = rec

    def __enter__(self):
        stack = _stack()
        if not stack:
            with _hook_lock:
                if not _hook_handle[1]:
                    _hook_handle[0] = torch.nn.modules.module \
                        .register_module_forward_pre_hook(_pre_hook)
                _hook_handle[1] += 1
        stack.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        stack = _stack()
        stack.pop()
        if not stack:
            with _hook_lock:
                _hook_handle[1] -= 1
                if not _hook_handle[1]:
                    _hook_handle[0].remove()
                    _hook_handle[0] = None
        return False


class _CaptureGate:
    """A capture against other threads' device work. A capture in the
    default (global) mode fails, or fails the other thread, when another
    thread makes a synchronising CUDA call meanwhile, and the launch
    counters would count the other thread's launches into the program's
    replays. So device work that may run beside a capture in another
    thread holds the gate shared (:func:`device_work`), any number of
    threads at once, and a capture holds it alone: it waits until no other
    thread is inside, and new shared holders wait while it waits or runs.
    A thread that captures from inside its own shared hold steps out of it
    for the capture (it issues nothing else meanwhile), so two such
    threads cannot wait on each other."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared: Dict[int, int] = {}      # thread id -> depth
        self._owner: Optional[int] = None      # the capturing thread
        self._waiting = 0                      # captures waiting

    @contextlib.contextmanager
    def shared(self):
        me = threading.get_ident()
        with self._cond:
            if not self._shared.get(me) and self._owner != me:
                while self._owner is not None or self._waiting:
                    self._cond.wait()
            self._shared[me] = self._shared.get(me, 0) + 1
        try:
            yield
        finally:
            with self._cond:
                depth = self._shared.pop(me) - 1
                if depth:
                    self._shared[me] = depth
                self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        with self._cond:
            mine = self._shared.pop(me, 0)
            self._waiting += 1
            try:
                while self._owner is not None or self._shared:
                    self._cond.wait()
            finally:
                self._waiting -= 1
            self._owner = me
        try:
            yield
        finally:
            with self._cond:
                self._owner = None
                if mine:
                    self._shared[me] = mine
                self._cond.notify_all()


_GATE = _CaptureGate()


def device_work():
    """A context for device work that a capture in another thread must not
    overlap (a serving engine's step, admission and handoffs hold it):
    entered at once unless a capture runs or waits; a capture waits until
    every thread has left it."""
    return _GATE.shared()


# ------------------------------------------------------------------ hooks
def uncapturable(what: str) -> None:
    """Say that the running step does ``what``, which a CUDA graph cannot
    hold (a host-staged collective, a barrier, a read of a device value).
    Call it before touching the host. Inside a capture it ends the
    capture; in a step's first run (or a CPU call that records what a
    capture would) it marks the program to run eagerly; outside a step it
    does nothing."""
    rec = _current()
    if rec is None:
        return
    if rec.graph:
        raise _Uncapturable(what)
    if rec.uncapturable is None:
        rec.uncapturable = what


def host_effect(fn: Callable[[], Any], owner=None) -> None:
    """Run ``fn`` (host-state arithmetic of the step: no device work) now
    and, when a step is being captured, again before every replay, in
    capture order. ``owner`` (with ``_host_state()`` and
    ``_set_host_state(state)``) is restored if the capture is abandoned."""
    rec = _current()
    if rec is not None and rec.mode == "capture":
        if owner is not None and id(owner) not in rec.snapshots:
            rec.snapshots[id(owner)] = (owner, owner._host_state())
        rec.effects.append((fn, None))
    if rec is not None:
        rec.depth += 1
    try:
        fn()
    finally:
        if rec is not None:
            rec.depth -= 1


def staged_fill(tensor: torch.Tensor, value: Callable[[], float]) -> None:
    """``tensor.fill_(value())``, staged inside a captured step: the graph
    copies ``tensor`` from a staging scalar of the program, which each
    replay writes from ``value()`` first. ``tensor`` is 0-d."""
    rec = _current()
    if rec is None or rec.mode == "eager":
        if rec is not None:
            rec.fill_specs.append((tensor.dtype, tensor.device))
        tensor.fill_(value())
        return
    # the slots are made before the capture, outside the graph's pool: a
    # slot allocated inside it could share memory with a temporary that
    # the graph writes before it reads the slot
    slots = rec.program.slots
    if rec.fill_index >= len(slots):
        uncapturable("a host value staged more often than in the step's "
                     "first run")
        tensor.fill_(value())
        return
    slot = slots[rec.fill_index]
    rec.fill_index += 1
    if rec.mode == "capture":
        v = value()
        rec.effects.append((value, slot))
        rec.fill_values.append(v)
        if slot.device.type != "cuda":
            slot.fill_(v)
    else:
        # a CPU call after capture writes the slot as a replay would
        slot.fill_(value())
    tensor.copy_(slot)


def host_guard(fn: Callable[[], Any]) -> None:
    """Register a host guard: ``fn()`` (hashable, read at the start of
    each call) must give the value it has now, else the call selects or
    makes another program. Call it before the step changes what ``fn``
    reads."""
    rec = _current()
    if rec is not None and rec.mode != "replay":
        rec.guards.append((fn, fn()))


def note_state(fn: Callable[[], Sequence[torch.Tensor]]) -> None:
    """Register the state tensors an object of the step reads and writes
    in place (an optimizer's LR, step count, accumulators and masters):
    ``fn()`` lists them once the step has run. Their storage is guarded."""
    rec = _current()
    if rec is not None and rec.mode != "replay":
        rec.state_fns.append(fn)
        rec.optimizers += 1


# ------------------------------------------------------------ the program
_SIDE_STREAMS: Dict[int, Any] = {}
_NO_GRAD_GUARD = object()


def _side_stream(dev: torch.device):
    """The device's capture stream (one per device, reused)."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    s = _SIDE_STREAMS.get(index)
    if s is None:
        s = _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return s


def _launch_counts():
    from paddle_tpu_torch.ops import kernels
    return kernels.launch_counts()


def _add_launches(delta) -> None:
    from paddle_tpu_torch.ops import kernels
    for name, n in delta:
        mod, attr = kernels.KERNELS[name]
        setattr(mod, attr, getattr(mod, attr) + n)


def _static_key(x) -> Any:
    try:
        hash(x)
        return x
    except TypeError:
        return repr(x)


def _stateful(obj) -> bool:
    """Objects whose identity a program guards when the function reaches
    them through its closure or globals."""
    return (isinstance(obj, (torch.nn.Module, torch.Generator))
            or hasattr(obj, "_parameter_list") or hasattr(obj, "_inner")
            or hasattr(obj, "_bound_tensor"))


def _reachable(fn):
    """``(kind, holder, name, object)`` for each closure cell and global
    that ``fn`` (or its underlying function) refers to."""
    out = []
    self_obj = getattr(fn, "__self__", None)
    func = getattr(fn, "__func__", fn)
    code = getattr(func, "__code__", None)
    if code is None:
        return out, self_obj
    for name, cell in zip(code.co_freevars, func.__closure__ or ()):
        try:
            out.append(("cell", cell, name, cell.cell_contents))
        except ValueError:      # an empty cell
            continue
    glb = getattr(func, "__globals__", {})
    for name in code.co_names:
        if name in glb:
            out.append(("global", glb, name, glb[name]))
    return out, self_obj


def _sync_debug_mode(mode) -> None:
    """``torch.cuda.set_sync_debug_mode`` without its warning that the
    mode is a prototype."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode(mode)


def _stage(slot: torch.Tensor, value: float) -> None:
    """Write ``value`` into a staging slot by a copy on the current stream
    from freshly allocated pinned memory (the host allocator hands the
    block out again only once this copy has run)."""
    host = torch.empty((), dtype=slot.dtype, pin_memory=True)
    host.fill_(value)
    slot.copy_(host, non_blocking=True)


class _MemoryAnalysis:
    """A captured program's pool, in the attribute names of XLA's
    ``CompiledMemoryStats``: static inputs (argument), static outputs
    (output) and the rest of the graph's pool (temp), in bytes."""

    def __init__(self, argument: int, output: int, pool: int):
        self.argument_size_in_bytes = int(argument)
        self.output_size_in_bytes = int(output)
        self.temp_size_in_bytes = int(max(pool - output, 0))

    def __repr__(self):
        return (f"MemoryAnalysis(argument={self.argument_size_in_bytes}, "
                f"output={self.output_size_in_bytes}, "
                f"temp={self.temp_size_in_bytes})")


class _SharedPool:
    """One graph memory pool for every program of a ``StaticFunction``
    made with ``shared_pool=True``, made at the first capture."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class _Region(torch.autograd.Function):
    """A captured differentiable region: the forward replays the forward
    graph, the backward the backward graph."""

    @staticmethod
    def forward(ctx, prog, *tensors):
        outs = prog.region_forward(tensors[:prog.n_dyn])
        ctx.prog, ctx.generation = prog, prog.generation
        ctx.mark_non_differentiable(
            *[o for o, d in zip(outs, prog.out_diff) if not d])
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (None,) + ctx.prog.region_backward(ctx.generation, grads)


class _Program:
    """One specialization of a ``StaticFunction``: its guards, and its
    graph once captured."""

    _run_counter = itertools.count()

    def __init__(self, fn: Callable, name: str,
                 pool: Optional[_SharedPool] = None):
        # the function and its name, not the StaticFunction: a program
        # that referred back to its owner would keep its graph alive until
        # the cycle collector ran
        self.fn, self.name, self.pool = fn, name, pool
        self.calls = 0
        self.captured = False        # a CUDA graph holds the step
        self.reason: Optional[str] = None   # why the step runs eagerly
        self.self_contained = True   # else a differentiable region
        self.mode_guard: List = []   # (weakref to module, training)
        self.guards: List = []       # (fn, value)
        self.identity: List = []     # (kind, holder, name, object)
        self.storage: List = []      # (tensor, data_ptr, grad key)
        self.end_grads: List = []
        self.params: List[torch.Tensor] = []
        self.generators: List[torch.Generator] = []
        self.slots: List[torch.Tensor] = []
        self.fill_specs: List = []
        self.effects: List = []
        self.launch_delta = ()
        self.memory: Optional[_MemoryAnalysis] = None
        self.capture_s = 0.0         # host seconds of the capture
        # and its parts: the synchronise and release before it, the step
        # run under capture, the end of the capture (instantiation)
        self.capture_parts = {"begin": 0.0, "record": 0.0,
                              "instantiate": 0.0}
        self.pool_bytes = 0          # reserved bytes the capture added
        self._run_seq = -1

    def __repr__(self):
        state = "captured" if self.captured else (
            f"eager ({self.reason})" if self.reason else "not captured")
        kind = "self-contained" if self.self_contained else "region"
        return f"<to_static program of {self.name}: {kind}, {state}>"

    # -- guards ---------------------------------------------------------------
    def guard_ok(self) -> bool:
        for ref, training in self.mode_guard:
            m = ref()
            if m is not None and m.training != training:
                return False
        for fn, value in self.guards:
            if fn() != value:
                return False
        for kind, holder, name, obj in self.identity:
            try:
                now = holder.cell_contents if kind == "cell" \
                    else holder.get(name)
            except ValueError:          # the cell was emptied
                return False
            if now is not obj:
                return False
        for t, ptr, gkey in self.storage:
            if t.data_ptr() != ptr:
                return False
            if gkey is not _NO_GRAD_GUARD:
                g = t.grad
                if (None if g is None else g.data_ptr()) != gkey:
                    return False
        return True

    def _absorb(self, rec: _Recorder) -> None:
        """The guards of a run: the modules' modes, the registered guards
        and the identity of the stateful objects the function reaches."""
        self.mode_guard = [(weakref.ref(m), t)
                           for m, t in rec.modules.values()]
        self.guards = list(rec.guards)
        reach, self_obj = _reachable(self.fn)
        self.identity = [r for r in reach
                         if isinstance(r[3], torch.Tensor) or _stateful(r[3])]
        seen = {id(m) for m, _ in rec.modules.values()}
        if isinstance(self_obj, torch.nn.Module) and id(self_obj) not in seen:
            # a patched forward: its own module runs outside the hook
            self.mode_guard.append((weakref.ref(self_obj),
                                    bool(self_obj.training)))
        mods = [m for m, _ in rec.modules.values()]
        if isinstance(self_obj, torch.nn.Module):
            mods.append(self_obj)
        objs = [r[3] for r in self.identity] + mods
        self.generators = []
        for o in objs:
            for v in ([o] + list(vars(o).values()) if hasattr(o, "__dict__")
                      else [o]):
                if isinstance(v, torch.Generator) and v.device.type == "cuda" \
                        and all(v is not g for g in self.generators):
                    self.generators.append(v)
        self._mods = mods

    def _state_tensors(self, state_fns) -> List[torch.Tensor]:
        """Every tensor the step reads from outside its inputs: the
        parameters and buffers of the modules that ran, the noted state
        and the tensors of the closure and globals."""
        out, seen = [], set()

        def add(t):
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        for m in self._mods:
            for t in m.parameters():
                add(t)
            for t in m.buffers():
                add(t)
        for fn in state_fns:
            for t in fn():
                add(t)
        for r in self.identity:
            add(r[3])
        return out

    def _guard_storage(self) -> None:
        """The storage guard: every state tensor as it stands when the
        capture begins (a self-contained step's parameters also with their
        gradients)."""
        params = {id(p) for m in self._mods for p in m.parameters()}
        self.storage = [
            (t, t.data_ptr(),
             _NO_GRAD_GUARD if not self.self_contained or id(t) not in params
             else (None if t.grad is None else t.grad.data_ptr()))
            for t in self._state_tensors(self._state_fns)]

    def _start(self, graph: bool = False) -> _Recorder:
        """A capture's recorder, which knows each parameter's gradient as
        it stands now (restored if the capture is dropped)."""
        self._guard_storage()
        self.slots = [torch.empty((), dtype=d, device=dev)
                      for d, dev in self.fill_specs]
        rec = _Recorder("capture", self, graph)
        for m in self._mods:
            for p in m.parameters():
                rec.grads.setdefault(id(p), (p, p.grad, None))
        return rec

    def _mark_eager(self, what: str) -> None:
        self.reason = what
        warnings.warn(
            f"to_static({self.name}): this specialization runs "
            f"eagerly: {what} cannot be captured into a CUDA graph",
            RuntimeWarning, stacklevel=4)
        _log.info("to_static(%s): runs eagerly: %s", self.name, what)

    # -- calls ----------------------------------------------------------------
    def __call__(self, args, kwargs, leaves, spec):
        self._run_seq = next(_Program._run_counter)
        self.calls += 1
        fn = self.fn
        if self.reason is not None:
            return fn(*args, **kwargs)
        if self.calls == 1:
            return self._first(args, kwargs)
        if self.calls == 2:
            return self._capture(args, kwargs, leaves, spec)
        return self._replay(args, kwargs, leaves)

    def _first(self, args, kwargs):
        """The eager first run: a real step that makes the lazy state and
        shows what the step touches."""
        rec = _Recorder("eager", self)
        with _recording(rec):
            out = self.fn(*args, **kwargs)
        self._absorb(rec)
        self._state_fns = rec.state_fns
        self.fill_specs = rec.fill_specs
        self._warm_ids = {id(t) for t in self._state_tensors(rec.state_fns)}
        changed = any(
            p.grad is not g or (g is not None and g._version != v)
            for p, g, v in rec.grads.values())
        diff = any(isinstance(t, torch.Tensor) and t.requires_grad
                   for t in pytree.tree_leaves(out))
        self.self_contained = not (torch.is_grad_enabled() and diff
                                   and not changed and not rec.optimizers)
        if rec.uncapturable is not None:
            self._mark_eager(rec.uncapturable)
        return out

    def _outputs(self):
        with torch.no_grad():
            outs = [t.clone() for t in self.static_out]
        return self._unflatten_out(outs)

    def _unflatten_out(self, tensors):
        leaves = list(self.out_static)
        for i, t in zip(self.out_idx, tensors):
            leaves[i] = t
        return pytree.tree_unflatten(leaves, self.out_spec)

    def _split_out(self, out):
        leaves, self.out_spec = pytree.tree_flatten(out)
        self.out_idx = [i for i, l in enumerate(leaves)
                        if isinstance(l, torch.Tensor)]
        self.out_static = [None if isinstance(l, torch.Tensor) else l
                           for l in leaves]
        return [leaves[i] for i in self.out_idx]

    def _check_state(self, rec: _Recorder) -> None:
        new = [t for t in self._state_tensors(rec.state_fns)
               if id(t) not in self._warm_ids]
        if new:
            raise RuntimeError(
                f"to_static({self.name}): the capture touched "
                f"{len(new)} state tensor(s) that the first run did not "
                f"(shapes {[tuple(t.shape) for t in new[:4]]}); avoid "
                f"creating state conditionally inside a to_static function")

    def _capture(self, args, kwargs, leaves, spec):
        dyn = [i for i, l in enumerate(leaves) if isinstance(l, torch.Tensor)]
        # a step over CUDA tensors (its inputs or its state) is captured;
        # one over CPU tensors only records what a capture would
        dev = next((t.device for t in [leaves[i] for i in dyn]
                    + self._state_tensors(self._state_fns) if t.is_cuda),
                   None)
        if dev is None:
            return self._record_cpu(args, kwargs)
        with _GATE.exclusive():
            if not self.self_contained:
                return self._capture_region(leaves, spec, dyn, dev)
            return self._capture_step(leaves, spec, dyn, dev, args, kwargs)

    # -- CPU: the same bookkeeping, eager runs --------------------------------
    def _record_cpu(self, args, kwargs):
        rec = self._start()
        with _recording(rec):
            out = self.fn(*args, **kwargs)
        if rec.uncapturable is not None:
            # the call ran as a step runs eagerly; the program stays so
            self._mark_eager(rec.uncapturable)
            return out
        self._check_state(rec)
        self._absorb(rec)
        self.effects = rec.effects
        self.slots = self.slots[:rec.fill_index]
        return self._detached(out)

    def _detached(self, out):
        if not self.self_contained:
            return out
        return pytree.tree_map(
            lambda t: t.detach() if isinstance(t, torch.Tensor) else t, out)

    def _replay_cpu(self, args, kwargs):
        rec = _Recorder("replay", self)
        with _recording(rec):
            out = self.fn(*args, **kwargs)
        if rec.fill_index != len(self.slots):
            raise RuntimeError(
                "to_static: the step staged fewer host values than at "
                "capture; its host control flow changed between calls")
        return self._detached(out)

    # -- CUDA: capture --------------------------------------------------------
    def _abandon(self, rec: _Recorder) -> None:
        """Undo the host state a dropped capture changed."""
        for owner, state in rec.snapshots.values():
            owner._set_host_state(state)
        for p, g, _ in rec.grads.values():
            p.grad = g

    def _pool_handle(self):
        return None if self.pool is None else self.pool.handle()

    def _begin(self, dev):
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        if self.pool is None:
            # a program of a shared pool (a serving engine's step, whose
            # signatures arrive mid-run) skips these: they took ~0.2 s a
            # capture in a large process, a stall each new signature would
            # add to a serving step; its pool grows as it needs
            gc.collect()
            torch.cuda.empty_cache()
        self.capture_parts["begin"] += time.perf_counter() - t0
        return torch.cuda.memory_reserved(dev)

    def _graph(self):
        g = torch.cuda.CUDAGraph()
        for gen in self.generators:
            reg = getattr(g, "register_generator_state", None)
            if reg is None:
                raise _Uncapturable(
                    "a draw from an explicit torch.Generator (this PyTorch "
                    "has no CUDAGraph.register_generator_state)")
            reg(gen)
        return g

    def _run_captured(self, graph, dev, body, pool=None):
        """``body()`` captured into ``graph`` on the side stream; the
        exception that ended it, or None."""
        side = _side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        err, out = None, None
        mode = torch.cuda.get_sync_debug_mode()
        # no collection while the graph is captured: a collected program's
        # graph destroyed meanwhile fails the capture inside CUDA ("not
        # permitted when stream is capturing"), and that capture's pool
        # stays marked as recording, so that the next capture into the
        # same pool cannot begin
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool)
                # a host sync inside the capture raises before its CUDA
                # call: the capture then ends cleanly. Issued, the sync
                # would fail in CUDA, and after a capture that fails there
                # the caching allocator returns no memory to the device for
                # the rest of the process (PyTorch 2.11 on the H100)
                _sync_debug_mode("error")
                t0 = time.perf_counter()
                try:
                    out = body()
                except BaseException as e:  # noqa: BLE001 - ends the capture
                    err = e
                finally:
                    _sync_debug_mode(mode)
                t1 = time.perf_counter()
                try:
                    graph.capture_end()
                except Exception as e:      # noqa: BLE001 - an ended capture
                    err = err or e
                self.capture_parts["record"] += t1 - t0
                self.capture_parts["instantiate"] += time.perf_counter() - t1
        except Exception as e:              # noqa: BLE001 - not begun
            err = err or e
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(dev).wait_stream(side)
        if err is not None and not isinstance(err, Exception):
            raise err                   # an interrupt: the capture is ended
        return out, err

    def _failed(self, rec, err, dev, args, kwargs):
        """A capture that did not complete: drop it, undo its host state,
        run the step eagerly, and keep it eager from now on."""
        self.graph = self.fwd_graph = self.bwd_graph = None
        self.static_in = self.static_out = []
        self._abandon(rec)
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        first = (str(err).splitlines() or [""])[0]
        what = err.what if isinstance(err, _Uncapturable) else \
            f"{type(err).__name__}: {first}"
        self._mark_eager(what)
        return self.fn(*args, **kwargs)

    def _static_inputs(self, leaves, dyn):
        ins = []
        with torch.no_grad():
            for i in dyn:
                x = leaves[i]
                s = torch.empty_like(x).copy_(x)
                ins.append(s.requires_grad_(x.requires_grad))
        return ins

    def _capture_step(self, leaves, spec, dyn, dev, args, kwargs):
        t0 = time.perf_counter()
        self.static_in = self._static_inputs(leaves, dyn)
        cap_leaves = list(leaves)
        for i, s in zip(dyn, self.static_in):
            cap_leaves[i] = s
        c_args, c_kwargs = pytree.tree_unflatten(cap_leaves, spec)
        rec = self._start(graph=True)
        reserved0 = self._begin(dev)
        before = _launch_counts()
        try:
            graph = self._graph()
        except _Uncapturable as e:
            return self._failed(rec, e, dev, args, kwargs)

        def body():
            with _recording(rec):
                return self.fn(*c_args, **c_kwargs)
        out, err = self._run_captured(graph, dev, body, self._pool_handle())
        if err is not None:
            return self._failed(rec, err, dev, args, kwargs)
        after = _launch_counts()
        self.launch_delta = tuple((k, after[k] - before[k]) for k in after
                                  if after[k] != before[k])
        self._check_state(rec)
        self._absorb(rec)
        # the gradients the step leaves (graph memory, rewritten by every
        # replay), put back after each replay as an eager step leaves them
        self.end_grads = [(p, p.grad) for p, g, _ in rec.grads.values()
                          if p.grad is not g]
        self.graph = graph
        self.static_out = [t.detach() for t in self._split_out(out)]
        self.effects = rec.effects
        self.slots = self.slots[:rec.fill_index]
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved0
        self.memory = _MemoryAnalysis(
            sum(t.numel() * t.element_size() for t in self.static_in),
            sum(t.numel() * t.element_size() for t in self.static_out),
            self.pool_bytes)
        self.captured = True
        self.capture_s = time.perf_counter() - t0
        _log.info("to_static(%s): captured in %.3f s, %s", self.name,
                  self.capture_s, self.memory)
        # the first replay stages the values the capture computed
        with torch.no_grad():
            for slot, v in zip(self.slots, rec.fill_values):
                _stage(slot, v)
            graph.replay()
        return self._outputs()

    def _replay(self, args, kwargs, leaves):
        if not self.captured:
            return self._replay_cpu(args, kwargs)
        if not self.self_contained:
            return self._call_region(leaves)
        with torch.no_grad():
            for s, i in zip(self.static_in, self.dyn_idx(leaves)):
                s.copy_(leaves[i])
            self._run_effects()
            self.graph.replay()
        for p, g in self.end_grads:
            p.grad = g
        _add_launches(self.launch_delta)
        return self._outputs()

    @staticmethod
    def dyn_idx(leaves):
        return [i for i, l in enumerate(leaves) if isinstance(l, torch.Tensor)]

    def _run_effects(self) -> None:
        for fn, slot in self.effects:
            if slot is None:
                fn()
            else:
                _stage(slot, fn())

    # -- CUDA: the differentiable region -------------------------------------
    def _alias_params(self):
        """Put fresh leaves over the parameters' storage in place of the
        parameters of the modules that ran, for the capture; returns the
        aliases by parameter id and the undo list. An autograd graph the
        caller keeps from an earlier call holds the parameters' gradient
        accumulators, made on the caller's stream, which a captured
        backward may not wait on; the aliases get theirs on the capture
        stream."""
        aliases, undo = {}, []
        subs = {id(sub): sub for m in self._mods for sub in m.modules()}
        for m in subs.values():
            for name, p in list(m._parameters.items()):
                if p is None:
                    continue
                a = aliases.get(id(p))
                if a is None:
                    a = aliases[id(p)] = torch.nn.Parameter(
                        p.detach(), requires_grad=p.requires_grad)
                m._parameters[name] = a
                undo.append((m, name, p))
        return aliases, undo

    def _capture_region(self, leaves, spec, dyn, dev):
        t0 = time.perf_counter()
        self.static_in = self._static_inputs(leaves, dyn)
        cap_leaves = list(leaves)
        for i, s in zip(dyn, self.static_in):
            cap_leaves[i] = s
        c_args, c_kwargs = pytree.tree_unflatten(cap_leaves, spec)
        self.params = [p for m in self._mods for p in m.parameters()
                       if p.requires_grad]
        self.params = list({id(p): p for p in self.params}.values())
        self.n_dyn = len(self.static_in)
        rec = self._start(graph=True)
        reserved0 = self._begin(dev)
        before = _launch_counts()
        args, kwargs = pytree.tree_unflatten(list(leaves), spec)
        try:
            fwd, bwd = self._graph(), self._graph()
        except _Uncapturable as e:
            return self._failed(rec, e, dev, args, kwargs)
        pool = torch.cuda.graph_pool_handle()
        aliases, undo = self._alias_params()
        try:
            def body():
                with _recording(rec), torch.enable_grad():
                    return self.fn(*c_args, **c_kwargs)
            out, err = self._run_captured(fwd, dev, body, pool)
            if err is None:
                mid = _launch_counts()
                outs = self._split_out(out)
                self.out_diff = [t.requires_grad for t in outs]
                diff = [t for t in outs if t.requires_grad]
                wrt = [s for s in self.static_in if s.requires_grad] + \
                    [aliases[id(p)] for p in self.params]
                self.static_grad_out = [torch.empty_like(t) for t in diff]

                def grads():
                    return torch.autograd.grad(
                        diff, wrt, self.static_grad_out, allow_unused=True)
                static_grads, err = self._run_captured(bwd, dev, grads,
                                                       pool)
        finally:
            for m, name, p in undo:
                m._parameters[name] = p
        if err is not None:
            return self._failed(rec, err, dev, args, kwargs)
        after = _launch_counts()
        self.fwd_delta = tuple((k, mid[k] - before[k]) for k in mid
                               if mid[k] != before[k])
        self.bwd_delta = tuple((k, after[k] - mid[k]) for k in after
                               if after[k] != mid[k])
        # the capture counted the backward's launches, which run when
        # the caller's backward replays that graph
        _add_launches(tuple((k, -n) for k, n in self.bwd_delta))
        self._check_state(rec)
        self._absorb(rec)
        self.fwd_graph, self.bwd_graph = fwd, bwd
        self.static_out = [t.detach() for t in outs]
        self.static_grads = list(static_grads)
        self.wrt_inputs = [s.requires_grad for s in self.static_in]
        self.effects = rec.effects
        self.slots = self.slots[:rec.fill_index]
        self.fill_values = rec.fill_values
        self.generation = 0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved0
        self.memory = _MemoryAnalysis(
            sum(t.numel() * t.element_size() for t in self.static_in),
            sum(t.numel() * t.element_size() for t in self.static_out),
            self.pool_bytes)
        self.captured = True
        self.capture_s = time.perf_counter() - t0
        _log.info("to_static(%s): captured a region in %.3f s, %s",
                  self.name, self.capture_s, self.memory)
        self._first_replay = True
        return self._call_region(leaves)

    def _call_region(self, leaves):
        dyn = [leaves[i] for i in self.dyn_idx(leaves)]
        outs = _Region.apply(self, *dyn, *self.params)
        return self._unflatten_out(list(outs))

    def region_forward(self, inputs):
        with torch.no_grad():
            for s, x in zip(self.static_in, inputs):
                s.copy_(x)
            if self._first_replay:
                for slot, v in zip(self.slots, self.fill_values):
                    _stage(slot, v)
                self._first_replay = False
            else:
                self._run_effects()
                _add_launches(self.fwd_delta)
            self.fwd_graph.replay()
            self.generation += 1
            return [t.clone() for t in self.static_out]

    def region_backward(self, generation, grads):
        if generation != self.generation:
            raise RuntimeError(
                f"to_static({self.name}): the captured region ran "
                f"forward again before this backward; its saved activations "
                f"are the later call's. Run backward after each call, or "
                f"disable to_static for this use")
        with torch.no_grad():
            diff = [g for g, d in zip(grads, self.out_diff) if d]
            for s, g in zip(self.static_grad_out, diff):
                if g is None:
                    s.zero_()
                else:
                    s.copy_(g)
            self.bwd_graph.replay()
            _add_launches(self.bwd_delta)
            got = [None if g is None else g.clone()
                   for g in self.static_grads]
        out, k = [], 0
        for wants in self.wrt_inputs:
            if wants:
                out.append(got[k])
                k += 1
            else:
                out.append(None)
        return tuple(out) + tuple(got[k:])

    # -- analysis -------------------------------------------------------------
    def memory_analysis(self):
        return self.memory

    def cost_analysis(self):
        """None: XLA's compile-time flop count has no counterpart over
        hand-written kernels (the reference's contract allows None)."""
        return None


class StaticFunction:
    """What ``to_static`` returns (the reference's ``StaticFunction``).

    ``shared_pool`` (the port's own; the serving engine's step sets it)
    captures every self-contained program of the function into one graph
    memory pool instead of one each. A graph's temporaries may then lie
    where another program's outputs lie, which is safe only when no two
    replays overlap and each replay's outputs are read (the program clones
    them) before the next replay: true of one thread calling the
    function."""

    def __init__(self, fn: Callable, input_spec=None, full_graph=True,
                 name: Optional[str] = None, shared_pool: bool = False):
        self._original_fn = fn
        self._fn = fn
        self._input_spec = input_spec
        self._name = name or getattr(fn, "__name__", "fn")
        self._cache: Dict[Any, List[_Program]] = {}
        self._pool = _SharedPool() if shared_pool else None
        self._lock = threading.RLock()
        functools.update_wrapper(self, fn, assigned=("__name__", "__doc__",
                                                     "__qualname__"))

    @property
    def function(self):
        return self._original_fn

    def rollback(self):
        return self._original_fn

    def concrete_programs(self) -> List[_Program]:
        # snapshots: another thread (a host's /introspect) may read while
        # the calling thread adds a program
        return [p for progs in list(self._cache.values())
                for p in list(progs)]

    def _last_run(self):
        return sorted(self.concrete_programs(), key=lambda p: p._run_seq,
                      reverse=True)

    def memory_analysis(self):
        """The pool of the most recently run captured program (static
        inputs, outputs and temporaries), or None."""
        for p in self._last_run():
            if p.memory is not None:
                return p.memory
        return None

    def cost_analysis(self):
        """None (see ``_Program.cost_analysis``)."""
        return None

    def _sig(self, leaves):
        parts = []
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                parts.append(("T", tuple(leaf.shape), leaf.dtype,
                              leaf.device, leaf.requires_grad))
            else:
                parts.append(("S", _static_key(leaf)))
        # no AMP or numerics part: neither plane is ported (ROADMAP.md
        # A.1, A.12)
        return (tuple(parts), torch.is_grad_enabled(),
                tuple(_flags._FLAGS.values()))

    def __call__(self, *args, **kwargs):
        if not _jit_enabled[0] or _stack():
            # disabled, or inside another step's run: inline
            return self._fn(*args, **kwargs)
        leaves, spec = pytree.tree_flatten((args, kwargs))
        key = (spec, self._sig(leaves))
        with self._lock:
            progs = self._cache.setdefault(key, [])
            prog = next((p for p in progs if p.guard_ok()), None)
            if prog is None:
                prog = _Program(self._fn, self._name, self._pool)
                progs.append(prog)
                _log.debug("to_static(%s): program %d", self._name,
                           sum(len(ps) for ps in self._cache.values()))
            return prog(args, kwargs, leaves, spec)

    def __get__(self, instance, owner):
        if instance is None:
            return self
        attr = f"__static_{self._name}"
        bound = instance.__dict__.get(attr) if hasattr(
            instance, "__dict__") else None
        if bound is None:
            bound = StaticFunction(self._original_fn.__get__(instance, owner),
                                   self._input_spec, name=self._name,
                                   shared_pool=self._pool is not None)
            # cache on the instance so its programs persist across calls
            try:
                object.__setattr__(instance, attr, bound)
            except AttributeError:
                pass
        return bound

    def __deepcopy__(self, memo):
        import copy
        return StaticFunction(copy.deepcopy(self._original_fn, memo),
                              self._input_spec, name=self._name,
                              shared_pool=self._pool is not None)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, **kwargs):
    """Capture a function, or a module's ``forward``, into CUDA graphs
    (``paddle.jit.to_static``). ``build_strategy`` and ``backend`` are
    accepted for the reference's signature."""
    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            layer = fn
            layer.forward = StaticFunction(layer.forward, input_spec,
                                           name=type(layer).__name__)
            return layer
        return StaticFunction(fn, input_spec, full_graph)

    if function is not None:
        return decorate(function)
    return decorate
