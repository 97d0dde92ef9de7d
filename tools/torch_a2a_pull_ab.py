#!/usr/bin/env python3
"""Time #15's pull alone (``tiled_a2a_pull``) of two checkouts on one card,
in turns.

    python3 tools/torch_a2a_pull_ab.py PARENT_DIR CHANGE_DIR

#15 runs only between ranks, so no ``chip_smoke.py`` phase times it apart
from the train-moe-ep path. Here each checkout, in a process of its own,
spawns two gloo ranks sharing the card; both stage bf16 x_send [32768,
1024] (the path's payload) with one ``tiled_a2a``, then rank 0 alone times
the pull on the staged slot (CUDA events, L2 flushed, ``chip_smoke.Timer``)
and reads its device time from the profiler (``chip_smoke._device_ms``),
three times, while rank 1 waits at a barrier. The order is parent, change,
change, parent; each run prints one JSON line. Each checkout builds its
own kernels. Needs a CUDA device.
"""

import json
import os
import subprocess
import sys
import tempfile


def _rank(rank, out):
    import torch
    import chip_smoke as cs
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    dist.init_parallel_env(backend="gloo")
    mesh = dist.ProcessMesh([0, 1], ["ep"])
    dist.set_mesh(mesh)
    group = mesh.group("ep")
    g = torch.Generator(device="cuda").manual_seed(5 + rank)
    x = torch.randn(32768, 1024, device="cuda", generator=g).bfloat16()
    timer = cs.Timer(torch)
    res = {"ms": [], "device_ms": []}
    for _ in range(3):
        want = hops.tiled_a2a(x, group)
        if rank == 0:
            res["ms"].append(timer.ms(lambda: hops.tiled_a2a_pull(x, group)))
            assert torch.equal(hops.tiled_a2a_pull(x, group), want)
            res["device_ms"].append(cs._device_ms(
                torch, timer, lambda: hops.tiled_a2a_pull(x, group),
                "ring_copy_kernel") or None)
        torch.distributed.barrier(group=group)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


def _one_tree() -> None:
    """This process's checkout (the working directory): spawn the ranks."""
    sys.path.insert(0, os.getcwd())
    import paddle_tpu_torch.distributed as dist
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rank0.json")
        dist.spawn(_rank, (out,), nprocs=2, timeout=600)
        with open(out) as f:
            print("A2A " + json.dumps(json.load(f)), flush=True)


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--one":
        _one_tree()
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    me = os.path.abspath(__file__)
    for turn, (label, tree) in enumerate((("parent", sys.argv[1]),
                                          ("change", sys.argv[2]),
                                          ("change", sys.argv[2]),
                                          ("parent", sys.argv[1]))):
        proc = subprocess.run([sys.executable, me, "--one"], cwd=tree,
                              capture_output=True, text=True)
        rows = [ln[4:] for ln in proc.stdout.splitlines()
                if ln.startswith("A2A ")]
        if proc.returncode != 0 or not rows:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        print(json.dumps({"turn": turn, "tree": label,
                          **json.loads(rows[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
