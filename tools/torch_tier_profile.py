#!/usr/bin/env python3
"""Time the host-RAM KV tier's spill and restore on one CUDA card, call by
call, and break their host time down by operation.

    python3 tools/torch_tier_profile.py [--cycles N]

A ``PagedKVCache`` at the smoke's serve-tiered shape (4 layers, 8 blocks of
64 rows, 4 KV heads of 64, fp32; a 64 MiB host tier) holds two prefix
families of 4 blocks; each cycle links one family, which spills one page of
the other and restores one of its own, as the serve-tiered leg does. Prints
the median ms a page of a spill and of a restore (the restore without the
spill it makes room with) on the host clock, then the host operations of
the timed cycles under ``torch.profiler`` by CPU time, and the card's name
and power limit. Needs a CUDA device.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cycles", type=int, default=200)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_tier_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.inference.paged_cache import PagedKVCache
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    cache = PagedKVCache(4, 8, 64, 4, 64, 2, device="cuda",
                         host_tier_bytes=64 << 20)
    fams = [[f * 1000 + i for i in range(256)] for f in range(2)]
    for f in range(2):          # index both families, 4 blocks each
        s = cache.allocate_slot()
        assert cache.ensure_capacity(s, 256)
        cache.register_prefix(s, fams[f], 256)
        cache.free_slot(s)
    times = {"spill": [], "restore": []}
    spill, restore = cache._spill_prefix_block, cache._restore_prefix_entries

    def timed_spill(*a):
        t0 = time.perf_counter()
        ok = spill(*a)
        times["spill"].append(1e3 * (time.perf_counter() - t0))
        return ok

    def timed_restore(*a, **k):
        n0, t0 = sum(times["spill"]), time.perf_counter()
        got = restore(*a, **k)
        ms = 1e3 * (time.perf_counter() - t0) - (sum(times["spill"]) - n0)
        times["restore"].append(ms / max(1, len(got)))
        return got
    cache._spill_prefix_block = timed_spill
    cache._restore_prefix_entries = timed_restore

    def cycle(i):
        s = cache.allocate_slot()
        cache.adopt_prefix(s, fams[i % 2] + [1])
        assert cache.ensure_capacity(s, 257)    # the tail: one more block
        cache.free_slot(s)
    for i in range(10):                          # warm
        cycle(i)
    torch.cuda.synchronize()
    times = {"spill": [], "restore": []}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(args.cycles):
            cycle(i)
        torch.cuda.synchronize()
    for kind, per in times.items():
        per = sorted(per)
        print(f"{kind}: {len(per)} calls, median {per[len(per) // 2]:.4f} "
              f"ms a page, p90 {per[int(len(per) * 0.9)]:.4f}")
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=15))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
