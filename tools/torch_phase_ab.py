#!/usr/bin/env python3
"""Time ``chip_smoke.py`` kernel phases of two checkouts on one card, in
turns.

    python3 tools/torch_phase_ab.py [--smoke DIR] PARENT_DIR CHANGE_DIR PHASE [PHASE ...]

Each checkout runs the named phases of its own ``chip_smoke.py`` (e.g.
``phase_flash_bwd``, ``phase_tgmm``, or a path such as ``phase_train``,
each given the arguments its signature names: ``torch``, ``timer``,
``np``, ``card``, ``rng``) in a process of its own, in the order
parent, change, change, parent, so that both versions are measured on the
same card at the same power limit. Each run prints one JSON line: the
checkout, the turn and, for every phase, the timings of the row the phase
returns (``ms``, ``library_ms``, ``bound_ms``, the per-launch
``launches_ms``, the profiler's ``device_ms``, the host's ``host_us``, a
path's ``ms_per_step`` and ``busy_share``, and the extra shapes a phase
times, such as tgmm's ``down``, the segment backward's ``t1`` or the
RMSNorm phases' ``shapes``, the fused block's ``parts_ms`` and
``edge_ms``, the train phase's ``off_ms_per_step``, and the ``digest`` of
the outputs a phase hashes, ``phase_quant``'s, ``phase_scan``'s and
``phase_scan_bwd``'s, so that one call shows whether two builds give the
same bits). Each checkout builds its own
kernels into its own ``paddle_tpu_torch/_build/``. With ``--smoke DIR`` both
checkouts run the phases of ``DIR/chip_smoke.py`` over their own package, so
that shapes a newer smoke times (``phase_ragged``'s decode steps, say) are
timed on the parent's kernels too; the phases then call only what both
packages have. Needs a CUDA device.
"""

import json
import os
import subprocess
import sys

_KEYS = ("ms", "device_ms", "library_ms", "library_device_ms", "bound_ms",
         "host_us", "library_host_us", "launches_ms", "cp", "down", "t1",
         "shapes", "ms_per_step", "busy_share", "parts_ms", "edge_ms",
         "off_ms_per_step", "digest", "passes_ms")

_RUN = """
import importlib.util, inspect, json, os, sys
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import paddle_tpu_torch.flags  # a path reads it as the package's attribute
smoke = os.environ.get("PTT_AB_SMOKE") or os.path.join(os.getcwd(),
                                                       "chip_smoke.py")
spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
keys = %r
args = dict(torch=torch, timer=cs.Timer(torch), np=np, card=cs.smi(),
            rng=np.random.RandomState(0))
out = {}
for name in sys.argv[1:]:
    fn = getattr(cs, name)
    row = fn(**{p: args[p] for p in inspect.signature(fn).parameters})
    if isinstance(row, tuple):      # a path: (counts, perf, ...)
        row = next(r for r in row if isinstance(r, dict)
                   and any(k in r for k in keys))
    out[name] = {k: row[k] for k in keys if k in row}
    torch.cuda.empty_cache()
print("AB " + json.dumps(out))
""" % (_KEYS,)


def run(tree: str, phases, smoke=None) -> dict:
    env = dict(os.environ)
    if smoke:
        env["PTT_AB_SMOKE"] = os.path.join(os.path.abspath(smoke),
                                           "chip_smoke.py")
    proc = subprocess.run([sys.executable, "-c", _RUN, *phases], cwd=tree,
                          capture_output=True, text=True, env=env)
    rows = [ln[3:] for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    if proc.returncode != 0 or not rows:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(rows[-1])


def main() -> int:
    argv, smoke = sys.argv[1:], None
    if argv[:1] == ["--smoke"] and len(argv) > 1:
        smoke, argv = argv[1], argv[2:]
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change, phases = argv[0], argv[1], argv[2:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for turn, (label, tree) in enumerate((("parent", parent),
                                          ("change", change),
                                          ("change", change),
                                          ("parent", parent))):
        print(json.dumps({"turn": turn, "tree": label,
                          "phases": run(os.path.abspath(tree), phases,
                                        smoke)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
