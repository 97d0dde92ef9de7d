#!/usr/bin/env python3
"""Run the MoE plane's phases of ``chip_smoke.py`` alone on one CUDA card.

    python3 tools/torch_moe_plane.py [plane] [ep]

``plane`` runs ``phase_moe_plane`` (train-moe-index, serve-moe-index and
the moe-layer checks); ``ep`` runs the all-gather expert path's legs of
train-moe-ep, (b4) and (b5), in two ``distributed.spawn`` ranks sharing the
card over gloo, after one process's index-form step for (b4)'s gradient
check; with no argument, both. Builds the kernels from this checkout
first, prints the smoke's lines and the card's name and power limit, and
exits non-zero where a check fails. Needs a CUDA device.
"""

import os
import sys
import tempfile
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def rank_fn(rank, work):
    """One rank of the (b4)/(b5) legs: ``chip_smoke._ep_gather_legs``."""
    import numpy as np
    import chip_smoke as cs
    torch, paddle, _, mesh = cs._ep_setup()
    out = {}
    cs._ep_gather_legs(torch, paddle, np, mesh, rank, work, out)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def ep_legs(torch, np, cs):
    """(b4) and (b5) as ``phase_train_moe_ep`` runs and checks them."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    cfg = cs.moe_config()
    torch.use_deterministic_algorithms(True, warn_only=True)
    model, _, _ = cs.build_trainer(torch, cfg)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(cs.MOE_B, cs.MOE_S)).astype("int32")).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    names = [n for n, _ in model.named_parameters()]
    paddle.flags.set_flags({"moe_grouped_gemm": "off"})
    try:
        loss_index, grads_index = cs.loss_and_grads(torch, model, ids)
    finally:
        paddle.flags.set_flags({"moe_grouped_gemm": "auto"})
    grads_index = [g.bfloat16().cpu() for g in grads_index]
    del model
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        dist.spawn(rank_fn, (work,), nprocs=cs.EP, timeout=600)
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False) for r in range(cs.EP)]
        grads = torch.load(os.path.join(work, "grads_b4.pt"))
        cs.log(f"ep legs in {time.perf_counter() - t0:.1f} s")
    cs._ep_gather_checks(torch, ranks, grads, loss_index, grads_index,
                         names, cs.moe_flops_per_token(cfg, n_params),
                         cfg.num_hidden_layers)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_moe_plane: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    card = cs.smi()
    cs.log(f"build {time.perf_counter() - t0:.1f} s on {card}")
    which = sys.argv[1:] or ["plane", "ep"]
    if "plane" in which:
        cs.phase_moe_plane(torch, np, card)
    if "ep" in which:
        ep_legs(torch, np, cs)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
