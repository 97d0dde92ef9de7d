"""Linear and Embedding (port of ``paddle_tpu/nn/layers/common.py``).

``Linear`` keeps Paddle's ``[in, out]`` weight layout and computes
``x @ w``: state-dict keys and shapes are the JAX model's, and the
compiled decode step multiplies the same leaves.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.nn.functional.common import linear
from paddle_tpu_torch.nn.initializer import Normal

__all__ = ["Linear", "Embedding"]


class Linear(nn.Module):
    """``y = x @ W (+ b)`` with ``W`` of shape ``[in, out]``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False, initializer=None,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = initializer or Normal(0.0, 0.02)
        self.weight = nn.Parameter(
            init((in_features, out_features), dtype, device, generator),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=device),
                                  requires_grad=False)
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 initializer=None, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = initializer or Normal(0.0, 1.0)
        self.weight = nn.Parameter(
            init((num_embeddings, embedding_dim), dtype, device, generator),
            requires_grad=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids]
