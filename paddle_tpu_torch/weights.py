"""Carry a JAX model's weights into the port.

:func:`load_jax_state` takes the JAX ``LlamaForCausalLM.state_dict()`` as
numpy arrays (``{name: np.asarray(p.numpy())}``) and copies each into the
port's parameter of the same name. Keys, shapes (Paddle's ``[in, out]``
Linear layout) and dtypes match one to one; norm weights are fp32, the
rest in the config dtype. Nothing is transposed or cast.

JAX bf16 arrays reach numpy as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects, so they cross as their raw 16 bits:
``.view(np.uint16)`` -> ``torch.from_numpy`` -> ``.view(torch.bfloat16)``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["load_jax_state", "to_torch"]


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy (including ``ml_dtypes.bfloat16``) -> CPU torch tensor,
    bitwise."""
    a = np.array(a, copy=True, order="C")     # writable, contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_jax_state(model: torch.nn.Module,
                   np_state: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Fill ``model``'s parameters from a JAX state dict of numpy arrays.

    Raises on a missing or unexpected key, a shape mismatch or a dtype
    mismatch — a silently cast or transposed weight would make every
    later comparison meaningless."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(np_state))
    extra = sorted(set(np_state) - set(params))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, unexpected "
                       f"{extra}")
    with torch.no_grad():
        for name, p in params.items():
            src = to_torch(np.asarray(np_state[name]))
            if tuple(src.shape) != tuple(p.shape) or src.dtype != p.dtype:
                raise ValueError(
                    f"{name}: JAX {tuple(src.shape)} {src.dtype} vs port "
                    f"{tuple(p.shape)} {p.dtype}")
            p.copy_(src)
    return model
