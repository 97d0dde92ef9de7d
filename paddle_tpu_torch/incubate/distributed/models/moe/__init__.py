"""Mixture of experts on one device (port of
``paddle_tpu/incubate/distributed/models/moe``): the gates and
:class:`MoELayer` over the grouped-GEMM kernels."""

from paddle_tpu_torch.incubate.distributed.models.moe.gate import (
    BaseGate, GShardGate, NaiveGate, SwitchGate)
from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import (
    MoELayer)

__all__ = ["MoELayer", "BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]
