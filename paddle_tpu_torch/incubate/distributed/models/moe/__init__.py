"""Mixture of experts (port of
``paddle_tpu/incubate/distributed/models/moe``): the gates, :class:`MoELayer`
(the grouped-GEMM kernels, the index form, the dense route), and its
expert-parallel paths (:mod:`.moe_a2a`)."""

from paddle_tpu_torch.incubate.distributed.models.moe.gate import (
    BaseGate, GShardGate, NaiveGate, SwitchGate)
from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import (
    MoELayer)

__all__ = ["MoELayer", "BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]
