from paddle_tpu_torch.nn.functional.common import (
    linear, matmul, scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.norm import rms_norm

__all__ = ["linear", "matmul", "rms_norm", "scaled_dot_product_attention"]
