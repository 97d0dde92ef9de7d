from paddle_tpu_torch.nn import functional, initializer
from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue, clip_grad_norm_,
                                      clip_grad_value_)
from paddle_tpu_torch.nn.layers.common import Embedding, Linear

__all__ = ["functional", "initializer", "Linear", "Embedding",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]
