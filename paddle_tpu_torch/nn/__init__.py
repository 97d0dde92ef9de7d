from paddle_tpu_torch.nn import functional, initializer
from paddle_tpu_torch.nn.layers.common import Embedding, Linear

__all__ = ["functional", "initializer", "Linear", "Embedding"]
