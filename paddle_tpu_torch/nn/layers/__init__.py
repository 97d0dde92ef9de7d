from paddle_tpu_torch.nn.layers.common import Embedding, Linear

__all__ = ["Linear", "Embedding"]
