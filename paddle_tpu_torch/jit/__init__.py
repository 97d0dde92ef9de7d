from paddle_tpu_torch.jit.api import to_static

__all__ = ["to_static"]
