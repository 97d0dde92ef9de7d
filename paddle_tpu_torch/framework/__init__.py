from paddle_tpu_torch.framework.dtype import to_torch_dtype
from paddle_tpu_torch.framework.place import resolve_device
from paddle_tpu_torch.framework.random import seed

__all__ = ["to_torch_dtype", "resolve_device", "seed"]
