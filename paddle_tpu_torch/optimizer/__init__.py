from paddle_tpu_torch.optimizer.optimizer import Optimizer
from paddle_tpu_torch.optimizer.optimizers import AdamW

__all__ = ["Optimizer", "AdamW"]
