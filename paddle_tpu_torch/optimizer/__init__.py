from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.optimizer.gradient_merge import GradientMergeOptimizer
from paddle_tpu_torch.optimizer.lbfgs import LBFGS
from paddle_tpu_torch.optimizer.optimizer import Optimizer
from paddle_tpu_torch.optimizer.optimizers import (ASGD, SGD, Adadelta,
                                                   Adagrad, Adam, Adamax,
                                                   AdamW, Lamb, Momentum,
                                                   NAdam, RAdam, RMSProp,
                                                   Rprop)

# the reference's __all__ but TrainGuard (ROADMAP.md A.12)
__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta", "Adam",
           "AdamW", "Adamax", "Lamb", "LBFGS", "RMSProp", "Rprop", "ASGD",
           "NAdam", "RAdam", "GradientMergeOptimizer", "lr"]
