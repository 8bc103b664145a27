from danerf_tpu_torch.train.metrics import MetricsLogger, psnr
from danerf_tpu_torch.train.trainer import (compute_loss_and_grads, loss_fn, make_optimizer,
                                            train, train_step)

__all__ = ["MetricsLogger", "psnr", "compute_loss_and_grads", "loss_fn", "make_optimizer",
           "train", "train_step"]
