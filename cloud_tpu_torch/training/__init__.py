"""Training of the PyTorch port: `Trainer` (fit / evaluate / predict),
the array input pipeline and the learning-rate schedules."""

from cloud_tpu_torch.training import data, schedules
from cloud_tpu_torch.training.data import ArrayDataset, as_dataset
from cloud_tpu_torch.training.trainer import (LOSSES, METRICS, OPTIMIZERS,
                                              Trainer, make_optimizer)

__all__ = ["ArrayDataset", "LOSSES", "METRICS", "OPTIMIZERS", "Trainer",
           "as_dataset", "data", "make_optimizer", "schedules"]
