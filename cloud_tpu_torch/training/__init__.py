"""Training of the PyTorch port: `Trainer` (fit / evaluate / predict),
the array input pipeline, the learning-rate schedules, callbacks,
checkpoints, the async metric reader and the resilient fit."""

from cloud_tpu_torch.training import (async_logs, callbacks, checkpoint,
                                      data, resilience, schedules)
from cloud_tpu_torch.training.async_logs import (AsyncMetricReader,
                                                 LazyLogs, MetricFuture)
from cloud_tpu_torch.training.callbacks import (Callback, EarlyStopping,
                                                LambdaCallback,
                                                MetricsLogger,
                                                ModelCheckpoint,
                                                PreemptionCheckpoint,
                                                TensorBoard, TerminateOnNaN,
                                                read_metrics_log)
from cloud_tpu_torch.training.data import ArrayDataset, as_dataset
from cloud_tpu_torch.training.resilience import (AutoCheckpoint,
                                                 resilient_fit)
from cloud_tpu_torch.training.trainer import (LOSSES, METRICS, OPTIMIZERS,
                                              Trainer, make_optimizer)

__all__ = ["ArrayDataset", "AsyncMetricReader", "AutoCheckpoint",
           "Callback", "EarlyStopping", "LOSSES", "LambdaCallback",
           "LazyLogs", "METRICS", "MetricFuture", "MetricsLogger",
           "ModelCheckpoint", "OPTIMIZERS", "PreemptionCheckpoint",
           "TensorBoard", "TerminateOnNaN", "Trainer", "as_dataset",
           "async_logs", "callbacks", "checkpoint", "data",
           "make_optimizer", "read_metrics_log", "resilience",
           "resilient_fit", "schedules"]
