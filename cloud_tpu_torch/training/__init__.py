"""Training of the PyTorch port: `Trainer` (fit / evaluate / predict),
the input pipeline (arrays, streams, wire casts, the device-resident
dataset, device read-ahead), the optimizers optax has and torch.optim
lacks, the learning-rate schedules, callbacks, checkpoints, the async
metric reader and the resilient fit."""

from cloud_tpu_torch.training import (async_logs, callbacks, checkpoint,
                                      data, optimizers, resilience,
                                      schedules)
from cloud_tpu_torch.training.async_logs import (AsyncMetricReader,
                                                 LazyLogs, MetricFuture)
from cloud_tpu_torch.training.callbacks import (Callback, EarlyStopping,
                                                LambdaCallback,
                                                MetricsLogger,
                                                ModelCheckpoint,
                                                PreemptionCheckpoint,
                                                TensorBoard, TerminateOnNaN,
                                                read_metrics_log)
from cloud_tpu_torch.training.data import (ArrayDataset,
                                           DeviceResidentDataset,
                                           GeneratorDataset, InputCast,
                                           NpzShardDataset, ThreadedDataset,
                                           as_dataset, make_input_cast,
                                           prefetch_to_device)
from cloud_tpu_torch.training.resilience import (AutoCheckpoint,
                                                 resilient_fit)
from cloud_tpu_torch.training.trainer import (LOSSES, METRICS, OPTIMIZERS,
                                              Trainer, make_optimizer)

__all__ = ["ArrayDataset", "AsyncMetricReader", "AutoCheckpoint",
           "Callback", "DeviceResidentDataset", "EarlyStopping",
           "GeneratorDataset", "InputCast", "LOSSES", "LambdaCallback",
           "LazyLogs", "METRICS", "MetricFuture", "MetricsLogger",
           "ModelCheckpoint", "NpzShardDataset", "OPTIMIZERS",
           "PreemptionCheckpoint", "TensorBoard", "TerminateOnNaN",
           "ThreadedDataset", "Trainer", "as_dataset", "async_logs",
           "callbacks", "checkpoint", "data", "make_input_cast",
           "make_optimizer", "optimizers", "prefetch_to_device",
           "read_metrics_log", "resilience", "resilient_fit",
           "schedules"]
