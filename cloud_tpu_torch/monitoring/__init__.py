"""Monitoring of the PyTorch port: the scheduler's histogram and span
hooks."""

from cloud_tpu_torch.monitoring import spans
from cloud_tpu_torch.monitoring.telemetry import Histogram

__all__ = ["Histogram", "spans"]
