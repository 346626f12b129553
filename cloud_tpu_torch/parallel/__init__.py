"""Device runtime of the PyTorch port (one device)."""

from cloud_tpu_torch.parallel import runtime
from cloud_tpu_torch.parallel.runtime import (default_device,
                                              device_fetch,
                                              resolve_device)

__all__ = ["default_device", "device_fetch", "resolve_device", "runtime"]
