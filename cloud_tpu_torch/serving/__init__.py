"""Continuous-batching decode over a paged KV-cache pool (PyTorch port).

- `PagePool` — host-side physical page accounting (kvpool.py)
- `DecodeEngine` — slot-indexed tick/insert/evict (engine.py)
- `Scheduler`/`ServeRequest`/`ServeResult` — threads, admission,
  backpressure (scheduler.py)
"""

from cloud_tpu_torch.serving.engine import DecodeEngine, PrefillResult
from cloud_tpu_torch.serving.kvpool import PagePool
from cloud_tpu_torch.serving.scheduler import (Scheduler, ServeRequest,
                                               ServeResult)

__all__ = ["DecodeEngine", "PagePool", "PrefillResult", "Scheduler",
           "ServeRequest", "ServeResult"]
