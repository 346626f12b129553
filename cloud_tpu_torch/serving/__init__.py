"""Continuous-batching decode over a paged KV-cache pool (PyTorch port).

- `PagePool` — host-side physical page accounting (kvpool.py)
- `PrefixCache` — the radix index of shared prompt pages
  (prefixcache.py)
- `DecodeEngine` — slot-indexed tick/insert/evict, the tick and the
  prefills as CUDA graphs on a card (engine.py)
- `Scheduler`/`ServeRequest`/`ServeResult` — threads, admission,
  backpressure, prefix hits, chunked prefill (scheduler.py)
"""

from cloud_tpu_torch.serving.engine import (DecodeEngine, PrefillResult,
                                            RetraceError)
from cloud_tpu_torch.serving.kvpool import PagePool
from cloud_tpu_torch.serving.prefixcache import PrefixCache, PrefixMatch
from cloud_tpu_torch.serving.scheduler import (Scheduler, ServeRequest,
                                               ServeResult)

__all__ = ["DecodeEngine", "PagePool", "PrefillResult", "PrefixCache",
           "PrefixMatch", "RetraceError", "Scheduler", "ServeRequest",
           "ServeResult"]
