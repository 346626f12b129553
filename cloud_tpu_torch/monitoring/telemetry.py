"""The latency histogram the serving scheduler keeps (TTFT, tick
latency, queue wait): the `Histogram` of
`cloud_tpu/monitoring/telemetry.py`, copied; and the part of its
telemetry session the port has so far, the per-token decode latency
that `generate()` feeds (`enable`, `disable`, `get`, `enabled`). The
registry, tracer, exporters and the environment contract are not
ported (ROADMAP: Modules to port, item 8).
"""

import bisect
import threading

#: The per-token decode latency histogram's name (the JAX package's).
DECODE_TOKEN_HISTOGRAM = "cloud_tpu_decode_token_latency_seconds"


class Histogram:
    """Exponential-bucket histogram with percentile readout.

    Bucket upper bounds are `start * factor**i` for i in [0, buckets);
    observations above the last bound land in the +Inf bucket. The
    defaults (1 µs .. ~72 min at factor 2) give percentiles with at
    most 2x relative bucket error.
    """

    __slots__ = ("name", "_mu", "bounds", "_counts", "_sum", "_count",
                 "_max")

    def __init__(self, name, start=1e-6, factor=2.0, buckets=32):
        self.name = name
        self._mu = threading.Lock()
        bounds = []
        bound = float(start)
        for _ in range(int(buckets)):
            bounds.append(bound)
            bound *= float(factor)
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # [+Inf overflow last]
        self._sum = 0.0
        self._count = 0
        self._max = 0.0

    def observe(self, value, count=1):
        """Records `count` observations of `value`."""
        value = float(value)
        idx = bisect.bisect_left(self.bounds, value)
        with self._mu:
            self._counts[idx] += count
            self._sum += value * count
            self._count += count
            if value > self._max:
                self._max = value

    @property
    def count(self):
        with self._mu:
            return self._count

    @property
    def sum(self):
        with self._mu:
            return self._sum

    def percentile(self, p):
        """Approximate p-th percentile (0-100) by linear interpolation
        inside the bucket holding that rank; 0.0 when empty. The +Inf
        bucket reports the largest observed value."""
        with self._mu:
            counts = list(self._counts)
            total = self._count
            largest = self._max
        if total <= 0:
            return 0.0
        rank = (p / 100.0) * total
        cumulative = 0
        for idx, bucket_count in enumerate(counts):
            previous = cumulative
            cumulative += bucket_count
            if cumulative >= rank and bucket_count:
                if idx >= len(self.bounds):
                    return largest
                upper = self.bounds[idx]
                lower = self.bounds[idx - 1] if idx else 0.0
                fraction = (rank - previous) / bucket_count
                return lower + (upper - lower) * min(fraction, 1.0)
        return largest

    def snapshot(self):
        with self._mu:
            counts = list(self._counts)
            total = self._count
            value_sum = self._sum
        return {
            "bounds": list(self.bounds),
            "counts": counts,
            "count": total,
            "sum": value_sum,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class Telemetry:
    """One enabled telemetry session: here, its decode-latency
    histogram."""

    def __init__(self):
        self.decode_token_latency = Histogram(DECODE_TOKEN_HISTOGRAM)
        self.active = True

    def observe_decode(self, n_tokens, elapsed_secs):
        """One observation per generated token at the call's mean
        per-token latency."""
        n_tokens = int(n_tokens)
        if n_tokens > 0:
            self.decode_token_latency.observe(
                float(elapsed_secs) / n_tokens, count=n_tokens)


_telemetry = None
_enable_lock = threading.Lock()


def enable():
    """Enables the ambient session (idempotent) and returns it."""
    global _telemetry
    with _enable_lock:
        if _telemetry is None:
            _telemetry = Telemetry()
        return _telemetry


def disable():
    """Ends the ambient session."""
    global _telemetry
    with _enable_lock:
        tele, _telemetry = _telemetry, None
    if tele is not None:
        tele.active = False


def get():
    """The ambient session, or None when disabled."""
    return _telemetry


def enabled():
    return _telemetry is not None and _telemetry.active


__all__ = ["DECODE_TOKEN_HISTOGRAM", "Histogram", "Telemetry", "disable",
           "enable", "enabled", "get"]
