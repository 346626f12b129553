"""The latency histogram the serving scheduler keeps (TTFT, tick
latency, queue wait): the `Histogram` of
`cloud_tpu/monitoring/telemetry.py`, copied."""

import bisect
import threading


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


__all__ = ["Histogram"]
