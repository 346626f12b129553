"""Span hooks of the serving loop. The port has no span tracer yet, so
`complete` records nothing; the call sites stay where
`cloud_tpu/monitoring/spans.py` has them."""


def complete(name, start_ns, dur_ns):
    """Records one finished span (a no-op until a tracer is ported)."""
    del name, start_ns, dur_ns


__all__ = ["complete"]
