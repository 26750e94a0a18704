"""Host milliseconds a sweep in the merger's calls (`observe` of every
lidar, `health`, `merge`), from the harness's `benchmark.merger` span
around them."""
from harness import trace


def read(rec, ctx):
    s = trace.host_span_s(rec, "benchmark.merger")
    return s * 1e3 / rec["sweeps"] if s > 0 else None
