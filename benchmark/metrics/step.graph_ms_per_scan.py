"""Device milliseconds a sweep in the captured step's graph: tail - head
of each replay's stamps, averaged over the replays before the profiler
(harness.replays)."""
from harness import replays


def read(rec, ctx):
    return replays.mean_ms(replays.graph_ms, ctx)
