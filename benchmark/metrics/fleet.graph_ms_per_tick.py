"""Device milliseconds a tick in the batched step's captured graph: tail -
head of each replay's stamps, averaged over the replays before the
profiler (harness.batched_records)."""
from harness import batched_records, replays


def read(rec, ctx):
    return batched_records.mean_ms(replays.graph_ms, ctx)
