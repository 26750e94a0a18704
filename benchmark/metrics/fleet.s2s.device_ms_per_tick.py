"""Device milliseconds a tick in the batched step's `stage_s2s` (the
scan-to-scan GICP of every robot): exit - entry of the stage's stamps,
averaged over the replays before the profiler (harness.batched_records)."""
from harness import batched_records, replays


def read(rec, ctx):
    return batched_records.mean_ms(lambda r: replays.stage_ms(r, "stage_s2s"), ctx)
