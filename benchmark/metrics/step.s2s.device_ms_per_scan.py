"""Device milliseconds a sweep in the step's `stage_s2s`: exit - entry of
the stage's stamps, captured into the step's graph, averaged over the
replays before the profiler (harness.replays)."""
from harness import replays


def read(rec, ctx):
    return replays.mean_ms(lambda r: replays.stage_ms(r, "stage_s2s"), ctx)
