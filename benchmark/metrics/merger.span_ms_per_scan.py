"""Host milliseconds a sweep in the merger's calls (`observe` of every
lidar, `health`, `merge`), from the program's own `merger.*` spans: their
sum between two calls of the captured step, averaged over the sweeps
before the profiler (harness.replays)."""
from harness import replays


def read(rec, ctx):
    timer = replays.program_timer()
    if timer is None:
        return None
    return replays.mean_ms(lambda r: replays.merger_ms(r, timer), ctx)
