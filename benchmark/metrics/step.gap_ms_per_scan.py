"""Device milliseconds between two replays of the captured step: the next
head - this tail, averaged over the pairs of consecutive replays before
the profiler (harness.replays): idle time, the input copies, the launch,
and the device work of the host between the calls (the merger's, on
husky)."""
from harness import replays


def read(rec, ctx):
    return replays.mean_ms(replays.gap_ms, ctx)
