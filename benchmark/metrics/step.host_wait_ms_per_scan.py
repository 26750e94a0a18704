"""The part of the gap between two replays before the host began the next
call, in milliseconds: clamp(next call's start on the device's clock -
tail, 0, gap), averaged over the pairs of consecutive replays before the
profiler (harness.replays): the device's idle time that the host's pace
causes."""
from harness import replays


def read(rec, ctx):
    return replays.mean_ms(replays.host_wait_ms, ctx)
