"""The device's busy time a sweep over the traced window of a replay: the
union of its kernels, copies and sets, so overlapping work counts once."""
from harness import trace


def read(rec, ctx):
    return trace.busy_s(rec) * 1e3 / rec["sweeps"] if rec["device"] else None
