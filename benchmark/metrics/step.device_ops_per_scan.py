"""Kernels, copies and sets on the device a sweep over the traced window
of a replay (a count: the same seed gives the same number)."""


def read(rec, ctx):
    return len(rec["device"]) / rec["sweeps"] if rec["device"] else None
