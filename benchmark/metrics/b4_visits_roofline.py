"""Kernel B4's (`csrc/moments.cu`, batched: the radius moments of every
robot's normals) share of its roofline over the traced ticks, in %: the
bound of its members' inputs together (harness.roofline_batched.b4_bound_s)
over its kernel time."""
from harness import roofline_batched


def read(rec, ctx):
    return roofline_batched.b4_share(rec)
