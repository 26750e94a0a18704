"""Kernel B1's (`csrc/moments.cu`, the radius moments of the normals)
share of its roofline over the traced sweeps, in %: the bound of each
launch's inputs (harness.roofline.b1_bound_s) over its kernel time."""
from harness import roofline


def read(rec, ctx):
    return roofline.b1_share(rec)
