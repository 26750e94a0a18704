"""Kernel B2's (`csrc/nn.cu`) share of its roofline on its map 1-NN
launches over the traced sweeps, in %: the bytes of each launch's valid
queries and map points (harness.roofline.b2_bound_s) over its kernel time."""
from harness import roofline


def read(rec, ctx):
    return roofline.b2_map_share(rec)
