"""Kernel B3's (`csrc/nn.cu`, batched) share of its roofline on its map
1-NN launches over the traced ticks, in %: the bytes of every member's
valid queries and map points (harness.roofline_batched.b3_map_bound_s)
over its kernel time."""
from harness import roofline_batched


def read(rec, ctx):
    return roofline_batched.b3_map_share(rec)
