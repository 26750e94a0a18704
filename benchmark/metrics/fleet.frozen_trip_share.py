"""The share of the batched GICP loops' member-trips spent on members that
had stopped, in %: 1 - (member-trips needed) / (member-trips run), both
stages, over the window's passes (harness.batched_records): the price of
lockstep."""
from harness import batched_records


def read(rec, ctx):
    return batched_records.frozen_trip_share(rec)
