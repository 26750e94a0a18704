"""The operations and bytes of the batched step's kernels B4 (`csrc/moments.cu`,
`locus_moments_visits_batched`: B1 with the member as `blockIdx.y`) and B3
(`csrc/nn.cu`, `locus_nn_visits_batched`: B2 likewise), by which their
shares of the roofline are computed over a traced run of the `fleet`
driver.

A launch serves every member of the tick, so its bound is that of its
members' valid inputs together, each counted exactly as `roofline` counts
B1's and B2's: B4 by max(the pairs' operations / the float32 peak, the
points' bytes / the HBM peak), B3 on the map by its bytes. The peaks and
the per-pair and per-point counts are `roofline`'s.
"""
from __future__ import annotations

from harness import roofline


def b4_bound_s(members: list) -> float:
    """One B4 launch over `members` (each {num_points, b4_pairs})."""
    return roofline.b1_bound_s(sum(m["num_points"] for m in members), sum(m["b4_pairs"] for m in members))


def b3_map_bound_s(members: list) -> float:
    """One B3 map launch: each member's valid queries against the map's
    points it held before the tick (each {num_points, map_before})."""
    return roofline.b2_bound_s(sum(m["num_points"] for m in members), sum(m["map_before"] for m in members))


def _ticks_of(rec: dict):
    """The traced ticks' (B4 launch, B3 launches, kernel inputs) when
    there is one B4 launch a tick (it opens the tick's preprocessing),
    else None."""
    rows = rec.get("kernel_inputs")
    b4 = [e for e in rec["device"] if "moments_visits_kernel" in e[0]]
    b3 = [e for e in rec["device"] if "nn_visits_kernel" in e[0]]
    if not rows or "members" not in rows[0] or len(b4) != len(rows):
        return None
    starts = [e[1] for e in b4] + [float("inf")]
    return [(b4[k], [e for e in b3 if starts[k] <= e[1] < starts[k + 1]], rows[k]) for k in range(len(rows))]


def b4_share(rec: dict):
    """B4's share of its roofline over the traced ticks, in %."""
    ticks = _ticks_of(rec)
    if not ticks:
        return None
    bound = sum(b4_bound_s(r["members"]) for _, _, r in ticks)
    spent = sum(e[2] - e[1] for e, _, _ in ticks)
    return 100.0 * bound / spent if spent > 0 else None


def b3_map_share(rec: dict):
    """B3's share of its roofline over the traced ticks' map 1-NN
    launches, in %. A tick's map launch follows the scan-to-scan loop's
    trips (its slowest member's count) and, where that loop ran to its
    cap, maybe a re-lookup; a tick whose B3 launches cannot be told apart
    that way is left out."""
    ticks = _ticks_of(rec)
    if not ticks:
        return None
    bound = spent = 0.0
    for _, b3, r in ticks:
        o, l = r["odom_loops"], r["loc_loops"]
        extra = len(b3) - (o + 1 + l)
        if o >= r["odom_cap"] or extra < 0 or extra > int(l >= r["loc_cap"]):
            continue
        e = b3[o]
        bound += b3_map_bound_s(r["members"])
        spent += e[2] - e[1]
    return 100.0 * bound / spent if spent > 0 else None
