"""The table of peaks and the operations and bytes of the port's kernels,
by which a kernel's share of its roofline is computed.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
power limit): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s
of HBM3. A fused multiply-add counts as two operations. A launch's bound
time is max(ops / peak ops, bytes / peak bytes); a kernel's share of its
roofline is the sum of its launches' bound times over the sum of their
measured kernel times.

The operations and bytes count what a launch's inputs need, never what a
kernel's own culling visits, and only valid points, never capacity: each
input byte once, each output byte once.
"""
from __future__ import annotations

import torch

PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12

# B1, per neighbour pair inside the radius: the squared distance (3
# subtractions, 3 multiplies, 2 adds) and the raw moments (count, 3 sums,
# 6 products summed: 16). All at the float32 peak, though the program sums
# them in float64, so the bound is not overstated.
B1_OPS_PER_PAIR = 8 + 16
# B1 reads each point once (xyz, f32) and writes its 10 moments (4 B each,
# the least the output could take).
B1_IN_BYTES, B1_OUT_BYTES = 12, 40
# B2 reads each query and each target point once (xyz, f32) and writes a
# distance and an index (4 B each) per query.
B2_IN_BYTES, B2_OUT_BYTES = 12, 8


def radius_pairs(xyz: torch.Tensor, radius: float, block: int = 2048) -> int:
    """Ordered pairs (i, j), i == j included, of points within `radius`:
    what B1's inputs define, whatever the kernel prunes."""
    total = 0
    r2 = radius * radius
    for a in range(0, xyz.shape[0], block):
        d2 = ((xyz[a:a + block, None, :].double() - xyz[None, :, :].double()) ** 2).sum(-1)
        total += int((d2 <= r2).sum())
    return total


def b1_bound_s(num_points: int, pairs: int) -> float:
    """The larger of B1's operations and bytes over their peaks."""
    return max(pairs * B1_OPS_PER_PAIR / PEAK_FLOPS_F32, num_points * (B1_IN_BYTES + B1_OUT_BYTES) / PEAK_BYTES)


def b2_bound_s(num_queries: int, num_targets: int) -> float:
    """B2 is counted by its bytes alone: the comparisons its culling saves
    are no cost that its inputs impose."""
    return (num_queries * (B2_IN_BYTES + B2_OUT_BYTES) + num_targets * B2_IN_BYTES) / PEAK_BYTES


def _sweeps_of(rec: dict):
    """The traced sweeps' (B1 launch, B2 launches, kernel inputs) when
    there is one B1 launch a sweep (it opens the sweep's preprocessing),
    else None."""
    rows = rec.get("kernel_inputs")
    b1 = [e for e in rec["device"] if "moments_visits_kernel" in e[0]]
    b2 = [e for e in rec["device"] if "nn_visits_kernel" in e[0]]
    if not rows or len(b1) != len(rows):
        return None
    starts = [e[1] for e in b1] + [float("inf")]
    return [(b1[k], [e for e in b2 if starts[k] <= e[1] < starts[k + 1]], rows[k]) for k in range(len(rows))]


def b1_share(rec: dict):
    """B1's share of its roofline over the traced sweeps, in %."""
    sweeps = _sweeps_of(rec)
    if not sweeps:
        return None
    bound = sum(b1_bound_s(r["num_points"], r["b1_pairs"]) for _, _, r in sweeps)
    spent = sum(e[2] - e[1] for e, _, _ in sweeps)
    return 100.0 * bound / spent if spent > 0 else None


def b2_map_share(rec: dict):
    """B2's share of its roofline over the traced sweeps' map 1-NN
    launches, in %. A sweep's map launch follows its scan-to-scan trips
    and, where that loop stopped at its cap, a re-lookup; a sweep whose
    B2 launches cannot be told apart that way is left out."""
    sweeps = _sweeps_of(rec)
    if not sweeps:
        return None
    bound = spent = 0.0
    for _, b2, r in sweeps:
        o, l = r["odom_iterations"], r["loc_iterations"]
        extra = len(b2) - (o + 1 + l)
        if o >= r["odom_cap"] or extra < 0 or extra > int(l >= r["loc_cap"]):
            continue
        e = b2[o]
        bound += b2_bound_s(r["num_points"], r["map_before"])
        spent += e[2] - e[1]
    return 100.0 * bound / spent if spent > 0 else None
