"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Sources live in `locus_tpu_torch/csrc/`; `build.py` compiles
them at first use.

Each wrapper counts its launches (`nn.launches`, `moments.launches`, ...):
`reset_launches` sets every counter of this process to 0 and
`read_launches` reads them by the row names of chip_smoke.py's `kernels`
line; a tool or the smoke script resets them just before the run it
measures and reads them just after."""


def reset_launches() -> None:
    """Set every kernel launch counter of this process to 0."""
    from locus_tpu_torch.ops.kernels import moments as tmom, nn as tnn

    for counts in (tnn.launches, tnn.batched_launches):
        counts.update({bt: 0 for bt in counts})
    tnn.other_launches.clear()
    tmom.launches = tmom.batched_launches = tmom.dense_launches = tmom.dense_batched_launches = 0


def read_launches() -> dict:
    """The counters by row name; B2/B3 at another chunk size than the
    pipeline's two (a sweep's) as `nn_visits[_batched]_bt<size>`."""
    from locus_tpu_torch.ops.kernels import moments as tmom, nn as tnn

    return {
        "moments_visits": tmom.launches,
        "nn_visits_scan": tnn.launches[tnn.SCAN_BT],
        "nn_visits_map": tnn.launches[tnn.BT],
        "nn_visits_batched_scan": tnn.batched_launches[tnn.SCAN_BT],
        "nn_visits_batched_map": tnn.batched_launches[tnn.BT],
        "moments_visits_batched": tmom.batched_launches,
        "moments_dense": tmom.dense_launches,
        "moments_dense_batched": tmom.dense_batched_launches,
    } | {f"nn_visits{'_batched' if batched else ''}_bt{bt}": n for (batched, bt), n in tnn.other_launches.items()}
