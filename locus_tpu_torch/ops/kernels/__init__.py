"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Sources live in `locus_tpu_torch/csrc/`; `build.py` compiles
them at first use.

Each wrapper counts its launches (`nn.launches`, `moments.launches`, ...):
`reset_launches` sets every counter of this process to 0 and
`read_launches` reads them by the row names of chip_smoke.py's `kernels`
line; a tool or the smoke script resets them just before the run it
measures and reads them just after. A replay of a captured step
(`ops.graph.CapturedStep`) runs no wrapper: `read_launches` adds its
launches, as counted at capture, to the counters first."""


def _modules():
    from locus_tpu_torch.ops.kernels import eigh as teigh, gicp as tgicp, moments as tmom, nn as tnn

    return tmom, tnn, tgicp, teigh


def reset_launches() -> None:
    """Set every kernel launch counter of this process to 0, those of the
    captured steps' replays too."""
    from locus_tpu_torch.ops import graph

    tmom, tnn, tgicp, teigh = _modules()
    graph.drop_launches()
    for counts in (tnn.launches, tnn.batched_launches):
        counts.update({bt: 0 for bt in counts})
    tnn.other_launches.clear()
    tmom.launches = tmom.batched_launches = tmom.dense_launches = tmom.dense_batched_launches = 0
    tgicp.trip_launches = tgicp.plain_trips = 0
    teigh.launches = 0


def raw_launches() -> dict:
    """The wrappers' counters by row name, without the captured steps'
    replays; B2/B3 at another chunk size than the pipeline's two (a
    sweep's) as `nn_visits[_batched]_bt<size>`; B7's trips as
    `gicp_trip` and the CUDA trips that ran its plain version as
    `gicp_plain_trips`; B8 as `eigh6`."""
    tmom, tnn, tgicp, teigh = _modules()
    return {
        "moments_visits": tmom.launches,
        "nn_visits_scan": tnn.launches[tnn.SCAN_BT],
        "nn_visits_map": tnn.launches[tnn.BT],
        "nn_visits_batched_scan": tnn.batched_launches[tnn.SCAN_BT],
        "nn_visits_batched_map": tnn.batched_launches[tnn.BT],
        "moments_visits_batched": tmom.batched_launches,
        "moments_dense": tmom.dense_launches,
        "moments_dense_batched": tmom.dense_batched_launches,
        "gicp_trip": tgicp.trip_launches,
        "gicp_plain_trips": tgicp.plain_trips,
        "eigh6": teigh.launches,
    } | {f"nn_visits{'_batched' if batched else ''}_bt{bt}": n for (batched, bt), n in tnn.other_launches.items()}


def add_launches(rows: dict) -> None:
    """Add launches by row name to the wrappers' counters."""
    tmom, tnn, tgicp, teigh = _modules()
    fields = {"moments_visits": (tmom, "launches"), "moments_visits_batched": (tmom, "batched_launches"),
              "moments_dense": (tmom, "dense_launches"), "moments_dense_batched": (tmom, "dense_batched_launches"),
              "gicp_trip": (tgicp, "trip_launches"), "gicp_plain_trips": (tgicp, "plain_trips"),
              "eigh6": (teigh, "launches")}
    for name, n in rows.items():
        if name in fields:
            module, field = fields[name]
            setattr(module, field, getattr(module, field) + n)
            continue
        counts = tnn.batched_launches if name.startswith("nn_visits_batched") else tnn.launches
        if name.endswith("_scan") or name.endswith("_map"):
            bt = tnn.SCAN_BT if name.endswith("_scan") else tnn.BT
            counts[bt] += n
        else:
            key = (name.startswith("nn_visits_batched"), int(name.rsplit("_bt", 1)[1]))
            tnn.other_launches[key] = tnn.other_launches.get(key, 0) + n


def save_launches():
    """A copy of every counter, for `restore_launches`."""
    tmom, tnn, tgicp, teigh = _modules()
    return (dict(tnn.launches), dict(tnn.batched_launches), dict(tnn.other_launches),
            (tmom.launches, tmom.batched_launches, tmom.dense_launches, tmom.dense_batched_launches),
            (tgicp.trip_launches, tgicp.plain_trips), teigh.launches)


def restore_launches(saved) -> None:
    """Set every counter back to a `save_launches` copy."""
    tmom, tnn, tgicp, teigh = _modules()
    for counts, old in zip((tnn.launches, tnn.batched_launches, tnn.other_launches), saved[:3]):
        counts.clear()
        counts.update(old)
    tmom.launches, tmom.batched_launches, tmom.dense_launches, tmom.dense_batched_launches = saved[3]
    tgicp.trip_launches, tgicp.plain_trips = saved[4]
    teigh.launches = saved[5]


def read_launches() -> dict:
    """The counters by row name (`raw_launches`), after adding the
    launches of the captured steps' replays since the last read (one host
    read per captured step that replayed)."""
    from locus_tpu_torch.ops import graph

    add_launches(graph.fold_launches())
    return raw_launches()
