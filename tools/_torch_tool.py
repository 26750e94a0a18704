"""What the port's command-line tools share: the device that --device
names, the card's name and power limit for their JSON, and bench.py's
production config and its fallback. Imports neither JAX nor the JAX
package."""
import json
import subprocess
import sys
from pathlib import Path

import _pathsetup  # noqa: F401

TOOLS = Path(__file__).resolve().parent


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; without a card the tool fails unless --device cpu)")


def device(arg):
    """The torch device of --device: None is the CUDA device, and with no
    card `ops.dispatch.resolve_device` raises (a tool never falls back to
    the CPU by itself)."""
    from locus_tpu_torch.ops.dispatch import resolve_device

    return resolve_device(arg)


def device_record(dev) -> dict:
    """{"device", "power_limit_w"} of `dev`: on a card, nvidia-smi's name
    and power limit (W); on the CPU "cpu" and None."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in line.rsplit(",", 1))
    return {"device": name, "power_limit_w": float(power.split()[0])}


def sync(torch, dev) -> None:
    """Wait for the card's queue (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def production_config(map_capacity: int = 1 << 17, scan_capacity: int = 4096):
    """bench.py:38-48 (`config.production_config`): 4096-point scans,
    32768-point raw sweeps, 3000 points a callback, normals_k 20, a
    131072-slot map of 0.15 m leaf; the two capacities may be set."""
    import dataclasses

    from locus_tpu_torch.config import production_config as production

    cfg = production()
    return cfg.replace(scan_capacity=scan_capacity,
                       mapper=dataclasses.replace(cfg.mapper, map_capacity=map_capacity))


def fallback_config():
    """bench.py:49-59's CI fallback: 1024-point scans, 8192-point raw
    sweeps, a 16384-slot map."""
    from locus_tpu_torch.config import FilterConfig, LocusConfig, MapperConfig

    return LocusConfig(
        scan_capacity=1024, raw_scan_capacity=8192, points_to_process_in_callback=800,
        filtering=FilterConfig(normals_k=12),
        mapper=MapperConfig(map_capacity=1 << 14, keyframe_capacity=1024, map_voxel_leaf=0.15),
    )


def write_json(path, record) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(record, f, indent=1)


def reset_launches() -> None:
    """Set the kernels' launch counters of this process to 0 (chip_smoke's
    `reset_launches`): a tool calls it just before its main run, and
    `launch_counts` just after."""
    import chip_smoke
    from locus_tpu_torch.ops.kernels import moments as tmom, nn as tnn

    chip_smoke.reset_launches(tnn, tmom)


def launch_counts() -> dict:
    """The kernels' launch counters of this process, by chip_smoke.py's row
    names (chip_smoke's `read_launches`)."""
    import chip_smoke
    from locus_tpu_torch.ops.kernels import moments as tmom, nn as tnn

    return chip_smoke.read_launches(tnn, tmom)


def launch_ranks(args: list, world: int, workdir, timeout_s: float) -> dict:
    """tools/torch_dist_smoke.py with `args` as `world` local ranks
    (parallel.distributed.spawn_ranks, a deadline for all of them): rank
    0's record, every rank's under "ranks". A rank that fails raises."""
    from locus_tpu_torch.parallel.distributed import spawn_ranks

    cmd = [sys.executable, str(TOOLS / "torch_dist_smoke.py"), *map(str, args), "--timeout", str(timeout_s)]
    results = spawn_ranks(cmd, world, workdir, timeout_s)
    failed = [f"rank {r} exited {rc}: {err[-2000:]}" for r, (rc, _, err) in enumerate(results) if rc != 0]
    if failed:
        raise RuntimeError(f"{world} ranks: " + "; ".join(failed))
    return json.loads(results[0][1].strip().splitlines()[-1])


def rank_config(profile: str, map_capacity=None, mode: str = "pipeline"):
    """The config tools/torch_dist_smoke.py's ranks run for `profile`."""
    import argparse

    if str(TOOLS) not in sys.path:
        sys.path.append(str(TOOLS))
    import torch_dist_smoke

    return torch_dist_smoke.config(argparse.Namespace(profile=profile, structure=None, map_capacity=map_capacity,
                                                      msw_box=None, mode=mode))
