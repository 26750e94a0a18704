#!/usr/bin/env python3
"""Pose agreement of the PyTorch port with the JAX package, on the CPU.

`--config` picks the path (chip_smoke.path_config): gicp (the default
configuration), ndt (NDT in both stages), features (LOAM features with
adaptive covariances) or voxel_hash (the voxel-hash map). `--tunnel`
picks the replay:

- small (default): the 12-scan tunnel of tests/test_torch_pipeline.py
  (make_tunnel_sequence(num_scans=12, azimuth_steps=256, step=0.3,
  seed=1) under tests.test_pipeline.small_cfg with the odometry prior;
  features at 256 columns, the sweep's azimuth steps);
- production: chip_smoke.py's protocol, its production config and the
  48-scan make_tunnel_sequence(azimuth_steps=1800, step=0.35, seed=0)
  (`--scans` to cut it);
- eval: the production config on the 48-scan world tunnel of
  tools/eval_suite.py (make_world_sequence("tunnel", azimuth_steps=900),
  the protocol of EVAL_NDT_r05.json), where chip_smoke.py runs NDT.

It replays the tunnel through the JAX package's XLA path and the port's
plain PyTorch path, and prints one JSON line: the per-scan translation
differences, the largest rotation difference, and each side's ATE
(unaligned, against ground truth). With the gicp config on the small
tunnel it adds, as before, JAX's Pallas path (interpret mode) and the
golden sequence through the port.

    JAX_PLATFORMS=cpu python tools/torch_parity.py [--config ndt] [--tunnel production]
"""
import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("gicp", "ndt", "features", "voxel_hash"), default="gicp")
    ap.add_argument("--tunnel", choices=("small", "production", "eval"), default="small")
    ap.add_argument("--scans", type=int, default=None, help="replay only the first N scans")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()

    import numpy as np
    import torch

    from chip_smoke import SCANS, path_config, production_config
    from locus_tpu import config as jcfg_mod
    from locus_tpu.config import FusionConfig
    from locus_tpu.io.dataset import Sequence, make_tunnel_sequence, make_world_sequence
    from locus_tpu.metrics import ate_rmse
    from locus_tpu.ops.dispatch import force_pallas
    from locus_tpu.runner import run_sequence as jax_run
    from locus_tpu_torch.convert import config_from_dict
    from locus_tpu_torch.io.dataset import Sequence as TSequence
    from locus_tpu_torch.runner import run_sequence as port_run
    from tests.test_pipeline import small_cfg

    torch.set_num_threads(args.threads)

    def port_seq(seq):
        return TSequence(**{f.name: getattr(seq, f.name) for f in dataclasses.fields(TSequence)})

    if args.tunnel == "small":
        cfg = path_config(small_cfg(fusion=FusionConfig(data_integration_mode=3)), args.config)
        if args.config == "features":
            cfg = cfg.replace(filtering=dataclasses.replace(cfg.filtering, feature_width=256))
        seq = make_tunnel_sequence(num_scans=12, azimuth_steps=256, step=0.3, seed=1)
    elif args.tunnel == "production":
        cfg = path_config(production_config(jcfg_mod), args.config)
        seq = make_tunnel_sequence(num_scans=SCANS, azimuth_steps=1800, step=0.35, seed=0)
    else:
        cfg = path_config(production_config(jcfg_mod), args.config)
        if args.config == "features":
            cfg = cfg.replace(filtering=dataclasses.replace(cfg.filtering, feature_width=900))
        seq = make_world_sequence("tunnel", num_scans=SCANS, azimuth_steps=900)
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    xla, _, _ = jax_run(seq, cfg, max_scans=args.scans)
    port, _, _ = port_run(port_seq(seq), tcfg, max_scans=args.scans, device="cpu")
    n = xla.shape[0]

    def diff(a, b):
        return np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1).tolist()

    def ate(p):
        return ate_rmse(p[:, :3, 3], seq.gt_poses[:n, :3, 3], align=False)

    out = {
        "config": args.config, "tunnel": args.tunnel, "scans": n,
        "port_vs_jax_xla_m": diff(port, xla),
        "port_vs_jax_xla_max_rotation_entry": float(np.abs(port[:, :3, :3] - xla[:, :3, :3]).max()),
        "ate_jax_xla_m": ate(xla), "ate_port_m": ate(port),
    }
    if args.config == "gicp" and args.tunnel == "small":
        with force_pallas():
            pallas, _, _ = jax_run(seq, cfg)
        golden_seq = Sequence.load(str(ROOT / "tests" / "data" / "golden_seq.npz"))
        golden = np.load(ROOT / "tests" / "data" / "golden_poses.npy")
        gport, _, _ = port_run(port_seq(golden_seq), tcfg, device="cpu")
        out |= {
            "tunnel_jax_xla_vs_jax_pallas_m": diff(xla, pallas),
            "tunnel_port_vs_jax_pallas_m": diff(port, pallas),
            "golden_port_max_m": float(np.linalg.norm(gport[:, :3, 3] - golden[:, :3, 3], axis=1).max()),
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
