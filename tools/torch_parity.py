#!/usr/bin/env python3
"""Pose agreement of the PyTorch port with the JAX package, on the CPU.

Replays the 12-scan tunnel of tests/test_torch_pipeline.py
(make_tunnel_sequence(num_scans=12, azimuth_steps=256, step=0.3, seed=1)
under tests.test_pipeline.small_cfg with the odometry prior) through:
the JAX package's XLA path, its Pallas path (interpret mode), and the
port's plain PyTorch path; and the golden sequence through the port. It
prints one JSON line: the per-scan translation differences between each
pair, and the port's largest distance from tests/data/golden_poses.npy.

    JAX_PLATFORMS=cpu python tools/torch_parity.py
"""
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> int:
    import numpy as np
    import torch

    from locus_tpu.config import FusionConfig
    from locus_tpu.io.dataset import Sequence, make_tunnel_sequence
    from locus_tpu.ops.dispatch import force_pallas
    from locus_tpu.runner import run_sequence as jax_run
    from locus_tpu_torch.convert import config_from_dict
    from locus_tpu_torch.io.dataset import Sequence as TSequence
    from locus_tpu_torch.runner import run_sequence as port_run
    from tests.test_pipeline import small_cfg

    torch.set_num_threads(4)

    def port_seq(seq):
        return TSequence(**{f.name: getattr(seq, f.name) for f in dataclasses.fields(TSequence)})

    cfg = small_cfg(fusion=FusionConfig(data_integration_mode=3))
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    seq = make_tunnel_sequence(num_scans=12, azimuth_steps=256, step=0.3, seed=1)
    xla, _, _ = jax_run(seq, cfg)
    with force_pallas():
        pallas, _, _ = jax_run(seq, cfg)
    port, _, _ = port_run(port_seq(seq), tcfg, device="cpu")

    def diff(a, b):
        return np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1).tolist()

    golden_seq = Sequence.load(str(ROOT / "tests" / "data" / "golden_seq.npz"))
    golden = np.load(ROOT / "tests" / "data" / "golden_poses.npy")
    gport, _, _ = port_run(port_seq(golden_seq), tcfg, device="cpu")
    print(json.dumps({
        "tunnel_jax_xla_vs_jax_pallas_m": diff(xla, pallas),
        "tunnel_port_vs_jax_xla_m": diff(port, xla),
        "tunnel_port_vs_jax_pallas_m": diff(port, pallas),
        "golden_port_max_m": float(np.linalg.norm(gport[:, :3, 3] - golden[:, :3, 3], axis=1).max()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
