"""locus_tpu_torch quickstart: replay a synthetic tunnel run through the
PyTorch port and evaluate its ATE.

  python examples/torch_quickstart.py [--device cpu] [--scans N]

Runs on the CUDA device unless --device cpu.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
ap.add_argument("--scans", type=int, default=40)
args = ap.parse_args()

from locus_tpu_torch.config import LocusConfig
from locus_tpu_torch.io.dataset import make_world_sequence
from locus_tpu_torch.metrics import ate_rmse
from locus_tpu_torch.runner import run_sequence

# 1. data: synthetic VLP-16 drive (swap in tools/torch_convert_bag.py
#    output + Sequence.load for real rosbag data)
seq = make_world_sequence("tunnel", num_scans=args.scans, azimuth_steps=900)

# 2. configure (defaults mirror LOCUS's production YAML; see configs/)
cfg = LocusConfig()

# 3. replay through the pipeline, on the card unless --device cpu
poses, outputs, report = run_sequence(seq, cfg, return_state=False, device=args.device)

print("rate:", report.summary().get("rate_hz"), "Hz")
print("ATE:", ate_rmse(poses[:, :3, 3], seq.gt_poses[: args.scans, :3, 3], align=False), "m")
print("keyframes:", sum(o["keyframe_inserted"] for o in outputs))
print("map points:", outputs[-1]["map_size"])
