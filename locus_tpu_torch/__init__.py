"""locus_tpu_torch — the locus_tpu lidar odometry and mapping pipeline in
PyTorch, with its search kernels written in CUDA for NVIDIA Hopper.

Module paths mirror `locus_tpu/` so that each function's counterpart is
easy to find. The JAX package is the reference; this package imports
nothing of it and never imports JAX. Entry points run on the CUDA device
unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry pipelines need true f32 products: TF32 keeps ~3 decimal digits
# and costs centimetres at 100 m scene scale (the JAX package forces
# highest matmul precision for the same reason, locus_tpu/__init__.py).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from locus_tpu_torch.config import LocusConfig  # noqa: E402,F401
from locus_tpu_torch.core.cloud import PointCloud  # noqa: E402,F401
