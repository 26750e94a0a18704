"""Shared helpers of the `test_torch_*` files that compare the port with
the JAX package: moving data between the two as numpy arrays, and pose
differences. Importing it caps torch at 2 threads (the suite runs 6
workers)."""
import numpy as np
import torch

torch.set_num_threads(2)


def np_(x):
    """Any array-like (jax, torch, numpy) -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_torch(x, device="cpu"):
    return torch.from_numpy(np.array(np_(x), copy=True)).to(device)


def torch_cloud(jcloud, device="cpu"):
    """JAX PointCloud -> port PointCloud (same arrays)."""
    from locus_tpu_torch.core.cloud import PointCloud

    return PointCloud(*(to_torch(a, device) for a in (jcloud.xyz, jcloud.normals, jcloud.intensity, jcloud.mask)))


def pose_diff(Ta, Tb):
    """(translation L2, rotation angle) between two 4x4 transforms."""
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    d = np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])
    Rrel = Ta[:3, :3].T @ Tb[:3, :3]
    return d, np.arccos(np.clip((np.trace(Rrel) - 1) / 2, -1, 1))


def load_tool(name):
    """tools/<name>.py as a module (tools/ on sys.path, for its helpers)."""
    import importlib
    import sys
    from pathlib import Path

    tools = str(Path(__file__).resolve().parent.parent / "tools")
    if tools not in sys.path:
        sys.path.append(tools)
    return importlib.import_module(name)
