"""PCD file I/O (ASCII and binary): a numpy-only copy of
`locus_tpu/io/pcd.py`, so the port reads PCDs without JAX.

Used for ground-truth-map bootstrap (the reference's
b_run_with_gt_point_cloud / InitWithGTPointCloud, Locus.cc:745-758,
pcl::io::loadPCDFile) and map snapshots (pointcloud_to_pcd on
locus/octree_map, tmuxp run_locus.yaml:93).

Supports the field sets LOCUS uses: xyz, xyzi, xyzinormal.
"""
from __future__ import annotations

import numpy as np

_DTYPE = {("F", 4): np.float32, ("F", 8): np.float64,
          ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
          ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32}


def read_pcd(path: str):
    """Returns dict field->np.ndarray (N,) plus '_fields' order."""
    with open(path, "rb") as f:
        header = {}
        fields = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "FIELDS":
                fields = val.split()
            if key == "DATA":
                data_mode = val
                break
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])

        dtype = np.dtype(
            [
                (name, _DTYPE[(t, s)], (c,)) if c > 1 else (name, _DTYPE[(t, s)])
                for name, t, s, c in zip(fields, types, sizes, counts)
            ]
        )
        if data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = np.atleast_2d(raw)
            out = {}
            col = 0
            for name, c in zip(fields, counts):
                out[name] = raw[:, col] if c == 1 else raw[:, col : col + c]
                col += c
        elif data_mode == "binary":
            buf = f.read(dtype.itemsize * n)
            arr = np.frombuffer(buf, dtype=dtype, count=n)
            out = {name: np.array(arr[name]) for name in fields}
        else:
            raise ValueError(f"unsupported PCD DATA mode {data_mode!r}")
    out["_fields"] = fields
    return out


def read_pcd_xyz_normals(path: str):
    """Returns (xyz (N,3) f32, normals (N,3) f32 or None)."""
    d = read_pcd(path)
    xyz = np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)
    if all(k in d for k in ("normal_x", "normal_y", "normal_z")):
        nrm = np.stack([d["normal_x"], d["normal_y"], d["normal_z"]], axis=1).astype(np.float32)
    else:
        nrm = None
    return xyz, nrm


def write_pcd(path: str, xyz: np.ndarray, normals: np.ndarray | None = None,
              intensity: np.ndarray | None = None, binary: bool = True):
    """Write points (+ optional normals/intensity) as PointXYZINormal-
    compatible PCD."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    fields = ["x", "y", "z"]
    cols = [xyz[:, 0], xyz[:, 1], xyz[:, 2]]
    if intensity is not None:
        fields.append("intensity")
        cols.append(np.asarray(intensity, np.float32))
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        fields += ["normal_x", "normal_y", "normal_z"]
        cols += [normals[:, 0], normals[:, 1], normals[:, 2]]
    k = len(fields)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * k)}\n"
        f"TYPE {' '.join(['F'] * k)}\n"
        f"COUNT {' '.join(['1'] * k)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        data = np.stack(cols, axis=1).astype(np.float32)
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")
