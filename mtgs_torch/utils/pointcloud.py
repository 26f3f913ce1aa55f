"""Point-cloud IO and filtering; port of `mtgs_tpu/utils/pointcloud.py`
(numpy and scipy, as there: it replaces open3d and the reference's PCD
parser `mtgs/utils/nuplan_pointcloud.py` in OpenDriveLab/MTGS).

Supports ASCII and binary (uncompressed) PCD v0.7, plus .npy/.npz with
'xyz'/'rgb' arrays. `statistical_outlier_removal` and `voxel_downsample`
mirror the open3d calls at `mtgs/dataset/nuplan_dataparser.py:471-494`;
`voxel_downsample_tensor` is the voxel average on tensors, on their device
(the data factory's point-cloud stacking runs it on the card).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch


def _parse_pcd_header(data: bytes):
    lines = []
    pos = 0
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl].decode("ascii", "ignore").strip()
        pos = nl + 1
        lines.append(line)
        if line.startswith("DATA"):
            break
    header = {}
    for line in lines:
        if not line or line.startswith("#"):
            continue
        k, *v = line.split()
        header[k] = v
    return header, pos


_PCD_DTYPES = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1", ("U", 2): "u2",
               ("U", 4): "u4", ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4"}


def load_pcd(path: str | Path) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Load a point cloud -> (xyz [n,3] | None, rgb [n,3] 0..255 | None)."""
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(path)
        return arr[:, :3].astype(np.float32), (
            arr[:, 3:6].astype(np.float32) if arr.shape[1] >= 6 else None
        )
    if path.suffix == ".npz":
        z = np.load(path)
        return z["xyz"].astype(np.float32), (
            z["rgb"].astype(np.float32) if "rgb" in z else None
        )

    data = path.read_bytes()
    header, offset = _parse_pcd_header(data)
    fields = header["FIELDS"]
    sizes = [int(s) for s in header["SIZE"]]
    types = header["TYPE"]
    counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
    n = int(header["POINTS"][0])
    fmt = header["DATA"][0]

    dtype = np.dtype([
        (f if c == 1 else f, f"{_PCD_DTYPES[(t, s)]}" if c == 1 else (f"{_PCD_DTYPES[(t, s)]}", (c,)))
        for f, s, t, c in zip(fields, sizes, types, counts)
    ])
    if fmt == "ascii":
        body = np.loadtxt(
            data[offset:].decode("ascii", "ignore").splitlines(), dtype=np.float64
        ).reshape(n, -1)
        cols = {f: body[:, i] for i, f in enumerate(fields)}
    elif fmt == "binary":
        rec = np.frombuffer(data, dtype=dtype, count=n, offset=offset)
        cols = {f: rec[f] for f in fields}
    else:
        raise ValueError(f"unsupported PCD DATA format: {fmt}")

    if not all(k in cols for k in ("x", "y", "z")):
        return None, None
    xyz = np.stack(
        [np.asarray(cols["x"], np.float32), np.asarray(cols["y"], np.float32),
         np.asarray(cols["z"], np.float32)], axis=-1)

    rgb = None
    if "rgb" in cols:
        packed = np.asarray(cols["rgb"])
        if packed.dtype.kind == "f":
            packed = packed.astype(np.float32).view(np.uint32)
        packed = packed.astype(np.uint32)
        rgb = np.stack(
            [(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF], -1
        ).astype(np.float32)
    elif all(k in cols for k in ("r", "g", "b")):
        rgb = np.stack([cols["r"], cols["g"], cols["b"]], -1).astype(np.float32)
    elif "intensity" in cols:
        i = np.asarray(cols["intensity"], np.float32)
        i = 255.0 * i / max(float(i.max()), 1e-6)
        rgb = np.stack([i, i, i], -1)
    return xyz, rgb


def save_pcd_npz(path: str | Path, xyz: np.ndarray, rgb: Optional[np.ndarray] = None):
    if rgb is None:
        np.savez_compressed(path, xyz=xyz)
    else:
        np.savez_compressed(path, xyz=xyz, rgb=rgb)


def statistical_outlier_removal(
    xyz: np.ndarray, k: int = 20, std_ratio: float = 2.0
) -> np.ndarray:
    """Boolean keep-mask (open3d remove_statistical_outlier equivalent)."""
    from scipy.spatial import cKDTree

    if len(xyz) <= k:
        return np.ones(len(xyz), bool)
    tree = cKDTree(xyz)
    d, _ = tree.query(xyz, k=k + 1, workers=-1)
    mean_d = d[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    return mean_d <= thresh


def voxel_downsample(
    xyz: np.ndarray, rgb: Optional[np.ndarray], voxel: float
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Average points per voxel (open3d voxel_down_sample equivalent)."""
    if len(xyz) == 0:
        return xyz, rgb
    keys = np.floor(xyz / voxel).astype(np.int64)
    # pack voxel coords into one int key
    kmin = keys.min(axis=0)
    keys = keys - kmin
    dims = keys.max(axis=0) + 1
    flat = (keys[:, 0] * dims[1] + keys[:, 1]) * dims[2] + keys[:, 2]
    uniq, inv = np.unique(flat, return_inverse=True)
    counts = np.bincount(inv)
    out_xyz = np.zeros((len(uniq), 3), np.float64)
    np.add.at(out_xyz, inv, xyz)
    out_xyz /= counts[:, None]
    out_rgb = None
    if rgb is not None:
        out_rgb = np.zeros((len(uniq), 3), np.float64)
        np.add.at(out_rgb, inv, rgb)
        out_rgb /= counts[:, None]
        out_rgb = out_rgb.astype(np.float32)
    return out_xyz.astype(np.float32), out_rgb


def voxel_downsample_tensor(
    xyz: torch.Tensor, rgb: Optional[torch.Tensor], voxel: float
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`voxel_downsample` on tensors, on their device: the same voxel keys
    (`floor(xyz / voxel)` in xyz's own dtype, as numpy 2 promotes a float32
    array by a Python float), the same float64 sums and means, and the rows
    in the order of the packed key, as `np.unique` sorts it. On a card the
    sums are atomic adds, so their order, and at most the last bit of a
    float32 output, may change from run to run."""
    if xyz.shape[0] == 0:
        return xyz, rgb
    # a divisor on the device: CUDA divides by a Python scalar as a product
    # with its reciprocal, which moves keys at voxel edges
    keys = torch.floor(xyz / torch.tensor(voxel, dtype=xyz.dtype, device=xyz.device))
    keys = keys.to(torch.int64)
    keys = keys - keys.min(dim=0).values
    dims = keys.max(dim=0).values + 1
    flat = (keys[:, 0] * dims[1] + keys[:, 1]) * dims[2] + keys[:, 2]
    uniq, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True)
    counts = counts.to(torch.float64)[:, None]

    def mean(values: torch.Tensor) -> torch.Tensor:
        sums = torch.zeros((len(uniq), values.shape[1]), dtype=torch.float64,
                           device=values.device)
        return sums.index_add_(0, inv, values.to(torch.float64)) / counts

    return mean(xyz).to(torch.float32), None if rgb is None else mean(rgb).to(torch.float32)
