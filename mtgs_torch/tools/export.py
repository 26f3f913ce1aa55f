"""Gaussian export: .ply (3DGS layout), .splat, coloured point cloud; port
of `mtgs_tpu/tools/export.py`.

The reference viewer's export panel (`mtgs/custom_viewer/export_panel.py` in
OpenDriveLab/MTGS) writes a trained scene in the formats standard 3DGS
viewers read. These functions export the *active* gaussians of one node,
and write the bytes the JAX package writes for the same state:

  - `.ply`: the canonical 3DGS binary layout (x y z nx ny nz f_dc_*
    f_rest_* opacity scale_* rot_*), raw parameter space (log scales,
    logit opacities) — what Inria/gsplat tooling reads.
  - `.splat`: antimatter15 web-viewer format, one 32-byte record per
    gaussian (pos f32x3, linear scale f32x3, RGBA u8x4, quat u8x4), sorted
    by volume x opacity descending; written as one structured array.
  - point-cloud `.ply`: xyz + u8 RGB from the SH DC term.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from mtgs_torch.models.gaussians import GaussianNodeParams, NodeAux

_SH_C0 = 0.28209479177387814


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _node_arrays(node: GaussianNodeParams, aux: NodeAux, travel_index: Optional[int]):
    """(means, scales [n, 3], quats, opacities [n], dc, rest [n, K-1, 3]) of
    the n = num_alive active rows; a traversal's adapter is added to dc and
    its rest selected when the node carries them per traversal."""
    n = int(aux.num_alive)
    means = _np(node.means[:n])
    scales = _np(node.scales[:n])
    if scales.shape[1] == 1:  # isotropic marbles: untie for the 3DGS layout
        scales = np.repeat(scales, 3, axis=1)
    quats = _np(node.quats[:n])
    opac = _np(node.opacities[:n, 0])
    dc = _np(node.features_dc[:n])
    if travel_index is not None and node.features_adapters.shape[1] > 0:
        dc = dc + _np(node.features_adapters[:n, travel_index])
    rest = node.features_rest
    if rest.ndim == 4:  # per-traversal rest: select the traversal
        rest = rest[:, travel_index if travel_index is not None else 0]
    return means, scales, quats, opac, dc, _np(rest[:n])


def export_ply(node: GaussianNodeParams, aux: NodeAux, path, *,
               travel_index: Optional[int] = None) -> Path:
    """Write the node's active gaussians as a 3DGS-layout binary PLY."""
    means, scales, quats, opac, dc, rest = _node_arrays(node, aux, travel_index)
    n, k1 = means.shape[0], rest.shape[1]
    # 3DGS stores f_rest channel-major: all K-1 red coeffs, then green, blue
    rest_cm = rest.transpose(0, 2, 1).reshape(n, 3 * k1)
    cols = [means, np.zeros((n, 3), np.float32), dc, rest_cm, opac[:, None], scales, quats]
    names = (["x", "y", "z", "nx", "ny", "nz"] + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(3 * k1)] + ["opacity"]
             + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])
    body = np.concatenate(cols, axis=1).astype("<f4")
    header = ("ply\nformat binary_little_endian 1.0\n" f"element vertex {n}\n"
              + "".join(f"property float {m}\n" for m in names) + "end_header\n")
    path = Path(path)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(body.tobytes())
    return path


SPLAT_RECORD = np.dtype([("pos", "<f4", 3), ("scale", "<f4", 3), ("rgba", "u1", 4),
                         ("rot", "u1", 4)])


def export_splat(node: GaussianNodeParams, aux: NodeAux, path, *,
                 travel_index: Optional[int] = None) -> Path:
    """Write the antimatter15 .splat format (web splat viewers)."""
    means, scales, quats, opac, dc, _ = _node_arrays(node, aux, travel_index)
    lin_scales = np.exp(scales)
    alpha = 1.0 / (1.0 + np.exp(-opac))
    order = np.argsort(-(lin_scales.prod(1) * alpha))
    rgb = np.clip(dc * _SH_C0 + 0.5, 0, 1)
    qn = quats / np.maximum(np.linalg.norm(quats, axis=1, keepdims=True), 1e-9)
    rec = np.empty(len(order), SPLAT_RECORD)
    rec["pos"] = means[order]
    rec["scale"] = lin_scales[order]
    rgba = np.concatenate([rgb, alpha[:, None]], axis=1)  # float32, as the JAX record's
    rec["rgba"] = np.clip(rgba[order] * 255, 0, 255).astype(np.uint8)
    rec["rot"] = np.clip(qn[order] * 128 + 128, 0, 255).astype(np.uint8)
    path = Path(path)
    path.write_bytes(rec.tobytes())
    return path


def export_point_cloud(node: GaussianNodeParams, aux: NodeAux, path, *,
                       travel_index: Optional[int] = None) -> Path:
    """Write active gaussian centres as an xyz+RGB binary PLY."""
    means, _, _, _, dc, _ = _node_arrays(node, aux, travel_index)
    n = means.shape[0]
    rgb = np.clip((dc * _SH_C0 + 0.5) * 255, 0, 255).astype(np.uint8)
    header = ("ply\nformat binary_little_endian 1.0\n" f"element vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "end_header\n")
    rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    rec["xyz"], rec["rgb"] = means.astype("<f4"), rgb
    path = Path(path)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
    return path


def read_gaussian_ply(path):
    """Read back a 3DGS-layout PLY -> dict of numpy arrays (means,
    features_dc, opacities, scales, quats and, with SH rest, features_rest)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a ply")
        names = []
        n = 0
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            line = line.strip()
            if line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            elif line.startswith(b"property float"):
                names.append(line.split()[-1].decode())
            elif line == b"end_header":
                break
        body = np.frombuffer(f.read(4 * n * len(names)), "<f4").reshape(n, len(names))
    cols = {m: body[:, i] for i, m in enumerate(names)}
    k1 = sum(1 for m in names if m.startswith("f_rest_")) // 3
    out = {
        "means": np.stack([cols["x"], cols["y"], cols["z"]], 1),
        "features_dc": np.stack([cols[f"f_dc_{i}"] for i in range(3)], 1),
        "opacities": cols["opacity"][:, None],
        "scales": np.stack([cols[f"scale_{i}"] for i in range(3)], 1),
        "quats": np.stack([cols[f"rot_{i}"] for i in range(4)], 1),
    }
    if k1:
        rest_cm = np.stack([cols[f"f_rest_{i}"] for i in range(3 * k1)], 1)
        out["features_rest"] = rest_cm.reshape(-1, 3, k1).transpose(0, 2, 1)
    return out
