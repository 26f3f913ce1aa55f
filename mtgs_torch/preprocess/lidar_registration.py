"""Multi-traversal LiDAR registration (stage 5 of the data factory); port
of `mtgs_tpu/preprocess/lidar_registration.py`.

Python driver over the native C++ odometry core (`csrc/icp_core.cc`, the
port's copy of `cpp/icp/icp_core.cc` — a from-scratch kiss-icp
equivalent), mirroring the reference pipeline
`nuplan_scripts/lidar_registration_multi_traversal.py` in
OpenDriveLab/MTGS:

  * feed ALL traversals' top-LiDAR scans in sequence through one odometry
    instance (ref `MTGSDataset`,
    `thirdparty/kiss-icp/python/kiss_icp/datasets/mtgs.py:18-118` —
    scans are pre-transformed into the first frame's reference);
  * rigidly align the ICP trajectory back to the original GPS/ego frame
    per traversal with an SVD/Umeyama fit (ref `align_poses`, :68-111);
  * compute per-traversal EPE/ATE/ARE error tables and EXCLUDE traversals
    with EPE > 1 m or ATE > 0.5 m (ref `calculate_errors`/gates,
    :26-66,204-222);
  * write refined `ego2global` back into the scene dict, preserving
    `ego2global_original` (ref :224-233).

The ICP runs on the host, as in the JAX package and the reference. The C++
library is compiled on first use by the host compiler (`$CXX`, else `c++`)
with the JAX package's flags into `build/mtgs_torch/` under a name hashing
the source, the flags and the host CPU (`data/image_io.py::build`);
nothing is written beside its source or under `cpp/icp/`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from mtgs_torch.data import image_io

SOURCE = image_io.CSRC / "icp_core.cc"
# the JAX package's flags (`mtgs_tpu/preprocess/lidar_registration.py:43-47`)
ICP_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _load_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(image_io.build(SOURCE, ICP_FLAGS)))
            lib.icp_create.restype = ctypes.c_void_p
            lib.icp_create.argtypes = [
                ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
                ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ]
            lib.icp_register.restype = None
            lib.icp_register.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.icp_destroy.restype = None
            lib.icp_destroy.argtypes = [ctypes.c_void_p]
            _LIB = lib
        return _LIB


class LidarOdometry:
    """ctypes wrapper over the C++ odometry core."""

    def __init__(
        self,
        voxel_size: float = 1.0,
        max_range: float = 100.0,
        min_range: float = 5.0,
        max_points_per_voxel: int = 20,
        initial_threshold: float = 2.0,
        min_motion_th: float = 0.1,
        deskew: bool = False,
    ):
        self._lib = _load_lib()
        self._h = self._lib.icp_create(
            voxel_size, max_range, min_range, max_points_per_voxel,
            initial_threshold, min_motion_th, int(deskew),
        )

    def register_scan(self, xyz: np.ndarray) -> np.ndarray:
        """[n, 3] float scan (sensor/reference frame) -> [4, 4] world pose."""
        pts = np.ascontiguousarray(xyz, np.float32)
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(f"register_scan takes [n, 3] points, got {pts.shape}")
        out = np.zeros(16, np.float64)
        self._lib.icp_register(
            self._h,
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(pts),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return out.reshape(4, 4)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.icp_destroy(self._h)
            self._h = None


def umeyama_rigid(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rigid SVD alignment dst ~ R src + t (ref `align_poses`, :68-111).

    Returns [4, 4] transform.
    """
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mu_d - R @ mu_s
    return T


def trajectory_errors(
    est: np.ndarray, ref: np.ndarray
) -> Dict[str, float]:
    """EPE / ATE / ARE between [n,4,4] pose arrays (ref :26-66)."""
    epe = float(np.linalg.norm(est[:, :3, 3] - ref[:, :3, 3], axis=1).mean())
    # ATE: after rigid alignment
    T = umeyama_rigid(est[:, :3, 3], ref[:, :3, 3])
    aligned = (T[:3, :3] @ est[:, :3, 3].T).T + T[:3, 3]
    ate = float(np.sqrt(((aligned - ref[:, :3, 3]) ** 2).sum(-1).mean()))
    # ARE: mean geodesic rotation distance
    R_rel = np.einsum("nij,nkj->nik", est[:, :3, :3], ref[:, :3, :3])
    tr = np.clip((np.trace(R_rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    are = float(np.degrees(np.arccos(tr)).mean())
    return dict(EPE=epe, ATE=ate, ARE=are)


def register_traversals(
    scans_per_traversal: Dict[int, List[np.ndarray]],
    ego_poses_per_traversal: Dict[int, np.ndarray],   # [F, 4, 4] GPS ego2global
    *,
    base_pose: Optional[np.ndarray] = None,
    voxel_size: float = 1.0,
    max_range: float = 100.0,
    epe_gate: float = 1.0,
    ate_gate: float = 0.5,
) -> Tuple[Dict[int, np.ndarray], Dict[int, Dict[str, float]], List[int]]:
    """Register all traversals' scans through ONE odometry/map instance.

    Convention (the reference's MTGSDataset one): each scan is fed
    pre-transformed into the shared reference frame — x_ref =
    inv(base) @ gps_pose(f) @ x_sensor — so the odometry estimates a
    small CORRECTION E(f) on top of GPS. The refined global pose is then
    base @ E(f) @ inv(base) @ gps(f), rigidly re-aligned to the GPS
    track (removing global drift of the merged frame) and gated on
    EPE/ATE (ref :26-66,204-233).

    Args:
        scans_per_traversal: travel_id -> list of [n, 3] sensor-frame scans.
        ego_poses_per_traversal: travel_id -> [F, 4, 4] original GPS poses.
        base_pose: shared reference pose (default: first traversal's
            first GPS pose).

    Returns:
        (refined ego2global per traversal, per-traversal error tables,
         list of travel_ids excluded by the EPE/ATE gates — those keep
         their GPS poses).
    """
    first = sorted(scans_per_traversal)[0]
    base = base_pose if base_pose is not None else ego_poses_per_traversal[first][0]
    base_inv = np.linalg.inv(base)

    odom = LidarOdometry(voxel_size=voxel_size, max_range=max_range)
    icp_global: Dict[int, np.ndarray] = {}
    for travel_id in sorted(scans_per_traversal):
        gps = ego_poses_per_traversal[travel_id]
        poses = []
        for f, scan in enumerate(scans_per_traversal[travel_id]):
            pre = base_inv @ gps[f]
            ref_scan = scan @ pre[:3, :3].T + pre[:3, 3]
            E = odom.register_scan(ref_scan.astype(np.float32))
            poses.append(base @ E @ pre)
        icp_global[travel_id] = np.stack(poses)

    refined: Dict[int, np.ndarray] = {}
    errors: Dict[int, Dict[str, float]] = {}
    excluded: List[int] = []
    for travel_id, est in icp_global.items():
        gps = ego_poses_per_traversal[travel_id]
        m = min(len(est), len(gps))
        T = umeyama_rigid(est[:m, :3, 3], gps[:m, :3, 3])
        aligned = np.einsum("ij,njk->nik", T, est[:m])
        errors[travel_id] = trajectory_errors(aligned, gps[:m])
        if errors[travel_id]["EPE"] > epe_gate or errors[travel_id]["ATE"] > ate_gate:
            excluded.append(travel_id)
            refined[travel_id] = gps
        else:
            refined[travel_id] = aligned
    return refined, errors, excluded
