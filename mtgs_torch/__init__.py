"""mtgs_torch — the PyTorch/CUDA port of mtgs_tpu for NVIDIA Hopper.

A second package beside `mtgs_tpu/`, mirroring its layout so every module
has an obvious counterpart:

    core/      quaternions, spherical harmonics, view matrices
    raster/    projection, binning, the differentiable rasterizer (fused and
               classic paths) and its hand-written CUDA kernels (csrc/)
               with plain twins
    models/    scene-graph nodes, rigid and deformable instances, the deform
               and WildGaussians MLPs, appearance, state conversion
    train/     render_view, losses, Adam, density control, camera-pose
               optimisation, the training step and loop, checkpoints
    data/      the synthetic road block; the nuPlan parser, sample loading
               and loaders, with the port's own JPEG/PNG decoders (host C++)
    utils/     point-cloud IO and filtering; metric writers, step timing and
               traces (observability)
    eval/      metric suite + the per-traversal eval pipeline
    tools/     rendering, the training campaign, per-road-block training
               (also from a road-block data config) and the multi-block
               farm, gaussian export, the train-step bench, the rasterizer
               stage profile, the traversal preview, the fused-against-
               classic validation, the eval/render/viewer smoke, the growth
               demo, the sharded scaling bench and the microbench
    viewer/    the HTTP viewer of a trained run
    parallel/  meshes of ranks over torch.distributed, collectives, camera
               data parallelism and the tile-sharded rasterizer
    preprocess/ the offline data factory: the staged video_scene_dict store,
               road-block configs (own YAML reader and writer), traversal
               splitting and preview mosaics, multi-traversal LiDAR
               registration over the host ICP core (csrc/icp_core.cc), COLMAP
               interop, the depth codec, the gated model stages, point-cloud
               stacking on the card, and the 8-stage pipeline driver

This package imports torch, numpy and scipy only — never jax, flax, mtgs_tpu,
PIL or PyYAML.
Entry points take an explicit `device` that defaults to "cuda" and raise
when no card is present; they never fall back to the CPU on their own.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Full-f32 matmuls and convolutions. TF32 keeps ~3 decimal digits — the
# Hopper analogue of the one-pass bf16 TPU matmul that corrupted SSIM and
# sent a training run NaN (mtgs_tpu/__init__.py pins "highest" for the
# same reason).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on; raises if it is a CUDA
    device and no card is present (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mtgs_torch: device 'cuda' requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU"
        )
    return dev
