#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`mtgs_torch`) on one GPU.

Drives the port's paths through the entry points a user calls, at the
full width of the `mtgs` preset (960x540, tile 32, antialiased, RGB+ED
with predicted normals, max_intersections 2^21) on a ~1M-gaussian scene
made from `--seed`: serving (`scene_from_state_dict` -> `evaluate_scene`
-> `render_view` -> `rasterize`), training (`Trainer.train` ->
`train_step` -> `loss_and_grads` -> the differentiable `rasterize`), the
render tool at nuPlan's 1920x1080 (`tools.render.render_camera_path`),
training across the capacity growth that leaves the fused path, the
training campaign (`tools.campaign.main`), a nuPlan road block through
`tools.train_scene.main` with the port's own JPEG and PNG decoders, the
road block's eval with LPIPS and DINOv2 scoring and its image and gaussian
export, the deformable and WildGaussians presets on the campaign's scene,
the viewer serving the road block over HTTP (`viewer.server`), and the
metric writers, the trace and the two bench tools
(`utils/observability.py`, `tools/bench_train.py`,
`tools/profile_raster.py`), `mtgs_torch.parallel` as ranks on the card
(data parallel, tile-sharded rasterization, a 2D mesh), and the data
factory (`preprocess/`: point-cloud stacking on the card, stages 5-8 of the
pipeline on the committed road block, `train_scene --data-config`, the
preview page and mosaics), and the last six tools (`tools/validate_fused.py`,
`onchip_smoke.py`, `grow_demo.py`, `scaling_bench.py`, `microbench_ops.py`,
`benchmark_farm.py`); and holds
the seven hand-written CUDA kernels (`csrc/expand_fused.cu`,
`csrc/blend_forward.cu`, `csrc/blend_backward.cu`, `csrc/segment_sum.cu`,
`csrc/expand_pairs.cu`, the two of `csrc/transpose.cu`) against their
plain PyTorch versions. Phases, each of which raises on failure:

  1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA;
  2. build: the six kernel sources compiled with nvcc for sm_90a, the
     image decoders (`csrc/image_decode.cc`), the JPEG encoder
     (`csrc/image_encode.cc`) and the ICP core (`csrc/icp_core.cc`) with
     the host compiler, in parallel;
  2b. prng: `core.prng` (the port's copy of `jax.random`, which draws
     the synthetic scenes, the refine noise and the initial weights) on
     the card against the CPU for four seeds, a chain of three splits and
     a fold_in: keys, bits, uniform, randint, bernoulli and normal bit for
     bit, some of its draws from erf_inv's tail branch; one refine-sized
     normal draw (2^20 x 3), erf_inv over every input of its tail branch
     and `core.xla_math`'s exp, sin, cos and sqrt over 2^20 inputs each,
     bit for bit;
  3. goldens: the kernel path's rasterize on the four gsplat-math goldens
     in tests/goldens/ (render 2e-3, alpha 1e-3);
  4. main path: the scene in the JAX state-dict layout, carried across
     with `scene_from_state_dict`; ground truth for each view is the
     plain path's render on the card (the same code with the kernel
     wrappers swapped for their plain versions); `evaluate_scene` over
     the views with the launch counters zeroed just before and read just
     after. Every view of that run is held against its own plain render:
     rgb, rgb_appearance and normal within 2e-3, accumulation within
     1e-3, depth within 1e-3 relative where alpha > 1e-2 (2e-3 at the
     few pixels the blend check allows to flip), the view's PSNR >= 50
     dB; depth RMSE <= 1e-3 m; every depth flip (a pixel above 1e-3)
     must be a termination or a cut-off flip of the view's blend; both
     forward kernels must have launched once per view, and no view may
     truncate (n_intersections <= max_intersections);
  6. training: `Trainer.train` for TRAIN_STEPS steps of
     `mtgs_config(max_steps=TRAIN_STEPS)` with refine_every overridden to
     10 (one refine and one opacity reset fire at step 10), from a copy
     of the scene with jittered means, features_dc and opacities, on the
     phase-4 views with the plain renders as targets (LiDAR depth with
     holes, pseudo depth without); the launch counters are zeroed just
     before and read just after: each of the four fused-path kernels must
     launch once per step. The refine's split noise of the background,
     `normal(key, (out_cap, 3))` drawn on the card, must equal the CPU's
     draw for that key and out_cap. Every step finite with no skipped step, no
     truncation; on the view of step 0 the total loss falls within each
     stretch between opacity resets (the reset, which sets every
     opacity to 0.01, raises it by design) and the l1 term falls after
     the reset; ms per step is the median of the host clock around
     `torch.cuda.synchronize()` after warm-up. Then one step's parameter
     gradients and absgrad on the kernel path are held against the same
     step with every kernel wrapper swapped for its plain version (each
     leaf max-scaled within 2e-4);
  7. classic against fused: the phase-4 views rendered with `fused=False`
     within 1e-6 of the fused renders, and the phase-6 gradient step's
     gradients within 1e-5 max-scaled; kernels 5-7 launch on the classic
     runs only;
  8. render tool: `render_camera_path` renders 6 frames of a camera path
     through the phase-4 cameras at 1920x1080 (max_intersections 2^23,
     where the fused key packing does not fit): every frame takes the
     classic path, truncates nothing and is held against the plain
     path's render with phase 4's tolerances and depth flip causes; ms per
     frame;
  9. growth: `Trainer.train` for GROWTH_STEPS steps on a larger scene
     (its views make more than 0.85 of GROW_FROM pairs) from
     max_intersections GROW_FROM; the refine at step 10 grows it to
     GROW_TO, past the fused gate: the fused kernels launch once per step
     before, the classic ones (and both blends and the segment sum) once
     per step after; every step finite, none skipped or truncated, the
     loss on view 0 falls after the reset; one grown step's gradients
     against the plain path (2e-4);
  10. campaign: `tools/campaign.py::main` in-process for CAMPAIGN_STEPS
     steps on the JAX campaign's scene at full width (960x540, 600k
     ground-truth gaussians, 100k seeds, a 5k instance, a 100k skybox, 3
     traversals x 8 frames), with its ladder, rotating checkpoints and
     mid-run teardown and resume, the launch counters zeroed just before
     and read just after, and read around main's own calls: the ground
     truth launched the kernels of the path `fused_fits` picks once per
     view, each training step one forward and one backward blend, one
     segment sum and one pair expansion, the eval one forward blend per
     view; each ladder stage's size and max_intersections follow the
     Trainer's rule from the (grown) base; refines and resets fall where
     the preset's schedule puts them; no step non-finite, skipped or
     truncated; at most 2 rotating checkpoints, the final one without
     optimizer state; a trainer rebuilt from the output (capacities
     padded, then loaded) repeats eval_result.json within 1e-6; the
     seen-split PSNR beats the untrained scene's by 2 dB; one view of the
     trained scene against the plain path with phase 4's tolerances, and
     one gradient step against the plain path with the kernel forward
     blend on both sides (GRAD_TOL; `trained_scene_grads` says why);
  11. nuPlan: `tools/train_scene.py::main` in-process on the committed road
     block (tests/fixtures/nuplan_block: 3 traversals x 4 frames of
     1920x1080 JPEGs through a distorting camera; the seed cloud, LiDAR,
     poses and boxes written at run time from the seed by
     tests/make_nuplan_fixture.py): the port's decoders against PIL's
     manifest (block means within 1/255, SHA-256 equality reported) with
     the host's ms per decode, per `load_sample` and for `SampleCache`'s
     prefetch; the untrained model's eval on traversal 2 (unseen);
     NUPLAN_STEPS steps of the `mtgs` preset at 960x540 with a checkpoint
     every NUPLAN_SAVE_EVERY, the launch counters zeroed just before and
     read just after: the four fused kernels once per step, the two forward
     kernels once per eval view; `main --resume` in a folder holding only
     the step-100 checkpoint, launching for the steps left; the eval psnr
     NUPLAN_PSNR_GAIN dB above the untrained; `eval_setup` + `evaluate_scene`
     repeating eval_result.json within 1e-6; `render_interpolated` of
     traversal 0 at 1920x1080 (10 frames, classic path: kernels 1, 5, 6
     once per frame), its middle frame against the plain path with phase
     4's tolerances and flip causes;
  12. deformables and WildGaussians: on phase 10's scene at full width,
     DEFORM_STEPS steps of `method_config("mtgs_deformable")` through
     `Trainer.train`, its rigid 5k instance made a deformable block
     (capacity 5,120, zero embeddings, a seeded deform MLP) and the
     deformation switched on at DEFORM_ENABLE (the preset's absolute 3000
     cut in depth); and DEFORM_STEPS steps of `method_config(
     "wild_gaussians")` on the scene built with the WildGaussians
     appearance. Each run with the launch counters zeroed just before and
     read just after: the four fused kernels once a step; no step
     non-finite, skipped or truncated. Deformable: the MLP and embeddings
     bit-equal to their start before the switch while the canonical means
     move, the canonical means bit-equal after it while every MLP weight
     trains, the refine consuming the block's densify statistics. Wild:
     every wild leaf trains, the seen split CAMPAIGN_PSNR_GAIN dB above
     the untrained model. Both: one gradient step of the trained scene
     against the all-plain path (GRAD_TOL; where L1 sign flips show, with
     the kernel forward blend on both sides, as phase 10), the eval, and
     a checkpoint reloaded into a freshly built model padded to its
     capacities repeating it within 1e-6; ms per step beside phase 10's;
  13. eval and export, on phase 11's trained run:
     seeded LPIPS-Alex and DINOv2 ViT-B/14 weights at the published widths
     written under build/chip_smoke/ and named by MTGS_LPIPS_WEIGHTS /
     MTGS_DINOV2_WEIGHTS for phases 13-14 only (phases 11 and 12 find none and
     score neither); `eval_setup`, then `evaluate_scene` with both metrics
     on over the held-out traversal and `export_eval_images` in its three
     modes (`nuplan` re-distorted to the raw 1920x1080 CAM_F0), the launch
     counters zeroed just before and read just after: the two forward
     kernels once per view of each; lpips and dinov2_sim finite, every
     other key within 1e-6 of an eval with both off; both forwards at one
     view on the card against the CPU (LPIPS rel 1e-4 / abs 1e-6, patch
     tokens atol 2e-4 / rtol 1e-3), lpips(x, x) = 0 and dinov2_sim(x, x) =
     1 within 1e-5; every written JPEG decoded by the port's decoder to the
     expected shape with PSNR >= 30 dB against its array, the raw-image
     symlinks resolving; `write_jpeg`'s bytes against PIL's SHA-256
     manifest (tests/fixtures/jpeg_manifest.json); the trained background
     through tools/export.py (.ply read back exactly); times of LPIPS and
     DINOv2 per view (CUDA events), the crop's host ms, `write_jpeg` per
     1920x1080 frame, `redistort_image` per frame, export s per 1e5
     gaussians;
  14. viewer, on phase 11's trained run (after phase 13, whose weight files
     it reuses): `viewer.server.viewer_from_run` on the card, served on
     127.0.0.1:0 in a thread; the page, /meta (travels, init_cam, at most 500
     cameras), /render for every output (rgb, depth, accumulation, normal) x
     both rungs (960x540 and lowres 240x135) x each traversal, `mean` and
     `null` x t in VIEWER_STAMPS at a held-out camera: status 200, a JPEG
     the port's decoder opens at the rung's size, byte-equal to
     `ViewerServer.render` in-process, the kernels of the path `fused_fits`
     picks launched once each (counted around the request); the full
     rung's rgb frames against the plain path within VIEW_TOL["rgb"];
     /export byte-equal to tools/export.py, format xyz 500, /nope 404; each
     rung timed over VIEWER_REQUESTS round trips after VIEWER_WARMUP, and
     in-process split into render + sync, colourise + copy and the q85
     encode; `evaluate_scene` twice with LPIPS and DINOv2 on, its weight
     loaders counted (one load of each, in the first call), both timed;
     `encode_jpeg(..., quality=85)` against the manifest's q85 hashes;
  15. observability and the tools: `Trainer.train(OBS_STEPS,
     writer=JsonlWriter)` on phase 4's scene from phase 6's start (every
     metric key, and step_ms / rays_per_s from the second step, in the
     file; the fused kernels once a step); `observability.trace` around
     OBS_TRACE_STEPS more steps, `summarize_trace` naming the four fused
     kernels as the CUDA sources do, once a step as counted;
     `tools/bench_train.py` and `tools/profile_raster.py` at their defaults
     (classic) and with `--fused` (profile_raster also `--trace`), their
     JSON line, iters/s, stage deltas and H100 roofline, and their
     launches counted against what each must make;
  16. parallel: `mtgs_torch.parallel` as processes on the one card (gloo,
     every rank on cuda:0, collectives staged through host memory; NCCL
     refuses two ranks on one device), each rank reading phase 6's start
     from one file the parent writes and taking phase 6's training views.
     World 2: a
     data-parallel step with the same view on both ranks against the
     single-process step (gradient leaves within 2e-4 max-scaled, the loss
     1e-6 relative, the parameters after it), then PARALLEL_DP_STEPS
     `DPTrainer` steps on distinct views with the refine and reset at
     REFINE_EVERY (psnr on the same views rising within each stretch, every
     rank's parameters, moments and densify statistics bit-equal by
     SHA-256); one view rendered and differentiated on a 2-rank tile mesh
     by the band plan (the default), the ownership plan (MTGS_DIST=1,
     MTGS_BLK_SLACK 2.0) and the layered plan (MTGS_LAYERED=1, buffer
     PARALLEL_LAYERED_I), each against the single process (phase 4's view
     tolerances, gradients 2e-4 max-scaled; the layered plan against its
     own semantics on one process, `layered_reference`, its difference from
     the single blend reported), no truncation; one classic
     1920x1080 frame (I = 2^23) rendered and differentiated with the blend
     sharded; `Trainer(mesh=...)` through a growth of the intersection
     buffer at the refine (from PARALLEL_GROW_FROM, which rounded to 512
     alone would leave the band plan), on the band plan at every step.
     World 4: one step over a (2 data, 2 tile) mesh (the ownership plan
     along tile) against the data-parallel step over its data axis. The
     pipeline of every sharded render is recorded and must be the plan's
     (`pipelines_recorded`, and the plan functions agree); the launch
     counters are read around each run on every rank (kernels 1-4 once a
     forward and backward, 5-7 on the classic frame); a failing rank fails
     the world, and every world has a deadline (PARALLEL_TIMEOUT). Wall ms
     of a DP step and of a sharded render are printed as ranks time-sliced
     on one card, not a scaling figure;
  17. preprocess (run after phase 14, on phase 11's block before its
     folder goes): (c) `train_scene.main --data-config` with a YAML
     `save_yaml` writes naming phase 11's road block, DATA_CONFIG_STEPS
     steps at 960x540, checked as phase 11 checks its run (launches
     counted: the fused four once a step, the forward two once an eval
     view); (a) `StackAccumulator` at nuPlan's sensor sizes (3 traversals x
     10 frames, 8 cameras at 1920x1080 with uint8 cityscapes masks, sweeps
     of 64 x 2,048 points out to 80 m, 30 boxes a frame; seeded) on the
     card, then the same run with device="cpu": every frame's rgb, seen,
     labels and box masks equal, the clouds the same rows within
     CLOUD_ULPS float32 ulps; ms a frame of `paint_points`,
     `points_in_boxes` and `add_frame` and the seconds of `finalize`, card
     and CPU; (b) the committed road block materialized anew, its stage
     inputs written (`write_stage_inputs`: the JPEGs undistorted, the
     nuPlan raw schema) and `run_pipeline` stages 5-8 on the card:
     registration ok with every traversal's EPE and ATE under the gates,
     COLMAP skipped with the fixed-pose model written, dense depth skipped,
     stacking ok with non-empty clouds; seconds a stage, ms a scan of the
     ICP; (d) `preview.build_preview_html` of the final stage and
     `export_traversal_videos` of every traversal (the camera tile against
     `resize_u8(..., bicubic=True)` of the decoded JPEG);
  18. tools (after phase 16): the last six tools' `main`s on the card, each
     with the launch counters zeroed just before and read just after:
     `validate_fused` at its defaults (exit 0: fused against classic on
     200k gaussians at 512x384; kernels 1-4 on the fused run, the classic
     path's six on the classic run); `onchip_smoke` at its defaults (exit 0,
     the eval, interpolated frames and viewer flags true; the fused forward
     pair once a ground-truth view, step, eval view, frame and viewer
     request); `grow_demo` at 960x540 from 100k seeds for GROW_STEPS steps
     (its 2000-step default cut in depth; exit 0, a growth event, no
     overflow, every step's forward and backward on the fused or, past the
     gate, the classic path, the split replayed from the trainer's growth
     events; every refine's alive count printed beside JAX's TPU log's),
     and again at the size of the CPU comparison in
     tests/fixtures/grow_demo_jax.json (JAX's run on the CPU): every
     refine's capacity, buffer and overflow equal to JAX's and its alive
     count within 1%; `scaling_bench` over worlds 1 and 2 at 200k gaussians in wall
     mode and `--cost` (gloo ranks time-sliced on cuda:0; every rank's fused
     four once a step, no render truncated, world 2's fullest band between
     half and all of the image's pairs); `microbench_ops` at JAX's sizes (kernels 6 and 7 once a
     call); `benchmark_farm` with two tasks of FARM_STEPS steps on a copy of
     the committed road block (`--slots 2`, the children on the card; each
     child's log shows the fused four once a step and the forward pair once
     an eval view), then `--resume` (both `cached`, no child started, the
     same tables but for the status column);
  5. kernels: each kernel against its plain version, the fused forward two
     at the shapes of one serving view, the backward two at those of one
     training step (both blends also on the faint scene of one more
     phase-6 step, 21 steps after the opacity reset, where two launches
     must give equal bits; the blend forward and the segment sum also at
     a grown training step's, the segment sum twice at each for equal
     bits; the fused expansion also at phase 9's first, fused, step's;
     both blends also at phase 10's trained-scene step's; the blend backward
     also on the lower tile-row band of the phase-6 step at its nonzero
     tile_base, its columns bit-equal to the whole image's),
     the classic three at a 1920x1080 frame's and a grown training
     step's; every blend pixel above BLEND_TOL must be a termination or a
     cut-off flip; each timed on the device alone (`device_ms`: a CUDA
     graph of DEVICE_K launches) and with the wrapper's host work
     (`ms`: CUDA events around one call, median of 20 after warm-up),
     with the least time the card could take for the same work.

Prints the card line, the `{"kernels": [...]}` line and, last,
`{"ok": true, "device": {...}}`; `--out DIR` also writes everything
measured to DIR/chip_smoke.json; `--ab SOURCE=PATH` also times another
version of a kernel source (the same C interface) against the
checkout's at phase 5's inputs, on device_ms (`phase_ab`). Exits non-zero
without a CUDA device.

Run from the repository root:  python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import csv
import ctypes
import dataclasses
import hashlib
import importlib
import importlib.util
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from mtgs_torch import configs
from mtgs_torch.core import prng, xla_math
from mtgs_torch.data import image_io, loader as data_loader
from mtgs_torch.data.dataset import SampleConfig, load_sample, undistort_image
from mtgs_torch.data.nuplan import parse_scene
from mtgs_torch.data.synthetic import build_scene_model
from mtgs_torch.eval import dinov2 as dinov2_mod
from mtgs_torch.eval import lpips as lpips_mod
from mtgs_torch.eval.metrics import masked_psnr
from mtgs_torch.eval.pipeline import EvalConfig, evaluate_scene, export_eval_images
from mtgs_torch.models.convert import scene_from_state_dict
from mtgs_torch.models.deform import init_deform_mlp
from mtgs_torch.models.gaussians import init_skybox_node, node_capacity
from mtgs_torch.models.scene_graph import DeformableParams, node_segments
from mtgs_torch.parallel.collectives import pmean
from mtgs_torch.parallel.data_parallel import DPTrainer, make_dp_train_step, shard_batch
from mtgs_torch.parallel.mesh import launch, make_mesh
from mtgs_torch.parallel.mesh2d import make_2d_train_step
from mtgs_torch.preprocess import lidar_registration
from mtgs_torch.raster import (
    RasterizeConfig, binning, blend, cuda_build, expand_fused, expand_pairs, rasterize,
    segment_sum,
)
from mtgs_torch.raster.dist_fused import dist_shard_plan
from mtgs_torch.raster.layered_dist import layered_shard_plan
from mtgs_torch.raster.chunk_math import (
    ALPHA_MAX, ALPHA_MIN, LOG_T_EPS, NUM_GEOM, conic_coefficients, pixel_features, round8,
)
from mtgs_torch.raster.expand_fused import fused_fits
from mtgs_torch.tools import (
    bench_train, benchmark_farm, campaign, grow_demo, microbench_ops, onchip_smoke,
    profile_raster, scaling_bench, train_scene, validate_fused,
)
from mtgs_torch.tools import export as gaussian_export
from mtgs_torch.tools import render as render_tool
from mtgs_torch.train import checkpoint
from mtgs_torch.train.optim import OptimConfig, default_groups, named_leaves
from mtgs_torch.train.trainer import (
    Batch, Trainer, _total_capacity, init_train_state, loss_and_grads, render_view, train_step,
)
from mtgs_torch.utils import observability
from mtgs_torch.viewer import server as viewer_server

# the modules (the packages' attributes of these names are functions)
rasterize_mod = importlib.import_module("mtgs_torch.raster.rasterize")
pipeline_mod = importlib.import_module("mtgs_torch.eval.pipeline")
trainer_mod = importlib.import_module("mtgs_torch.train.trainer")
dist_mod = importlib.import_module("mtgs_torch.raster.dist_fused")
layered_mod = importlib.import_module("mtgs_torch.raster.layered_dist")
ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit), shared with
# tools/profile_raster.py's roofline
PEAK_BYTES_PER_S = profile_raster.PEAK_BYTES_PER_S
PEAK_F32_PER_S = profile_raster.PEAK_F32_PER_S

BLEND_TOL = 1e-4        # f32 rounding of the same formulation
BLEND_FLIP_TOL = 2e-3   # a pixel where an alpha = 1/255 or sigma = 0 cut-off flips
CUT_ULPS = 16           # cutoff_flips: the rounding band of a cut-off decision, in f32 ulps
DEVICE_K = 20           # device_ms: the launches in one CUDA graph
PSNR_MIN = 50.0
# each view of the kernel path against its plain render (the golden
# tolerances the CPU tests hold the port to against the JAX package)
VIEW_TOL = dict(rgb=2e-3, rgb_appearance=2e-3, normal=2e-3, accumulation=1e-3)
DEPTH_REL_TOL = 1e-3    # where alpha > 1e-2; BLEND_FLIP_TOL at flipped pixels
DEPTH_RMSE_MAX = 1e-3   # metres, against the plain depth where alpha > 0.5
GRAD_TOL = 2e-4         # a gradient against the plain path's, over its largest |value|
SEGMENT_TOL = 1e-5      # the segment sum: the same f32 sums in another order
N_TRAVELS = 3
N_FRAMES = 8
TRAIN_STEPS = 31        # step 30 trains on the view of step 0 (6 views)
REFINE_EVERY = 10       # the override of the preset's 100
FUSED_KERNELS = ("expand_fused", "blend_forward", "blend_backward", "dense_segment_sum")
CLASSIC_ONLY = ("expand_pairs", "rows_to_attr_major", "attr_major_to_rows")
KERNELS = FUSED_KERNELS + CLASSIC_ONLY
# the module whose attribute each kernel wrapper is where the path calls it
KERNEL_HOMES = {**{k: rasterize_mod for k in KERNELS}, "expand_pairs": binning}
CLASSIC_TOL = dict(render=1e-6, grads=1e-5)  # phase 7: the classic path against the fused
# the pipelines of rasterize(mesh=...): phase 16 records which one ran
PIPELINES = dict(layered=(layered_mod, "rasterize_layered"),
                 dist=(dist_mod, "rasterize_fused_dist"),
                 band=(rasterize_mod, "_rasterize_fused_sharded"),
                 classic=(rasterize_mod, "_blend_sharded"))
RENDER_SIZE = (1920, 1080)  # phase 8: nuPlan's camera resolution, the render tool's default
RENDER_I = 1 << 23
RENDER_FRAMES = 6
GROW_FROM, GROW_TO = 3_145_728, 4_718_592  # phase 9: the preset's first and second growth
GROWTH_STEPS = 20
GRAD_STEP = 10          # the step of the gradient check: SH degree 3, sharp-shape gate open
CAMPAIGN_STEPS = 600    # phase 10: refines at 100 and 200, a reset at 100, resume at 300
CAMPAIGN_SAVE_EVERY = 150
CAMPAIGN_PSNR_GAIN = 2.0  # dB: the trained seen split over the untrained seed scene's
CAMPAIGN_EVAL_TOL = 1e-6  # a rebuilt trainer's eval against eval_result.json
NUPLAN_SIZE = (960, 540)  # phase 11: the training size (the JPEGs' 1920x1080 at scale 0.5)
NUPLAN_STEPS = 200       # phase 11: train_scene.main on the committed road block
NUPLAN_SAVE_EVERY = 100  # the resume starts from the step-100 checkpoint
NUPLAN_PSNR_GAIN = 1.0   # dB: the trained eval over the untrained build's
NUPLAN_EVAL_TOL = 1e-6   # eval_setup + evaluate_scene against eval_result.json
NUPLAN_MEANS_TOL = 1 / 255  # the JPEGs' 1/32-scale block means against the manifest's (PIL)
INTERP_HZ = 6.0          # render_interpolated: 4 frames at 2 Hz become 10
DEFORM_STEPS = 300       # phase 12: steps of each preset on phase 10's scene
DEFORM_ENABLE = 150      # the deformation switch (the preset's absolute 3000, cut in depth)
DEFORM_SEED = 12         # the deform MLP's key
EVAL_EXPORT_SEED = 13    # phase 13: the seeded LPIPS and DINOv2 weights
EVAL_EXPORT_TOL = 1e-6   # phase 13: the other metrics with LPIPS and DINOv2 on, against off
LPIPS_TOL = dict(rel=1e-4, abs=1e-6)    # phase 13: the card's LPIPS against the CPU's
DINOV2_TOL = dict(atol=2e-4, rtol=1e-3)  # phase 13: the card's patch tokens against the CPU's
SELF_TOL = 1e-5          # phase 13: lpips(x, x) = 0 and dinov2_sim(x, x) = 1
EXPORT_PSNR_MIN = 30.0   # phase 13: a written JPEG against the uint8 array it encodes
VITB = dict(D=768, heads=12, layers=12, hidden=3072, patch=14, grid=37)  # DINOv2 ViT-B/14
VIEWER_STAMPS = ("0", "0.5")  # phase 14: the time slider's values requested
VIEWER_WARMUP = 5        # phase 14: HTTP round trips before the timed ones, a rung
VIEWER_REQUESTS = 30     # phase 14: timed requests a rung (and in-process splits)
OBS_STEPS = 20           # phase 15: Trainer.train steps with a JsonlWriter
OBS_TRACE_STEPS = 5      # phase 15: steps under observability.trace
PARALLEL_DP_STEPS = 20   # phase 16: DPTrainer steps (a refine and a reset at REFINE_EVERY)
PARALLEL_GROW_FROM = (1 << 21) + 1024  # phase 16: Trainer(mesh=)'s first buffer: grown at
# the refine by 1.5 it is an odd multiple of 512, which the band plan at 2 ranks refuses
PARALLEL_GROW_STEPS = 12  # phase 16: Trainer(mesh=) steps, the growth at the refine of step 10
PARALLEL_TIMEOUT = 300   # phase 16: seconds each world of ranks may take, start-up included
# the layered plan's buffer: its depth slabs split the gaussians, not the pairs, and at the
# preset's 2^21 the fuller slab of phase 6's first view holds more pairs than its I / 2
# slots (truncated: the n_intersections check fails)
PARALLEL_LAYERED_I = 1 << 22
# phase 16's plans, by the variables that pick them (MTGS_BLK_SLACK 2.0: untruncated
# exchange blocks, so the ownership plan can be held to the single-process render)
PARALLEL_PLANS = dict(band={}, dist=dict(MTGS_DIST="1", MTGS_BLK_SLACK="2.0"),
                      layered=dict(MTGS_LAYERED="1"))
PLAN_VARS = ("MTGS_DIST", "MTGS_BLK_SLACK", "MTGS_LAYERED", "MTGS_ROW_SLACK")
# the training start: the scene's alive rows jittered by these standard deviations
JITTER = dict(means=0.05, features_dc=0.3, opacities=0.5)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


# ----------------------------------------------------------------- scene

def _logit(p):
    return np.log(p / (1.0 - p)).astype(np.float32)


def _random_quats(rng, n):
    return rng.normal(size=(n, 4)).astype(np.float32)


def _node_sd(means, log_scales, quats, dc, rest, opac_logit, adapters, cap):
    """One node in the JAX state-dict layout, padded to `cap` rows."""
    n = len(means)

    def pad(a):
        out = np.zeros((cap,) + a.shape[1:], np.float32)
        out[:n] = a
        return out

    node = dict(means=pad(means), scales=pad(log_scales), quats=pad(quats),
                features_dc=pad(dc), features_rest=pad(rest),
                opacities=pad(opac_logit), features_adapters=pad(adapters),
                fourier_dc=np.zeros((cap, 0, 3), np.float32))
    node["scales"][n:] = -5.0
    alive = np.zeros((cap,), np.float32)
    alive[:n] = 1.0
    return node, dict(alive=alive, num_alive=np.array(n, np.int32))


def make_scene_state(seed: int, n_bg: int, n_sky: int, n_inst: int):
    """The scene as the JAX package's `to_state_dict` gives it (numpy
    leaves): a multicolour background in bench.py's driving layout (ground
    carpet + structures, opacities 0.3-0.95) with per-traversal SH degree 3
    rest, a spheric skybox (`init_skybox_node` defaults) and one rigid
    instance with N_FRAMES poses."""
    rng = np.random.default_rng(seed)
    n_ground = (n_bg * 3) // 5
    n_struct = n_bg - n_ground
    ground = np.stack([rng.uniform(-60, 60, n_ground), rng.uniform(-20, 20, n_ground),
                       np.zeros(n_ground)], -1)
    struct = np.stack([rng.uniform(-60, 60, n_struct), rng.uniform(-25, 25, n_struct),
                       rng.uniform(0, 12, n_struct)], -1)
    means = np.concatenate([ground, struct]).astype(np.float32)
    log_scales = np.concatenate([rng.normal(-2.3, 0.4, (n_ground, 3)),
                                 rng.normal(-2.0, 0.5, (n_struct, 3))]).astype(np.float32)
    bg, bg_aux = _node_sd(
        means, log_scales, _random_quats(rng, n_bg),
        rng.normal(0.0, 0.8, (n_bg, 3)).astype(np.float32),
        (0.15 * rng.normal(size=(n_bg, N_TRAVELS, 15, 3))).astype(np.float32),
        _logit(rng.uniform(0.3, 0.95, (n_bg, 1))),
        (0.2 * rng.normal(size=(n_bg, N_TRAVELS, 3))).astype(np.float32),
        node_capacity(n_bg))

    sky_p, sky_a = init_skybox_node(num_points=n_sky, seed=seed + 1, device="cpu")
    sky = {f: getattr(sky_p, f).numpy() for f in (
        "means", "scales", "quats", "features_dc", "features_rest", "opacities",
        "features_adapters", "fourier_dc")}
    sky_aux = dict(alive=sky_a.alive.numpy(), num_alive=sky_a.num_alive.numpy())

    box = np.array([4.5, 2.0, 1.6], np.float32)
    local = (rng.uniform(-0.5, 0.5, (n_inst, 3)) * box).astype(np.float32)
    node, node_aux = _node_sd(
        local, rng.normal(-2.5, 0.3, (n_inst, 3)).astype(np.float32),
        _random_quats(rng, n_inst), rng.normal(0.0, 0.8, (n_inst, 3)).astype(np.float32),
        (0.15 * rng.normal(size=(n_inst, 15, 3))).astype(np.float32),
        _logit(rng.uniform(0.5, 0.95, (n_inst, 1))),
        np.zeros((n_inst, 0, 3), np.float32), node_capacity(n_inst))
    yaw = rng.uniform(-0.2, 0.2, N_FRAMES)
    inst_q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
    inst_t = np.stack([np.linspace(-40, -30, N_FRAMES), rng.uniform(-2, 2, N_FRAMES),
                       np.full(N_FRAMES, 0.8)], -1)
    travel_of_frame = np.array([0, 0, 0, 1, 1, 1, 2, 2], np.int32)
    instances = dict(node={k: v[None] for k, v in node.items()},
                     quats=inst_q[None].astype(np.float32),
                     trans=inst_t[None].astype(np.float32))
    inst_aux = dict(
        alive=node_aux["alive"][None], num_alive=node_aux["num_alive"][None],
        present=np.ones((1, N_FRAMES), np.float32), is_static=np.zeros((1,), np.float32),
        frame_timestamps=np.array([0, .5, 1, 0, .5, 1, 0, 1], np.float32),
        travel_of_frame=travel_of_frame, sizes=box[None])

    appearance = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], 1), (3, 1, 1))
    appearance[1, :, :3] *= 0.95
    appearance[2, :, 3] += 0.02
    params = dict(background=bg, skybox=sky, instances=instances, deformables=None,
                  appearance=appearance.astype(np.float32),
                  camera_opt=np.zeros((N_FRAMES, 6), np.float32), wild=None)
    aux = dict(background=bg_aux, skybox=sky_aux, instances=inst_aux, deformables=None)
    return params, aux


def make_views(seed: int, n_views: int, width: int, height: int, focal: float):
    """Eval views spread over the traversals: cameras near bench.py's
    (x = -55, 1.6 m up, looking along +x), each on one instance frame."""
    rng = np.random.default_rng(seed + 7)
    frames = [0, 2, 3, 5, 6, 7]
    stamps = [0, 1, 0, 1, 0, 1]
    views = []
    for i in range(n_views):
        f = frames[i % len(frames)]
        yaw = rng.uniform(-0.05, 0.05)
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, [0, 0, 1], -fwd
        c2w[:3, 3] = [-55.0 + rng.uniform(-1, 1), rng.uniform(-1.5, 1.5), 1.6]
        K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]], np.float32)
        views.append(dict(c2w=c2w, K=K, cam_idx=i % 3, image_idx=i,
                          travel_index=f // 3, frame_idx=f, timestamp=float(stamps[i % 6])))
    return views


# ------------------------------------------------------------- measuring

def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `reps` runs, CUDA events, after
    warm-up. The window holds the wrapper's host work too (checks,
    allocations, the ctypes call): the device waits for the enqueue."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, k: int = DEVICE_K, reps: int = 5) -> float:
    """Milliseconds of one fn() on the device alone: a CUDA graph of k
    calls of fn, replayed after one warm-up replay, over k (the median of
    `reps` replays, CUDA events). The graph holds only the device work of
    the wrapper (its kernel and any torch operation it launches), so the
    host's checks, allocations and ctypes call are out of the window."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / k)
    del graph
    return float(np.median(times))


def timed(fn, **cuda_kw) -> dict:
    """A kernel wrapper's `ms` (cuda_ms, host work inside), `device_ms`
    and the difference, the wrapper's host cost."""
    ms, dev_ms = cuda_ms(fn, **cuda_kw), device_ms(fn)
    return dict(ms=ms, device_ms=dev_ms, host_ms=ms - dev_ms)


def blend_errors(got, want):
    """Each pixel's error [T, PIX]: colour channels and transmittance
    absolute, each channel scaled by max(1, its largest |value|) so the
    depth channel is held relatively."""
    rgb_g, t_g = got
    rgb_w, t_w = want
    scale = torch.clamp(rgb_w.abs().amax(dim=(0, 2), keepdim=True), min=1.0)
    err_rgb = ((rgb_g - rgb_w).abs() / scale).amax(dim=1)
    return torch.maximum(err_rgb, (t_g - t_w).abs())


def termination_flips(got, want, slab_t, c_total):
    """Pixels where one blend stopped before a gaussian that the other
    composited as its last (T = 1e-4 decided on differently rounded log
    sums: the plain version's chunked cumsum against the kernel's running
    sum): the smaller transmittance lies within 1e-4 relative of the 1e-4
    cut-off, and each colour channel's error (scaled as in blend_errors)
    is within that gaussian's weight, the transmittances' difference,
    times the channel's largest |value| in the slab, plus BLEND_TOL."""
    rgb_g, t_g = got
    rgb_w, t_w = want
    scale = torch.clamp(rgb_w.abs().amax(dim=(0, 2), keepdim=True), min=1.0)
    col_max = slab_t[NUM_GEOM:NUM_GEOM + c_total].abs().amax(dim=1)[None, :, None]
    d_t = (t_g - t_w).abs()[:, None]
    explained = ((rgb_g - rgb_w).abs() <= (d_t * col_max + BLEND_TOL) * scale).all(dim=1)
    at_cut = ((torch.minimum(t_g, t_w) - 1e-4).abs() <= 1e-8)
    return explained & at_cut


def cutoff_flips(got, want, slab_t, tile_offsets, tile_heads, tile_counts, *, tile_size,
                 tiles_x, c_total, pixels, tile_base=0, group=64):
    """Of the pixels `pixels` (bool [T, PIX]), those where the two blends
    took a pair on different sides of a cut-off (BLEND_FLIP_TOL's cases):
    the pixel's tile holds pairs, reached before the blend ended, whose
    alpha lies within CUT_ULPS float32 ulps (of the sum of sigma's terms'
    magnitudes, plus one) of 1/255, or whose sigma lies within CUT_ULPS
    ulps of those magnitudes from 0; and each colour channel's error is
    within those pairs' summed weight (the transmittance before the pair
    times its alpha) times the channel's span in the slab (its largest
    value less its smallest, 0 included: what letting one pair in or out
    moves a pixel by at most), plus BLEND_TOL (scaled as in
    blend_errors), the transmittance's within that weight plus BLEND_TOL.
    The pairs are replayed with chunk_math's formulas (the plain
    version's), the transmittance in float64. Returns (the mask, a list
    of per-pixel diagnostics for the pixels it leaves out)."""
    rgb_g, t_g = got
    rgb_w, t_w = want
    dev = slab_t.device
    scale = torch.clamp(rgb_w.abs().amax(dim=(0, 2)), min=1.0)
    cols = slab_t[NUM_GEOM:NUM_GEOM + c_total]
    span = cols.amax(dim=1).clamp(min=0.0) - cols.amin(dim=1).clamp(max=0.0)
    F = pixel_features(tile_size, dev)
    eps = CUT_ULPS * 2.0 ** -23
    out = torch.zeros_like(pixels)
    diag = []
    t_idx, p_idx = pixels.nonzero(as_tuple=True)
    for g0 in range(0, t_idx.numel(), group):
        t, p = t_idx[g0:g0 + group], p_idx[g0:g0 + group]
        count = tile_counts[t].to(torch.int64)
        lane = torch.arange(max(int(count.max()), 1), device=dev)
        valid = lane[None, :] < count[:, None]
        col = torch.clamp(tile_offsets[t].to(torch.int64) + tile_heads[t] + lane[None, :],
                          max=slab_t.shape[1] - 1)
        geom = slab_t[:NUM_GEOM, col]                                  # [6, K, n]
        tid = tile_base + t
        ox = ((tid % tiles_x) * tile_size).to(torch.float32)[:, None]
        oy = ((tid // tiles_x) * tile_size).to(torch.float32)[:, None]
        Q = conic_coefficients(geom, ox, oy)
        f = F[:, p][:, :, None]                                        # [6, K, 1]
        S = f[0] * Q[0]
        for k in range(1, 6):
            S = S + f[k] * Q[k]
        mag = (f * Q).abs().sum(dim=0)
        raw = geom[5] * torch.exp(-S)
        taken = valid & (S >= 0.0) & (raw >= ALPHA_MIN)
        L = torch.log1p(-(torch.clamp(raw, max=ALPHA_MAX) * taken).double())
        before = torch.cumsum(L, dim=1) - L
        reached = valid & (before > LOG_T_EPS - eps)
        near = reached & (((raw - ALPHA_MIN).abs() <= ALPHA_MIN * eps * (1.0 + mag))
                          | (S.abs() <= eps * mag))
        w = (torch.exp(before) * torch.clamp(raw, max=ALPHA_MAX).double() * near).sum(dim=1)
        err_c = (rgb_g[t, :, p] - rgb_w[t, :, p]).abs().double()      # [K, c]
        err_t = (t_g[t, p] - t_w[t, p]).abs().double()
        ok = ((err_c <= w[:, None] * span.double() + BLEND_TOL * scale.double()).all(dim=1)
              & (err_t <= w + BLEND_TOL) & (w > 0))
        out[t[ok], p[ok]] = True
        for i in (~ok).nonzero()[:, 0].tolist():
            diag.append(dict(tile=int(t[i]), pixel=int(p[i]), near_pairs=int(near[i].sum()),
                             weight=float(w[i]), err=[float(e) for e in err_c[i]],
                             err_t=float(err_t[i]), t_final=float(t_w[t[i], p[i]])))
    return out, diag


def flip_causes(got, want, a, kw, pixels):
    """Of the pixels `pixels` of one blend (captured arguments a, kw), how
    many show each cause for the two blends' difference: a termination
    flip, a cut-off flip, or none. Returns (the counts, diagnostics of
    up to 8 pixels with neither)."""
    slab_t, offs, heads, counts, _ = a
    term = termination_flips(got, want, slab_t, kw["c_total"]) & pixels
    cut, diag = cutoff_flips(got, want, slab_t, offs, heads, counts, pixels=pixels & ~term,
                             **kw)
    none = pixels & ~term & ~cut
    return dict(termination=int(term.sum()), cutoff=int(cut.sum()),
                none=int(none.sum())), diag[:8]


@contextlib.contextmanager
def kernels_replaced(fns: dict):
    """The rasterizer calls fns[name] in place of its kernel wrapper `name`
    (one of KERNELS) inside the with block."""
    saved = {k: getattr(KERNEL_HOMES[k], k) for k in fns}
    for k, fn in fns.items():
        setattr(KERNEL_HOMES[k], k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(KERNEL_HOMES[k], k, fn)


PLAIN = dict(expand_fused=expand_fused.expand_fused_plain,
             blend_forward=blend.blend_forward_plain,
             blend_backward=blend.blend_backward_plain,
             dense_segment_sum=segment_sum.dense_segment_sum_plain,
             expand_pairs=binning.searchsorted_expand,
             rows_to_attr_major=blend.rows_to_attr_major_plain,
             attr_major_to_rows=blend.attr_major_to_rows_plain)


def plain_path():
    """Both paths, forward and backward, with the plain versions in place
    of the seven kernels."""
    return kernels_replaced(PLAIN)


def capturing(args: dict):
    """Records in `args` the arguments of the first call of each kernel
    wrapper (the main path's shapes) and passes the calls through."""
    def wrap(name, fn):
        def call(*a, **kw):
            args.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return call
    return kernels_replaced({k: wrap(k, getattr(KERNEL_HOMES[k], k)) for k in KERNELS})


@contextlib.contextmanager
def views_recorded(outs: list, calls: list):
    """Appends to `outs` the images of every `render_view` that
    `evaluate_scene` makes, and to `calls` its arguments, passing them
    through unchanged."""
    saved = pipeline_mod.render_view

    def call(*a, **kw):
        out = saved(*a, **kw)
        outs.append({k: out[k] for k in (*VIEW_TOL, "depth")})
        calls.append((a, kw))
        return out

    pipeline_mod.render_view = call
    try:
        yield
    finally:
        pipeline_mod.render_view = saved


def view_errors(got: dict, want: dict) -> dict:
    """One kernel-path view against its plain render: max abs error of
    each image in VIEW_TOL, max relative depth error where alpha > 1e-2
    and the pixels above DEPTH_REL_TOL (a termination decided on
    differently rounded log sums lets a last, far gaussian in or out, as
    the blend check allows), and the view's own PSNR (rgb_appearance,
    capped at 100 dB)."""
    err = {k: float((got[k] - want[k]).abs().max()) for k in VIEW_TOL}
    covered = want["accumulation"] > 1e-2
    d_w = want["depth"][covered]
    rel = (got["depth"][covered] - d_w).abs() / d_w.abs()
    err["depth_rel"] = float(rel.max())
    err["depth_flips"] = int((rel > DEPTH_REL_TOL).sum())
    err["covered"] = float(covered.float().mean())
    err["psnr"] = float(masked_psnr(got["rgb_appearance"], want["rgb_appearance"]))
    return err


def depth_flip_mask(got: dict, want: dict) -> torch.Tensor:
    """[H, W]: the covered pixels (alpha > 1e-2) whose depth is off the
    plain render's by more than DEPTH_REL_TOL relative (view_errors'
    depth_flips)."""
    covered = want["accumulation"] > 1e-2
    rel = (got["depth"] - want["depth"]).abs() / want["depth"].abs()
    mask = covered & (rel > DEPTH_REL_TOL)
    return mask.reshape(mask.shape[:2])


def require_depth_flip_causes(render, got: dict, want: dict, label: str) -> dict:
    """Every depth flip of a view (depth_flip_mask: the pixels the flat
    BLEND_FLIP_TOL allowance of require_view_close admits) must come from a
    termination or a cut-off flip of the view's blend (`flip_causes`):
    `render` renders the view again on the kernel path, with its one blend's
    arguments and output recorded (its depth bit-equal to `got`'s), and
    the pixels are looked up in that blend against its plain version.
    Returns the causes' counts."""
    mask = depth_flip_mask(got, want)
    if not mask.any():
        return dict(termination=0, cutoff=0, none=0)
    calls = []
    saved = KERNEL_HOMES["blend_forward"].blend_forward

    def record(*a, **kw):
        out = saved(*a, **kw)
        calls.append((a, kw, out))
        return out

    with kernels_replaced({"blend_forward": record}):
        again = render()
    torch.cuda.synchronize()
    require(len(calls) == 1 and torch.equal(again["depth"], got["depth"]),
            f"{label}: rendered again, the view's depth is not the run's ({len(calls)} blends)")
    a, kw, out = calls[0]
    plain = blend.blend_forward_plain(*a, **kw)
    ts, tx = kw["tile_size"], kw["tiles_x"]
    ys, xs = mask.nonzero(as_tuple=True)
    pixels = torch.zeros((a[1].shape[0], ts * ts), dtype=torch.bool, device=mask.device)
    pixels[(ys // ts) * tx + xs // ts, (ys % ts) * ts + xs % ts] = True
    causes, diag = flip_causes(out, plain, a, kw, pixels)
    require(not causes["none"], f"{label}: {causes['none']} of {int(mask.sum())} depth flips "
            f"show neither a termination nor a cut-off flip in the blend: {diag}")
    return causes


def launch_delta(before: dict) -> dict:
    """The launches since the counts `before`."""
    return {k: cuda_build.LAUNCHES[k] - before[k] for k in KERNELS}


def require_launches(launches: dict, want: dict, what: str) -> None:
    """Every kernel launched exactly want.get(name, 0) times."""
    bad = {k: (launches[k], want.get(k, 0)) for k in KERNELS if launches[k] != want.get(k, 0)}
    require(not bad, f"{what}: launches (got, expected) {bad}")


def require_view_close(e: dict, n_pix: int, label: str) -> None:
    """A view's errors (view_errors) within VIEW_TOL, depth within
    DEPTH_REL_TOL except at up to 0.1% of its n_pix pixels (BLEND_FLIP_TOL
    there), and its PSNR at least PSNR_MIN."""
    bad = [k for k, tol in VIEW_TOL.items() if not e[k] <= tol]
    bad += ["depth_rel"] * (not (e["depth_rel"] <= BLEND_FLIP_TOL
                                 and e["depth_flips"] <= max(2, n_pix // 1000)))
    bad += ["psnr"] * (not e["psnr"] >= PSNR_MIN)
    require(not bad, f"{label}: kernel path vs plain path out of tolerance in {bad}: {e}")


# ---------------------------------------------------------------- phases

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    return card


def phase_build():
    """The six kernel sources (one nvcc each), the image decoders, the JPEG
    encoder and the ICP core (the host compiler), all at once."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        decoders = ex.submit(image_io.build)
        encoder = ex.submit(image_io.build, image_io.ENCODE_SOURCE)
        icp = ex.submit(image_io.build, lidar_registration.SOURCE, lidar_registration.ICP_FLAGS)
        libs = cuda_build.build()
        host_libs = [decoders.result(), encoder.result(), icp.result()]
    secs = time.perf_counter() - t0
    log(f"# build: {', '.join(p.name for p in [*libs.values(), *host_libs])} in {secs:.1f} s")
    return secs


PRNG_SEEDS = (0, 7, 2**31 - 1, 2**32 + 5)
PRNG_NORMAL_ULPS = 0      # normal: XLA's erf_inv, log1p and sqrt, every step correctly rounded
PRNG_TAIL = 3.0           # |normal| past it comes from erf_inv's tail branch (w >= 5)
PRNG_REFINE_SHAPE = (1 << 20, 3)   # one refine-sized normal draw
XLA_MATH_SWEEP = 1 << 20  # inputs a function of core.xla_math, card against CPU
XLA_MATH_RANGES = dict(   # tests/test_torch_xla_math.py's draw ranges, halved
    exp=((-4.0, 1.0), (-90.0, 90.0)), sin=((0.0, 2 * math.pi), (-130.0, 130.0)),
    cos=((0.0, 2 * math.pi), (-130.0, 130.0)), sqrt=((0.0, 1.0), (5.0, 40.0)))


def differing(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of two float32 tensors whose bits differ (NaN equal to NaN)."""
    g, w = got.cpu(), want.cpu()
    same = (g.view(torch.int32) == w.view(torch.int32)) | (g.isnan() & w.isnan())
    return int((~same).sum())


def prng_large(dev) -> dict:
    """What a refine draws and what feeds it, card against CPU: one
    normal(key(seed 0), PRNG_REFINE_SHAPE), erf_inv over every float32 of
    its tail branch (0.9966 <= |x| < 1: 114,086 inputs) and core.xla_math's
    exp, sin, cos and sqrt over XLA_MATH_SWEEP seeded inputs each; returns
    the count of differing elements of each."""
    out = {}
    draws = [prng.normal(prng.key(PRNG_SEEDS[0], device=d), PRNG_REFINE_SHAPE)
             for d in ("cpu", dev)]
    out[f"normal{PRNG_REFINE_SHAPE}"] = differing(draws[1], draws[0])
    pos = torch.arange(int(np.float32(0.9966).view(np.int32)),
                       int(np.float32(1.0).view(np.int32)), dtype=torch.int32).view(torch.float32)
    tail = torch.cat([pos, -pos])
    require(tail.numel() == 114_086, f"erf_inv's tail: {tail.numel()} inputs")
    out["erf_inv tail"] = differing(prng.erf_inv(tail.to(dev)), prng.erf_inv(tail))
    rng = np.random.default_rng(16)
    for name, ranges in XLA_MATH_RANGES.items():
        x = torch.from_numpy(np.concatenate([
            rng.uniform(lo, hi, XLA_MATH_SWEEP // len(ranges)) for lo, hi in ranges
        ]).astype(np.float32))
        fn = getattr(xla_math, name)
        out[name] = differing(fn(x.to(dev)), fn(x))
    torch.cuda.synchronize()
    return out


def prng_draws(key) -> dict:
    """The streams of one key, as the port draws them: bits, the uniforms
    of the synthetic scene's bounds, randint spans, bernoulli(0.5) and
    normal at the shapes of tests/test_torch_prng.py."""
    out = dict(key=key, bits=prng.random_bits(key, (1001, 3)),
               bernoulli=prng.bernoulli(key, 0.5, (1001,)))
    for lo, hi in ((0.0, 1.0), (-60.0, 60.0), (0.15, 0.9), (0.0, 2 * math.pi)):
        out[f"uniform[{lo}, {hi})"] = prng.uniform(key, (1001, 3), lo, hi)
    for lo, hi in ((0, 15), (0, 37), (0, 2**31 - 1)):
        out[f"randint[{lo}, {hi})"] = prng.randint(key, (2001,), lo, hi)
    for shape in ((), (7,), (1001, 3), (4, 5, 3)):
        out[f"normal{shape}"] = prng.normal(key, shape)
    return out


def phase_prng(dev):
    """`core.prng` on the card against the same streams on the CPU: every
    seed's key, a chain of three splits (5, 16, 3 keys) and a fold_in(17)
    of its end; keys, bits, uniform, randint and bernoulli bit for bit,
    normal within PRNG_NORMAL_ULPS float32 ulps, erf_inv's tail branch
    among its draws; then `prng_large`, every element equal."""
    t0 = time.perf_counter()
    n_cases, worst, tail = 0, 0, 0
    for seed in PRNG_SEEDS:
        keys = {}
        for d in ("cpu", dev):
            k = prng.key(seed, device=d)
            chain = [k]
            for n, pick in ((5, 0), (16, 15), (3, 1)):
                chain.append(prng.split(chain[-1], n)[pick])
            chain.append(prng.fold_in(chain[-1], 17))
            keys[str(d)] = chain
        for k_cpu, k_dev in zip(keys["cpu"], keys[str(dev)]):
            want, got = prng_draws(k_cpu), prng_draws(k_dev)
            torch.cuda.synchronize()
            for name, w in want.items():
                g = got[name].cpu()
                n_cases += 1
                if name.startswith("normal"):
                    ulps = (g.view(torch.int32).long() - w.view(torch.int32).long()).abs()
                    err = int(ulps.max()) if ulps.numel() else 0
                    worst = max(worst, err)
                    tail += int((w.abs() > PRNG_TAIL).sum())
                    require(err <= PRNG_NORMAL_ULPS,
                            f"prng seed {seed} {name}: card {err} ulps from the CPU")
                else:
                    require(g.dtype == w.dtype and torch.equal(g, w),
                            f"prng seed {seed} {name}: the card's draw is not the CPU's")
    require(tail > 0, f"prng: no normal draw past {PRNG_TAIL} (erf_inv's tail branch)")
    large = prng_large(dev)
    secs = time.perf_counter() - t0
    log(f"# prng: {n_cases} streams of {len(PRNG_SEEDS)} seeds (keys, a split chain, "
        f"fold_in) on the card: keys, bits, uniform, randint, bernoulli bit-equal to the "
        f"CPU; normal within {worst} ulp (limit {PRNG_NORMAL_ULPS}), {tail} draws past "
        f"{PRNG_TAIL}; elements differing card against CPU {large}; {secs:.1f} s")
    bad = {k: v for k, v in large.items() if v}
    require(not bad, f"prng: the card's draws or XLA math differ from the CPU's: {bad}")
    return dict(cases=n_cases, normal_max_ulps=worst, normal_tail_draws=tail,
                differing=large, seconds=secs)


def phase_goldens(dev):
    """The kernel path against the independent gsplat-math goldens."""
    worst = {}
    for path in sorted((ROOT / "tests" / "goldens").glob("*.npz")):
        g = np.load(path)
        cfg = RasterizeConfig(
            width=int(g["W"]), height=int(g["H"]), tile_size=int(g["tile_size"]),
            rasterize_mode="antialiased" if bool(g["antialiased"]) else "classic",
            render_mode="RGB+ED" if bool(g["with_depth"]) else "RGB",
            max_intersections=1 << 16)
        args = [torch.as_tensor(np.asarray(g[k], np.float32), device=dev)
                for k in ("means", "quats", "scales", "opac", "colors", "viewmat", "K")]
        render, alpha, _ = rasterize(*args, cfg)
        e_r = float(np.abs(render.cpu().numpy() - g["render"]).max())
        e_a = float(np.abs(alpha.cpu().numpy() - g["alpha"]).max())
        require(e_r <= 2e-3 and e_a <= 1e-3,
                f"golden {path.stem}: render err {e_r}, alpha err {e_a}")
        worst[path.stem] = (e_r, e_a)
    require(len(worst) == 4, f"expected 4 goldens, found {sorted(worst)}")
    log(f"# goldens (kernel path): max |render err|, |alpha err| = {worst}")
    return worst


def phase_main(args, dev):
    t0 = time.perf_counter()
    p_sd, a_sd = make_scene_state(args.seed, args.n_bg, args.n_sky, args.n_inst)
    params, aux = scene_from_state_dict(p_sd, a_sd, device=dev)
    n_total = sum(int(a) for a in (
        aux.background.num_alive, aux.skybox.num_alive, aux.instances.num_alive.sum()))
    cfg = configs.mtgs_config(args.width, args.height)
    views = make_views(args.seed, args.views, args.width, args.height, args.focal)
    torch.cuda.synchronize()
    log(f"# scene: {n_total} live gaussians ({args.n_bg} background, {args.n_sky} skybox, "
        f"{args.n_inst} instance), {len(views)} views at {cfg.width}x{cfg.height}, "
        f"built in {time.perf_counter() - t0:.1f} s")

    # ground truth: the plain path's render of each view, on the card
    holes = torch.Generator(device=dev).manual_seed(args.seed + 3)
    batches, train_batches, plain_outs, plain_ms, n_isect = [], [], [], [], []
    for v in views:
        t1 = time.perf_counter()
        with plain_path():
            out = render_view(params, aux, cfg, view_batch(v), 10**9, device=dev)
        torch.cuda.synchronize()
        plain_ms.append(1e3 * (time.perf_counter() - t1))
        n_isect.append(int(out["n_intersections"]))
        plain_outs.append({k: out[k] for k in (*VIEW_TOL, "depth")})
        for dst, b in zip((batches, train_batches), target_batches(out, v, holes)):
            dst.append(b)
    require(max(n_isect) <= cfg.max_intersections,
            f"n_intersections {n_isect} exceed max_intersections "
            f"{cfg.max_intersections}: the render would be truncated")

    # the serving path: kernel launches counted from here ...
    kernel_outs, kernel_calls = [], []
    with views_recorded(kernel_outs, kernel_calls):
        cuda_build.reset_launches()
        t1 = time.perf_counter()
        result = evaluate_scene(params, aux, cfg, batches, eval_cfg=EvalConfig(),
                                device=dev)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t1
        launches = dict(cuda_build.LAUNCHES)
    # ... to here
    require_launches(launches, dict(expand_fused=len(views), blend_forward=len(views)),
                     f"evaluate_scene over {len(views)} views")
    require(result["num_images"] == len(views) == len(kernel_outs)
            and np.isfinite(result["ssim"]), f"bad eval result {result}")

    # every view of that run against its own plain render
    per_view = [view_errors(g, w) for g, w in zip(kernel_outs, plain_outs)]
    for i, e in enumerate(per_view):
        require_view_close(e, cfg.width * cfg.height, f"view {i}")
        a, kw = kernel_calls[i]
        e["depth_flip_causes"] = require_depth_flip_causes(
            lambda: pipeline_mod.render_view(*a, **kw), kernel_outs[i], plain_outs[i],
            f"view {i}")
    rmse = {k: v for k, v in result.items() if k.endswith("depth_RMSE")}
    require(all(v <= DEPTH_RMSE_MAX for v in rmse.values()),
            f"depth RMSE above {DEPTH_RMSE_MAX} m: {rmse}")
    worst = {k: max(e[k] for e in per_view) for k in (*VIEW_TOL, "depth_rel", "depth_flips")}
    worst["psnr_min"] = min(e["psnr"] for e in per_view)

    # steady-state time per view on the kernel path
    view_ms = []
    for b in batches:
        for _ in range(2):
            t1 = time.perf_counter()
            out = render_view(params, aux, cfg, b, 10**9, device=dev)
            torch.cuda.synchronize()
            view_ms.append(1e3 * (time.perf_counter() - t1))
        require(int(out["n_intersections"]) <= cfg.max_intersections, "truncated render")
        require(out["rgb"].shape == (cfg.height, cfg.width, 3), f"rgb {out['rgb'].shape}")
        require(bool(torch.isfinite(out["rgb"]).all() & torch.isfinite(out["depth"]).all()),
                "non-finite render")
    main = dict(
        n_gaussians=n_total, views=len(views), n_intersections=n_isect,
        max_intersections=cfg.max_intersections, launches=launches,
        eval_seconds=eval_s, eval_fps=result["fps"],
        ms_per_view_median=float(np.median(view_ms)),
        plain_ms_per_view_median=float(np.median(plain_ms[1:])),
        psnr=result["psnr"], ssim=result["ssim"], cc_psnr=result["cc_psnr"],
        depth_RMSE=result.get("depth_RMSE"), per_view=per_view, worst_view=worst,
        result=result)
    log(f"# main path: evaluate_scene over {len(views)} views in {eval_s:.2f} s; "
        f"launches {launches}; n_intersections {n_isect} (max {cfg.max_intersections})")
    log(f"# main path, worst view against its plain render: {worst}")
    log(f"# main path: psnr {result['psnr']:.2f} dB, ssim {result['ssim']:.6f}, "
        f"cc_psnr {result['cc_psnr']:.2f} dB vs the plain path; "
        f"median {main['ms_per_view_median']:.2f} ms/view (kernel path), "
        f"{main['plain_ms_per_view_median']:.1f} ms/view (plain path)")
    return params, aux, cfg, batches, main, (p_sd, a_sd, train_batches, views)


def view_batch(v: dict) -> Batch:
    """A view to render (render_view reads no image when not training)."""
    return Batch(image=np.zeros((1, 1, 3), np.float32), mask=np.ones((1, 1, 1), np.float32),
                 **v)


def target_batches(out: dict, v: dict, holes: torch.Generator):
    """(eval batch, training batch) of a view whose ground truth is the
    render `out`: the eval batch carries its depth as LiDAR where alpha >
    0.5; the training batch drops half of those pixels (a LiDAR map with
    holes) and adds the hole-free depth as pseudo depth."""
    alpha = out["accumulation"]
    lidar = torch.where(alpha > 0.5, out["depth"], torch.zeros_like(out["depth"]))
    kept = torch.rand(alpha.shape, generator=holes, device=alpha.device) < 0.5
    return (Batch(image=out["rgb_appearance"], mask=torch.ones_like(alpha),
                  lidar_depth=lidar, **v),
            Batch(image=out["rgb_appearance"], mask=torch.ones_like(alpha),
                  lidar_depth=torch.where(kept, lidar, torch.zeros_like(lidar)),
                  pseudo_depth=out["depth"], **v))


def jittered_state(p_sd, a_sd, seed: int):
    """A copy of the scene state with every alive row's means, features_dc
    and opacity logits jittered (standard deviations JITTER): the
    training start."""
    rng = np.random.default_rng(seed + 101)
    p = copy.deepcopy(p_sd)
    for node, alive in ((p["background"], a_sd["background"]["alive"]),
                        (p["skybox"], a_sd["skybox"]["alive"]),
                        (p["instances"]["node"], a_sd["instances"]["alive"])):
        live = (alive > 0).astype(np.float32)
        for field, sd in JITTER.items():
            a = node[field]
            noise = sd * rng.normal(size=a.shape).astype(np.float32)
            node[field] = a + noise * live.reshape(live.shape + (1,) * (a.ndim - live.ndim))
    return p


def max_scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (max |got| where want is all zero)."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    return err / scale if scale > 0 else err


def phase_grads(cfg, state_sd, batch, dev):
    """One training step's gradients on the kernel path against the same
    step on the plain path. Returns (per-leaf errors, the kernel wrappers'
    arguments captured in that step)."""
    captured, res = {}, {}
    for name, ctx in (("kernel", capturing(captured)), ("plain", plain_path())):
        params, aux = scene_from_state_dict(*state_sd, device=dev)
        t0 = time.perf_counter()
        with ctx:
            total, _, _, sink, grads = loss_and_grads(params, aux, cfg, batch, GRAD_STEP,
                                                      device=dev)
        torch.cuda.synchronize()
        res[name] = dict(grads, absgrad=sink, total=total.reshape(1))
        log(f"# gradients ({name} path): one step in {time.perf_counter() - t0:.2f} s, "
            f"total loss {float(total):.6f}")
    errs = {k: max_scaled_err(res["kernel"][k], w) for k, w in res["plain"].items()}
    require(all(np.isfinite(float(g.abs().max())) for g in res["kernel"].values()
                if g.numel()), "non-finite gradient on the kernel path")
    require(float(res["plain"]["absgrad"].abs().max()) > 0, "absgrad is all zero")
    bad = {k: e for k, e in errs.items() if not e <= GRAD_TOL}
    require(not bad, f"kernel-path gradients differ from the plain path's: {bad}")
    log(f"# gradients, kernel path against plain path (max-scaled, tol {GRAD_TOL}): "
        f"worst {max(errs, key=errs.get)} {max(errs.values()):.3g}")
    return errs, captured, res["kernel"]


def check_steps(trainer, logged, max_intersections: int, v0, *, every_stretch: bool):
    """The checks of a `Trainer.train` run: every step finite with no
    skipped step; no step truncates (n_intersections within the capacity
    of its step, growth included); a refine and a reset fired; on view 0
    (steps v0) the total loss falls within each stretch between opacity
    resets (a reset lowers every opacity to 0.01 and raises the loss), or
    within the last stretch only, and the l1 term falls over the last
    stretch, the one after the reset."""
    for i, m in enumerate(logged):
        require(all(np.isfinite(v) for v in m.values()), f"step {i}: non-finite metrics {m}")
        require(m["nonfinite_grad_step"] == 0, f"step {i} skipped a non-finite gradient")
    limit = max_intersections
    for i, m in enumerate(logged):
        limit = max([limit] + [e["new"] for e in trainer.growth_events
                               if e["node"] == "max_intersections" and e["step"] <= i])
        require(m["n_intersections"] <= limit,
                f"step {i}: {m['n_intersections']} intersections > {limit}: truncated")
    require(trainer.refine_events and trainer.reset_steps,
            f"refines {trainer.refine_events}, resets {trainer.reset_steps}: expected both")
    losses = [m["total_loss"] for m in logged]
    l1 = [m["l1"] for m in logged]
    bounds = [0, *trainer.reset_steps, len(logged)]
    stretches = [[i for i in v0 if lo <= i < hi] for lo, hi in zip(bounds, bounds[1:])]
    for s in stretches if every_stretch else stretches[-1:]:
        require(len(s) >= 2 and losses[s[-1]] < losses[s[0]],
                f"total loss on view 0 did not fall between resets: steps {s}, "
                f"loss {[losses[i] for i in s]}")
    require(l1[stretches[-1][-1]] < l1[stretches[-1][0]],
            f"l1 on view 0 did not fall after the reset: steps {stretches[-1]}, "
            f"l1 {[l1[i] for i in stretches[-1]]}")


def train_config(args, **kw):
    """`mtgs_config(max_steps=TRAIN_STEPS)` with refine_every REFINE_EVERY."""
    cfg = configs.mtgs_config(args.width, args.height, max_steps=TRAIN_STEPS)
    return cfg.replace(control=dataclasses.replace(cfg.control, refine_every=REFINE_EVERY), **kw)


@contextlib.contextmanager
def normal_recorded(draws: list):
    """Appends to `draws` (key, shape, draw) of every `prng.normal` call,
    the key and the draw copied to the host, passing the draws through."""
    saved = prng.normal

    def call(key, shape=()):
        out = saved(key, shape)
        draws.append((key.cpu(), shape, out.cpu()))
        return out

    prng.normal = call
    try:
        yield
    finally:
        prng.normal = saved


def phase_train(args, dev, state_sd, batches):
    """`Trainer.train` on the kernel path with the launch counters zeroed
    just before and read just after."""
    cfg = train_config(args)
    preset = configs.mtgs_config(args.width, args.height, max_steps=TRAIN_STEPS)
    preset = preset.control.refine_every
    log(f"# training: mtgs_config({args.width}, {args.height}, max_steps={TRAIN_STEPS}) "
        f"with control.refine_every overridden {preset} -> {REFINE_EVERY}; start: jitter "
        f"{JITTER}")
    grad_errs, captured, kernel_grads = phase_grads(cfg, state_sd, batches[0], dev)

    params, aux = scene_from_state_dict(*state_sd, device=dev)
    trainer = Trainer(cfg, params, aux, itertools.cycle(batches), seed=args.seed, device=dev)
    n0 = int(trainer.aux.background.num_alive) + int(trainer.aux.skybox.num_alive) \
        + int(trainer.aux.instances.num_alive.sum())
    stamps, logged = [], []

    def on_step(step, metrics):  # called after the step's refine and reset
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        logged.append(metrics)

    torch.cuda.synchronize()
    noise = []
    # the training path: kernel launches counted from here ...
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    with normal_recorded(noise):
        trainer.train(TRAIN_STEPS, log_every=1, callback=on_step)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(cuda_build.LAUNCHES)
    # ... to here
    # the refine's split noise of the background, drawn on the card, is the
    # CPU's draw for the same key and out_cap
    require(noise, "the refine drew no split noise")
    key, shape, eps = noise[0]
    want = prng.normal(key, shape)
    noise_differing = differing(eps, want)
    log(f"# training: the refine's noise normal(key, {tuple(shape)}) for the background "
        f"(out_cap {shape[0]}), drawn on the card: {noise_differing} elements differ from "
        f"the CPU's draw; {len(noise)} draws in the run")
    require(noise_differing == 0, f"the refine's noise on the card differs from the CPU's "
            f"at {noise_differing} elements")
    step_ms = list(1e3 * np.diff([t0] + stamps))
    losses = [m["total_loss"] for m in logged]
    l1 = [m["l1"] for m in logged]
    v0 = list(range(0, len(logged), len(batches)))  # the steps on the view of step 0
    n1 = int(trainer.aux.background.num_alive) + int(trainer.aux.skybox.num_alive) \
        + int(trainer.aux.instances.num_alive.sum())
    res = dict(
        steps=TRAIN_STEPS, refine_every=REFINE_EVERY, jitter=JITTER, seconds=train_s,
        ms_per_step_median=float(np.median(step_ms[2:])), step_ms=step_ms,
        launches=launches, total_loss=losses, l1=l1, psnr=[m["psnr"] for m in logged],
        n_intersections=[m["n_intersections"] for m in logged],
        gaussians_before=n0, gaussians_after=n1, refine_events=trainer.refine_events,
        reset_steps=trainer.reset_steps, growth_events=trainer.growth_events,
        first_metrics=logged[0], last_metrics=logged[-1], grad_errors=grad_errs,
        refine_noise=dict(out_cap=int(shape[0]), draws=len(noise), differing=noise_differing))
    log(f"# training: {len(logged)} steps in {train_s:.2f} s, median "
        f"{res['ms_per_step_median']:.2f} ms/step after 2 warm-up steps; launches {launches}")
    log(f"# training: total loss {losses[0]:.5f} -> {losses[-1]:.5f}, psnr "
        f"{res['psnr'][0]:.2f} -> {res['psnr'][-1]:.2f} dB; per step "
        f"{[round(v, 5) for v in losses]}; l1 on view 0 at steps {v0}: "
        f"{[round(l1[i], 5) for i in v0]}")
    log(f"# training: first step {logged[0]}")
    log(f"# training: last step {logged[-1]}")
    log(f"# training: refines {trainer.refine_events}, opacity resets at {trainer.reset_steps}, "
        f"growth {trainer.growth_events}; gaussians {n0} -> {n1}; n_intersections "
        f"max {max(res['n_intersections'])}")

    require_launches(launches, dict.fromkeys(FUSED_KERNELS, TRAIN_STEPS),
                     f"{TRAIN_STEPS} training steps")
    require(len(logged) == TRAIN_STEPS, f"{len(logged)} steps logged")
    check_steps(trainer, logged, cfg.max_intersections, v0, every_stretch=True)
    return trainer, res, captured, kernel_grads


def capture_faint_step(trainer):
    """The kernel wrappers' arguments in one more step of a trainer after
    its opacity reset (phase 6's: 21 steps after it; phase 9's: 10), the
    scene still faint (the blends evaluate most of each tile's pairs), as
    in the training step that --profile traces after it."""
    captured = {}
    with capturing(captured):
        trainer.train(1)
    torch.cuda.synchronize()
    return captured


def render_errors(got: dict, want: dict) -> float:
    """Largest error between two renders of one view: absolute in the
    images of VIEW_TOL, relative in depth."""
    err = max(float((got[k] - want[k]).abs().max()) for k in VIEW_TOL)
    rel = (got["depth"] - want["depth"]).abs() / torch.clamp(want["depth"].abs(), min=1e-6)
    return max(err, float(rel.max()))


def phase_classic(params, aux, cfg, batches, train_cfg, state_sd, train_batch, fused_grads,
                  dev):
    """The classic path against the fused path on the phase-4 scene and
    views (960x540, I = 2^21, where both fit and both hold every pair):
    each view's render within CLASSIC_TOL["render"], the phase-6 gradient
    step's gradients and absgrad within CLASSIC_TOL["grads"] max-scaled,
    and kernels 5-7 launched on the classic runs only."""
    outs, launches = {}, {}
    for fused in (True, False):
        cuda_build.reset_launches()  # each path's launches counted from here ...
        outs[fused] = [render_view(params, aux, cfg.replace(fused=fused), b, 10**9, device=dev)
                       for b in batches]
        torch.cuda.synchronize()
        launches[fused] = dict(cuda_build.LAUNCHES)  # ... to here
    n = len(batches)
    require_launches(launches[True], dict(expand_fused=n, blend_forward=n), "fused renders")
    require_launches(launches[False], dict(expand_pairs=n, rows_to_attr_major=n,
                                           blend_forward=n), "classic renders")
    render_err = max(render_errors(c, f) for c, f in zip(outs[False], outs[True]))
    require(all(int(o["n_intersections"]) <= cfg.max_intersections for o in outs[False]),
            "classic render truncated")
    require(render_err <= CLASSIC_TOL["render"],
            f"classic renders differ from the fused ones by {render_err}")

    params_c, aux_c = scene_from_state_dict(*state_sd, device=dev)
    cuda_build.reset_launches()
    total, _, _, sink, grads = loss_and_grads(params_c, aux_c, train_cfg.replace(fused=False),
                                              train_batch, GRAD_STEP, device=dev)
    torch.cuda.synchronize()
    grad_launches = dict(cuda_build.LAUNCHES)
    require_launches(grad_launches, {k: 1 for k in KERNELS if k != "expand_fused"},
                     "classic gradient step")
    classic = dict(grads, absgrad=sink, total=total.reshape(1))
    grad_errs = {k: max_scaled_err(classic[k], w) for k, w in fused_grads.items()}
    bad = {k: e for k, e in grad_errs.items() if not e <= CLASSIC_TOL["grads"]}
    require(not bad, f"classic-path gradients differ from the fused path's: {bad}")
    res = dict(render_max_err=render_err, grad_max_err=max(grad_errs.values()),
               worst_grad=max(grad_errs, key=grad_errs.get), grad_errors=grad_errs,
               launches_fused=launches[True], launches_classic=launches[False],
               launches_grad_step=grad_launches, tol=CLASSIC_TOL,
               n_intersections=[int(o["n_intersections"]) for o in outs[False]])
    log(f"# classic vs fused: {n} views, max render error {render_err:.3g}; gradient step "
        f"worst {res['worst_grad']} {res['grad_max_err']:.3g} (tol {CLASSIC_TOL}); launches "
        f"classic {launches[False]}, fused {launches[True]}, classic step {grad_launches}")
    return res, launches[False], grad_launches


def png_size(path: Path):
    """(width, height) from a PNG's IHDR."""
    head = path.read_bytes()[:24]
    require(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", f"{path}: not a PNG")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


def phase_render_tool(args, params, aux, views, dev):
    """`render_camera_path` at 1920x1080 (a camera path through the
    phase-4 cameras, intrinsics rescaled to the render size), the preset
    otherwise with max_intersections RENDER_I: the fused key packing does
    not fit, so every frame takes the classic path. Each frame is held
    against the plain path's render of the same view."""
    W, H = RENDER_SIZE
    cfg = configs.mtgs_config(args.width, args.height).replace(max_intersections=RENDER_I)
    require(not fused_fits(RENDER_I, -(-W // cfg.tile_size) * -(-H // cfg.tile_size), 1),
            "the render's fused key packing fits: phase 8 would not take the classic path")
    out_dir = ROOT / "build" / "chip_smoke" / "render"
    out_dir.mkdir(parents=True, exist_ok=True)
    fy = args.focal * H / args.height
    fov = float(np.rad2deg(2.0 * np.arctan(0.5 * H / fy)))
    frames = [dict(camera_to_world=v["c2w"].reshape(-1).tolist(), fov=fov)
              for v in (views * RENDER_FRAMES)[:RENDER_FRAMES]]
    path = out_dir / "camera_path.json"
    path.write_text(json.dumps(dict(render_width=W, render_height=H, fps=30,
                                    camera_path=frames)))

    calls = []
    saved = render_tool.render_view

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved(*a, **kw)
        torch.cuda.synchronize()
        calls.append(dict(args=(a, kw), ms=1e3 * (time.perf_counter() - t0),
                          out={k: out[k] for k in (*VIEW_TOL, "depth", "n_intersections")}))
        return out

    render_tool.render_view = timed
    try:
        cuda_build.reset_launches()  # the render tool's launches counted from here ...
        t0 = time.perf_counter()
        written = render_tool.render_camera_path(params, aux, cfg, path, out_dir / "frames",
                                                 make_video=False, device=dev)
        tool_s = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)  # ... to here
    finally:
        render_tool.render_view = saved
    n = RENDER_FRAMES
    require(len(written) == len(calls) == n, f"{len(written)} frames written, {len(calls)} renders")
    require_launches(launches, dict(expand_pairs=n, rows_to_attr_major=n, blend_forward=n),
                     "render tool")
    require(all(png_size(p) == (W, H) for p in written), "frames of the wrong size")
    per_frame, plain_ms = [], []
    for i, c in enumerate(calls):
        got = c["out"]
        n_isect = int(got["n_intersections"])
        require(n_isect <= RENDER_I, f"frame {i}: {n_isect} intersections > {RENDER_I}")
        require(got["rgb"].shape == (H, W, 3), f"frame {i}: rgb {tuple(got['rgb'].shape)}")
        t1 = time.perf_counter()
        with plain_path():
            want = saved(*c["args"][0], **c["args"][1])
        torch.cuda.synchronize()
        plain_ms.append(1e3 * (time.perf_counter() - t1))
        e = view_errors(got, want)
        require_view_close(e, W * H, f"frame {i}")
        e["depth_flip_causes"] = require_depth_flip_causes(
            lambda: saved(*c["args"][0], **c["args"][1]), got, want, f"frame {i}")
        per_frame.append(dict(e, n_intersections=n_isect, ms=c["ms"]))
    res = dict(size=[W, H], frames=n, max_intersections=RENDER_I, fov_deg=fov,
               launches=launches, tool_seconds=tool_s,
               ms_per_frame_median=float(np.median([c["ms"] for c in calls[1:]])),
               plain_ms_per_frame_median=float(np.median(plain_ms[1:])),
               per_frame=per_frame,
               worst_frame={k: max(e[k] for e in per_frame)
                            for k in (*VIEW_TOL, "depth_rel", "depth_flips")})
    log(f"# render tool: {n} frames at {W}x{H} through render_camera_path in {tool_s:.2f} s; "
        f"median {res['ms_per_frame_median']:.2f} ms/frame after the first (plain path "
        f"{res['plain_ms_per_frame_median']:.1f}); launches {launches}; n_intersections "
        f"{[e['n_intersections'] for e in per_frame]} (max {RENDER_I})")
    log(f"# render tool, worst frame against its plain render: {res['worst_frame']}")
    return res, calls[-1]["args"], cfg


def scene_pairs(params, aux, cfg, views, dev):
    """The untruncated pair count of each view."""
    return [int(render_view(params, aux, cfg, view_batch(v), 10**9,
                            device=dev)["n_intersections"]) for v in views]


def phase_growth(args, dev):
    """`Trainer.train` across the capacity growth that crosses the fused
    gate: a scene larger than phase 4's (its views make more than
    isect_grow_frac of GROW_FROM pairs) trains from max_intersections
    GROW_FROM (fused) at 960x540; the refine after step 9 grows it to
    GROW_TO, where the fused key packing no longer fits, and every later
    step takes the classic path. Returns (the trainer, the results, the
    kernel wrappers' arguments in a grown gradient step, expand_fused's in
    the run's first step, the run's launches)."""
    cfg = train_config(args, max_intersections=GROW_FROM)
    tiles = cfg.raster_config().tiles_x * cfg.raster_config().tiles_y
    require(fused_fits(GROW_FROM, tiles, 1) and not fused_fits(GROW_TO, tiles, 1),
            "the growth does not cross the fused gate")
    lo, hi = cfg.isect_grow_frac * GROW_FROM, GROW_FROM
    views = make_views(args.seed, args.views, args.width, args.height, args.focal)
    n_bg = args.growth_n_bg
    for attempt in range(2):
        p_sd, a_sd = make_scene_state(args.seed, n_bg, args.n_sky, args.n_inst)
        state_sd = (jittered_state(p_sd, a_sd, args.seed), a_sd)
        params, aux = scene_from_state_dict(*state_sd, device=dev)
        pairs = scene_pairs(params, aux, cfg, views, dev)
        log(f"# growth: {n_bg} background gaussians, start pairs per view {pairs} "
            f"(window ({lo:.0f}, {hi}])")
        if all(lo * 1.01 < p <= hi * 0.99 for p in pairs) or attempt == 1:
            break
        # pairs grow about in proportion to the background: aim at the window's middle
        n_bg = int(n_bg * 0.5 * (lo + hi) / float(np.median(pairs)))
        del params, aux
    require(all(lo < p <= hi for p in pairs),
            f"start pairs {pairs} outside ({lo}, {hi}]: the growth would not fire, "
            "or the fused steps would truncate")

    # targets: the kernel path's renders of the scene before jitter
    holes = torch.Generator(device=dev).manual_seed(args.seed + 5)
    truth, truth_aux = scene_from_state_dict(p_sd, a_sd, device=dev)
    batches = [target_batches(render_view(truth, truth_aux, cfg, view_batch(v), 10**9,
                                          device=dev), v, holes)[1] for v in views]
    del truth, truth_aux
    grown = cfg.replace(max_intersections=GROW_TO)
    grad_errs, captured, _ = phase_grads(grown, state_sd, batches[0], dev)

    trainer = Trainer(cfg, params, aux, itertools.cycle(batches), seed=args.seed, device=dev)
    stamps, logged, per_step = [], [], []
    last = dict(cuda_build.LAUNCHES)

    def on_step(step, metrics):  # called after the step's refine and reset
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        logged.append(metrics)
        per_step.append(launch_delta(last))
        last.update(cuda_build.LAUNCHES)

    torch.cuda.synchronize()
    steps_captured = {}  # the kernel wrappers' arguments of their first calls: step 0 fused
    # the training path across the growth: kernel launches counted from here ...
    cuda_build.reset_launches()
    last.update(cuda_build.LAUNCHES)
    t0 = time.perf_counter()
    with capturing(steps_captured):
        trainer.train(GROWTH_STEPS, log_every=1, callback=on_step)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(cuda_build.LAUNCHES)
    # ... to here
    step_ms = list(1e3 * np.diff([t0] + stamps))
    growth = [e for e in trainer.growth_events if e["node"] == "max_intersections"]
    require(len(growth) == 1 and growth[0]["old"] == GROW_FROM and growth[0]["new"] == GROW_TO,
            f"expected one growth {GROW_FROM} -> {GROW_TO}, got {growth}")
    first_classic = growth[0]["step"]  # the step after the refine that grew it
    fused_step = dict.fromkeys(FUSED_KERNELS, 1)
    classic_step = {k: 1 for k in KERNELS if k != "expand_fused"}
    for i, d in enumerate(per_step):
        require_launches(d, fused_step if i < first_classic else classic_step, f"step {i}")
    require(len(logged) == GROWTH_STEPS, f"{len(logged)} steps logged")
    v0 = list(range(0, len(logged), len(batches)))
    check_steps(trainer, logged, GROW_FROM, v0, every_stretch=False)
    losses = [m["total_loss"] for m in logged]
    res = dict(
        n_bg=n_bg, start_pairs=pairs, steps=GROWTH_STEPS, seconds=train_s, step_ms=step_ms,
        growth=growth, first_classic_step=first_classic, launches=launches,
        ms_per_step_fused_median=float(np.median(step_ms[2:first_classic - 1])),
        ms_per_step_classic_median=float(np.median(step_ms[first_classic + 1:])),
        n_intersections=[m["n_intersections"] for m in logged], total_loss=losses,
        l1=[m["l1"] for m in logged], refine_events=trainer.refine_events,
        reset_steps=trainer.reset_steps, grad_errors=grad_errs)
    log(f"# growth: {GROWTH_STEPS} steps in {train_s:.2f} s; growth {growth}; median "
        f"{res['ms_per_step_fused_median']:.2f} ms/step fused (steps 2-{first_classic - 2}), "
        f"{res['ms_per_step_classic_median']:.2f} ms/step classic (steps "
        f"{first_classic + 1}-{GROWTH_STEPS - 1}); launches {launches}")
    log(f"# growth: n_intersections per step {res['n_intersections']}; total loss "
        f"{[round(v, 5) for v in losses]}; refines {trainer.refine_events}, resets "
        f"{trainer.reset_steps}")
    return trainer, res, captured, {"expand_fused": steps_captured["expand_fused"]}, launches


@contextlib.contextmanager
def wrapped(owner, name: str, wrap):
    """owner.name replaced by wrap(owner.name) inside the with block."""
    saved = getattr(owner, name)
    setattr(owner, name, wrap(saved))
    try:
        yield
    finally:
        setattr(owner, name, saved)


def campaign_recorders(rec: dict):
    """Wrappers that record, around `campaign.main`'s own calls, what phase
    10 checks: the launches of the ground-truth build, of each
    `Trainer.train` call and of the eval; each ladder stage switch; each
    step's host time (between synchronizes), scale, pair count and
    capacity; the refine and reset steps."""
    def gt(fn):
        def call(*a, **kw):
            before = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            scene = fn(*a, **kw)
            torch.cuda.synchronize()
            rec["gt"].append(dict(launches=launch_delta(before), views=scene.frame_rows,
                                  n_gaussians=kw["n_bg"] + kw["n_instance"],
                                  max_intersections=kw["gt_max_intersections"],
                                  seconds=time.perf_counter() - t0))
            return scene
        return call

    def stage(fn):
        def call(self, scale):
            fn(self, scale)
            rec["stages"].append(dict(
                step=self.state.step, scale=scale, width=self.cfg.width,
                height=self.cfg.height, max_intersections=self.cfg.max_intersections,
                base=self._base_cfg.max_intersections))
        return call

    def step(fn):
        def call(self, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = fn(self, batch)
            torch.cuda.synchronize()
            rec["steps"].append(dict(
                ms=1e3 * (time.perf_counter() - t0), scale=self._cur_scale,
                limit=self.cfg.max_intersections, n=m["n_intersections"],
                loss=m["total_loss"], skipped=m["nonfinite_grad_step"]))
            return m
        return call

    def train(fn):
        def call(self, n, **kw):
            before = dict(cuda_build.LAUNCHES)
            s0, r0, z0 = self.state.step, len(self.refine_events), len(self.reset_steps)
            hist = fn(self, n, **kw)
            torch.cuda.synchronize()
            rec["train"].append(dict(steps=self.state.step - s0, launches=launch_delta(before),
                                     loop_stats=dict(self.loop_stats)))
            rec["refines"] += [e["step"] for e in self.refine_events[r0:]]
            rec["resets"] += self.reset_steps[z0:]
            return hist
        return call

    def evaluate(fn):
        def call(params, aux, cfg, batches, **kw):
            before = dict(cuda_build.LAUNCHES)
            n_isect = []

            def render(render_fn):
                def call_view(*a, **k):
                    out = render_fn(*a, **k)
                    n_isect.append(out["n_intersections"])
                    return out
                return call_view

            with wrapped(pipeline_mod, "render_view", render):
                result = fn(params, aux, cfg, batches, **kw)
            torch.cuda.synchronize()
            rec["evals"].append(dict(cfg=cfg, launches=launch_delta(before),
                                     n_intersections=[int(n) for n in n_isect]))
            return result
        return call

    return [(campaign, "make_synthetic_scene", gt), (Trainer, "_set_resolution_stage", stage),
            (Trainer, "step", step), (Trainer, "train", train),
            (campaign, "evaluate_scene", evaluate)]


def campaign_schedule(cargs):
    """The refine and opacity-reset steps of `Trainer.train`'s schedule for
    the campaign's preset, computed from its ControlConfig."""
    return campaign_schedule_for(configs.method_config("mtgs", max_steps=cargs.steps),
                                 cargs.steps)


def campaign_schedule_for(cfg, steps: int):
    """The refine and opacity-reset steps of `Trainer.train`'s schedule for
    `steps` steps of `cfg`, computed from its ControlConfig."""
    cc = cfg.control
    refines, resets = [], []
    for s in range(1, steps + 1):
        if s > cc.densify_from_iter and s % cc.refine_every == 0:
            if s < cc.stop_split_at or cc.continue_cull_post_densification:
                refines.append(s)
            interval = cc.reset_alpha_every * cc.refine_every
            if s < cc.stop_split_at and s % interval == cc.refine_every:
                resets.append(s)
    return refines, resets


def grown_base(base: int, growth: list, step: int) -> int:
    """The ladder's base intersection buffer at `step`: `base` grown by
    isect_grow_factor at each max_intersections growth up to that step."""
    factor = configs.mtgs_config().isect_grow_factor
    for e in growth:
        if e["node"] == "max_intersections" and e["step"] <= step:
            base = int(base * factor)
    return base


def phase_campaign(card: str, dev):
    """`tools/campaign.py::main` in-process on the card: the JAX campaign's
    scene at full width (960x540, 600k ground-truth gaussians, 100k seeds, a
    5k instance, a 100k skybox, 3 traversals x 8 frames, max_intersections
    2^21, ground truth at 6 << 20) for CAMPAIGN_STEPS steps with a
    checkpoint every CAMPAIGN_SAVE_EVERY and main's own teardown and
    resume at the half. The launch counters are zeroed just before main
    and read just after; the parts are read around main's own calls
    (`campaign_recorders`). Then a trainer is rebuilt from --out as a
    crash-resume does, and evaluated; the untrained seed scene is
    evaluated; one full-resolution view and one gradient step of the final
    scene are held against the plain path. Returns (results, the kernel
    wrappers' arguments in that gradient step, the run's launches, the
    rebuilt trainer, the campaign's synthetic scene)."""
    out = ROOT / "build" / "chip_smoke" / "campaign"
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--out", str(out), "--steps", str(CAMPAIGN_STEPS),
            "--save-every", str(CAMPAIGN_SAVE_EVERY)]
    cargs = campaign.parse_args(argv)
    rec = dict(gt=[], stages=[], steps=[], train=[], refines=[], resets=[], evals=[])
    printed = io.StringIO()
    log(f"# campaign ({card}): campaign.main({' '.join(argv)})")
    try:
        with contextlib.ExitStack() as stack:
            for owner, name, wrap in campaign_recorders(rec):
                stack.enter_context(wrapped(owner, name, wrap))
            torch.cuda.synchronize()
            # the campaign path: kernel launches counted from here ...
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                rc = campaign.main(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = dict(cuda_build.LAUNCHES)
            # ... to here
        return campaign_checks(cargs, out, rec, rc, printed.getvalue(), wall_s, launches,
                               card, dev)
    finally:
        # the scene cache and the checkpoints are hundreds of MB: keep only
        # the logs, the JSON results and the previews
        for p in [out / "scene_cache.npz", *out.glob("step-*"), *out.glob("final-step-*")]:
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
            else:
                p.unlink(missing_ok=True)


def campaign_checks(cargs, out: Path, rec: dict, rc, printed: str, wall_s: float,
                    launches: dict, card: str, dev):
    """The checks of phase 10 on what `campaign.main` left in `out` and what
    `campaign_recorders` recorded (phase_campaign)."""
    line = json.loads(printed.strip().splitlines()[-1])
    require(rc == 0 and "value" in line, f"campaign.main returned {rc}, printed {printed!r}")
    summary = json.loads((out / "campaign_summary.json").read_text())
    result = json.loads((out / "eval_result.json").read_text())
    meta = json.loads((out / "resume_meta.json").read_text())
    steps = cargs.steps
    seen, _, train_pairs, eval_pairs = campaign.splits(cargs.n_travels, cargs.n_frames)
    modes = campaign.travel_modes_for(cargs.n_travels)

    # launches of each part: the ground truth takes the path fused_fits picks
    require(len(rec["gt"]) == 1, f"{len(rec['gt'])} ground-truth builds")
    gt = rec["gt"][0]
    tiles = -(-cargs.width // 32) * -(-cargs.height // 32)
    gt_fused = fused_fits(gt["max_intersections"], tiles, gt["n_gaussians"])
    v = gt["views"]
    require(v == cargs.n_travels * cargs.n_frames, f"{v} ground-truth views")
    require_launches(gt["launches"], dict(expand_fused=v, blend_forward=v) if gt_fused else
                     dict(expand_pairs=v, rows_to_attr_major=v, blend_forward=v),
                     f"the {v} ground-truth renders")
    train_l = {k: sum(t["launches"][k] for t in rec["train"]) for k in KERNELS}
    n_steps = sum(t["steps"] for t in rec["train"])
    require(n_steps == steps == len(rec["steps"]), f"{n_steps} steps trained, "
            f"{len(rec['steps'])} recorded, {steps} asked")
    n_classic = train_l["expand_pairs"]
    require_launches(train_l, dict(
        blend_backward=steps, dense_segment_sum=steps, blend_forward=steps,
        expand_fused=steps - n_classic, expand_pairs=n_classic,
        rows_to_attr_major=n_classic, attr_major_to_rows=n_classic), f"{steps} training steps")
    require(len(rec["evals"]) == 1, f"{len(rec['evals'])} evals")
    ev = rec["evals"][0]
    n_ev = len(eval_pairs)
    ev_classic = ev["launches"]["expand_pairs"]
    require_launches(ev["launches"], dict(
        blend_forward=n_ev, expand_fused=n_ev - ev_classic, expand_pairs=ev_classic,
        rows_to_attr_major=ev_classic), f"the eval over {n_ev} views")
    require(all(n <= ev["cfg"].max_intersections for n in ev["n_intersections"]),
            f"eval truncated: {ev['n_intersections']} > {ev['cfg'].max_intersections}")
    previews = 2  # main's two preview renders
    require(launches["blend_forward"] == v + steps + n_ev + previews
            and launches["blend_backward"] == steps,
            f"launches over main {launches} are not the parts' sum")

    # the schedule, computed from the preset, against what ran
    refines, resets = campaign_schedule(cargs)
    resume_at = (steps // 2 // cargs.save_every) * cargs.save_every
    stages = campaign._stages_for(steps)
    require(rec["refines"] == refines and rec["resets"] == resets,
            f"refines {rec['refines']} / resets {rec['resets']}: the schedule says "
            f"{refines} / {resets}")
    scale_at = lambda s: [sc for start, sc in stages if s >= start][-1]
    want_switch = [(start, sc) for start, sc in stages] + [(resume_at, scale_at(resume_at))]
    require([(r["step"], r["scale"]) for r in rec["stages"]] == want_switch,
            f"stage switches {rec['stages']}, expected {want_switch}")
    growth = summary["growth_events"]
    for r in rec["stages"]:
        k = int(round(1.0 / r["scale"]))
        base = grown_base(cargs.max_isect, growth, r["step"])
        isect = ((max(int(base * r["scale"] ** 2), 1 << 14) + 511) // 512) * 512
        require((r["width"], r["height"], r["base"], r["max_intersections"])
                == (cargs.width // k, cargs.height // k, base, isect),
                f"stage {r}: expected {cargs.width // k}x{cargs.height // k}, base {base}, "
                f"max_intersections {isect}")

    # every step finite, none skipped, none truncated
    per = {k: torch.stack([r[k].reshape(()).float() for r in rec["steps"]]).tolist()
           for k in ("n", "loss", "skipped")}
    limits = [r["limit"] for r in rec["steps"]]
    require(all(np.isfinite(per["loss"])) and not any(per["skipped"]),
            "a campaign step was non-finite or skipped")
    over = [(i, n, lim) for i, (n, lim) in enumerate(zip(per["n"], limits)) if n > lim]
    require(not over, f"campaign steps truncated (step, n_intersections, max): {over[:5]}")

    # the resume: main's teardown ran, rotation kept two, the final checkpoint is stripped
    require((out / "RESUME_DEMO_DONE").read_text() == str(resume_at) and summary["resume_demo"],
            "the mid-run teardown and resume did not run")
    kept = sorted(p.name for p in out.glob("step-*"))
    require(len(kept) <= 2, f"rotating checkpoints kept: {kept}")
    final = torch.load(checkpoint.payload_path(out / f"final-step-{steps:09d}"),
                       map_location="cpu", weights_only=True)
    require("opt_state" not in final and final["step"] == steps,
            f"final checkpoint keys {sorted(final)}")
    del final

    # a crash-resume from --out: capacities padded, the scene restored, the eval repeated
    scene = campaign._scene_cache_roundtrip(out / "scene_cache.npz", lambda: None)
    eval_batches = [campaign.make_batch(scene, t, f, 1.0, dev) for t, f in eval_pairs]
    rebuilt = campaign.build_trainer(cargs, scene, train_pairs, caps=meta["caps"],
                                     base_max_isect=meta["base_max_intersections"])
    require(campaign.try_resume(out, rebuilt) == steps, "the rebuilt trainer did not resume")
    require(campaign.node_caps(rebuilt.state.params) == meta["caps"] == summary["caps"],
            f"rebuilt capacities {campaign.node_caps(rebuilt.state.params)} vs {meta['caps']}")
    again = evaluate_scene(rebuilt.state.params, rebuilt.aux, ev["cfg"], eval_batches,
                           travel_modes=modes, device=dev)
    diff = {k: abs(again[k] - result[k]) for k in result if k not in ("fps", "num_images")
            and not (np.isnan(again[k]) and np.isnan(result[k]))}
    require(max(diff.values()) <= CAMPAIGN_EVAL_TOL and again["num_images"] == n_ev,
            f"the rebuilt trainer's eval differs from eval_result.json: {diff}")
    keys = ("psnr", "cc_psnr", "ssim", "depth_RMSE", "depth_absRel", "depth_delta1")
    missing = [p + k for k in keys for p in ["", *(f"trv{t}_" for t in range(cargs.n_travels))]
               if not np.isfinite(result.get(p + k, np.nan))]
    require(not missing, f"eval_result.json lacks {missing}")

    # the untrained seed scene on the same views
    seed_trainer = campaign.build_trainer(cargs, scene, train_pairs)
    untrained = evaluate_scene(seed_trainer.state.params, seed_trainer.aux, ev["cfg"],
                               eval_batches, travel_modes=modes, device=dev)
    del seed_trainer
    seen_psnr = float(np.mean([result[f"trv{t}_psnr"] for t in seen]))
    seen_psnr0 = float(np.mean([untrained[f"trv{t}_psnr"] for t in seen]))
    require(seen_psnr >= seen_psnr0 + CAMPAIGN_PSNR_GAIN,
            f"seen-split psnr {seen_psnr:.3f} dB, untrained {seen_psnr0:.3f} dB: gained "
            f"less than {CAMPAIGN_PSNR_GAIN} dB")

    # the kernels on the trained scene: one full-resolution view and one step
    (t, f), b = eval_pairs[0], eval_batches[0]
    view = lambda: render_view(rebuilt.state.params, rebuilt.aux, ev["cfg"], b, 10**9,
                               travel_mode=modes[t], device=dev)
    got = view()
    with plain_path():
        want = view()
    view_err = view_errors(got, want)
    require_view_close(view_err, cargs.width * cargs.height, "campaign: trained-scene view")
    view_err["depth_flip_causes"] = require_depth_flip_causes(
        view, got, want, "campaign: trained-scene view")
    del got, want
    train_batch = campaign.make_batch(scene, *train_pairs[0], 1.0, dev)
    grads = trained_scene_grads(rebuilt, ev["cfg"], train_batch)
    captured = grads.pop("captured")

    by_stage = {}
    for r in rec["steps"]:
        by_stage.setdefault(r["scale"], []).append(r["ms"])
    loop = {k: sum(t["loop_stats"][k] for t in rec["train"])
            for k in ("dispatch_s", "refine_s", "sync_s", "steps")}
    res = dict(
        card=card, argv=cargs.__dict__, wall_s=wall_s, gt=gt, gt_fused=gt_fused,
        launches=launches, train_launches=train_l, eval_launches=ev["launches"],
        eval_n_intersections=ev["n_intersections"],
        stages=rec["stages"], refines=rec["refines"], resets=rec["resets"],
        resume_at=resume_at, kept_checkpoints=kept,
        ms_per_step_by_scale={str(s): float(np.median(v)) for s, v in by_stage.items()},
        steps_by_scale={str(s): len(v) for s, v in by_stage.items()},
        step_ms=[r["ms"] for r in rec["steps"]], n_intersections=per["n"],
        max_intersections=limits, total_loss=per["loss"], loop_stats=loop,
        train_calls=[dict(steps=t["steps"], loop_stats=t["loop_stats"]) for t in rec["train"]],
        growth_events=growth, summary=summary, eval=result, eval_fps=result["fps"],
        rebuilt_eval_max_diff=max(diff.values()), untrained_eval=untrained,
        seen_psnr=seen_psnr, untrained_seen_psnr=seen_psnr0, view_errors=view_err,
        grads=grads, campaign_line=line)
    log(f"# campaign ({card}): {steps} steps in {wall_s:.1f} s (ground truth "
        f"{gt['seconds']:.1f} s, {'fused' if gt_fused else 'classic'} path); ms/step by "
        f"scale (median, host clock between synchronizes) {res['ms_per_step_by_scale']} "
        f"over {res['steps_by_scale']} steps; loop_stats {loop}")
    log(f"# campaign ({card}): stages {rec['stages']}; refines {rec['refines']}, resets "
        f"{rec['resets']}, resume at {resume_at}; growth {growth}; alive "
        f"{summary['seed_alive']} -> {summary['final_alive']}; caps {summary['caps']}")
    log(f"# campaign ({card}): launches {launches} (training {train_l}, eval "
        f"{ev['launches']}); step n_intersections max {max(per['n'])}")
    log(f"# campaign ({card}): eval {json.dumps({k: round(x, 4) for k, x in result.items() if not k.startswith('trv')})}; "
        f"seen psnr {seen_psnr:.3f} dB (untrained {seen_psnr0:.3f}); eval fps "
        f"{result['fps']:.2f}; rebuilt eval max diff {res['rebuilt_eval_max_diff']:.3g}")
    log(f"# campaign ({card}): trained-scene view vs plain {view_err}")
    return res, captured, launches, rebuilt, scene


def nuplan_fixture():
    """tests/make_nuplan_fixture.py, the road block's generator (numpy only
    for what phase 11 calls)."""
    spec = importlib.util.spec_from_file_location(
        "make_nuplan_fixture", ROOT / "tests" / "make_nuplan_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass resolves annotations through it
    spec.loader.exec_module(mod)
    return mod


def nuplan_decoders(fx, root: Path, records) -> dict:
    """The port's decoders on the committed JPEGs against the manifest of
    PIL's decodes (block means within NUPLAN_MEANS_TOL; whether the SHA-256
    matches, i.e. bit-equal to PIL), and host times on this machine: a
    1920x1080 decode, a `load_sample` (decode, undistort, resize to
    960x540, masks and depth), and `SampleCache`'s prefetch of the training
    records."""
    manifest = json.loads((root / "manifest.json").read_text())
    decode_ms, sha_equal, worst = [], 0, 0.0
    for rel, entry in sorted(manifest["images"].items()):
        t0 = time.perf_counter()
        img = image_io.read_image(root / rel)
        decode_ms.append(1e3 * (time.perf_counter() - t0))
        require(img.shape == (manifest["height"], manifest["width"], 3), f"{rel}: {img.shape}")
        err = float(np.abs(fx.block_means(img) - np.asarray(entry["block_means"])).max())
        require(err <= NUPLAN_MEANS_TOL, f"{rel}: block means off PIL's by {err}")
        worst = max(worst, err)
        sha_equal += hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"]
    cfg = SampleConfig(scale_factor=0.5)
    sample_ms = []
    for rec in records[:4]:
        t0 = time.perf_counter()
        s = load_sample(rec, cfg)
        sample_ms.append(1e3 * (time.perf_counter() - t0))
        require(s["image"].shape == (NUPLAN_SIZE[1], NUPLAN_SIZE[0], 3),
                f"load_sample: {s['image'].shape}")
    # the parts of one sample (the undistortion map is cached by now)
    img = image_io.read_image(records[0].image_path).astype(np.float32) / 255.0
    t0 = time.perf_counter()
    und, _, _ = undistort_image(img, records[0].intrinsic, records[0].distortion, cfg.undistort)
    undistort_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    image_io.resize(und, cfg.scale_factor)
    resize_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    cache = data_loader.SampleCache(records, cfg, strategy="prefetch", num_workers=4)
    cache._pool.shutdown(wait=True)  # every prefetch done
    prefetch_s = time.perf_counter() - t0
    require(len(cache._cache) == len(records), "SampleCache did not prefetch every record")
    cache.close()
    res = dict(jpegs=len(decode_ms), sha256_equal=sha_equal, block_means_max_err=worst,
               decode_ms=decode_ms, decode_ms_median=float(np.median(decode_ms)),
               load_sample_ms=sample_ms, load_sample_ms_median=float(np.median(sample_ms)),
               undistort_rgb_ms=undistort_ms, resize_rgb_ms=resize_ms,
               prefetch_records=len(records), prefetch_s=prefetch_s)
    log(f"# nuplan decoders: {sha_equal}/{len(decode_ms)} JPEGs bit-equal to PIL (SHA-256), "
        f"block means max err {worst:.2e}; 1920x1080 decode median {res['decode_ms_median']:.1f} "
        f"ms; load_sample (to 960x540) median {res['load_sample_ms_median']:.1f} ms (of it the "
        f"image's undistortion {undistort_ms:.1f}, its resize {resize_ms:.1f}); "
        f"SampleCache prefetch of {len(records)} records with 4 threads {prefetch_s:.2f} s")
    return res


def nuplan_main(argv, rec: dict):
    """`train_scene.main(argv)` in-process with the launch counters zeroed
    just before and read just after, each `Trainer.step` timed between
    synchronizes and the launches of the eval read around its own call.
    Returns (printed text, launches, wall seconds)."""
    def step(fn):
        def call(self, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = fn(self, batch)
            torch.cuda.synchronize()
            rec["steps"].append(dict(ms=1e3 * (time.perf_counter() - t0),
                                     n=int(m["n_intersections"]),
                                     limit=self.cfg.max_intersections,
                                     loss=float(m["total_loss"]),
                                     skipped=float(m["nonfinite_grad_step"])))
            return m
        return call

    def evaluate(fn):
        def call(params, aux, cfg, batches, **kw):
            before = dict(cuda_build.LAUNCHES)
            batches = list(batches)
            result = fn(params, aux, cfg, batches, **kw)
            torch.cuda.synchronize()
            rec["evals"].append(dict(views=len(batches), launches=launch_delta(before)))
            return result
        return call

    printed = io.StringIO()
    pipeline_eval = importlib.import_module("mtgs_torch.eval.pipeline")
    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(Trainer, "step", step))
        stack.enter_context(wrapped(pipeline_eval, "evaluate_scene", evaluate))
        torch.cuda.synchronize()
        # the nuPlan path: kernel launches counted from here ...
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = train_scene.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        # ... to here
    require(rc == 0, f"train_scene.main returned {rc}: {printed.getvalue()[-2000:]}")
    return printed.getvalue(), launches, wall_s


def require_nuplan_run(launches: dict, rec: dict, steps: int, what: str) -> None:
    """A main run's launches: the four fused kernels once per training step
    (none of the classic ones), both forward kernels once per eval view;
    every step finite, none skipped or truncated."""
    require(len(rec["steps"]) == steps, f"{what}: {len(rec['steps'])} steps, expected {steps}")
    require(len(rec["evals"]) == 1, f"{what}: {len(rec['evals'])} evals")
    views = rec["evals"][0]["views"]
    require_launches(rec["evals"][0]["launches"], dict(expand_fused=views, blend_forward=views),
                     f"{what}: the eval over {views} views")
    require_launches(launches, dict(expand_fused=steps + views, blend_forward=steps + views,
                                    blend_backward=steps, dense_segment_sum=steps),
                     f"{what}: {steps} fused training steps and the eval")
    bad = [(i, r) for i, r in enumerate(rec["steps"])
           if not np.isfinite(r["loss"]) or r["skipped"] or r["n"] > r["limit"]]
    require(not bad, f"{what}: non-finite, skipped or truncated steps {bad[:3]}")


def phase_nuplan(card: str, dev):
    """The nuPlan path through `tools/train_scene.py` at full width on the
    committed road block (tests/fixtures/nuplan_block: 3 traversals x 4
    frames of 1920x1080 JPEGs through a distorting camera, the rest written
    from the seed): the decoders against PIL's manifest; the untrained
    model's eval on the val split (traversal 2, unseen); `main` for
    NUPLAN_STEPS steps of the `mtgs` preset at 960x540 (scale 0.5, the
    JPEGs undistorted by `optimal_new_K`); `main --resume` in a fresh folder
    holding only the step-100 checkpoint; the eval psnr NUPLAN_PSNR_GAIN
    above the untrained one; `eval_setup` + `evaluate_scene` repeating
    eval_result.json; `render_interpolated` of traversal 0 at 1920x1080
    (classic path), one frame against the plain path. Returns (results,
    the launches of the phase's runs, what phase 13 reads: the held-out
    records, samples and batches, the run and its work directory, which the
    caller removes after phase 13)."""
    fx = nuplan_fixture()
    work = Path(tempfile.mkdtemp(prefix="nuplan_", dir=ROOT / "build"))
    t0 = time.perf_counter()
    try:
        res, launches, held_out = _phase_nuplan(fx, work, card, dev)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    res["phase_s"] = time.perf_counter() - t0
    log(f"# nuplan ({card}): phase 11 took {res['phase_s']:.1f} s")
    return res, launches, dict(held_out, work=work)


def _phase_nuplan(fx, work: Path, card: str, dev):
    t0 = time.perf_counter()
    root = fx.materialize(work / "road_block")
    setup_s = time.perf_counter() - t0
    argv = ["--data", str(root), "--method", "mtgs", "--scale", "0.5",
            "--width", str(NUPLAN_SIZE[0]), "--height", str(NUPLAN_SIZE[1]),
            "--travels", "0", "1", "--eval-travels", "2",
            "--steps", str(NUPLAN_STEPS), "--save-every", str(NUPLAN_SAVE_EVERY),
            "--device", str(dev)]
    t0 = time.perf_counter()
    scene = parse_scene(root, split="train", train_travels=[0, 1], eval_travels=[2])
    parse_s = time.perf_counter() - t0
    require(len(scene.records) == 8 and scene.seed_xyz is not None and len(scene.instances) == 2,
            f"parsed {len(scene.records)} records, {len(scene.instances)} instances")
    decoders = nuplan_decoders(fx, root, scene.records)

    # the untrained model on the eval split
    cfg = configs.method_config("mtgs", width=NUPLAN_SIZE[0], height=NUPLAN_SIZE[1],
                                max_steps=NUPLAN_STEPS)
    params0, aux0 = train_scene.build_model_from_parsed(scene, cfg, SampleConfig(), device=dev)
    ev = parse_scene(root, split="val", train_travels=[0, 1], eval_travels=[2],
                     load_points=False)
    cache = data_loader.SampleCache(ev.records, SampleConfig(scale_factor=0.5),
                                    strategy="on_demand")
    eval_samples = [cache.get(i) for i in range(len(ev.records))]
    eval_batches = [data_loader.batch_from_sample(r, s, device=dev)
                    for r, s in zip(ev.records, eval_samples)]
    before = dict(cuda_build.LAUNCHES)
    untrained = evaluate_scene(params0, aux0, cfg, eval_batches, device=dev)
    n_ev = len(eval_batches)
    require_launches(launch_delta(before), dict(expand_fused=n_ev, blend_forward=n_ev),
                     "the untrained eval")
    n_gauss = sum(int(a.alive.sum()) for a in (aux0.background, aux0.skybox))
    n_gauss += int(aux0.instances.alive.sum())
    del params0, aux0

    # train
    out = work / "run"
    rec = dict(steps=[], evals=[])
    printed, launches, wall_s = nuplan_main(argv + ["--out", str(out)], rec)
    require_nuplan_run(launches, rec, NUPLAN_STEPS, "train_scene.main")
    result = json.loads((out / "eval_result.json").read_text())
    kept = sorted(p.name for p in out.glob("step-*"))
    require(kept == [f"step-{NUPLAN_SAVE_EVERY:09d}", f"step-{NUPLAN_STEPS:09d}"],
            f"checkpoints kept: {kept}")
    require(result["num_images"] == n_ev and result["psnr"] >= untrained["psnr"] + NUPLAN_PSNR_GAIN,
            f"eval psnr {result['psnr']:.3f} dB against {untrained['psnr']:.3f} untrained: gained "
            f"less than {NUPLAN_PSNR_GAIN} dB")

    # resume from the step-100 checkpoint alone
    fresh = work / "resumed"
    fresh.mkdir()
    shutil.copytree(out / f"step-{NUPLAN_SAVE_EVERY:09d}", fresh / f"step-{NUPLAN_SAVE_EVERY:09d}")
    restored = checkpoint.checkpoint_layout(fresh / f"step-{NUPLAN_SAVE_EVERY:09d}")
    require(restored["has_optimizer"], "the step-100 checkpoint has no optimizer state")
    rrec = dict(steps=[], evals=[])
    rprinted, rlaunches, rwall_s = nuplan_main(argv + ["--out", str(fresh), "--resume"], rrec)
    resumed_steps = NUPLAN_STEPS - restored["step"]
    want = f"resumed from step-{NUPLAN_SAVE_EVERY:09d} (step {restored['step']})"
    require(want in rprinted, f"the resume printed no {want!r}: {rprinted[:2000]}")
    require_nuplan_run(rlaunches, rrec, resumed_steps, "train_scene.main --resume")
    resumed = json.loads((fresh / "eval_result.json").read_text())

    # eval_setup repeats the run's eval
    params, aux, rcfg, rscene, run_cfg = train_scene.eval_setup(out, device=dev)
    again = evaluate_scene(params, aux, rcfg, eval_batches, device=dev)
    diff = {k: abs(again[k] - result[k]) for k in result if k not in ("fps", "num_images")
            and not (np.isnan(again[k]) and np.isnan(result[k]))}
    require(max(diff.values()) <= NUPLAN_EVAL_TOL,
            f"eval_setup's eval differs from eval_result.json: {diff}")

    # render_interpolated at 1920x1080: the classic path
    W, H = RENDER_SIZE
    icfg = configs.mtgs_config(W, H).replace(max_intersections=RENDER_I)
    calls = []
    saved = render_tool.render_view

    def timed_view(*a, **k):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        o = saved(*a, **k)
        torch.cuda.synchronize()
        calls.append(dict(args=(a, k), ms=1e3 * (time.perf_counter() - t1),
                          out={n: o[n] for n in (*VIEW_TOL, "depth", "n_intersections")}))
        return o

    render_tool.render_view = timed_view
    try:
        cuda_build.reset_launches()  # render_interpolated's launches counted from here ...
        t0 = time.perf_counter()
        frames = render_tool.render_interpolated(
            params, aux, icfg, rscene, 0, work / "frames", cameras=("CAM_F0",),
            target_hz=INTERP_HZ, make_video=False, device=dev)
        interp_s = time.perf_counter() - t0
        ilaunches = dict(cuda_build.LAUNCHES)  # ... to here
    finally:
        render_tool.render_view = saved
    n = len(frames)
    require(n == len(calls) == 10, f"{n} frames written, {len(calls)} renders")
    require_launches(ilaunches, dict(expand_pairs=n, rows_to_attr_major=n, blend_forward=n),
                     "render_interpolated")
    require(all(png_size(p) == (W, H) for p in frames), "frames of the wrong size")
    require(all(int(c["out"]["n_intersections"]) <= RENDER_I for c in calls),
            "render_interpolated truncated a frame")
    c = calls[n // 2]
    with plain_path():
        want_view = saved(*c["args"][0], **c["args"][1])
    frame_err = view_errors(c["out"], want_view)
    require_view_close(frame_err, W * H, "render_interpolated: the middle frame")
    frame_err["depth_flip_causes"] = require_depth_flip_causes(
        lambda: saved(*c["args"][0], **c["args"][1]), c["out"], want_view,
        "render_interpolated: the middle frame")
    del want_view

    total = {k: launches[k] + rlaunches[k] + ilaunches[k] for k in KERNELS}
    step_ms = [r["ms"] for r in rec["steps"]]
    res = dict(
        card=card, setup_s=setup_s, parse_s=parse_s, n_gaussians=n_gauss, decoders=decoders,
        untrained_eval=untrained, eval=result, resumed_eval=resumed,
        eval_setup_max_diff=max(diff.values()), wall_s=wall_s, resumed_wall_s=rwall_s,
        ms_per_step_median=float(np.median(step_ms[2:])), step_ms=step_ms,
        resumed_ms_per_step_median=float(np.median([r["ms"] for r in rrec["steps"]][2:])),
        n_intersections_max=max(r["n"] for r in rec["steps"]), launches=launches,
        resumed_launches=rlaunches, resumed_from=restored["step"], resumed_steps=resumed_steps,
        interp=dict(frames=n, seconds=interp_s, launches=ilaunches,
                    ms_per_frame_median=float(np.median([c["ms"] for c in calls[1:]])),
                    n_intersections=[int(c["out"]["n_intersections"]) for c in calls],
                    middle_frame_vs_plain=frame_err),
        total_launches=total, printed_tail=printed[-1500:])
    held_out = dict(records=ev.records, samples=eval_samples, batches=eval_batches,
                    run=out)
    log(f"# nuplan ({card}): road block written in {setup_s:.1f} s, parsed in {parse_s:.1f} s "
        f"({len(scene.records)} records, {len(scene.seed_xyz)} seeds, {n_gauss} gaussians)")
    log(f"# nuplan ({card}): main {NUPLAN_STEPS} steps in {wall_s:.1f} s, ms/step median "
        f"{res['ms_per_step_median']:.2f} (host clock between synchronizes); launches "
        f"{launches}; resumed from step {restored['step']}: {resumed_steps} steps in "
        f"{rwall_s:.1f} s, launches {rlaunches}")
    log(f"# nuplan ({card}): eval psnr {result['psnr']:.3f} dB (untrained "
        f"{untrained['psnr']:.3f}, resumed run {resumed['psnr']:.3f}); ssim {result['ssim']:.4f}; "
        f"eval_setup max diff {res['eval_setup_max_diff']:.3g}")
    log(f"# nuplan ({card}): render_interpolated {n} frames at {W}x{H} in {interp_s:.2f} s, "
        f"median {res['interp']['ms_per_frame_median']:.2f} ms/frame after the first; launches "
        f"{ilaunches}; middle frame vs plain {frame_err}")
    return res, total, held_out


def seeded_lpips_weights(rng) -> dict:
    """LPIPS-Alex at its published widths (the five convolutions of
    `eval/lpips.py::_ALEX`), `lin` weights non-negative."""
    w, in_ch = {}, 3
    for i, (out_ch, k, _, _, _) in enumerate(lpips_mod._ALEX):
        w[f"conv{i}_w"] = rng.standard_normal((out_ch, in_ch, k, k), np.float32) * np.float32(
            (in_ch * k * k) ** -0.5)
        w[f"conv{i}_b"] = rng.standard_normal(out_ch, np.float32) * np.float32(0.1)
        w[f"lin{i}_w"] = rng.random(out_ch, np.float32)
        in_ch = out_ch
    return w


def seeded_dinov2_weights(rng, D: int, heads: int, layers: int, hidden: int, patch: int,
                          grid: int) -> dict:
    """DINOv2 in the canonical layout: projections N(0, 1/fan_in), LayerNorms
    near 1, LayerScale 0.05-0.15, embeddings N(0, 0.02)."""
    def n(*shape, scale):
        return rng.standard_normal(shape, np.float32) * np.float32(scale)

    w = dict(patch_w=n(D, 3, patch, patch, scale=(3 * patch * patch) ** -0.5),
             patch_b=n(D, scale=0.02), cls=n(D, scale=0.02), pos=n(1 + grid * grid, D, scale=0.02),
             norm_w=1 + n(D, scale=0.1), norm_b=n(D, scale=0.02), heads=np.asarray(heads),
             patch=np.asarray(patch))
    for i in range(layers):
        w.update({f"L{i}_{k}": n(D, D, scale=D ** -0.5) for k in ("q_w", "k_w", "v_w", "o_w")})
        w.update({f"L{i}_{k}": n(D, scale=0.02) for k in ("q_b", "k_b", "v_b", "o_b", "n1_b",
                                                          "n2_b", "fc2_b")})
        w.update({f"L{i}_n1_w": 1 + n(D, scale=0.1), f"L{i}_n2_w": 1 + n(D, scale=0.1),
                  f"L{i}_ls1": rng.uniform(0.05, 0.15, D).astype(np.float32),
                  f"L{i}_ls2": rng.uniform(0.05, 0.15, D).astype(np.float32),
                  f"L{i}_fc1_w": n(hidden, D, scale=D ** -0.5), f"L{i}_fc1_b": n(hidden, scale=0.02),
                  f"L{i}_fc2_w": n(D, hidden, scale=hidden ** -0.5)})
    return w


@contextlib.contextmanager
def weight_files(lpips_path: Path, dinov2_path: Path):
    """MTGS_LPIPS_WEIGHTS / MTGS_DINOV2_WEIGHTS pointed at the two files
    inside the block, restored after it."""
    names = ("MTGS_LPIPS_WEIGHTS", "MTGS_DINOV2_WEIGHTS")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(dict(zip(names, (str(lpips_path), str(dinov2_path)))))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def psnr_u8(got: np.ndarray, want: np.ndarray) -> float:
    mse = float(np.mean((got.astype(np.float64) - want.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def jpeg_manifest():
    """tests/make_jpeg_manifest.py (numpy only for `make_array`) and its
    manifest of PIL's hashes."""
    spec = importlib.util.spec_from_file_location(
        "make_jpeg_manifest", ROOT / "tests" / "make_jpeg_manifest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, json.loads(mod.MANIFEST.read_text())


def eval_export_scores(view, lp_params: dict, dv_weights: dict, dev, profile: bool) -> dict:
    """Both forwards at one view on the card and on the CPU (the same port
    code), their self-scores, and their times: LPIPS of the masked render
    against the masked ground truth (one batch of two), DINOv2 patch tokens
    of the render's 518x518 crop; host ms of the crop. With `profile`, also
    a torch.profiler breakdown of one forward of each."""
    out, batch = view
    pred = out["rgb_appearance"] * batch.mask
    gt = batch.image * batch.mask
    lp_cpu = {k: v.cpu() for k, v in lp_params.items()}
    lp_card = float(lpips_mod.lpips_forward(lp_params, pred, gt))
    lp_host = float(lpips_mod.lpips_forward(lp_cpu, pred.cpu(), gt.cpu()))
    lp_err = abs(lp_card - lp_host)
    require(lp_err <= LPIPS_TOL["abs"] + LPIPS_TOL["rel"] * abs(lp_host),
            f"LPIPS on the card {lp_card} against the CPU's {lp_host}")
    lp_self = float(lpips_mod.lpips_forward(lp_params, pred, pred))
    require(abs(lp_self) <= SELF_TOL, f"lpips(x, x) = {lp_self}")

    rgb = out["rgb_appearance"].cpu().numpy()
    crop_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        x = dinov2_mod._resize_center_crop(rgb, nearest=False)
        crop_ms.append(1e3 * (time.perf_counter() - t0))
    x = torch.as_tensor((x - 0.5) / 0.5)
    xd = x.to(dev)
    dv_cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in dv_weights.items()}
    tok_card = dinov2_mod.dinov2_forward(dv_weights, xd).cpu()
    t0 = time.perf_counter()
    tok_host = dinov2_mod.dinov2_forward(dv_cpu, x)
    host_forward_s = time.perf_counter() - t0
    dv_err = float((tok_card - tok_host).abs().max())
    excess = float(((tok_card - tok_host).abs()
                    - DINOV2_TOL["rtol"] * tok_host.abs()).max())
    require(excess <= DINOV2_TOL["atol"],
            f"DINOv2 patch tokens on the card off the CPU's by up to {dv_err}")
    with torch.no_grad():
        lp_ms = cuda_ms(lambda: lpips_mod.lpips_forward(lp_params, pred, gt), reps=10)
        dv_ms = cuda_ms(lambda: dinov2_mod.dinov2_forward(dv_weights, xd), reps=10)
        prof = None if not profile else dict(
            lpips=phase_profile("one LPIPS forward (a view: render and ground truth)",
                                lambda: lpips_mod.lpips_forward(lp_params, pred, gt)),
            dinov2=phase_profile("one DINOv2 ViT-B/14 forward (518x518)",
                                 lambda: dinov2_mod.dinov2_forward(dv_weights, xd)))
    H, W = pred.shape[:2]
    return dict(lpips_card=lp_card, lpips_cpu=lp_host, lpips_abs_err=lp_err,
                lpips_self=lp_self, dinov2_tokens_max_abs_err=dv_err,
                dinov2_tokens_shape=list(tok_card.shape), dinov2_cpu_forward_s=host_forward_s,
                view_hw=[H, W], lpips_ms_per_view=lp_ms, dinov2_ms_per_forward=dv_ms,
                dinov2_ms_per_view=2 * dv_ms, crop_host_ms=crop_ms,
                crop_host_ms_median=float(np.median(crop_ms)), profile=prof)


def gaussian_exports(node, aux, out: Path) -> dict:
    """The trained background through the three exporters, timed; the .ply
    read back must give the node's parameters exactly."""
    n = int(aux.num_alive)
    secs = {}
    for fmt in ("ply", "splat", "point_cloud"):
        t0 = time.perf_counter()
        path = getattr(gaussian_export, f"export_{fmt}")(node, aux, out / f"background.{fmt}")
        secs[fmt] = time.perf_counter() - t0
        require(path.exists() and path.stat().st_size > 0, f"{path}: not written")
    require((out / "background.splat").stat().st_size == 32 * n, ".splat: not 32 bytes a record")
    back = gaussian_export.read_gaussian_ply(out / "background.ply")
    host = lambda t: t[:n].detach().cpu().numpy()
    want = dict(means=host(node.means), quats=host(node.quats), opacities=host(node.opacities),
                features_dc=host(node.features_dc),
                scales=np.broadcast_to(host(node.scales), (n, 3)))
    rest = node.features_rest if node.features_rest.ndim == 3 else node.features_rest[:, 0]
    if rest.shape[1]:
        want["features_rest"] = host(rest)
    bad = [k for k, v in want.items() if not np.array_equal(back.get(k), v)]
    require(not bad, f"read_gaussian_ply gave back other {bad}")
    return dict(gaussians=n, seconds=secs,
                seconds_per_1e5={k: v * 1e5 / n for k, v in secs.items()},
                bytes={fmt: (out / f"background.{fmt}").stat().st_size
                       for fmt in ("ply", "splat", "point_cloud")})


def phase_eval_export(card: str, dev, nuplan_res: dict, held_out: dict, weights,
                      profile: bool = False):
    """Phase 13: eval scoring and export on phase 11's trained road block
    (after phase 12, so that phases 4-12 run as before it was added).
    Seeded LPIPS-Alex and DINOv2 ViT-B/14 weights at the published widths
    written to `weights` (two paths under build/chip_smoke/, which the
    caller removes after phase 14), pointed at by MTGS_LPIPS_WEIGHTS /
    MTGS_DINOV2_WEIGHTS for phases 13-14 only; `eval_setup` on the run, then
    `evaluate_scene` with both metrics on over the held-out traversal and
    `export_eval_images` in its three modes, the launch counters zeroed just
    before and read just after (the two forward kernels once per view of
    each); the other metrics equal to an eval with both off; both forwards
    on the card against the CPU at one view; every written JPEG decoded by
    the port's decoder, PSNR >= EXPORT_PSNR_MIN against the array it
    encodes; the encoder's bytes against PIL's manifest; the trained
    background through tools/export.py; `profile` adds a torch.profiler
    breakdown of one LPIPS and one DINOv2 forward. Returns (results,
    launches)."""
    t_phase = time.perf_counter()
    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
            "TF32 is on: the f32 LPIPS convolutions and DINOv2 matmuls would round to TF32")
    for label in ("untrained_eval", "eval", "resumed_eval"):
        found = {"lpips", "dinov2_sim"} & set(nuplan_res[label])
        require(not found, f"phase 11's {label} scored {found}: a weight file was found")
    records, samples, batches = held_out["records"], held_out["samples"], held_out["batches"]
    work, n_ev = held_out["work"], len(batches)

    rng = np.random.default_rng(EVAL_EXPORT_SEED)
    t0 = time.perf_counter()
    lp_path, dv_path = weights
    np.savez(lp_path, **seeded_lpips_weights(rng))
    np.savez(dv_path, **seeded_dinov2_weights(rng, **VITB))
    weights_s = time.perf_counter() - t0
    export_root = work / "export"
    with weight_files(lp_path, dv_path):
        params, aux, rcfg, _, _ = train_scene.eval_setup(held_out["run"], device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        off = evaluate_scene(params, aux, rcfg, batches,
                             eval_cfg=EvalConfig(lpips=False, dinov2=False), device=dev)
        torch.cuda.synchronize()
        eval_off_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lp_params = lpips_mod.load_weights(lp_path, dev)
        dv_weights = dinov2_mod.load_weights(dv_path, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n_params = sum(v.numel() for v in dv_weights.values() if isinstance(v, torch.Tensor))
        lp_fn, dv_fn = lpips_mod.get_lpips(dev), dinov2_mod.get_dinov2(dev)
        require(lp_fn is not None and dv_fn is not None, "a weight file was not found")

        writes, warps = [], []

        def timed_write(fn):
            def call(path, img):
                t1 = time.perf_counter()
                p = fn(path, img)
                writes.append(dict(path=Path(p), img=img,
                                   ms=1e3 * (time.perf_counter() - t1)))
                return p
            return call

        def timed_warp(fn):
            def call(*a, **k):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                o = fn(*a, **k)
                torch.cuda.synchronize()
                warps.append(1e3 * (time.perf_counter() - t1))
                return o
            return call

        metas = [dict(raw_path=r.image_path, K_raw=r.intrinsic, dist=r.distortion,
                      K_und=s["K"], raw_hw=(r.height, r.width),
                      rel_path="/".join(Path(r.image_path).parts[-3:]))
                 for r, s in zip(records, samples)]
        written = {}
        with contextlib.ExitStack() as stack:
            stack.enter_context(wrapped(pipeline_mod, "write_jpeg", timed_write))
            stack.enter_context(wrapped(pipeline_mod, "redistort_image", timed_warp))
            torch.cuda.synchronize()
            # the eval and export path: kernel launches counted from here ...
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            on = evaluate_scene(params, aux, rcfg, batches,
                                eval_cfg=EvalConfig(lpips=True, dinov2=True), device=dev)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            eval_launches = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            for mode in ("sequential", "sequential_with_gt", "nuplan"):
                written[mode] = export_eval_images(
                    params, aux, rcfg, batches, export_root / mode, mode=mode,
                    view_metas=metas, device=dev)
            torch.cuda.synchronize()
            export_s = time.perf_counter() - t0
            launches = dict(cuda_build.LAUNCHES)
            # ... to here
        require_launches(eval_launches, dict(expand_fused=n_ev, blend_forward=n_ev),
                         f"phase 13: the eval over {n_ev} views")
        require_launches(launches, dict(expand_fused=4 * n_ev, blend_forward=4 * n_ev),
                         f"phase 13: the eval and three exports of {n_ev} views")
        new_keys = {"lpips", "dinov2_sim"}
        new_keys |= {f"trv{int(b.travel_index)}_{k}" for b in batches for k in new_keys}
        require(set(on) == set(off) | new_keys, f"eval keys {sorted(set(on) ^ set(off))}")
        require(all(np.isfinite(on[k]) for k in new_keys),
                f"non-finite scores {({k: on[k] for k in new_keys})}")
        diff = {k: abs(on[k] - off[k]) for k in off if k not in ("fps", "num_images")
                and not (np.isnan(on[k]) and np.isnan(off[k]))}
        require(max(diff.values()) <= EVAL_EXPORT_TOL,
                f"metrics moved with LPIPS and DINOv2 on: {diff}")

        with torch.no_grad():
            view = render_view(params, aux, rcfg, batches[0], 10**9, device=dev)
        scores = eval_export_scores((view, batches[0]), lp_params, dv_weights, dev, profile)
        x = view["rgb_appearance"]
        dv_self = dv_fn(x, x, batches[0].mask.squeeze())
        require(abs(dv_self - 1.0) <= SELF_TOL, f"dinov2_sim(x, x) = {dv_self}")
        scores["dinov2_sim_self"] = dv_self

    # every written file decodes to its array's shape, PSNR >= the floor
    by_path = {str(w["path"]): w for w in writes}
    files = {}
    for mode, paths in written.items():
        rows = []
        for p in paths:
            if p.endswith("_gt.jpg"):  # the raw ground truth's symlink
                require(Path(p).is_symlink() and Path(p).resolve().exists(),
                        f"{p}: the symlink does not resolve")
                rows.append(dict(path=p, symlink_to=os.readlink(p)))
                continue
            w = by_path[p]
            dec = image_io.read_image(p)
            require(dec.shape == w["img"].shape, f"{p}: decoded {dec.shape}, wrote "
                    f"{w['img'].shape}")
            rows.append(dict(path=os.path.relpath(p, export_root), shape=list(dec.shape),
                             psnr=psnr_u8(dec, w["img"]), bytes=Path(p).stat().st_size))
            require(rows[-1]["psnr"] >= EXPORT_PSNR_MIN,
                    f"{p}: PSNR {rows[-1]['psnr']:.2f} dB against its array")
        files[mode] = rows
    want_shapes = dict(sequential=tuple(batches[0].image.shape),
                       nuplan=(records[0].height, records[0].width, 3))
    for mode, shape in want_shapes.items():
        require(all(tuple(r["shape"]) == shape for r in files[mode]),
                f"{mode}: shapes {[r['shape'] for r in files[mode]]}, expected {shape}")
    require(len(files["sequential_with_gt"]) == 3 * n_ev,
            f"sequential_with_gt wrote {len(files['sequential_with_gt'])} files")

    # the encoder against PIL's manifest (no PIL here)
    mfx, manifest = jpeg_manifest()
    sha = []
    for entry in manifest["arrays"]:
        img = mfx.make_array(entry)
        data = image_io.encode_jpeg(img)
        sha.append(dict(name=entry["name"],
                        equal=hashlib.sha256(data).hexdigest() == entry["sha256"]))
    require(all(e["equal"] for e in sha), f"encoder bytes off PIL's manifest: {sha}")
    grad = mfx.make_array(manifest["arrays"][-1])
    encode_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        image_io.encode_jpeg(grad)
        encode_ms.append(1e3 * (time.perf_counter() - t0))
    frames = [w["ms"] for w in writes if w["img"].shape[:2] == (1080, 1920)]

    gexp = gaussian_exports(params.background, aux.background, work)
    res = dict(
        card=card, weights_s=weights_s, load_s=load_s, dinov2_params=n_params, views=n_ev,
        eval=on, eval_off=off, eval_max_diff=max(diff.values()), eval_s=eval_s,
        eval_off_s=eval_off_s,
        export_s=export_s, launches=launches, eval_launches=eval_launches, scores=scores,
        files=files, manifest_sha256=sha, write_jpeg_ms_1920x1080=frames,
        write_jpeg_ms_1920x1080_median=float(np.median(frames)),
        encode_gradient_ms=encode_ms, encode_gradient_ms_median=float(np.median(encode_ms)),
        redistort_ms=warps, redistort_ms_median=float(np.median(warps)),
        gaussian_export=gexp)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"# eval+export ({card}): lpips {on['lpips']:.4f}, dinov2_sim {on['dinov2_sim']:.4f} over "
        f"{n_ev} views (other metrics off by at most {res['eval_max_diff']:.2g}); eval {eval_s:.2f} "
        f"s ({eval_off_s:.2f} without the two; both weight files load in {load_s:.2f} s), "
        f"exports {export_s:.2f} s; launches {launches}")
    log(f"# eval+export ({card}): LPIPS {scores['lpips_ms_per_view']:.3f} ms/view, DINOv2 "
        f"{scores['dinov2_ms_per_forward']:.3f} ms/forward (ViT-B/14, {n_params} parameters), "
        f"crop {scores['crop_host_ms_median']:.2f} ms host; card vs CPU: lpips err "
        f"{scores['lpips_abs_err']:.2g}, tokens err {scores['dinov2_tokens_max_abs_err']:.2g}")
    log(f"# eval+export ({card}): write_jpeg 1920x1080 median {res['write_jpeg_ms_1920x1080_median']:.1f}"
        f" ms, redistort_image median {res['redistort_ms_median']:.2f} ms/frame, min PSNR "
        f"{min(r['psnr'] for rows in files.values() for r in rows if 'psnr' in r):.2f} dB; "
        f"manifest {sum(e['equal'] for e in sha)}/{len(sha)} equal; gaussian export of "
        f"{gexp['gaussians']}: {gexp['seconds_per_1e5']} s per 1e5; phase 13 took "
        f"{res['phase_s']:.1f} s")
    return res, launches


def http_get(url: str):
    """(status, headers, body) of one GET."""
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def spread(xs) -> dict:
    """Median and spread of a list of times."""
    q = np.percentile(xs, [0, 25, 50, 75, 100])
    return dict(median=float(q[2]), q25=float(q[1]), q75=float(q[3]), min=float(q[0]),
                max=float(q[4]), n=len(xs))


def view_query(record) -> dict:
    """The viewer's camera query at a dataset camera: its position, and the
    yaw and pitch of its view direction (the viewer's camera has no roll;
    its forward is (-cos p cos y, -cos p sin y, -sin p))."""
    c2w = np.asarray(record.c2w, np.float64)
    fwd = -c2w[:3, 2]
    pos = c2w[:3, 3]
    return dict(px=repr(float(pos[0])), py=repr(float(pos[1])), pz=repr(float(pos[2])),
                yaw=repr(float(np.arctan2(-fwd[1], -fwd[0]))),
                pitch=repr(float(np.arcsin(np.clip(-fwd[2], -1.0, 1.0)))))


def counting(reads: dict, name: str):
    """A wrap for `wrapped` that counts the calls in reads[name]."""
    def wrap(fn):
        def call(*a, **kw):
            reads[name] += 1
            return fn(*a, **kw)
        return call
    return wrap


def phase_viewer(card: str, dev, held_out: dict, weights):
    """Phase 14: the viewer on phase 11's trained run. `viewer_from_run` (what
    `python -m mtgs_torch.viewer.server --run` serves) on the card, served on
    127.0.0.1:0 in a thread: the page, /meta, /render for every output x
    both rungs x each traversal, `mean` and `null` x t in VIEWER_STAMPS at
    a held-out camera (each a JPEG the port's decoder opens at the rung's
    size, byte-equal to `ViewerServer.render` in-process, launching the
    kernels of the path `fused_fits` picks once; the full rung's rgb frames
    against the plain path within VIEW_TOL["rgb"]), /export byte-equal to
    tools/export.py, 500 and 404; each rung timed over VIEWER_REQUESTS HTTP
    round trips after VIEWER_WARMUP, and in-process split into render +
    sync, colourise + copy and the q85 encode; `evaluate_scene` twice with
    the phase-13 weight files, the loaders counted (the second call reads
    no file); the q85 encoder against PIL's manifest. Returns (results, the
    launches of the /render requests)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    srv = viewer_server.viewer_from_run(held_out["run"], device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    W, H = srv.cfg.width, srv.cfg.height
    n_gauss = node_segments(srv.params)[-1][2]
    base_q = view_query(held_out["records"][0])
    travels = [str(t) for t in srv.travels] + ["mean", "null"]
    rungs = dict(full=("0", 1), lowres=("1", viewer_server.LOWRES_SCALE))
    paths = {}
    for rung, (_, scale) in rungs.items():
        rc = srv._get_cfg("index", scale).raster_config()
        fused = rc.fused and fused_fits(rc.max_intersections, rc.tiles_x * rc.tiles_y, n_gauss)
        paths[rung] = dict(
            fused=fused, size=[rc.width, rc.height], max_intersections=rc.max_intersections,
            launches=dict(expand_fused=1, blend_forward=1) if fused else
            dict(expand_pairs=1, rows_to_attr_major=1, blend_forward=1))
    tmp = held_out["work"] / "viewer"
    tmp.mkdir(parents=True, exist_ok=True)

    http = srv.make_server(0, "127.0.0.1")
    thread = threading.Thread(target=http.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{http.server_port}"
    try:
        status, headers, body = http_get(url + "/")
        require(status == 200 and headers.get("Content-Type") == "text/html"
                and body == viewer_server._PAGE.encode(), f"/: status {status}, not the page")
        status, _, body = http_get(url + "/meta")
        meta = json.loads(body)
        require(status == 200 and meta["travels"] == srv.travels
                and meta["init_cam"] == dict(pos=srv.init_pos, yaw=0.0, pitch=0.0)
                and 0 < len(meta["cameras"]) <= viewer_server.MAX_CAMERAS
                and meta["cameras"] == srv.cameras, f"/meta: status {status}, {str(meta)[:300]}")

        frames = []
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        # the viewer's /render path: kernel launches counted from here ...
        for rung, (lowres, scale) in rungs.items():
            for travel, t, output in itertools.product(travels, VIEWER_STAMPS,
                                                       viewer_server.OUTPUTS):
                q = dict(base_q, travel=travel, t=t, output=output, lowres=lowres)
                before = dict(cuda_build.LAUNCHES)
                status, headers, body = http_get(url + "/render?" + urllib.parse.urlencode(q))
                launches = launch_delta(before)
                what = f"/render ({rung}, travel {travel}, t {t}, {output})"
                require(status == 200 and headers.get("Content-Type") == "image/jpeg",
                        f"{what}: status {status} {body[:300]!r}")
                require_launches(launches, paths[rung]["launches"], what)
                (tmp / "frame.jpg").write_bytes(body)
                shape = image_io.read_image(tmp / "frame.jpg").shape
                require(shape == (H // scale, W // scale, 3), f"{what}: decoded {shape}")
                require(body == srv.render(q), f"{what}: the bytes differ from render() "
                        "in-process")
                row = dict(rung=rung, travel=travel, t=t, output=output, bytes=len(body))
                if rung == "full" and output == "rgb":
                    mode, sc, batch, _ = srv.request(q)
                    got = srv.render_outputs(mode, sc, batch)
                    with plain_path():
                        want = srv.render_outputs(mode, sc, batch)
                    err = float((srv._colorize(got, "rgb") - srv._colorize(want, "rgb"))
                                .abs().max())
                    row.update(rgb_err_vs_plain=err,
                               psnr_vs_plain=float(masked_psnr(got["rgb"], want["rgb"])),
                               covered=float((got["accumulation"] > 0.5).float().mean()))
                    require(err <= VIEW_TOL["rgb"],
                            f"{what}: kernel path vs plain path {err} > {VIEW_TOL['rgb']}")
                    require(row["covered"] > 0.05, f"{what}: the camera sees little "
                            f"({row['covered']:.3f} of the pixels covered)")
                frames.append(row)
        render_launches = dict(cuda_build.LAUNCHES)
        # ... to here

        timing = {}
        for rung, (lowres, scale) in rungs.items():
            q = dict(base_q, travel=travels[0], t="0", output="rgb", lowres=lowres)
            full_url = url + "/render?" + urllib.parse.urlencode(q)
            for _ in range(VIEWER_WARMUP):
                http_get(full_url)
            round_trip = []
            for _ in range(VIEWER_REQUESTS):
                t0 = time.perf_counter()
                status, _, body = http_get(full_url)
                round_trip.append(1e3 * (time.perf_counter() - t0))
                require(status == 200, f"timed /render ({rung}): status {status}")
            mode, sc, batch, kind = srv.request(q)
            split = dict(render=[], colorize=[], encode=[])
            for _ in range(VIEWER_REQUESTS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = srv.render_outputs(mode, sc, batch)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                frame = srv.frame(out, kind)  # the copy to the host waits for the device
                t2 = time.perf_counter()
                image_io.encode_jpeg(frame, quality=viewer_server.JPEG_QUALITY)
                t3 = time.perf_counter()
                for k, a, b in (("render", t0, t1), ("colorize", t1, t2), ("encode", t2, t3)):
                    split[k].append(1e3 * (b - a))
            timing[rung] = dict(size=paths[rung]["size"], fused=paths[rung]["fused"],
                                http_ms=spread(round_trip),
                                **{f"{k}_ms": spread(v) for k, v in split.items()})

        exports = {}
        for fmt, (fn, name) in dict(ply=(gaussian_export.export_ply, "scene.ply"),
                                    splat=(gaussian_export.export_splat, "scene.splat"),
                                    pcd=(gaussian_export.export_point_cloud,
                                         "points.ply")).items():
            status, headers, body = http_get(url + f"/export?format={fmt}")
            want = fn(srv.params.background, srv.aux.background, tmp / name).read_bytes()
            require(status == 200 and body == want, f"/export?format={fmt}: status {status}, "
                    f"{len(body)} bytes against the export tool's {len(want)}")
            exports[fmt] = len(body)
        status, _, body = http_get(url + "/export?format=xyz")
        require(status == 500 and body == b"unknown export format xyz",
                f"/export?format=xyz: status {status} {body[:200]!r}")
        status = http_get(url + "/nope")[0]
        require(status == 404, f"/nope: status {status}")
    finally:
        http.shutdown()
        http.server_close()
        thread.join(timeout=60)
    require(not thread.is_alive(), "the viewer's server thread did not stop")

    # evaluate_scene twice with the weight files: the second reads neither
    lpips_mod.cached_weights.cache_clear()
    dinov2_mod.cached_weights.cache_clear()
    reads = dict(lpips=0, dinov2=0)
    evals = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(weight_files(*weights))
        stack.enter_context(wrapped(lpips_mod, "load_weights", counting(reads, "lpips")))
        stack.enter_context(wrapped(dinov2_mod, "load_weights", counting(reads, "dinov2")))
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = evaluate_scene(srv.params, srv.aux, srv.cfg, held_out["batches"],
                                    device=dev)
            torch.cuda.synchronize()
            evals.append(dict(seconds=time.perf_counter() - t0, reads=dict(reads),
                              result=result))
    require([e["reads"] for e in evals] == [dict(lpips=1, dinov2=1)] * 2,
            f"weight files read per evaluate_scene: {[e['reads'] for e in evals]} (want one "
            "read of each, in the first call only)")
    first, second = (e["result"] for e in evals)
    require({"lpips", "dinov2_sim"} <= set(first), f"eval keys {sorted(first)}")
    same = json.dumps({k: v for k, v in first.items() if k != "fps"}, sort_keys=True) == \
        json.dumps({k: v for k, v in second.items() if k != "fps"}, sort_keys=True)
    require(same, "the second evaluate_scene differs from the first")

    # the viewer's encoder quality against PIL's manifest (no PIL here)
    mfx, manifest = jpeg_manifest()
    q85 = [dict(name=e["name"], equal=hashlib.sha256(image_io.encode_jpeg(
        mfx.make_array(e), quality=viewer_server.JPEG_QUALITY)).hexdigest() == e["q85"]["sha256"])
        for e in manifest["arrays"]]
    require(all(e["equal"] for e in q85), f"q85 encoder bytes off PIL's manifest: {q85}")

    res = dict(card=card, setup_s=setup_s, size=[W, H], gaussians=n_gauss, query=base_q,
               travels=travels, paths=paths, frames=frames, launches=render_launches,
               timing=timing, export_bytes=exports, manifest_q85=q85,
               eval_twice=[dict(seconds=e["seconds"], reads=e["reads"]) for e in evals],
               cameras=len(srv.cameras))
    res["phase_s"] = time.perf_counter() - t_phase
    full = [f for f in frames if "rgb_err_vs_plain" in f]
    log(f"# viewer ({card}): viewer_from_run in {setup_s:.2f} s ({n_gauss} gaussians, travels "
        f"{srv.travels}, {len(srv.cameras)} cameras); {len(frames)} /render requests, launches "
        f"{render_launches}; paths {({k: v['fused'] for k, v in paths.items()})} (fused)")
    log(f"# viewer ({card}): full-rung rgb against the plain path: max err "
        f"{max(f['rgb_err_vs_plain'] for f in full):.3g}, min psnr "
        f"{min(f['psnr_vs_plain'] for f in full):.2f} dB, covered "
        f"{min(f['covered'] for f in full):.3f}-{max(f['covered'] for f in full):.3f}")
    for rung, tm in timing.items():
        log(f"# viewer ({card}): {rung} {tm['size'][0]}x{tm['size'][1]}: /render "
            f"{tm['http_ms']['median']:.2f} ms median (IQR {tm['http_ms']['q25']:.2f}-"
            f"{tm['http_ms']['q75']:.2f}, {tm['http_ms']['n']} requests); in-process render "
            f"{tm['render_ms']['median']:.2f}, colourise + copy {tm['colorize_ms']['median']:.2f},"
            f" encode q{viewer_server.JPEG_QUALITY} {tm['encode_ms']['median']:.2f} ms")
    log(f"# viewer ({card}): evaluate_scene with LPIPS and DINOv2 {evals[0]['seconds']:.3f} s "
        f"then {evals[1]['seconds']:.3f} s; loads {[e['reads'] for e in evals]}; exports "
        f"{exports} bytes; q85 manifest {sum(e['equal'] for e in q85)}/{len(q85)} equal; phase 14 "
        f"took {res['phase_s']:.1f} s")
    return res, render_launches


def bench_launches(fused: bool, steps: int, gt_views: int, gt_fused: bool) -> dict:
    """The launches `tools/bench_train.py` must make: the ground truth's
    renders (the path `fused_fits` picks at its buffer) and `steps`
    training steps on the fused or the classic path."""
    want = collections.Counter()
    for k in ("expand_fused",) if gt_fused else ("expand_pairs", "rows_to_attr_major"):
        want[k] += gt_views
    want["blend_forward"] += gt_views
    for k in FUSED_KERNELS if fused else ("expand_pairs", "rows_to_attr_major", "blend_forward",
                                          "blend_backward", "dense_segment_sum",
                                          "attr_major_to_rows"):
        want[k] += steps
    return dict(want)


def profile_launches(fused: bool, calls: int, traced: int) -> dict:
    """The launches `tools/profile_raster.py` must make: each stage `calls`
    times (a warm-up and the timed iterations), the roofline's one gather,
    and `traced` more forward + backward steps."""
    n, fb = calls, calls + traced
    if fused:  # stages +expand, +pair sort, full forward, fwd+bwd; the roofline's gather
        return dict(expand_fused=2 * n + n + fb + 1, blend_forward=n + fb,
                    blend_backward=fb, dense_segment_sum=fb)
    # stages projection+binning, full forward, fwd+bwd; the roofline's binning and slab
    return dict(expand_pairs=2 * n + fb + 1, rows_to_attr_major=n + fb + 1,
                blend_forward=n + fb, blend_backward=fb, dense_segment_sum=fb,
                attr_major_to_rows=fb)


def phase_observability(args, card: str, dev, state_sd, batches):
    """Phase 15: observability and the bench tools. `Trainer.train(OBS_STEPS,
    writer=JsonlWriter)` on phase 4's scene from phase 6's start (every
    metric key, and step_ms / rays_per_s from the second step, in the file;
    the fused kernels once per step); `observability.trace` around
    OBS_TRACE_STEPS more steps and `summarize_trace`, whose entries must name
    the four fused kernels as the CUDA sources do, once per step as counted;
    `tools/bench_train.py` and `tools/profile_raster.py` at their defaults,
    classic and `--fused` (the latter with `--trace`), their launches
    counted. Returns (results, the launches of its runs)."""
    t_phase = time.perf_counter()
    out = ROOT / "build" / "chip_smoke" / "observability"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    total = collections.Counter()

    cfg = train_config(args)
    params, aux = scene_from_state_dict(*state_sd, device=dev)
    trainer = Trainer(cfg, params, aux, itertools.cycle(batches), seed=args.seed, device=dev)
    writer = observability.JsonlWriter(str(out / "train.jsonl"), steps_per_log=1)
    torch.cuda.synchronize()
    before = dict(cuda_build.LAUNCHES)
    t0 = time.perf_counter()
    history = trainer.train(OBS_STEPS, writer=writer)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    writer.close()
    launches = launch_delta(before)
    total.update(launches)
    require_launches(launches, dict.fromkeys(FUSED_KERNELS, OBS_STEPS),
                     f"Trainer.train({OBS_STEPS}, writer=...)")
    rows = [json.loads(line) for line in (out / "train.jsonl").read_text().splitlines()]
    keys = set(history[0])
    require([r["step"] for r in rows] == list(range(OBS_STEPS)),
            f"the writer logged steps {[r['step'] for r in rows]}")
    for i, r in enumerate(rows):
        want = keys | {"step"} | ({"step_ms", "rays_per_s"} if i else set())
        require(set(r) == want, f"logged step {i}: keys {sorted(set(r) ^ want)} differ")
        require(all(np.isfinite(v) for v in r.values()), f"logged step {i}: {r}")

    trace_dir = out / "trace"
    before = dict(cuda_build.LAUNCHES)
    t0 = time.perf_counter()
    with observability.trace(str(trace_dir)) as tr:
        trainer.train(OBS_TRACE_STEPS)
    trace_s = time.perf_counter() - t0
    tlaunches = launch_delta(before)
    total.update(tlaunches)
    top = observability.summarize_trace(str(trace_dir), top=10 ** 6, iters=OBS_TRACE_STEPS)
    traced = {}
    for k in FUSED_KERNELS:
        hits = [(ms, n, name) for ms, n, name in top if KERNEL_SYMBOLS[k] in name]
        traced[k] = dict(ms_per_step=sum(h[0] for h in hits), per_step=sum(h[1] for h in hits),
                         names=[h[2] for h in hits])
        require(hits and traced[k]["per_step"] * OBS_TRACE_STEPS == tlaunches[k]
                == OBS_TRACE_STEPS, f"trace: {k} ({KERNEL_SYMBOLS[k]}) {traced[k]}, counted "
                f"{tlaunches[k]} launches in {OBS_TRACE_STEPS} steps")

    bench = {}
    n_tiles = -(-960 // 32) * -(-540 // 32)
    gt_fused = fused_fits(bench_train.gt_capacity(960, 540), n_tiles, 780_000 + 20_000)
    for label, argv in (("classic", []), ("fused", ["--fused"])):
        buf = io.StringIO()
        torch.cuda.synchronize()
        before = dict(cuda_build.LAUNCHES)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            bench_train.main(argv)
        seconds = time.perf_counter() - t0
        launches = launch_delta(before)
        total.update(launches)
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        require(rec["unit"] == "iters/s" and rec["value"] > 0
                and rec["device"] == torch.cuda.get_device_name(0)
                and rec["fused"] == (label == "fused"), f"bench_train {argv}: {rec}")
        require_launches(launches, bench_launches(label == "fused", 21, 6, gt_fused),
                         f"bench_train {argv}")
        bench[label] = dict(rec, seconds=seconds, launches=launches)
        log(f"# bench_train {' '.join(argv) or '(defaults)'} ({card}): {rec['value']} iters/s "
            f"({1e3 / rec['value']:.2f} ms/step), {seconds:.1f} s with the scene; launches "
            f"{launches}")

    raster = {}
    for label, argv in (("classic", []), ("fused", ["--fused", "--trace",
                                                    str(out / "raster_trace")])):
        buf = io.StringIO()
        before = dict(cuda_build.LAUNCHES)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = profile_raster.main(argv)
        seconds = time.perf_counter() - t0
        launches = launch_delta(before)
        total.update(launches)
        printed = buf.getvalue()
        for line in printed.splitlines():
            log(f"# profile_raster {label}: {line}")
        require("H100" in printed and "x off" in printed, f"profile_raster {argv}: no roofline")
        require_launches(launches, profile_launches(label == "fused", 11,
                                                    6 if "--trace" in argv else 0),
                         f"profile_raster {argv}")
        raster[label] = dict(result, seconds=seconds, launches=launches)

    total = {k: total[k] for k in KERNELS}
    res = dict(card=card, train_steps=OBS_STEPS, train_s=train_s, logged_rows=len(rows),
               step_ms_logged=[r.get("step_ms") for r in rows], last_row=rows[-1],
               trace=dict(steps=OBS_TRACE_STEPS, seconds=trace_s, path=os.path.relpath(
                   tr.path, ROOT), bytes=os.path.getsize(tr.path), kernels=traced,
                   top=top[:25]),
               bench_train=bench, profile_raster=raster, launches=total)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"# observability ({card}): Trainer.train({OBS_STEPS}, writer=JsonlWriter) in "
        f"{train_s:.2f} s, {len(rows)} rows, step_ms (EMA) at the last step "
        f"{rows[-1]['step_ms']:.2f}; trace of {OBS_TRACE_STEPS} steps "
        f"({res['trace']['bytes']} bytes) in {trace_s:.2f} s: "
        f"{({k: round(v['ms_per_step'], 4) for k, v in traced.items()})} ms a step")
    for ms, n, name in top[:12]:
        log(f"#   {ms:9.3f} ms  x{n:<4d} {name[:100]}")
    log(f"# observability ({card}): phase 15 took {res['phase_s']:.1f} s")
    return res, total


def trained_scene_grads(trainer, cfg, batch, label: str = "campaign",
                        all_plain_first: bool = False):
    """One gradient step of a trained scene (at the trainer's step) on the
    kernel path, held within GRAD_TOL (max-scaled, every leaf) of the same
    step with every kernel but the forward blend swapped for its plain
    version (with all_plain_first: of the all-plain step, and only where
    L1 sign flips show of the step with the kernel forward blend on both
    sides; `held_against` says which). The forward blend is held on its own at this step's inputs
    (phase 5's `at_campaign` row) and in a view of the scene: with the
    plain forward in the reference too, the comparison would be
    ill-conditioned here, as the all-plain errors and `l1_sign_flips`
    recorded beside it show. On a trained scene many pixels' residuals lie
    within the two forwards' rounding (~1e-6), so the sign of the L1 terms
    flips between them; each flip moves a colour gradient by about
    w * 2 / (3 H W), against a largest colour gradient that training has
    made small."""
    captured = {}
    no_fwd = {k: fn for k, fn in PLAIN.items() if k != "blend_forward"}
    runs = {}
    for name, ctx in (("kernel", capturing(captured)), ("plain_but_forward",
                      kernels_replaced(no_fwd)), ("plain", plain_path())):
        with ctx:
            total, losses, out, sink, g = loss_and_grads(
                trainer.state.params, trainer.aux, cfg, batch, trainer.state.step,
                device=trainer.device)
        torch.cuda.synchronize()
        runs[name] = (dict(g, absgrad=sink, total=total.reshape(1)), out["rgb_appearance"])
    ref, rgb_ref = runs["plain_but_forward"]
    got, rgb = runs["kernel"]
    errs = {k: max_scaled_err(got[k], w) for k, w in ref.items()}
    require(all(np.isfinite(float(x.abs().max())) for x in got.values() if x.numel()),
            f"{label}: non-finite gradient on the trained scene")
    plain, rgb_plain = runs["plain"]
    all_plain = {k: max_scaled_err(got[k], w) for k, w in plain.items()}
    gt = torch.as_tensor(batch.image, device=rgb.device)
    flips = int((torch.sign(rgb - gt) != torch.sign(rgb_plain - gt)).sum())
    held = "plain_but_forward"
    if all_plain_first:
        held = "plain" if all(e <= GRAD_TOL for e in all_plain.values()) else held
        require(held == "plain" or flips > 0,
                f"{label}: gradients differ from the all-plain path's with no L1 sign flip: "
                f"{ {k: e for k, e in all_plain.items() if not e <= GRAD_TOL} }")
    bad = {k: e for k, e in errs.items() if not e <= GRAD_TOL}
    require(held == "plain" or not bad, f"{label}: trained-scene gradients differ from the "
            f"plain path's (its forward blend the kernel's): {bad}")
    res = dict(held_against=held,
               errors=errs, worst=max(errs, key=errs.get), max_err=max(errs.values()),
               all_plain_errors=all_plain, all_plain_worst=max(all_plain, key=all_plain.get),
               all_plain_max_err=max(all_plain.values()), l1_sign_flips=flips,
               forward_rgb_max_diff=float((rgb - rgb_plain).abs().max()),
               kernel_vs_reference_rgb_equal=bool(torch.equal(rgb, rgb_ref)),
               captured=captured)
    log(f"# {label}: trained-scene gradient step (step {trainer.state.step}), held against "
        f"{held}; kernel path against plain but the forward blend (max-scaled, tol "
        f"{GRAD_TOL}): worst "
        f"{res['worst']} {res['max_err']:.3g}; against the all-plain path: worst "
        f"{res['all_plain_worst']} {res['all_plain_max_err']:.3g}, forward rgb max diff "
        f"{res['forward_rgb_max_diff']:.3g}, L1 residual signs flipped at {flips} of "
        f"{rgb.numel()} pixel channels")
    return res


def deform_recorders(rec: dict):
    """Wrappers of `Trainer.step` (each step's host time between
    synchronizes, index, deformation switch, pair count, buffer, loss,
    skip flag) and `Trainer.refine` (the deformable block's alive count
    and densify visibility sum before and after), for phase 12."""
    def step(fn):
        def call(self, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = fn(self, batch)
            torch.cuda.synchronize()
            rec["steps"].append(dict(
                ms=1e3 * (time.perf_counter() - t0), step=self.state.step - 1,
                deform=self.cfg.scene.deform_enabled, limit=self.cfg.max_intersections,
                n=int(m["n_intersections"]), loss=float(m["total_loss"]),
                skipped=float(m["nonfinite_grad_step"])))
            return m
        return call

    def refine(fn):
        def call(self, flags):
            def block():
                a, d = self.aux.deformables, self.state.densify.get("deformables")
                return None if a is None else dict(
                    alive=int(a.num_alive.sum()), seen=float(d.vis_counts.sum()),
                    cap=int(a.alive.shape[1]))
            before = block()
            info = fn(self, flags)
            rec["refines"].append(dict(step=info["step"], before=before, after=block(),
                                       n_split=info["n_split"], n_dup=info["n_dup"],
                                       n_cull=info["n_cull"]))
            return info
        return call

    return [(Trainer, "step", step), (Trainer, "refine", refine)]


def deformable_scene(scene, cargs, dev):
    """Phase 10's scene model (`build_scene_model`, with its 5k instance and
    100k skybox) with the rigid instance block made a deformable one, as the
    JAX package's test_train_e2e.py does: capacity 5,120, zero embeddings
    [1, 16], the deform MLP from a key."""
    params, aux = build_scene_model(scene, with_instances=True, with_skybox=True,
                                    skybox_points=cargs.skybox_points, device=dev)
    inst = params.instances
    deform = DeformableParams(
        node=inst.node, quats=inst.quats, trans=inst.trans,
        embeddings=torch.zeros((inst.node.means.shape[0], 16), device=dev),
        mlp=init_deform_mlp(prng.key(DEFORM_SEED), device=dev))
    return (dataclasses.replace(params, instances=None, deformables=deform),
            dataclasses.replace(aux, instances=None, deformables=aux.instances))


def leaves_of(tree, prefix: str) -> dict:
    """{path: a copy} of a tree's leaves under `prefix`."""
    return {k: v.detach().clone() for k, v in named_leaves(tree) if k.startswith(prefix)}


def changed(now: dict, then: dict) -> dict:
    """For each leaf: whether it differs from its earlier copy."""
    return {k: not torch.equal(now[k], then[k]) for k in then}


def deform_run(label: str, cfg, params, aux, scene, cargs, dev, chunks, snaps: dict):
    """Trains a phase-12 model for DEFORM_STEPS steps through `Trainer.train`
    in `chunks` of steps, with the launch counters zeroed just before and
    read just after; after each chunk snaps[step] holds copies of the
    deformable block's leaves (no launch). Requires each fused kernel to launch once a
    step and no step to be non-finite, skipped or truncated. Returns
    (trainer, launches, the per-step and refine records)."""
    _, _, train_pairs, _ = campaign.splits(cargs.n_travels, cargs.n_frames)
    data = campaign.make_factory(scene, train_pairs, device=dev)(1.0)
    trainer = Trainer(cfg, params, aux, data,
                      optim_config=configs.optimizer_table(DEFORM_STEPS), device=dev)
    rec = dict(steps=[], refines=[])
    with contextlib.ExitStack() as stack:
        for owner, name, wrap in deform_recorders(rec):
            stack.enter_context(wrapped(owner, name, wrap))
        torch.cuda.synchronize()
        # the preset's training path: kernel launches counted from here ...
        cuda_build.reset_launches()
        for n in chunks:
            trainer.train(n)
            snaps[trainer.state.step] = leaves_of(trainer.state.params, "deformables")
        torch.cuda.synchronize()
        launches = dict(cuda_build.LAUNCHES)
        # ... to here
    steps = DEFORM_STEPS
    require(len(rec["steps"]) == steps == trainer.state.step,
            f"{label}: {len(rec['steps'])} steps recorded, {trainer.state.step} trained")
    require_launches(launches, {k: steps for k in FUSED_KERNELS},
                     f"{label}: {steps} fused training steps")
    bad = [r for r in rec["steps"] if not np.isfinite(r["loss"]) or r["skipped"]
           or r["n"] > r["limit"]]
    require(not bad, f"{label}: non-finite, skipped or truncated steps {bad[:3]}")
    return trainer, launches, rec


def deform_eval_and_reload(label: str, trainer, rebuild, scene, cargs, dev, work: Path):
    """`evaluate_scene` of a trained phase-12 model over phase 10's eval
    views; its checkpoint saved, a freshly built model padded to
    `checkpoint_layout`'s capacities and loaded, and its eval within
    CAMPAIGN_EVAL_TOL of the first. Returns (eval, the eval batches, the
    reload's largest difference)."""
    _, _, _, eval_pairs = campaign.splits(cargs.n_travels, cargs.n_frames)
    modes = campaign.travel_modes_for(cargs.n_travels)
    batches = [campaign.make_batch(scene, t, f, 1.0, dev) for t, f in eval_pairs]
    result = evaluate_scene(trainer.state.params, trainer.aux, trainer.cfg, batches,
                            travel_modes=modes, device=dev)
    path = work / label
    checkpoint.save_checkpoint(path, trainer.state, trainer.aux, keep_optimizer=False)
    layout = checkpoint.checkpoint_layout(path)
    params, aux = checkpoint.pad_scene_to_caps(*rebuild(), layout["caps"])
    fresh = Trainer(trainer.cfg, params, aux, iter(()), device=dev)
    got = checkpoint.load_checkpoint(path, dict(params=fresh.state.params,
                                                densify=fresh.state.densify,
                                                step=fresh.state.step, aux=fresh.aux))
    shutil.rmtree(path, ignore_errors=True)
    again = evaluate_scene(got["params"], got["aux"], trainer.cfg, batches, travel_modes=modes,
                           device=dev)
    diff = max(abs(again[k] - result[k]) for k in result if k not in ("fps", "num_images")
               and not (np.isnan(again[k]) and np.isnan(result[k])))
    require(diff <= CAMPAIGN_EVAL_TOL and got["step"] == DEFORM_STEPS,
            f"{label}: the reloaded checkpoint's eval differs by {diff}")
    return result, batches, diff, layout["caps"]


def phase_deformables(card: str, dev, scene, campaign_res: dict):
    """Phase 12: the `mtgs_deformable` and `wild_gaussians` presets trained
    on phase 10's scene at full width through `Trainer.train`. Returns
    (results, {"deformable": launches, "wild": launches}, {preset: its
    trained Trainer})."""
    cargs = argparse.Namespace(**campaign_res["argv"])
    work = Path(tempfile.mkdtemp(prefix="deform_", dir=ROOT / "build"))
    t0 = time.perf_counter()
    try:
        deform, deform_launches, deform_trainer = phase_mtgs_deformable(
            card, dev, scene, cargs, work)
        wild, wild_launches, wild_trainer = phase_wild(card, dev, scene, cargs, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ms_mtgs = campaign_res["ms_per_step_by_scale"].get("1.0")
    res = dict(mtgs_deformable=deform, wild_gaussians=wild, phase_s=time.perf_counter() - t0,
               mtgs_ms_per_step=ms_mtgs)
    log(f"# deformables ({card}): ms/step (median, host clock between synchronizes): "
        f"mtgs_deformable {deform['ms_per_step_before']:.2f} before the switch, "
        f"{deform['ms_per_step_after']:.2f} after; wild_gaussians "
        f"{wild['ms_per_step']:.2f}; phase 10's mtgs at full resolution {ms_mtgs}; "
        f"phase 12 took {res['phase_s']:.1f} s")
    return (res, dict(deformable=deform_launches, wild=wild_launches),
            dict(mtgs_deformable=deform_trainer, wild_gaussians=wild_trainer))


def phase_mtgs_deformable(card: str, dev, scene, cargs, work: Path):
    """(a) `method_config("mtgs_deformable", max_steps=DEFORM_STEPS)` with the
    switch at DEFORM_ENABLE: the MLP and embeddings bit-equal to their start
    before it while the canonical means move; the canonical means bit-equal
    from it on (no refine falls after it) while the MLP trains; the refine
    over the deformable block consumes its densify statistics; one step
    after the switch against the plain path; the eval and a reload."""
    label = "mtgs_deformable"
    cfg = configs.method_config(label, max_steps=DEFORM_STEPS).replace(
        deform_enable_step=DEFORM_ENABLE)
    params, aux = deformable_scene(scene, cargs, dev)
    snaps = {0: leaves_of(params, "deformables")}
    refine_at = campaign_schedule_for(cfg, DEFORM_STEPS)[0]
    trainer, launches, rec = deform_run(
        label, cfg, params, aux, scene, cargs, dev,
        [refine_at[0], DEFORM_ENABLE - refine_at[0], 1, DEFORM_STEPS - DEFORM_ENABLE - 1],
        snaps)
    _, _, train_pairs, _ = campaign.splits(cargs.n_travels, cargs.n_frames)
    grads = trained_scene_grads(trainer, trainer.cfg,
                                campaign.make_batch(scene, *train_pairs[0], 1.0, dev),
                                label=label, all_plain_first=True)
    grads.pop("captured")
    require(trainer.cfg.scene.deform_enabled
            and [r["deform"] for r in rec["steps"]] == [s >= DEFORM_ENABLE for s in
                                                         range(DEFORM_STEPS)],
            f"{label}: deformation not switched on at step {DEFORM_ENABLE}")
    mlp = lambda k: k.startswith(("deformables.mlp", "deformables.embeddings"))
    start, r0, pre, flip, end = (snaps[k] for k in (0, refine_at[0], DEFORM_ENABLE,
                                                    DEFORM_ENABLE + 1, DEFORM_STEPS))
    require(not any(v for k, v in changed(pre, start).items() if mlp(k)),
            f"{label}: the MLP or the embeddings moved before step {DEFORM_ENABLE}")
    require(changed(pre, r0)["deformables.node.means"],
            f"{label}: the canonical means did not move before step {DEFORM_ENABLE}")
    after_refines = [r for r in rec["refines"] if r["step"] > DEFORM_ENABLE]
    frozen = not after_refines and not changed(end, pre)["deformables.node.means"]
    require(frozen and not changed(flip, pre)["deformables.node.means"],
            f"{label}: the canonical means moved after step {DEFORM_ENABLE}")
    moved = changed(end, pre)
    require(all(moved[k] for k in moved if k.startswith("deformables.mlp.w")),
            f"{label}: not every MLP weight trained after step {DEFORM_ENABLE}: {moved}")
    require([r["step"] for r in rec["refines"]] == refine_at,
            f"{label}: refines at {[r['step'] for r in rec['refines']]}, expected {refine_at}")
    for r in rec["refines"]:
        require(r["before"]["seen"] > 0 and r["after"]["seen"] == 0,
                f"{label}: the refine at {r['step']} did not consume the deformable block's "
                f"densify statistics: {r}")

    result, _, reload_diff, caps = deform_eval_and_reload(
        label, trainer, lambda: deformable_scene(scene, cargs, dev), scene, cargs, dev, work)
    ms = lambda on: float(np.median([r["ms"] for r in rec["steps"][5:] if r["deform"] == on]))
    res = dict(steps=DEFORM_STEPS, deform_enable_step=DEFORM_ENABLE, launches=launches,
               refines=rec["refines"], grads=grads, eval=result, reload_max_diff=reload_diff,
               caps=caps, ms_per_step_before=ms(False), ms_per_step_after=ms(True),
               step_ms=[r["ms"] for r in rec["steps"]],
               n_intersections_max=max(r["n"] for r in rec["steps"]),
               embeddings_moved=moved["deformables.embeddings"])
    log(f"# {label} ({card}): {DEFORM_STEPS} steps, deformation on at {DEFORM_ENABLE}; "
        f"ms/step {res['ms_per_step_before']:.2f} before, {res['ms_per_step_after']:.2f} after; "
        f"refines {rec['refines']}; launches {launches}; eval psnr {result['psnr']:.3f}; "
        f"reload max diff {reload_diff:.3g}; gradient step held against "
        f"{grads['held_against']}, all-plain worst {grads['all_plain_worst']} "
        f"{grads['all_plain_max_err']:.3g}, L1 sign flips {grads['l1_sign_flips']}")
    return res, launches, trainer


def phase_wild(card: str, dev, scene, cargs, work: Path):
    """(b) `method_config("wild_gaussians", max_steps=DEFORM_STEPS)` on the
    scene built with the WildGaussians appearance: every wild leaf trains,
    the seen split gains CAMPAIGN_PSNR_GAIN dB over the untrained model, one
    gradient step against the plain path, the eval and a reload."""
    label = "wild_gaussians"
    cfg = configs.method_config(label, max_steps=DEFORM_STEPS)
    build = lambda: build_scene_model(scene, with_skybox=True, wild_appearance=True,
                                      skybox_points=cargs.skybox_points, device=dev)
    params, aux = build()
    start = leaves_of(params, "wild")
    trainer, launches, rec = deform_run(label, cfg, params, aux, scene, cargs, dev,
                                        [DEFORM_STEPS], {})
    _, _, train_pairs, _ = campaign.splits(cargs.n_travels, cargs.n_frames)
    grads = trained_scene_grads(trainer, trainer.cfg,
                                campaign.make_batch(scene, *train_pairs[0], 1.0, dev),
                                label=label, all_plain_first=True)
    grads.pop("captured")
    moved = changed(leaves_of(trainer.state.params, "wild"), start)
    require(all(moved.values()), f"{label}: not every wild leaf trained: {moved}")
    result, batches, reload_diff, caps = deform_eval_and_reload(
        label, trainer, build, scene, cargs, dev, work)
    seen, _, _, _ = campaign.splits(cargs.n_travels, cargs.n_frames)
    untrained = evaluate_scene(*build(), trainer.cfg, batches,
                               travel_modes=campaign.travel_modes_for(cargs.n_travels),
                               device=dev)
    seen_psnr = float(np.mean([result[f"trv{t}_psnr"] for t in seen]))
    seen_psnr0 = float(np.mean([untrained[f"trv{t}_psnr"] for t in seen]))
    require(seen_psnr >= seen_psnr0 + CAMPAIGN_PSNR_GAIN,
            f"{label}: seen-split psnr {seen_psnr:.3f} dB, untrained {seen_psnr0:.3f} dB")
    res = dict(steps=DEFORM_STEPS, launches=launches, refines=rec["refines"], grads=grads,
               eval=result, untrained_eval=untrained, seen_psnr=seen_psnr,
               untrained_seen_psnr=seen_psnr0, reload_max_diff=reload_diff, caps=caps,
               ms_per_step=float(np.median([r["ms"] for r in rec["steps"][5:]])),
               step_ms=[r["ms"] for r in rec["steps"]],
               n_intersections_max=max(r["n"] for r in rec["steps"]), wild_moved=moved)
    log(f"# {label} ({card}): {DEFORM_STEPS} steps; ms/step {res['ms_per_step']:.2f}; seen "
        f"psnr {seen_psnr:.3f} dB (untrained {seen_psnr0:.3f}); launches {launches}; reload "
        f"max diff {reload_diff:.3g}; gradient step held against {grads['held_against']}, "
        f"all-plain worst {grads['all_plain_worst']} {grads['all_plain_max_err']:.3g}, L1 "
        f"sign flips {grads['l1_sign_flips']}")
    return res, launches, trainer


def row_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each row's max |error| over its largest |value| (the error itself
    for an all-zero row)."""
    err = (got - want).abs().amax(dim=1)
    scale = want.abs().amax(dim=1)
    return torch.where(scale > 0, err / torch.clamp(scale, min=1e-30), err)


def expand_fused_timing(captured):
    """expand_fused on one capture's arguments against its plain version
    (every output torch.equal), timed, with its bytes bound."""
    (table, offsets, packed, total, I), kw = captured["expand_fused"]
    got = expand_fused.expand_fused(table, offsets, packed, total, I, **kw)
    want = expand_fused.expand_fused_plain(table, offsets, packed, total, I, **kw)
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "expand_fused kernel differs from its plain version")
    nw, n = table.shape
    n_live = int((torch.diff(offsets, append=total) > 0).sum())
    # the live owners' table columns, offsets, span words and total read
    # once; key, src and round8(nw) attribute rows written once
    e_bytes = 4 * (nw * n_live + 2 * n + 1) + 4 * I * (2 + got[2].shape[0])
    return dict(
        max_abs_err=float((got[2] - want[2]).abs().max()),
        **timed(lambda: expand_fused.expand_fused(table, offsets, packed, total, I, **kw)),
        plain_ms=cuda_ms(lambda: expand_fused.expand_fused_plain(
            table, offsets, packed, total, I, **kw)),
        bound_ms=1e3 * e_bytes / PEAK_BYTES_PER_S, bound_by="bytes", bytes=e_bytes,
        shapes=dict(table=list(table.shape), I=I, total=int(total), nw=nw, n_live=n_live))


def forward_timing(a, kw, plain_reps: int = 5, term_flips: bool = False):
    """blend_forward on one capture's arguments against its plain version
    (BLEND_TOL, BLEND_FLIP_TOL at up to 0.1% of pixels; with `term_flips`
    a pixel of those may instead be a termination flip beyond
    BLEND_FLIP_TOL; every pixel above BLEND_TOL must be a termination or a
    cut-off flip, `flip_causes`), timed, with the least time the card
    could take for the blend of these inputs. Returns (the row's numbers,
    the kernel's output)."""
    slab_t, offs, heads, counts, nchunks = a
    c_total, T = kw["c_total"], offs.shape[0]
    got = blend.blend_forward(*a, **kw)
    stats = {}
    want = blend.blend_forward_plain(*a, **kw, stats=stats)
    torch.cuda.synchronize()
    errs = blend_errors(got, want)
    flagged = errs > BLEND_TOL
    err, flips, n_pix = float(errs.max()), int(flagged.sum()), errs.numel()
    term = torch.zeros_like(flagged)
    if term_flips:
        term = termination_flips(got, want, slab_t, c_total) & flagged
    n_term = int(term.sum())
    err_rest = float(torch.where(term, 0.0, errs).max())
    require(flips <= max(2, n_pix // 1000) and err_rest <= BLEND_FLIP_TOL,
            f"blend_forward: max err {err} ({err_rest} outside {n_term} termination flips), "
            f"{flips} pixels above {BLEND_TOL} (allowed {max(2, n_pix // 1000)} up to "
            f"{BLEND_FLIP_TOL}{', or termination flips' if term_flips else ''})")
    causes, diag = flip_causes(got, want, a, kw, flagged)
    require(not causes["none"], f"blend_forward: {causes['none']} of the {flips} pixels above "
            f"{BLEND_TOL} show neither a termination nor a cut-off flip: {diag}")
    b_bytes, b_ops = blend.blend_forward_work(stats, c_total, T, n_pix)
    b_bound_bytes = 1e3 * b_bytes / PEAK_BYTES_PER_S
    b_bound_ops = 1e3 * b_ops / PEAK_F32_PER_S
    row = dict(
        max_abs_err=err,
        tol=dict(abs=BLEND_TOL, flip=BLEND_FLIP_TOL, flip_pixels_max=max(2, n_pix // 1000),
                 termination_flips_allowed=term_flips),
        flip_pixels=flips, termination_flips=n_term, max_err_outside_termination_flips=err_rest,
        flip_causes=causes, **timed(lambda: blend.blend_forward(*a, **kw)),
        tile_order_ms=cuda_ms(lambda: blend.tile_order(counts)),  # inside ms: the wrapper's sort
        plain_ms=cuda_ms(lambda: blend.blend_forward_plain(*a, **kw), reps=plain_reps,
                         warmup=1),
        bound_ms=max(b_bound_bytes, b_bound_ops),
        bound_by="operations" if b_bound_ops >= b_bound_bytes else "bytes",
        shapes=dict(slab=list(slab_t.shape), tiles=T, tile_size=kw["tile_size"],
                    c_total=c_total, pairs=int(counts.sum()), deepest_tile=int(counts.max())),
        pairs_read=stats["pairs_read"], pair_evals=stats["pair_evals"],
        pair_support=stats["pair_support"], pair_blends=stats["pair_blends"],
        bytes=b_bytes, ops=b_ops,
        bound_bytes_ms=b_bound_bytes, bound_ops_ms=b_bound_ops)
    return row, got


def segment_timing(rows, src, n, dev):
    """dense_segment_sum on one capture's arguments against its plain
    version (SEGMENT_TOL max-scaled per row), twice for equal bits, timed,
    with its bytes bound and index_add_'s time."""
    got = segment_sum.dense_segment_sum(rows, src, n)
    again = segment_sum.dense_segment_sum(rows, src, n)
    want = segment_sum.dense_segment_sum_plain(rows, src, n)
    torch.cuda.synchronize()
    errs = row_errors(got, want)
    err = float(errs.max())
    require(err <= SEGMENT_TOL, f"dense_segment_sum: row errors {errs.tolist()}")
    require(torch.equal(got, again), "dense_segment_sum: two launches differ")
    live_slots = int((src < n).sum())
    W = rows.shape[0]
    src64 = src.to(torch.int64)

    def index_add():
        return torch.zeros((W, n + 1), dtype=torch.float32, device=dev).index_add_(1, src64, rows)

    # the live slots' rows and every slot's owner read once, the output written once
    s_bytes = 4 * (W * live_slots + src.numel() + W * (n + 1))
    return dict(
        max_abs_err=float((got - want).abs().max()), max_scaled_err=err,
        tol=dict(max_scaled=SEGMENT_TOL), repeat_bit_equal=True,
        **timed(lambda: segment_sum.dense_segment_sum(rows, src, n)),
        plain_ms=cuda_ms(lambda: segment_sum.dense_segment_sum_plain(rows, src, n)),
        bound_ms=1e3 * s_bytes / PEAK_BYTES_PER_S, bound_by="bytes",
        library_ms=cuda_ms(index_add),
        library_device_ms=device_ms(index_add),
        shapes=dict(rows=list(rows.shape), n=n, live_slots=live_slots,
                    longest_segment=int(torch.unique_consecutive(
                        src[src < n], return_counts=True)[1].max()) if live_slots else 0),
        bytes=s_bytes)


def backward_timing(a, kw):
    """blend_backward on one capture's arguments against its plain version
    (GRAD_TOL max-scaled per row, the rows past 6 + c_total all zero),
    timed, with the least time the card could take for the replay of these
    inputs. Returns (the row's numbers, the kernel's output)."""
    got = blend.blend_backward(*a, **kw)
    want = blend.blend_backward_plain(*a, **kw)
    stats = {}
    blend.blend_forward_plain(*a[:5], **kw, stats=stats)  # the pairs the replay reaches
    torch.cuda.synchronize()
    slab_t, offs, heads, counts, nchunks = a[:5]
    c_total, T = kw["c_total"], offs.shape[0]
    nw = NUM_GEOM + c_total
    errs = row_errors(got[:nw], want[:nw])
    err = float(errs.max())
    require(err <= GRAD_TOL and not got[nw:].any(),
            f"blend_backward: row errors {errs.tolist()} (tol {GRAD_TOL})")
    bb_bytes, bb_ops = blend.blend_backward_work(stats, c_total, T, a[6].numel(), got.numel())
    bb_bound_bytes = 1e3 * bb_bytes / PEAK_BYTES_PER_S
    bb_bound_ops = 1e3 * bb_ops / PEAK_F32_PER_S
    row = dict(
        max_abs_err=float((got - want).abs().max()), max_scaled_err=err,
        row_errors=errs.tolist(),
        **timed(lambda: blend.blend_backward(*a, **kw)),
        plain_ms=cuda_ms(lambda: blend.blend_backward_plain(*a, **kw), reps=3, warmup=1),
        bound_ms=max(bb_bound_bytes, bb_bound_ops),
        bound_by="operations" if bb_bound_ops >= bb_bound_bytes else "bytes",
        shapes=dict(slab=list(slab_t.shape), tiles=T, tile_size=kw["tile_size"],
                    c_total=c_total, pairs=int(counts.sum()), deepest_tile=int(counts.max())),
        pairs_read=stats["pairs_read"], pair_evals=stats["pair_evals"],
        pair_support=stats["pair_support"], pair_blends=stats["pair_blends"],
        pair_clamped=stats["pair_clamped"],
        bytes=bb_bytes, ops=bb_ops, bound_bytes_ms=bb_bound_bytes, bound_ops_ms=bb_bound_ops)
    return row, got


def band_capture(a, kw):
    """One capture's blend backward arguments cut to its lower tile-row
    band (the rows the second rank of a 2-rank band plan replays), with the
    band's tile_base."""
    tx, T = kw["tiles_x"], a[1].shape[0]
    base = -(-(T // tx) // 2) * tx
    return (a[0], *(x[base:] for x in a[1:])), dict(kw, tile_base=base)


def range_columns(offs, heads, counts, cap: int) -> torch.Tensor:
    """[cap] bool: the slab columns inside the tiles' ranges."""
    starts = (offs + heads).long()
    delta = torch.zeros(cap + 1, dtype=torch.int32, device=offs.device)
    delta.index_add_(0, starts, torch.ones_like(counts))
    delta.index_add_(0, starts + counts.long(), -torch.ones_like(counts))
    return torch.cumsum(delta, 0)[:cap] > 0


@torch.no_grad()
def phase_kernels(by_path, captured, train_captured, faint_captured, render_captured,
                  growth_captured, growth_fused_captured, campaign_captured, dev):
    """Each kernel against its plain version: the fused forward two at one
    serving view's shapes (`captured`; the blend forward also at a faint
    step's and a grown training step's, the expansion also at a fused step
    of phase 9 before the growth's), the backward two at one training
    step's (the blend backward also at a faint step's, and twice there for
    equal bits; the segment sum also at a grown step's, and twice at each
    for equal bits), the classic three (classic_kernel_rows) at a
    1920x1080 frame's and a grown training step's; both blends also at a
    full-resolution step of phase 10's trained scene (`at_campaign`).
    by_path: {path: launch counts of that path's run}."""
    launches = {k: sum(c[k] for c in by_path.values()) for k in KERNELS}
    kernels = []

    # expand_fused: exact integer math and copies, at a serving view and
    # at a fused training step of phase 9 before the growth
    kernels.append(dict(
        name="expand_fused", route="cuda", source="mtgs_torch/csrc/expand_fused.cu",
        replaces="mtgs_tpu/raster/expand_fused.py:205",
        tpu_kernel="mtgs_tpu/raster/expand_fused.py::expand_fused",
        launches=launches["expand_fused"], tol=0.0, **expand_fused_timing(captured),
        at_growth=expand_fused_timing(growth_fused_captured), library_ms=None,
        library_note="no single PyTorch call computes it (searchsorted + gathers is "
                     "the plain version)"))

    # blend_forward: the front-to-back blend at a serving view, on the
    # faint scene after the opacity reset (one more phase-6 step) and at a
    # grown training step (classic path); two launches on the faint
    # capture give equal bits
    serving, _ = forward_timing(*captured["blend_forward"])
    faint, faint_got = forward_timing(*faint_captured["blend_forward"], plain_reps=3,
                                      term_flips=True)
    grown, _ = forward_timing(*growth_captured["blend_forward"], plain_reps=3, term_flips=True)
    trained, _ = forward_timing(*campaign_captured["blend_forward"], plain_reps=3,
                                term_flips=True)
    a, kw = faint_captured["blend_forward"]
    again = blend.blend_forward(*a, **kw)
    torch.cuda.synchronize()
    require(all(torch.equal(x, y) for x, y in zip(faint_got, again)),
            "blend_forward: two launches on the faint capture differ")
    kernels.append(dict(
        name="blend_forward", route="cuda", source="mtgs_torch/csrc/blend_forward.cu",
        replaces="mtgs_tpu/raster/blend_pallas.py:185",
        tpu_kernel="mtgs_tpu/raster/blend_pallas.py::blend_forward_pallas",
        launches=launches["blend_forward"], **serving, at_faint=faint, at_growth=grown,
        at_campaign=trained, repeat_bit_equal=True, library_ms=None,
        library_note="no single PyTorch call computes a depth-ordered alpha blend"))

    # blend_backward: the replay of one training step's blend, at the bright
    # start (the phase-6 gradient step) and on the faint scene after the
    # opacity reset (one more step of the phase-6 trainer)
    bright, bright_got = backward_timing(*train_captured["blend_backward"])
    # a tile-row band at its nonzero tile_base: against the plain version
    # (backward_timing), and its columns bit-equal to the whole image's
    # (each tile is replayed alone)
    band_a, band_kw = band_capture(*train_captured["blend_backward"])
    at_band, band_got = backward_timing(band_a, band_kw)
    cols = range_columns(*band_a[1:4], band_a[0].shape[1])
    require(bool(cols.any()) and torch.equal(band_got[:, cols], bright_got[:, cols]),
            f"blend_backward at tile_base {band_kw['tile_base']}: the band's columns differ "
            "from the whole image's")
    at_band["tile_base"] = band_kw["tile_base"]
    faint, faint_got = backward_timing(*faint_captured["blend_backward"])
    trained, _ = backward_timing(*campaign_captured["blend_backward"])
    a, kw = faint_captured["blend_backward"]
    again = blend.blend_backward(*a, **kw)
    torch.cuda.synchronize()
    require(torch.equal(faint_got, again), "blend_backward: two launches on the faint "
            "capture differ")
    kernels.append(dict(
        name="blend_backward", route="cuda", source="mtgs_torch/csrc/blend_backward.cu",
        replaces="mtgs_tpu/raster/blend_pallas.py:462",
        tpu_kernel="mtgs_tpu/raster/blend_pallas.py::blend_backward_pallas",
        launches=launches["blend_backward"], tol=dict(max_scaled=GRAD_TOL), **bright,
        at_faint=faint, at_campaign=trained, at_tile_base=at_band, repeat_bit_equal=True,
        library_ms=None,
        library_note="none: no PyTorch call computes the gradient of a depth-ordered blend"))

    # dense_segment_sum: one training step's slot rows to per-gaussian sums,
    # and a grown (classic) step's
    (rows, src, n), _ = train_captured["dense_segment_sum"]
    (g_rows, g_src, g_n), _ = growth_captured["dense_segment_sum"]
    kernels.append(dict(
        name="dense_segment_sum", route="cuda", source="mtgs_torch/csrc/segment_sum.cu",
        replaces="mtgs_tpu/raster/segment_sum.py:75",
        tpu_kernel="mtgs_tpu/raster/segment_sum.py::dense_segment_sum",
        launches=launches["dense_segment_sum"], **segment_timing(rows, src, n, dev),
        at_growth=segment_timing(g_rows, g_src, g_n, dev),
        library_note="index_add_ of the rows into a zeroed [W, n + 1] (index precomputed)"))
    kernels += classic_kernel_rows(render_captured, growth_captured, launches, dev)
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
        k["kernel_ms"] = k["ms"]
        for label, row in [("kernel " + k["name"], k)] + [
                ("  " + at, k[at]) for at in ("at_faint", "at_growth", "at_training",
                                              "at_campaign", "at_tile_base") if at in k]:
            log(f"# {label}: {row['device_ms']:.4f} ms on the device, {row['ms']:.4f} ms "
                f"with the wrapper (plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} "
                f"ms by {row['bound_by']}), max err {row['max_abs_err']:.3g}")
    return kernels


def classic_kernel_rows(render_captured, growth_captured, launches, dev):
    """Kernels 5-7 against their plain versions (bit-equal: integer math
    and copies), timed at phase 8's shapes (a 1920x1080 frame, I = 2^23)
    and, under `at_training`, at phase 9's (a training step at I =
    GROW_TO); attr_major_to_rows runs in the backward only, so at phase
    9's alone. Bounds by bytes: each input read once, each output written
    once."""
    def expand_row(captured):
        (offsets, packed, total, I), kw = captured["expand_pairs"]
        got = expand_pairs.expand_pairs(offsets, packed, total, I, **kw)
        want = binning.searchsorted_expand(offsets, packed, total, I, **kw)
        torch.cuda.synchronize()
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                "expand_pairs kernel differs from its plain version")
        slot = torch.arange(I, dtype=torch.int32, device=dev)
        n = offsets.shape[0]
        nbytes = 4 * (2 * n + 1) + 8 * I
        return dict(
            max_abs_err=0.0,
            **timed(lambda: expand_pairs.expand_pairs(offsets, packed, total, I, **kw)),
            plain_ms=cuda_ms(lambda: binning.searchsorted_expand(offsets, packed, total, I,
                                                                 **kw)),
            searchsorted_ms=cuda_ms(lambda: torch.searchsorted(offsets, slot, right=True,
                                                               out_int32=True)),
            bound_ms=1e3 * nbytes / PEAK_BYTES_PER_S, bound_by="bytes", library_ms=None,
            bytes=nbytes, shapes=dict(n=n, I=I, total=int(total), **kw))

    def transpose_row(name, a, library):
        kernel, plain = getattr(blend, name), getattr(blend, name + "_plain")
        got = kernel(a)
        torch.cuda.synchronize()
        require(torch.equal(got, plain(a)), f"{name} kernel differs from its plain version")
        nbytes = 4 * (a.numel() + got.numel())
        return dict(
            max_abs_err=0.0, **timed(lambda: kernel(a)), plain_ms=cuda_ms(lambda: plain(a)),
            bound_ms=1e3 * nbytes / PEAK_BYTES_PER_S, bound_by="bytes",
            library_ms=cuda_ms(lambda: library(a)),
            library_device_ms=device_ms(lambda: library(a)), bytes=nbytes,
            shapes=dict(input=list(a.shape), output=list(got.shape)))

    def pad_t(rows):
        w = rows.shape[1]
        return torch.nn.functional.pad(rows, (0, round8(w) - w)).t().contiguous()

    rows = []
    e_render, e_train = expand_row(render_captured), expand_row(growth_captured)
    rows.append(dict(
        name="expand_pairs", route="cuda", source="mtgs_torch/csrc/expand_pairs.cu",
        replaces="mtgs_tpu/raster/expand_pallas.py:102",
        tpu_kernel="mtgs_tpu/raster/expand_pallas.py::expand_pairs",
        launches=launches["expand_pairs"], tol=0.0, **e_render, at_training=e_train,
        library_note="none: the plain version (torch.searchsorted and gathers) is not one "
                     "call; searchsorted_ms times torch.searchsorted alone"))
    r_render = transpose_row("rows_to_attr_major", render_captured["rows_to_attr_major"][0][0],
                             pad_t)
    r_train = transpose_row("rows_to_attr_major", growth_captured["rows_to_attr_major"][0][0],
                            pad_t)
    rows.append(dict(
        name="rows_to_attr_major", route="cuda", source="mtgs_torch/csrc/transpose.cu",
        replaces="mtgs_tpu/raster/blend_pallas.py:568",
        tpu_kernel="mtgs_tpu/raster/blend_pallas.py::rows_to_attr_major",
        launches=launches["rows_to_attr_major"], tol=0.0, **r_render, at_training=r_train,
        library_note="F.pad(rows, (0, round8(W) - W)).t().contiguous() (also the plain "
                     "version)"))
    a_train = transpose_row("attr_major_to_rows", growth_captured["attr_major_to_rows"][0][0],
                            lambda a: a.t().contiguous())
    rows.append(dict(
        name="attr_major_to_rows", route="cuda", source="mtgs_torch/csrc/transpose.cu",
        replaces="mtgs_tpu/raster/blend_pallas.py:588",
        tpu_kernel="mtgs_tpu/raster/blend_pallas.py::attr_major_to_rows",
        launches=launches["attr_major_to_rows"], tol=0.0, **a_train,
        library_note="attrs.t().contiguous() (also the plain version)"))
    return rows


def build_other(path: Path):
    """A library built from another version of one of csrc/'s sources (the
    same C interface), with the port's flags and csrc/ on the include path."""
    digest = hashlib.sha256(path.read_bytes()).hexdigest()[:12]
    out = cuda_build.BUILD_DIR / f"other_{path.stem}_{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
                    "-o", str(out), str(path)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def legacy_blend_forward(lib, slab_t, tile_offsets, tile_heads, tile_counts, tile_nchunks, *,
                         tile_size, tiles_x, c_total, tile_base=0):
    """blend_forward through a library whose mtgs_blend_forward takes the
    argument list without tile_order (no mtgs_blend_forward_abi symbol:
    csrc/blend_forward.cu before it launched the tiles deepest first)."""
    fn = lib.mtgs_blend_forward
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_longlong, p, p, p, i, i, i, i, i, p, p, p]
    fn.restype = ctypes.c_int
    T, P = tile_offsets.shape[0], tile_size * tile_size
    rgb = torch.empty((T, c_total, P), dtype=torch.float32, device=slab_t.device)
    t_final = torch.empty((T, P), dtype=torch.float32, device=slab_t.device)
    err = fn(slab_t.data_ptr(), slab_t.shape[1], tile_offsets.data_ptr(), tile_heads.data_ptr(),
             tile_counts.data_ptr(), T, tile_size, tiles_x, int(tile_base), c_total,
             rgb.data_ptr(), t_final.data_ptr(),
             torch.cuda.current_stream(slab_t.device).cuda_stream)
    cuda_build.check(err, "blend_forward (legacy argument list)")
    return rgb, t_final


def legacy_blend_backward(lib, slab_t, tile_offsets, tile_heads, tile_counts, tile_nchunks,
                          rgb_tiles, t_final, g_rgb, g_t, *, tile_size, tiles_x, c_total,
                          tile_base=0):
    """blend_backward through a library whose mtgs_blend_backward takes the
    argument list without tile_base (no mtgs_blend_backward_abi symbol:
    csrc/blend_backward.cu before it took one); tile_base must be 0."""
    require(tile_base == 0, "a blend_backward.cu without tile_base replays tile 0 onwards")
    fn = lib.mtgs_blend_backward
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_longlong, i, p, p, p, p, i, i, i, i, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    W, cap = slab_t.shape
    g_slab = torch.zeros((W, cap), dtype=torch.float32, device=slab_t.device)
    order = blend.tile_order(tile_counts)
    dense = [x.contiguous() for x in (rgb_tiles, t_final, g_rgb, g_t)]
    err = fn(slab_t.data_ptr(), cap, W, tile_offsets.data_ptr(), tile_heads.data_ptr(),
             tile_counts.data_ptr(), order.data_ptr(), tile_offsets.shape[0], tile_size,
             tiles_x, c_total, *(x.data_ptr() for x in dense), g_slab.data_ptr(),
             torch.cuda.current_stream(slab_t.device).cuda_stream)
    cuda_build.check(err, "blend_backward (legacy argument list)")
    return g_slab


def phase_ab(specs, serving_captured, train_captured, faint_captured, render_captured,
             growth_captured, growth_faint_captured, growth_fused_captured):
    """`--ab SOURCE=PATH`: each kernel of another version of a source
    against the checkout's, on phase 5's captured inputs, in one process:
    its output held to the checkout kernel's (bit-equal for the blend
    forward, the expansions and the transposes, GRAD_TOL for the blend
    backward, SEGMENT_TOL for the segment sum), then both timed in the
    order checkout, other, other, checkout: device_ms, compared, and
    cuda_ms (the wrapper's host work inside) each. A blend_forward.cu
    without the `mtgs_blend_forward_abi` marker is called with the
    argument list it takes (`legacy_blend_forward`)."""
    def bf(captured):
        a, kw = captured["blend_forward"]

        def call():
            lib = cuda_build.load("blend_forward.cu")
            if hasattr(lib, "mtgs_blend_forward_abi"):
                return blend.blend_forward(*a, **kw)
            return legacy_blend_forward(lib, *a, **kw)
        return call, lambda mine, other: all(torch.equal(x, y) for x, y in zip(mine, other))

    def bb(captured):
        a, kw = captured["blend_backward"]
        nw = NUM_GEOM + kw["c_total"]

        def same(mine, other):
            return (float(row_errors(other[:nw], mine[:nw]).max()) <= GRAD_TOL
                    and not other[nw:].any())

        def call():
            lib = cuda_build.load("blend_backward.cu")
            if hasattr(lib, "mtgs_blend_backward_abi"):
                return blend.blend_backward(*a, **kw)
            return legacy_blend_backward(lib, *a, **kw)
        return call, same

    def ss(captured):
        (rows, src, n), _ = captured["dense_segment_sum"]
        return (lambda: segment_sum.dense_segment_sum(rows, src, n),
                lambda mine, other: float(row_errors(other, mine).max()) <= SEGMENT_TOL)

    def tr(name, captured):
        x = captured[name][0][0]
        return lambda: getattr(blend, name)(x), torch.equal

    def ex(module, name, captured):
        a, kw = captured[name]
        return (lambda: getattr(module, name)(*a, **kw),
                lambda mine, other: all(torch.equal(x, y) for x, y in zip(mine, other)))

    cases = {
        "blend_forward.cu": dict(serving=bf(serving_captured), faint=bf(faint_captured),
                                 growth=bf(growth_captured),
                                 growth_faint=bf(growth_faint_captured)),
        "blend_backward.cu": dict(bright=bb(train_captured), faint=bb(faint_captured)),
        "segment_sum.cu": dict(training=ss(train_captured), growth=ss(growth_captured)),
        "transpose.cu": dict(
            rows_to_attr_major_frame=tr("rows_to_attr_major", render_captured),
            rows_to_attr_major_grown=tr("rows_to_attr_major", growth_captured),
            attr_major_to_rows_grown=tr("attr_major_to_rows", growth_captured)),
        "expand_fused.cu": dict(
            serving=ex(expand_fused, "expand_fused", serving_captured),
            growth_fused=ex(expand_fused, "expand_fused", growth_fused_captured)),
        "expand_pairs.cu": dict(
            frame=ex(expand_pairs, "expand_pairs", render_captured),
            growth=ex(expand_pairs, "expand_pairs", growth_captured)),
    }
    out = []
    for spec in specs:
        source, path = spec.split("=", 1)
        require(source in cases, f"--ab: no cases for {source} (have {sorted(cases)})")
        libs = dict(checkout=cuda_build.load(source), other=build_other(Path(path)))

        @contextlib.contextmanager
        def using(which):
            cuda_build._LIBS[source] = libs[which]
            try:
                yield
            finally:
                cuda_build._LIBS[source] = libs["checkout"]

        for label, (call, same) in cases[source].items():
            with using("checkout"):
                mine = call()
            with using("other"):
                other = call()
            torch.cuda.synchronize()
            require(same(mine, other), f"--ab {source} {label}: the other version's output "
                    "differs from the checkout's")
            dev_ms, ms = dict(checkout=[], other=[]), dict(checkout=[], other=[])
            for which in ("checkout", "other", "other", "checkout"):
                with using(which):
                    dev_ms[which].append(device_ms(call))
                    ms[which].append(cuda_ms(call))
            out.append(dict(source=source, other=path, case=label, device_ms=dev_ms, ms=ms))
            log(f"# ab {source} {label}: device_ms checkout {dev_ms['checkout']}, {path} "
                f"{dev_ms['other']} (ratio {np.mean(dev_ms['checkout']) / np.mean(dev_ms['other']):.3f}); "
                f"ms checkout {ms['checkout']}, other {ms['other']}")
    return out


KERNEL_SYMBOLS = dict(expand_fused="expand_fused_kernel",
                      blend_forward="blend_forward_kernel",
                      blend_backward="blend_backward_kernel",
                      dense_segment_sum="segment_sum_kernel",
                      expand_pairs="expand_pairs_kernel",
                      rows_to_attr_major="rows_to_attr_major_kernel",
                      attr_major_to_rows="attr_major_to_rows_kernel")


def phase_profile(label, fn, top: int = 25):
    """torch.profiler over one call of fn (after one unprofiled call):
    device time by kernel name, the device's busy share of the wall time,
    and the time of each of this port's kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    ours = {k: sum(ms for name, (ms, _) in by_name.items() if sym in name)
            for k, sym in KERNEL_SYMBOLS.items()}
    log(f"# profile: {label} {wall_ms:.2f} ms wall (profiled), device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} kernel launches; "
        f"the port's kernels {sum(ours.values()):.3f} ms {ours}")
    for name, (ms, n) in rows[:top]:
        log(f"#   {ms:8.3f} ms  x{n:<4d} {name[:110]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, launches=len(kernels),
                port_kernels_ms=ours,
                by_kernel=[dict(name=k, ms=ms, count=n) for k, (ms, n) in rows])


# ------------------------------------------------------ phase 16: parallel

@contextlib.contextmanager
def pipelines_recorded(ran: list):
    """Appends to `ran` the name of each sharded rasterizer pipeline that
    runs (rasterize(mesh=...) picks one of PIPELINES per view)."""
    saved = {name: getattr(mod, fn) for name, (mod, fn) in PIPELINES.items()}

    def rec(name, f):
        def call(*a, **kw):
            ran.append(name)
            return f(*a, **kw)
        return call

    for name, (mod, fn) in PIPELINES.items():
        setattr(mod, fn, rec(name, saved[name]))
    try:
        yield
    finally:
        for name, (mod, fn) in PIPELINES.items():
            setattr(mod, fn, saved[name])


@contextlib.contextmanager
def plan_env(env: dict):
    """The rasterizer's plan variables set to `env` alone inside the block."""
    saved = {k: os.environ.pop(k, None) for k in PLAN_VARS}
    os.environ.update(env)
    try:
        yield
    finally:
        for k in PLAN_VARS:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def stacked(batches) -> Batch:
    """One batch whose fields carry a leading axis: one view per rank of a
    data axis (`shard_batch` takes the rank's)."""
    return Batch(**{f.name: None if getattr(batches[0], f.name) is None else torch.stack(
        [torch.as_tensor(getattr(b, f.name)) for b in batches]) for f in dataclasses.fields(Batch)})


def batches_to(batches, dev):
    """Batches with every array on `dev` (numpy or host tensors in)."""
    return [Batch(**{f.name: (torch.as_tensor(v, device=dev)
                              if isinstance(v, (np.ndarray, torch.Tensor)) else v)
                     for f in dataclasses.fields(Batch) for v in [getattr(b, f.name)]})
            for b in batches]


def state_digest(state) -> str:
    """SHA-256 over the bytes of every parameter, Adam moment and densify
    statistic of a TrainState: equal digests are equal states, bit for bit."""
    h = hashlib.sha256()
    for tree in (state.params, state.adam.mu, state.adam.nu):
        for path, t in named_leaves(tree):
            h.update(path.encode())
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    for kind in sorted(state.densify):
        for f in dataclasses.fields(state.densify[kind]):
            h.update(getattr(state.densify[kind], f.name).cpu().numpy().tobytes())
    return h.hexdigest()


def grad_errors(got: dict, want: dict) -> dict:
    """Each gradient leaf's max error over its largest |value|, that scale
    taken as at least 1e-3 of the largest leaf's: a leaf of rounding noise
    (the quaternions of near-isotropic splats) is held absolutely, since a
    sharded backward sums its partial gradients in another order."""
    top = max(float(w.abs().max()) for w in want.values() if w.numel())
    return {k: float((got[k] - w).abs().max()) / max(float(w.abs().max()), 1e-3 * top)
            for k, w in want.items() if w.numel()}


def save_state(state_sd, path: Path) -> None:
    """A scene state (nested dicts of numpy arrays, None left out) to an
    uncompressed .npz, the keys its paths joined by '/'."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            elif v is not None:
                flat[f"{prefix}{k}"] = v

    walk(dict(params=state_sd[0], aux=state_sd[1]), "")
    np.savez(path, **flat)


def load_state(path: Path):
    """save_state's file back as (params, aux) state dicts."""
    out = {}
    with np.load(path) as f:
        for key in f.files:
            node = out
            *dirs, leaf = key.split("/")
            for d in dirs:
                node = node.setdefault(d, {})
            node[leaf] = f[key]
    return out["params"], out["aux"]


def rank_scene(a: dict, dev):
    """Phase 6's start (the jittered scene, in its JAX state-dict layout),
    read from the file the parent wrote, and its train config."""
    return load_state(Path(a["state_path"])), train_config(argparse.Namespace(**a))


def sync(dev) -> None:
    """Wait for a rank's device (its host has nothing to wait for)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_ms(fn, dev, reps: int = 5) -> float:
    """Median host milliseconds of fn() ending in a device sync, after one
    warm-up call."""
    fn()
    sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def rank_dp(a, mesh, state_sd, cfg, batches, dev) -> dict:
    """Phase 16's data-parallel checks on one rank of a 2-rank 'data' mesh."""
    optim = OptimConfig(groups=default_groups(cfg.max_steps))
    group = mesh.group("data")
    # one step with the same view on both ranks, against the single-process step
    params, aux = scene_from_state_dict(*state_sd, device=dev)
    single = init_train_state(params)
    total1, _, _, sink1, grads1 = loss_and_grads(params, aux, cfg, batches[0], 0, device=dev)
    train_step(single, aux, cfg, batches[0], optim, device=dev)
    params, aux = scene_from_state_dict(*state_sd, device=dev)
    state = init_train_state(params)
    batch = shard_batch(stacked([batches[0], batches[0]]), mesh)
    total2, _, _, sink2, grads2 = loss_and_grads(params, aux, cfg, batch, 0, device=dev)
    keys = list(grads2)
    red = pmean([grads2[k] for k in keys] + [sink2, total2], group)
    cuda_build.reset_launches()  # the data-parallel step's launches counted from here ...
    metrics = make_dp_train_step(cfg, optim, mesh, device=dev)(
        state, aux, stacked([batches[0], batches[0]]))
    sync(dev)
    step_launches = dict(cuda_build.LAUNCHES)  # ... to here
    g_err = grad_errors(dict(zip(keys, red[:len(keys)]), absgrad=red[-2]),
                        dict(grads1, absgrad=sink1))
    loss_rel = abs(float(red[-1]) - float(total1)) / abs(float(total1))
    p_err = max(float((x - y).detach().abs().max()) for (_, x), (_, y) in
                zip(named_leaves(state.params), named_leaves(single.params)) if x.numel())
    del params, aux, single, state, grads1, grads2, red
    torch.cuda.empty_cache()

    # DPTrainer: distinct views (rank r takes view 2i + r at step i), a refine
    # and an opacity reset at step REFINE_EVERY
    params, aux = scene_from_state_dict(*state_sd, device=dev)

    def data():
        for i in itertools.count():
            yield stacked([batches[(2 * i) % len(batches)], batches[(2 * i + 1) % len(batches)]])

    trainer = DPTrainer(cfg, params, aux, data(), mesh, seed=a["seed"], device=dev)
    stamps, logged = [], []

    def on_step(step, m):
        sync(dev)
        stamps.append(time.perf_counter())
        logged.append(m)

    sync(dev)
    cuda_build.reset_launches()  # DPTrainer's launches counted from here ...
    t0 = time.perf_counter()
    trainer.train(a["dp_steps"], log_every=1, callback=on_step)
    sync(dev)
    launches = dict(cuda_build.LAUNCHES)  # ... to here
    step_ms = list(1e3 * np.diff([t0] + stamps))
    return dict(
        identical=dict(grad_errors=g_err, loss_rel=loss_rel, params_max_abs_diff=p_err,
                       launches=step_launches, total_loss=float(metrics["total_loss"])),
        trainer=dict(launches=launches, psnr=[m["psnr"] for m in logged],
                     total_loss=[m["total_loss"] for m in logged],
                     nonfinite=[k for m in logged for k, v in m.items() if not np.isfinite(v)],
                     n_intersections=[m["n_intersections"] for m in logged],
                     refine_events=trainer.refine_events, reset_steps=trainer.reset_steps,
                     step_ms=step_ms, ms_per_step_median=float(np.median(step_ms[2:])),
                     max_intersections=trainer.cfg.max_intersections,
                     digest=state_digest(trainer.state)))


def layered_reference(n_ranks: int, k_smp: int = 64):
    """A rasterize of one process with the layered plan's semantics, for
    `render_view` to call in place of the rasterizer: the gaussians split
    into n_ranks depth slabs at the splitters the plan's homes draw (k_smp
    depth samples of each stride-interleaved home), each slab blended alone
    over the whole image from T = 1 (`_FusedRasterize`), the slabs
    composited front to back (`layered_dist._Composite`). The layered plan
    must match it to f32 rounding, forward and backward; the single blend it
    does not match where a blend stops (a later slab goes on compositing)."""
    def run(means, quats, scales, opacities, colors, viewmat, K, config, *, tap2d=None,
            absgrad_sink=None, **_):
        N = means.shape[0]
        proj = rasterize_mod.project_gaussians(
            means, quats, scales, viewmat, K, config.width, config.height,
            near_plane=config.near_plane, far_plane=config.far_plane,
            antialiased=(config.rasterize_mode == "antialiased"))
        means2d = proj.means2d if tap2d is None else proj.means2d + tap2d
        op_eff = opacities * proj.compensations
        cols = torch.cat([colors, proj.depths[:, None]], dim=-1) if config.with_depth else colors
        table = torch.cat([means2d, proj.conics, op_eff[:, None], cols], dim=-1)
        sink = absgrad_sink if absgrad_sink is not None else table.new_zeros((N, 2))
        live = proj.valid & (op_eff.detach() > 0)
        with torch.no_grad():
            packed, counts = binning.tile_spans(
                means2d.detach(), proj.radii, live, width=config.width, height=config.height,
                tile_size=config.tile_size, conics=proj.conics.detach(), op_eff=op_eff.detach())
            depth_key = torch.where(counts > 0, proj.depths.detach(), float("inf"))
            smp = []
            for h in range(n_ranks):
                dk = torch.sort(depth_key[h::n_ranks]).values
                n_live = int(torch.isfinite(dk).sum())
                pos = torch.clamp(torch.arange(k_smp, device=dk.device) * max(n_live, 1) // k_smp,
                                  0, dk.shape[0] - 1)
                smp.append(dk[pos] if n_live else torch.full_like(dk[pos], float("inf")))
            all_smp = torch.sort(torch.cat(smp)).values
            q = all_smp[torch.arange(1, n_ranks, device=dk.device) * k_smp]
            slab = torch.searchsorted(q, depth_key, right=True)
        # each slab's buffer is the plan's: I / n_ranks slots
        st = rasterize_mod.FusedStatics(config.max_intersections // n_ranks,
                                        config.tiles_x * config.tiles_y, config.tiles_x,
                                        config.tile_size)
        layers = [rasterize_mod._FusedRasterize.apply(
            st, table, packed, torch.where(slab == d, counts, 0), proj.depths.detach(), sink)
            for d in range(n_ranks)]
        rgb, t = layered_mod._Composite.apply(torch.stack([x[0] for x in layers]),
                                              torch.stack([x[1] for x in layers]))
        render, alpha = rasterize_mod._assemble_image(rgb, t, config, cols.shape[-1])
        n_isect = torch.stack([x[2] for x in layers]).max().reshape(1) * n_ranks
        return render, alpha, dict(means2d=means2d, radii=proj.radii, depths=proj.depths,
                                   n_intersections=n_isect,
                                   compensations=proj.compensations.detach())
    return run


@contextlib.contextmanager
def rasterizer_replaced(fn):
    """render_view calls fn in place of `rasterize` inside the block."""
    saved = trainer_mod.rasterize
    trainer_mod.rasterize = fn
    try:
        yield
    finally:
        trainer_mod.rasterize = saved


def rank_tile(a, mesh, state_sd, cfg, batches, dev) -> dict:
    """Phase 16's tile-sharded checks on one rank of a 2-rank 'tile' mesh:
    one view's render and gradients under each fused plan, one classic
    1920x1080 frame, Trainer(mesh=...) through a capacity growth."""
    params, aux = scene_from_state_dict(*state_sd, device=dev)
    n_gauss = _total_capacity(params)
    batch = batches[0]
    want_view = render_view(params, aux, cfg, batch, GRAD_STEP, device=dev)
    total1, _, _, sink1, grads1 = loss_and_grads(params, aux, cfg, batch, GRAD_STEP, device=dev)
    want_grads = dict(grads1, absgrad=sink1)
    single_ms = wall_ms(lambda: render_view(params, aux, cfg, batch, GRAD_STEP, device=dev), dev)
    out = dict(n_gauss=n_gauss, single_render_ms=single_ms)
    for plan, env in PARALLEL_PLANS.items():
        pcfg = cfg.replace(max_intersections=a["layered_i"]) if plan == "layered" else cfg
        rcfg = pcfg.raster_config()
        with plan_env(env):
            plans = dict(layered=layered_shard_plan(rcfg, 2, n_gauss),
                         dist=dist_shard_plan(rcfg, 2, n_gauss),
                         band=rasterize_mod._fused_shard_plan(rcfg, 2, n_gauss))
            ran = []
            with pipelines_recorded(ran):
                cuda_build.reset_launches()  # this plan's render counted from here ...
                got_view = render_view(params, aux, pcfg, batch, GRAD_STEP, device=dev,
                                       mesh=mesh)
                sync(dev)
                render_launches = dict(cuda_build.LAUNCHES)  # ... to here
                cuda_build.reset_launches()  # its gradient step counted from here ...
                total2, _, _, sink2, grads2 = loss_and_grads(params, aux, pcfg, batch,
                                                             GRAD_STEP, device=dev, mesh=mesh)
                sync(dev)
                grad_launches = dict(cuda_build.LAUNCHES)  # ... to here
            ms = wall_ms(lambda: render_view(params, aux, pcfg, batch, GRAD_STEP, device=dev,
                                             mesh=mesh), dev)
        ref_view, ref_grads, ref_total = want_view, want_grads, total1
        single = None
        if plan == "layered":
            # held against the layered semantics on one process; its
            # difference from the single blend is reported (layered_reference)
            single = dict(view_errors=view_errors(got_view, want_view),
                          grad_errors=grad_errors(dict(grads2, absgrad=sink2), want_grads))
            with rasterizer_replaced(layered_reference(2)):
                ref_view = render_view(params, aux, pcfg, batch, GRAD_STEP, device=dev)
                ref_total, _, _, ref_sink, ref_grads = loss_and_grads(
                    params, aux, pcfg, batch, GRAD_STEP, device=dev)
            ref_grads = dict(ref_grads, absgrad=ref_sink)
        out[plan] = dict(
            ran=ran, plans_active={k: v is not None for k, v in plans.items()},
            view_errors=view_errors(got_view, ref_view),
            grad_errors=grad_errors(dict(grads2, absgrad=sink2), ref_grads),
            against_single=single,
            loss_rel=abs(float(total2) - float(ref_total)) / abs(float(ref_total)),
            n_intersections=int(got_view["n_intersections"]),
            max_intersections=pcfg.max_intersections,
            render_launches=render_launches, grad_launches=grad_launches, render_ms=ms)
        del got_view, grads2, sink2

    # one classic frame at the render tool's size: the blend alone sharded
    W, H = a["render_size"]
    fcfg = configs.mtgs_config(W, H).replace(max_intersections=a["render_i"])
    K = np.asarray(batch.K.cpu()) * np.array([[W / a["width"]], [H / a["height"]], [1.0]])
    frame = Batch(image=torch.full((H, W, 3), 0.5, device=dev),
                  mask=torch.ones((H, W, 1), device=dev), c2w=batch.c2w,
                  K=torch.as_tensor(K, dtype=torch.float32, device=dev),
                  cam_idx=batch.cam_idx, image_idx=batch.image_idx,
                  travel_index=batch.travel_index, frame_idx=batch.frame_idx,
                  timestamp=batch.timestamp)
    del want_view, grads1, sink1, want_grads
    want_view = render_view(params, aux, fcfg, frame, GRAD_STEP, device=dev)
    total1, _, _, sink1, grads1 = loss_and_grads(params, aux, fcfg, frame, GRAD_STEP,
                                                 device=dev)
    ran = []
    with pipelines_recorded(ran):
        cuda_build.reset_launches()  # the sharded classic frame counted from here ...
        got_view = render_view(params, aux, fcfg, frame, GRAD_STEP, device=dev, mesh=mesh)
        total2, _, _, sink2, grads2 = loss_and_grads(params, aux, fcfg, frame, GRAD_STEP,
                                                     device=dev, mesh=mesh)
        sync(dev)
        launches = dict(cuda_build.LAUNCHES)  # ... to here
    out["classic"] = dict(
        ran=ran, view_errors=view_errors(got_view, want_view),
        grad_errors=grad_errors(dict(grads2, absgrad=sink2), dict(grads1, absgrad=sink1)),
        loss_rel=abs(float(total2) - float(total1)) / abs(float(total1)),
        n_intersections=int(got_view["n_intersections"]), launches=launches,
        fused_fits=fused_fits(a["render_i"], fcfg.raster_config().tiles_x
                              * fcfg.raster_config().tiles_y, n_gauss))
    del params, aux, want_view, got_view, grads1, grads2
    torch.cuda.empty_cache()

    # Trainer(mesh=...) through a growth of the intersection buffer at the
    # refine (isect_grow_frac lowered so that it fires), from a buffer whose
    # growth rounded to 512 alone would leave the band plan
    gcfg = cfg.replace(max_intersections=a["grow_from"], isect_grow_frac=0.01)
    params, aux = scene_from_state_dict(*state_sd, device=dev)
    trainer = Trainer(gcfg, params, aux, itertools.cycle(batches), seed=a["seed"], device=dev,
                      mesh=mesh)
    steps = []
    cuda_build.reset_launches()  # Trainer(mesh=...)'s launches counted from here ...
    for _ in range(a["grow_steps"]):
        ran = []
        with pipelines_recorded(ran):
            m = trainer.train(1)[0]
        steps.append(dict(ran=ran, max_intersections=trainer.cfg.max_intersections,
                          n_intersections=int(m["n_intersections"]),
                          total_loss=float(m["total_loss"]),
                          band_plan=rasterize_mod._fused_shard_plan(
                              trainer.cfg.raster_config(), 2, n_gauss) is not None))
    sync(dev)
    out["trainer"] = dict(steps=steps, growth=trainer.growth_events,
                          launches=dict(cuda_build.LAUNCHES),  # ... to here
                          digest=state_digest(trainer.state))
    return out


def parallel_world2(rank: int, world: int, dev, a: dict, batches) -> dict:
    """Phase 16 on one rank of the 2-rank world: data parallel, then tile
    sharded (the two meshes are the same ranks)."""
    state_sd, cfg = rank_scene(a, dev)
    batches = batches_to(batches, dev)
    data, tile = make_mesh([world], ("data",)), make_mesh([world], ("tile",))
    t0 = time.perf_counter()
    dp = rank_dp(a, data, state_sd, cfg, batches, dev)
    t1 = time.perf_counter()
    tiles = rank_tile(a, tile, state_sd, cfg, batches, dev)
    return dict(tf32=(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32),
                device=str(dev), dp=dp, tile=tiles,
                dp_seconds=t1 - t0, tile_seconds=time.perf_counter() - t1)


def parallel_world4(rank: int, world: int, dev, a: dict, batches) -> dict:
    """Phase 16 on one rank of the 4-rank world: one step over a (2 data, 2
    tile) mesh against the data-parallel step over its data axis, on views
    0 and 1."""
    state_sd, cfg = rank_scene(a, dev)
    batches = batches_to(batches[:2], dev)
    mesh = make_mesh([2, 2], ("data", "tile"))
    optim = OptimConfig(groups=default_groups(cfg.max_steps))
    group = mesh.group("data")
    res = {}
    for kind in ("dp", "2d"):
        params, aux = scene_from_state_dict(*state_sd, device=dev)
        state = init_train_state(params)
        batch = shard_batch(stacked(batches), mesh)
        kw = {} if kind == "dp" else dict(mesh=mesh, mesh_axis="tile", inside_shard_map=True)
        ran = []
        with plan_env(PARALLEL_PLANS["dist"]), pipelines_recorded(ran):
            _, _, _, sink, grads = loss_and_grads(params, aux, cfg, batch, 0, device=dev, **kw)
            keys = list(grads)
            red = pmean([grads[k] for k in keys] + [sink], group)
            make = make_dp_train_step if kind == "dp" else make_2d_train_step
            cuda_build.reset_launches()  # the step's launches counted from here ...
            t0 = time.perf_counter()
            metrics = make(cfg, optim, mesh, device=dev)(state, aux, stacked(batches))
            sync(dev)
            step_ms = 1e3 * (time.perf_counter() - t0)
            launches = dict(cuda_build.LAUNCHES)  # ... to here
        res[kind] = dict(ran=ran, grads=dict(zip(keys, red[:-1]), absgrad=red[-1]),
                         metrics={k: float(v) for k, v in metrics.items()}, state=state,
                         launches=launches, step_ms=step_ms)
        del params, grads, red
    d, t = res["dp"], res["2d"]
    # Adam's first step moves a parameter by lr * sign(g): where a gradient
    # is rounding noise the two steps may move it apart by up to 2 lr, so the
    # parameters are held where |g| > 1e-3 of the leaf's largest (f32 rounding)
    dp_params = dict(named_leaves(d["state"].params))
    params_diff = 0.0
    for k, x in named_leaves(t["state"].params):
        g = d["grads"][k]
        if not x.numel() or not g.abs().max() > 0:
            continue
        held = g.abs() > 1e-3 * g.abs().max()
        rel = (x - dp_params[k]).detach().abs() / torch.clamp(dp_params[k].detach().abs(), min=1.0)
        params_diff = max(params_diff, float(rel[held].max()) if held.any() else 0.0)
    densify = {f.name: max_scaled_err(getattr(t["state"].densify["background"], f.name),
                                      getattr(d["state"].densify["background"], f.name))
               for f in dataclasses.fields(t["state"].densify["background"])}
    return dict(
        ran=dict(dp=d["ran"], mesh2d=t["ran"]),
        grad_errors=grad_errors(t["grads"], d["grads"]),
        loss_rel=abs(t["metrics"]["total_loss"] - d["metrics"]["total_loss"])
        / abs(d["metrics"]["total_loss"]),
        psnr=(t["metrics"]["psnr"], d["metrics"]["psnr"]), params_rel_diff=params_diff,
        densify_errors=densify, launches=dict(dp=d["launches"], mesh2d=t["launches"]),
        step_ms=dict(dp=d["step_ms"], mesh2d=t["step_ms"]),
        digest=dict(dp=state_digest(d["state"]), mesh2d=state_digest(t["state"])))


def host_batches(batches):
    """Batches with their arrays copied to host numpy (sent to the ranks)."""
    return [Batch(**{f.name: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
                     for f in dataclasses.fields(Batch) for v in [getattr(b, f.name)]})
            for b in batches]


def phase_parallel(args, card: str, state_sd, batches, device: str = "cuda:0") -> tuple:
    """Phase 16: `mtgs_torch.parallel` as ranks on the one card (gloo: NCCL
    refuses two ranks on one device), at the mtgs preset's full width on
    phase 6's start (`state_sd`) and training views (`batches`). Returns
    (results, the launches of every rank summed)."""
    log(f"# parallel: backend gloo, every rank on cuda:0 of the one card ({card}); "
        "collectives staged through host memory")
    a = dict(seed=args.seed, n_bg=args.n_bg, n_sky=args.n_sky, n_inst=args.n_inst,
             width=args.width, height=args.height, views=args.views, focal=args.focal,
             dp_steps=PARALLEL_DP_STEPS, grow_from=PARALLEL_GROW_FROM,
             grow_steps=PARALLEL_GROW_STEPS, render_size=RENDER_SIZE, render_i=RENDER_I,
             layered_i=PARALLEL_LAYERED_I)
    batches = host_batches(batches)
    # the ranks read phase 6's start from one file (each building it from
    # the seed would take the host tens of seconds a world)
    state_path = ROOT / "build" / "chip_smoke" / "parallel_state.npz"
    state_path.parent.mkdir(parents=True, exist_ok=True)
    save_state(state_sd, state_path)
    a["state_path"] = str(state_path)
    try:
        t0 = time.perf_counter()
        w2 = launch(parallel_world2, 2, backend="gloo", device=device,
                    timeout=PARALLEL_TIMEOUT, args=(a, batches))
        t1 = time.perf_counter()
        w4 = launch(parallel_world4, 4, backend="gloo", device=device,
                    timeout=PARALLEL_TIMEOUT, args=(a, batches))
        t2 = time.perf_counter()
    finally:
        state_path.unlink(missing_ok=True)
    for r in w2 + w4:
        require(r.get("tf32", (False, False)) == (False, False),
                f"a rank runs with TF32 on: {r.get('tf32')}")
    total = {k: 0 for k in KERNELS}

    def count(launches):
        for k in KERNELS:
            total[k] += launches[k]

    # ---- data parallel (world 2) ----
    for rank, r in enumerate(w2):
        dp = r["dp"]
        i = dp["identical"]
        bad = {k: e for k, e in i["grad_errors"].items() if not e <= GRAD_TOL}
        require(not bad and i["loss_rel"] <= 1e-6,
                f"rank {rank}: DP step on identical views vs the single step: grads {bad}, "
                f"loss rel {i['loss_rel']}")
        require_launches(i["launches"], dict.fromkeys(FUSED_KERNELS, 1),
                         f"rank {rank}: one data-parallel step")
        t = dp["trainer"]
        require_launches(t["launches"], dict.fromkeys(FUSED_KERNELS, a["dp_steps"]),
                         f"rank {rank}: {a['dp_steps']} DPTrainer steps")
        require(not t["nonfinite"], f"rank {rank}: non-finite metrics {t['nonfinite']}")
        require(t["refine_events"] and t["reset_steps"] == [REFINE_EVERY],
                f"rank {rank}: refines {t['refine_events']}, resets {t['reset_steps']}")
        require(all(n <= t["max_intersections"] for n in t["n_intersections"]),
                f"rank {rank}: truncated steps {t['n_intersections']}")
        # the same two views every 3 steps: psnr rises within each stretch
        # between opacity resets
        cycle = len(batches) // 2
        for lo, hi in ((0, REFINE_EVERY), (REFINE_EVERY, a["dp_steps"])):
            same = [s for s in range(lo, hi) if s % cycle == lo % cycle]
            require(t["psnr"][same[-1]] > t["psnr"][same[0]],
                    f"rank {rank}: psnr on the same views did not rise over steps {same}: "
                    f"{[t['psnr'][s] for s in same]}")
        count(i["launches"])
        count(t["launches"])
    require(all(r["dp"]["trainer"]["digest"] == w2[0]["dp"]["trainer"]["digest"] for r in w2),
            "DPTrainer: the ranks' parameters, moments or densify statistics differ")
    dp0 = w2[0]["dp"]
    log(f"# parallel, DP (2 ranks): one step on identical views vs the single step: worst grad "
        f"{max(dp0['identical']['grad_errors'].values()):.3g}, loss rel "
        f"{dp0['identical']['loss_rel']:.3g}, params max diff "
        f"{dp0['identical']['params_max_abs_diff']:.3g}")
    log(f"# parallel, DP (2 ranks): {a['dp_steps']} DPTrainer steps, psnr "
        f"{[round(p, 2) for p in dp0['trainer']['psnr']]}; refine {dp0['trainer']['refine_events']}; "
        f"every rank's state bit-equal (sha256 {dp0['trainer']['digest'][:16]})")
    log(f"# parallel, DP step: {dp0['trainer']['ms_per_step_median']:.2f} ms wall (median after 2; "
        f"2 ranks time-sliced on one card, gloo through host memory: not a scaling figure; "
        f"{card})")

    # ---- tile sharded (world 2) ----
    expect = dict(band="band", dist="dist", layered="layered")
    for rank, r in enumerate(w2):
        tl = r["tile"]
        for plan, name in expect.items():
            p = tl[plan]
            require(p["ran"] == [name] * 2, f"rank {rank}, {plan}: pipelines run {p['ran']}")
            active = [k for k, v in p["plans_active"].items() if v]
            require(active and active[0] == plan, f"rank {rank}, {plan}: plans {p['plans_active']}")
            require(p["n_intersections"] <= p["max_intersections"],
                    f"rank {rank}, {plan}: n_intersections {p['n_intersections']} > "
                    f"{p['max_intersections']}: truncated")
            require_view_close(p["view_errors"], args.width * args.height,
                               f"rank {rank}, {plan} render")
            bad = {k: e for k, e in p["grad_errors"].items() if not e <= GRAD_TOL}
            require(not bad and p["loss_rel"] <= 1e-5,
                    f"rank {rank}, {plan}: grads {bad}, loss rel {p['loss_rel']}")
            require_launches(p["render_launches"],
                             dict(expand_fused=1, blend_forward=1), f"rank {rank}, {plan} render")
            require_launches(p["grad_launches"], dict.fromkeys(FUSED_KERNELS, 1),
                             f"rank {rank}, {plan} gradient step")
            count(p["render_launches"])
            count(p["grad_launches"])
        c = tl["classic"]
        require(c["ran"] == ["classic"] * 2 and not c["fused_fits"],
                f"rank {rank}, classic frame: pipelines run {c['ran']}")
        require(c["n_intersections"] <= a["render_i"],
                f"rank {rank}, classic frame: {c['n_intersections']} intersections > "
                f"{a['render_i']}: truncated")
        require_view_close(c["view_errors"], a["render_size"][0] * a["render_size"][1],
                           f"rank {rank}, classic frame")
        bad = {k: e for k, e in c["grad_errors"].items() if not e <= GRAD_TOL}
        require(not bad, f"rank {rank}, classic frame: grads {bad}")
        require_launches(c["launches"], dict(expand_pairs=2, rows_to_attr_major=2,
                                             attr_major_to_rows=1, blend_forward=2,
                                             blend_backward=1, dense_segment_sum=1),
                         f"rank {rank}, classic frame (render + gradient step)")
        count(c["launches"])
        tr = tl["trainer"]
        grown = [e for e in tr["growth"] if e["node"] == "max_intersections"]
        require(grown and all(e["new"] % 1024 == 0 for e in grown),
                f"rank {rank}: Trainer(mesh=) growth {tr['growth']}")
        require(all(s["ran"] == ["band"] and s["band_plan"] for s in tr["steps"]),
                f"rank {rank}: Trainer(mesh=) left the band plan: {tr['steps']}")
        require(tr["steps"][-1]["max_intersections"] > a["grow_from"],
                f"rank {rank}: no step ran on the grown buffer")
        require_launches(tr["launches"], dict.fromkeys(FUSED_KERNELS, a["grow_steps"]),
                         f"rank {rank}: {a['grow_steps']} Trainer(mesh=) steps")
        count(tr["launches"])
    require(all(r["tile"]["trainer"]["digest"] == w2[0]["tile"]["trainer"]["digest"]
                for r in w2), "Trainer(mesh=): the ranks' states differ")
    t0r = w2[0]["tile"]
    for plan in (*expect, "classic"):
        p = t0r[plan]
        log(f"# parallel, {plan} (2 ranks): view {p['view_errors']}, worst grad "
            f"{max(p['grad_errors'].values()):.3g} ({max(p['grad_errors'], key=p['grad_errors'].get)}), "
            f"n_intersections {p['n_intersections']}")
    single = t0r["layered"]["against_single"]
    log(f"# parallel, layered against the single blend (reported, not held): view "
        f"{single['view_errors']}, worst grad {max(single['grad_errors'].values()):.3g} "
        f"({max(single['grad_errors'], key=single['grad_errors'].get)})")
    log(f"# parallel, sharded render (band plan): {t0r['band']['render_ms']:.2f} ms wall, "
        f"ownership {t0r['dist']['render_ms']:.2f}, layered {t0r['layered']['render_ms']:.2f}, "
        f"single process {t0r['single_render_ms']:.2f} (2 ranks time-sliced on one card: not a "
        f"scaling figure; {card})")
    log(f"# parallel, Trainer(mesh=): growth {t0r['trainer']['growth']}; band plan at every step, "
        f"buffers {[s['max_intersections'] for s in t0r['trainer']['steps']]}")

    # ---- 2D (world 4) ----
    for rank, r in enumerate(w4):
        require(r["ran"] == dict(dp=[], mesh2d=["dist"] * 2),
                f"rank {rank}, 2D: pipelines run {r['ran']}")
        bad = {k: e for k, e in r["grad_errors"].items() if not e <= GRAD_TOL}
        require(not bad and r["loss_rel"] <= 1e-5,
                f"rank {rank}, 2D vs DP: grads {bad}, loss rel {r['loss_rel']}")
        require(r["params_rel_diff"] <= 1e-6,
                f"rank {rank}, 2D vs DP: params apart by {r['params_rel_diff']} (relative, where "
                "|g| > 1e-3 of the leaf's largest)")
        bad = {k: e for k, e in r["densify_errors"].items() if not e <= GRAD_TOL}
        require(not bad, f"rank {rank}, 2D vs DP: densify statistics {bad}")
        require_launches(r["launches"]["mesh2d"], dict.fromkeys(FUSED_KERNELS, 1),
                         f"rank {rank}: one 2D step")
        count(r["launches"]["dp"])
        count(r["launches"]["mesh2d"])
    for kind in ("dp", "mesh2d"):
        require(all(r["digest"][kind] == w4[0]["digest"][kind] for r in w4),
                f"2D world: the ranks' {kind} states differ")
    log(f"# parallel, 2D (2 data x 2 tile) vs DP over its data axis: worst grad "
        f"{max(w4[0]['grad_errors'].values()):.3g}, loss rel {w4[0]['loss_rel']:.3g}, psnr "
        f"{w4[0]['psnr']}, params rel diff {w4[0]['params_rel_diff']:.3g}; step ms "
        f"{w4[0]['step_ms']} (4 ranks time-sliced on one card: not a scaling figure)")
    log(f"# parallel: world 2 {t1 - t0:.1f} s, world 4 {t2 - t1:.1f} s")
    res = dict(backend="gloo", world2=w2, world4=w4, world2_seconds=t1 - t0,
               world4_seconds=t2 - t1, launches=total)
    return res, total


# ------------------------------------------------------------ preprocess

STACK_TRAVELS, STACK_FRAMES = 3, 10   # phase 17 (a): nuPlan's sensor sizes
STACK_CAMS, STACK_SIZE = 8, (1920, 1080)
STACK_BEAMS, STACK_AZIMUTHS, STACK_RANGE = 64, 2048, 80.0
STACK_BOXES = 30
STACK_VOXEL = 0.15                    # StackAccumulator's default
STACK_SEED = 17
CLOUD_ULPS = 1                        # the card's clouds against the CPU's, in float32 ulps
DATA_CONFIG_STEPS = 20                # phase 17 (c): train_scene.main --data-config
REGISTRATION_GATES = dict(EPE=1.0, ATE=0.5)  # register_traversals' exclusion gates
MOSAIC_TILE = 320                     # export_traversal_videos' tile width


def float32_ulps(got: np.ndarray, want: np.ndarray) -> int:
    """The largest distance in float32 ulps between two float32 arrays."""
    a = np.ascontiguousarray(got, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(want, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


def stack_inputs(seed: int) -> dict:
    """Seeded stacking inputs at nuPlan's sizes: per traversal, STACK_CAMS
    uint8 1920x1080 images and cityscapes label masks (0..18) around the
    ego; per frame, a STACK_BEAMS x STACK_AZIMUTHS sweep out to STACK_RANGE
    m, an ego pose and STACK_BOXES boxes with their track tokens (made on
    demand from the frame's seed)."""
    rng = np.random.default_rng(seed)
    W, H = STACK_SIZE
    f = 1545.0 * W / 1920  # nuPlan's focal length at 1920 wide
    K = np.array([[f, 0.0, W / 2], [0.0, f, H / 2 + 20.0 * W / 1920], [0.0, 0.0, 1.0]])
    R_cv = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    cams = []
    for yaw in np.linspace(0.0, 2 * np.pi, STACK_CAMS, endpoint=False):
        c, s = np.cos(yaw), np.sin(yaw)
        m = np.eye(4)
        m[:3, :3] = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]) @ R_cv
        m[:3, 3] = [1.5 * c, 1.0 * s, 1.6]
        cams.append(m)
    images = [[rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(STACK_CAMS)]
              for _ in range(STACK_TRAVELS)]
    masks = [[rng.integers(0, 19, (H, W), dtype=np.uint8) for _ in range(STACK_CAMS)]
             for _ in range(STACK_TRAVELS)]
    elev = np.deg2rad(np.linspace(-25.0, 15.0, STACK_BEAMS))
    azim = np.linspace(-np.pi, np.pi, STACK_AZIMUTHS, endpoint=False)
    ee, aa = np.meshgrid(elev, azim, indexing="ij")
    dirs = np.stack([np.cos(ee) * np.cos(aa), np.cos(ee) * np.sin(aa), np.sin(ee)],
                    -1).reshape(-1, 3)

    def frame(t: int, f: int):
        r = np.random.default_rng((seed, t, f))
        pts = (dirs * r.uniform(2.0, STACK_RANGE, (len(dirs), 1))).astype(np.float32)
        yaw = 0.01 * t
        e2g = np.eye(4)
        e2g[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0.0], [np.sin(yaw), np.cos(yaw), 0.0],
                       [0.0, 0.0, 1.0]]
        e2g[:3, 3] = [2.5 * f - 10.0, -1.8 + 0.3 * t, 0.0]
        boxes = np.concatenate([
            r.uniform(-30.0, 30.0, (STACK_BOXES, 2)), r.uniform(-1.0, 1.0, (STACK_BOXES, 1)),
            r.uniform(3.5, 5.0, (STACK_BOXES, 1)), r.uniform(1.7, 2.1, (STACK_BOXES, 1)),
            r.uniform(1.4, 2.0, (STACK_BOXES, 1)), r.uniform(-np.pi, np.pi, (STACK_BOXES, 1))], 1)
        return pts, e2g, boxes, [f"trk{t}_{b}" for b in range(STACK_BOXES)]

    return dict(K=K, cams=cams, images=images, masks=masks, frame=frame)


def stack_run(inputs: dict, dev, out: Path, want=None) -> dict:
    """StackAccumulator over every frame on `dev`, each step timed between
    synchronizes; with `want` (the card's run), every frame's rgb, seen,
    semantic labels and box masks must equal it. Returns times, the
    per-frame outputs and the written clouds."""
    from mtgs_torch.preprocess.stack_point_cloud import (
        StackAccumulator, paint_points, points_in_boxes,
    )

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    acc = StackAccumulator(voxel=STACK_VOXEL, device=dev)
    Ks = [inputs["K"]] * STACK_CAMS
    paint_ms, boxes_ms, add_ms, frames = [], [], [], []
    for t in range(STACK_TRAVELS):
        imgs = [torch.as_tensor(im, device=dev) for im in inputs["images"][t]]
        masks = [torch.as_tensor(m, device=dev) for m in inputs["masks"][t]]
        for f in range(STACK_FRAMES):
            pts, e2g, boxes, toks = inputs["frame"](t, f)
            pts = torch.as_tensor(pts, device=dev)
            sync()
            t0 = time.perf_counter()
            rgb, seen, sem = paint_points(pts, imgs, inputs["cams"], Ks, masks, device=dev)
            sync()
            t1 = time.perf_counter()
            bg, per_box = points_in_boxes(pts, boxes, device=dev)
            sync()
            t2 = time.perf_counter()
            acc.add_frame(pts, rgb, seen, sem, e2g, boxes, toks)
            sync()
            t3 = time.perf_counter()
            paint_ms.append(1e3 * (t1 - t0))
            boxes_ms.append(1e3 * (t2 - t1))
            add_ms.append(1e3 * (t3 - t2))
            got = [x.cpu() for x in (rgb, seen, sem, bg, per_box)]
            if want is not None:
                w = want["frames"][len(frames)]
                bad = [n for n, a, b in zip(("rgb", "seen", "sem", "background", "boxes"), got, w)
                       if not torch.equal(a, b)]
                require(not bad, f"stacking: frame ({t}, {f}) on the CPU differs from the card "
                                 f"in {bad}")
            frames.append(got if want is None else None)
    sync()
    t0 = time.perf_counter()
    written = acc.finalize(out)
    sync()
    finalize_s = time.perf_counter() - t0
    return dict(paint_ms=paint_ms, boxes_ms=boxes_ms, add_frame_ms=add_ms, frames=frames,
                finalize_s=finalize_s, written=written,
                seen_fraction=float(np.mean([float(x[1].float().mean()) for x in frames]))
                if want is None else None)


def stack_phase(dev, work: Path, card: str) -> dict:
    """Phase 17 (a): the stacking at nuPlan's sizes on the card, then the
    same run on the CPU: every frame's outputs equal, the clouds the same
    rows within CLOUD_ULPS."""
    from mtgs_torch.utils.pointcloud import load_pcd

    t0 = time.perf_counter()
    inputs = stack_inputs(STACK_SEED)
    setup_s = time.perf_counter() - t0
    gpu = stack_run(inputs, dev, work / "card")
    cpu = stack_run(inputs, torch.device("cpu"), work / "cpu", want=gpu)
    names = sorted(p.relative_to(work / "card") for p in gpu["written"])
    require(names == sorted(p.relative_to(work / "cpu") for p in cpu["written"]),
            "stacking: the card and the CPU wrote different files")
    require(Path("stacked_point_cloud/background.pcd.npz") in names and len(names) > 1,
            f"stacking: no background or no instance cloud ({len(names)} files)")
    worst, rows = 0, {}
    for rel in names:
        (gx, gc), (cx, cc) = load_pcd(work / "card" / rel), load_pcd(work / "cpu" / rel)
        require(gx.shape == cx.shape, f"stacking: {rel}: {gx.shape[0]} rows on the card, "
                                      f"{cx.shape[0]} on the CPU")
        worst = max(worst, float32_ulps(gx, cx), float32_ulps(gc, cc))
        rows[str(rel)] = int(gx.shape[0])
    require(worst <= CLOUD_ULPS, f"stacking: clouds {worst} float32 ulps apart (> {CLOUD_ULPS})")
    n_pts = STACK_BEAMS * STACK_AZIMUTHS

    def med(xs):
        return float(np.median(xs[1:]))  # the first frame pays the first calls

    res = dict(
        card=card, setup_s=setup_s, frames=STACK_TRAVELS * STACK_FRAMES, points=n_pts,
        cameras=STACK_CAMS, size=list(STACK_SIZE), boxes=STACK_BOXES,
        seen_fraction=gpu["seen_fraction"], clouds=len(names),
        background_rows=rows["stacked_point_cloud/background.pcd.npz"],
        instance_rows=sum(v for k, v in rows.items() if k.startswith("instance")),
        cloud_ulps=worst,
        card_ms=dict(paint_points=med(gpu["paint_ms"]), points_in_boxes=med(gpu["boxes_ms"]),
                     add_frame=med(gpu["add_frame_ms"]), finalize_s=gpu["finalize_s"]),
        cpu_ms=dict(paint_points=med(cpu["paint_ms"]), points_in_boxes=med(cpu["boxes_ms"]),
                    add_frame=med(cpu["add_frame_ms"]), finalize_s=cpu["finalize_s"]),
        cpu_threads=torch.get_num_threads())
    log(f"# preprocess ({card}): stacking {res['frames']} frames of {n_pts} points x "
        f"{STACK_CAMS} cameras at {STACK_SIZE[0]}x{STACK_SIZE[1]} x {STACK_BOXES} boxes "
        f"(seen {res['seen_fraction']:.3f}): card paint_points {res['card_ms']['paint_points']:.2f}"
        f" ms/frame, points_in_boxes {res['card_ms']['points_in_boxes']:.2f}, add_frame "
        f"{res['card_ms']['add_frame']:.2f}, finalize {gpu['finalize_s']:.3f} s; CPU "
        f"({res['cpu_threads']} threads) {res['cpu_ms']['paint_points']:.2f} / "
        f"{res['cpu_ms']['points_in_boxes']:.2f} / {res['cpu_ms']['add_frame']:.2f} ms/frame, "
        f"finalize {cpu['finalize_s']:.3f} s; every frame equal, {len(names)} clouds "
        f"({res['background_rows']} background rows, {res['instance_rows']} instance rows) within "
        f"{worst} ulp")
    return res


def timed_stages(stage_s: dict, scan_ms: list):
    """Wrap each pipeline stage (seconds between synchronizes) and the ICP's
    register_scan (ms a scan) for the `with` block."""
    from mtgs_torch.preprocess import lidar_registration, pipeline

    stack = contextlib.ExitStack()

    def stage(name):
        def wrap(fn):
            def call(vs, cfg, device):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return fn(vs, cfg, device)
                finally:
                    torch.cuda.synchronize()
                    stage_s[name] = time.perf_counter() - t0
            return call
        return wrap

    def scan(fn):
        def call(self, xyz):
            t0 = time.perf_counter()
            out = fn(self, xyz)
            scan_ms.append(dict(ms=1e3 * (time.perf_counter() - t0), points=len(xyz)))
            return out
        return call

    for name in list(pipeline.STAGES):
        stack.enter_context(wrapped_item(pipeline.STAGES, name, stage(name)))
    stack.enter_context(wrapped(lidar_registration.LidarOdometry, "register_scan", scan))
    return stack


@contextlib.contextmanager
def wrapped_item(mapping: dict, key, wrap):
    saved = mapping[key]
    mapping[key] = wrap(saved)
    try:
        yield
    finally:
        mapping[key] = saved


def pipeline_phase(fx, dev, work: Path, card: str) -> dict:
    """Phase 17 (b): the committed road block through `run_pipeline` stages
    5-8 on the card, from the raw stage `write_stage_inputs` builds (nuPlan's
    raw schema, the JPEGs undistorted): registration ok with every
    traversal's EPE and ATE under the gates, COLMAP skipped with the
    fixed-pose model written, dense depth skipped, stacking ok with
    non-empty clouds. Then (d): the preview page of the final stage and the
    mosaics of every traversal."""
    from mtgs_torch.preprocess import pipeline as prep
    from mtgs_torch.preprocess.export_videos import export_traversal_videos
    from mtgs_torch.preprocess.video_scene import VideoScene
    from mtgs_torch.tools import preview
    from mtgs_torch.utils.pointcloud import load_pcd

    t0 = time.perf_counter()
    root = fx.materialize(work / "road_block")
    raw = fx.write_stage_inputs(root)
    vs = VideoScene(work, "road_block")
    vs.save(raw, "raw")
    setup_s = time.perf_counter() - t0
    stage_s, scan_ms = {}, []
    with timed_stages(stage_s, scan_ms):
        t0 = time.perf_counter()
        status = prep.run_pipeline(work, "road_block", {}, start=5, stop=8, device=dev)
        run_s = time.perf_counter() - t0
    require(status["lidar_registration"] == "ok" and status["stack_point_cloud"] == "ok",
            f"run_pipeline: {status}")
    require(status["colmap"].startswith("skipped: fixed-pose model written")
            and (vs.colmap_path / "sparse_model" / "images.bin").exists(), f"colmap: {status}")
    require(status["dense_depth"].startswith("skipped: UniDepth"), f"dense_depth: {status}")
    registered = vs.load("registered")
    errors = {tok: info["registration_errors"] for tok, info in registered.items()}
    bad = {tok: e for tok, e in errors.items()
           if registered[tok]["registration_excluded"]
           or any(e[k] > gate for k, gate in REGISTRATION_GATES.items())}
    require(not bad, f"lidar_registration: traversals over the gates {bad}")
    clouds = {str(p.relative_to(root)): len(load_pcd(p)[0]) for p in sorted(root.rglob("*.pcd.npz"))}
    require(clouds.get("stacked_point_cloud/background.pcd.npz", 0) > 0
            and all(n > 0 for n in clouds.values()), f"stack_point_cloud: clouds {clouds}")
    final = vs.load()
    require(vs.latest_stage() == "final", f"latest stage {vs.latest_stage()}")

    # (d) the preview page and the mosaics
    t0 = time.perf_counter()
    page = preview.build_preview_html(final, work / "preview.html")
    preview_ms = 1e3 * (time.perf_counter() - t0)
    text = page.read_text()
    require(all(f'"{t.split("-")[-1]}": {{"pts"' in text for t in final), "preview: traversals")
    t0 = time.perf_counter()
    mosaics = export_traversal_videos(vs, tile_width=MOSAIC_TILE, make_video=False)
    mosaic_s = time.perf_counter() - t0
    require(len(mosaics) == sum(len(i["frame_infos"]) for i in final.values()),
            f"{len(mosaics)} mosaics")
    first = final[sorted(final)[0]]["frame_infos"][0]["cams"]["CAM_F0"]["data_path"]
    camera = image_io.read_image(root / "raw_images" / first)
    th = MOSAIC_TILE * camera.shape[0] // camera.shape[1]
    tile = image_io.resize_u8(camera, (MOSAIC_TILE, th), bicubic=True)
    got = image_io.read_image(mosaics[0])
    require(got.shape == (th, 2 * MOSAIC_TILE, 3) and np.array_equal(got[:, :MOSAIC_TILE], tile),
            "mosaic: the camera tile")
    n_scan = len(scan_ms)
    res = dict(card=card, setup_s=setup_s, run_s=run_s, status=status, stage_s=stage_s,
               icp_scans=n_scan, icp_ms_per_scan=float(np.median([s["ms"] for s in scan_ms])),
               icp_points_per_scan=float(np.mean([s["points"] for s in scan_ms])),
               registration_errors=errors, clouds=clouds, preview_ms=preview_ms,
               preview_bytes=len(text), mosaics=len(mosaics),
               mosaic_ms=1e3 * mosaic_s / max(len(mosaics), 1))
    log(f"# preprocess ({card}): stages 5-8 of the road block in {run_s:.2f} s (inputs "
        f"{setup_s:.1f} s): {', '.join(f'{k} {v:.3f} s' for k, v in stage_s.items())}; ICP "
        f"{res['icp_ms_per_scan']:.1f} ms/scan ({n_scan} scans of ~"
        f"{res['icp_points_per_scan']:.0f} points); errors {errors}; clouds {clouds}")
    log(f"# preprocess ({card}): preview page {preview_ms:.1f} ms ({len(text)} bytes); "
        f"{len(mosaics)} mosaics at {MOSAIC_TILE} px tiles, {res['mosaic_ms']:.1f} ms each")
    return res


def data_config_phase(fx, dev, block: Path, work: Path, card: str, untrained_psnr: float):
    """Phase 17 (c): `train_scene.main --data-config` on phase 11's road
    block, named by a YAML `save_yaml` writes: DATA_CONFIG_STEPS steps of
    the `mtgs` preset at 960x540, checked as phase 11 checks its run (the
    fused four once per step, the forward two once per eval view, every
    step finite and untruncated), the run's data folder the block's."""
    from mtgs_torch.preprocess.roadblock_config import RoadBlockConfig, save_yaml

    cfg_path = work / "road_block.yaml"
    save_yaml(RoadBlockConfig(road_block_name=block.name, data_root=str(block.parent)),
              cfg_path)
    out = work / "data_config_run"
    argv = ["--data-config", str(cfg_path), "--method", "mtgs", "--scale", "0.5",
            "--width", str(NUPLAN_SIZE[0]), "--height", str(NUPLAN_SIZE[1]),
            "--travels", "0", "1", "--eval-travels", "2", "--steps", str(DATA_CONFIG_STEPS),
            "--device", str(dev), "--out", str(out)]
    rec = dict(steps=[], evals=[])
    printed, launches, wall_s = nuplan_main(argv, rec)
    require_nuplan_run(launches, rec, DATA_CONFIG_STEPS, "train_scene.main --data-config")
    rc = json.loads((out / "run_config.json").read_text())
    require(rc["data"] == str(block.absolute()), f"--data-config trained on {rc['data']}")
    result = json.loads((out / "eval_result.json").read_text())
    require(result["num_images"] == rec["evals"][0]["views"] and np.isfinite(result["psnr"]),
            f"eval {result}")
    res = dict(card=card, steps=DATA_CONFIG_STEPS, wall_s=wall_s, eval=result,
               untrained_psnr=untrained_psnr, launches=launches,
               ms_per_step_median=float(np.median([r["ms"] for r in rec["steps"]][2:])),
               config=cfg_path.read_text())
    log(f"# preprocess ({card}): train_scene --data-config {DATA_CONFIG_STEPS} steps in "
        f"{wall_s:.1f} s, ms/step median {res['ms_per_step_median']:.2f}; eval psnr "
        f"{result['psnr']:.3f} dB (untrained {untrained_psnr:.3f}); launches {launches}")
    return res, launches


def phase_preprocess(card: str, dev, block: Path, untrained_psnr: float):
    """Phase 17: the data factory. (a) stacking at nuPlan's sizes on the
    card against the CPU, (b) the committed road block through stages 5-8,
    (c) train_scene --data-config on phase 11's block, (d) the preview page
    and mosaics. Returns (results, the launches of (c))."""
    fx = nuplan_fixture()
    work = Path(tempfile.mkdtemp(prefix="preprocess_", dir=ROOT / "build"))
    t0 = time.perf_counter()
    try:
        config_res, launches = data_config_phase(fx, dev, block, work, card, untrained_psnr)
        stack_res = stack_phase(dev, work / "stack", card)
        pipeline_res = pipeline_phase(fx, dev, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res = dict(stacking=stack_res, pipeline=pipeline_res, data_config=config_res,
               phase_s=time.perf_counter() - t0)
    log(f"# preprocess ({card}): phase 17 took {res['phase_s']:.1f} s")
    return res, launches


# ----------------------------------------------------------------- tools

ONCHIP_TRAIN_STEPS = 30      # phase 18: onchip_smoke's default --steps
ONCHIP_EVAL_VIEWS, ONCHIP_VIEWER = 4, 3
GT_VIEWS = 6                 # grow_demo's and onchip_smoke's scenes: 2 traversals x 3 frames
GROW_SIZE, GROW_N_BG = (960, 540), 100_000
GROW_STEPS = 400             # grow_demo's --max-steps (its default 2000, cut in depth)
GROW_TPU_LOG = ROOT / "results" / "onchip" / "20260821_060110" / "grow_demo.log"
GROW_FIXTURE = ROOT / "tests" / "fixtures" / "grow_demo_jax.json"  # JAX's run on the CPU
GROW_ALIVE_TOL = 0.01        # alive counts cross float thresholds (gradient > 1e-9, opacity)
GROW_GT_ISECT = 1 << 17      # grow_demo's ground-truth buffer (make_synthetic_scene's default)
FARM_STEPS = 20              # the farm: train_scene steps a task
FARM_TASKS = ("block_a", "block_b")


def tool_run(main, argv, what: str):
    """`main(argv)` in-process, its stdout kept, with the launch counters
    zeroed just before and read just after. Returns (exit code, stdout,
    launches, seconds)."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    # this tool's run: kernel launches counted from here ...
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_build.LAUNCHES)
    # ... to here
    printed = buf.getvalue()
    for line in printed.splitlines():
        log(f"#   {what}: {line}")
    return rc, printed, launches, seconds


def last_json(printed: str) -> dict:
    return json.loads(printed.strip().splitlines()[-1])


def validate_recorders(rec: dict):
    """A wrapper of `validate_fused.run` recording the launches of each path."""
    def wrap(fn):
        def call(scene, viewmat, K, gw, cfg):
            before = dict(cuda_build.LAUNCHES)
            out = fn(scene, viewmat, K, gw, cfg)
            torch.cuda.synchronize()
            rec["fused" if cfg.fused else "classic"] = launch_delta(before)
            return out
        return call
    return wrap


def tools_validate(total) -> dict:
    """validate_fused at its defaults: exit 0, VALIDATE PASS; kernels 1-4
    on the fused run (a forward, then a forward and backward), the classic
    path's six on the classic run."""
    rec = {}
    with wrapped(validate_fused, "run", validate_recorders(rec)):
        rc, printed, launches, seconds = tool_run(validate_fused.main, [], "validate_fused")
    require(rc == 0 and "VALIDATE PASS" in printed, f"validate_fused: rc {rc}\n{printed}")
    require_launches(rec["fused"], dict(expand_fused=2, blend_forward=2, blend_backward=1,
                                        dense_segment_sum=1), "validate_fused, fused path")
    require_launches(rec["classic"], dict(expand_pairs=2, rows_to_attr_major=2,
                                          blend_forward=2, blend_backward=1,
                                          dense_segment_sum=1, attr_major_to_rows=1),
                     "validate_fused, classic path")
    total.update(launches)
    return dict(printed=printed.splitlines(), launches=rec, seconds=seconds)


def tools_onchip(total, work: Path) -> dict:
    """onchip_smoke at its defaults: exit 0, its three flags true; the fused
    forward pair once for every ground-truth view, training step, eval view,
    interpolated frame and viewer request, the backward pair once a step."""
    out = work / "onchip"
    rc, printed, launches, seconds = tool_run(onchip_smoke.main, ["--out", str(out)],
                                              "onchip_smoke")
    res = last_json(printed)
    require(rc == 0 and res["eval_ok"] and res["interp_ok"] and res["viewer_ok"]
            and res["backend"] == "cuda", f"onchip_smoke: rc {rc}, {res}")
    frames = len(list((out / "interp").glob("frame_*.png")))
    fwd = GT_VIEWS + ONCHIP_TRAIN_STEPS + ONCHIP_EVAL_VIEWS + frames + ONCHIP_VIEWER
    require_launches(launches, dict(expand_fused=fwd, blend_forward=fwd,
                                    blend_backward=ONCHIP_TRAIN_STEPS,
                                    dense_segment_sum=ONCHIP_TRAIN_STEPS), "onchip_smoke")
    total.update(launches)
    return dict(res, frames=frames, launches=launches, seconds=seconds)


def grow_fused_steps(trainer, steps: int, seed_capacity: int, ntl: int) -> int:
    """The training steps of a grow_demo run that `fused_fits` sends down
    the fused path, replayed from the trainer's growth events: an event at
    step s sets the buffer (or the capacity) of steps s + 1 on."""
    events = trainer.growth_events
    isect = next((e["old"] for e in events if e["node"] == "max_intersections"),
                 trainer.cfg.max_intersections)
    cap, fused = seed_capacity, 0
    for step in range(1, steps + 1):
        fused += fused_fits(isect, ntl, cap)
        for e in events:
            if e["step"] == step:
                if e["node"] == "max_intersections":
                    isect = e["new"]
                else:
                    cap = e["new"]
    return fused


GROW_LINE = re.compile(r"^# step (\d+): alive=(\d+) capacity=(\d+) overflow=(\d+) "
                       r"max_isect=(\d+)$", re.M)
REFINE_LINE = re.compile(r"^# refine (\d+): n_split=(\d+) n_dup=(\d+) n_cull=(\d+)$", re.M)


def grow_refines(err: str) -> list:
    """grow_demo's refines from its stderr: a `# step` line a span (alive,
    capacity, overflow, buffer) with the refine's counts where one ran."""
    counts = {int(m[0]): dict(n_split=int(m[1]), n_dup=int(m[2]), n_cull=int(m[3]))
              for m in REFINE_LINE.findall(err)}
    return [dict(step=int(m[0]), alive=int(m[1]), capacity=int(m[2]), overflow=int(m[3]),
                 max_isect=int(m[4]), **counts.get(int(m[0]), {}))
            for m in GROW_LINE.findall(err)]


def grow_run(total, argv, what: str, rc_want: int = 0) -> dict:
    """One grow_demo run: exit rc_want, a growth event, no overflow; every step
    one forward and one backward, on the path `fused_fits` picks at that
    step's buffer and capacity (from the trainer's growth events), the
    ground truth's views on the path it picks at their buffer. Returns the
    tool's JSON with its refines (from its stderr)."""
    opts = dict(zip(argv[::2], argv[1::2]))
    w, h, n_bg = int(opts["--width"]), int(opts["--height"]), int(opts["--n-bg"])
    rec, err = {}, io.StringIO()

    def record(fn):
        def call(self, *a, **kw):
            rec["trainer"] = self
            return fn(self, *a, **kw)
        return call

    with wrapped(Trainer, "train", record), contextlib.redirect_stderr(err):
        rc, printed, launches, seconds = tool_run(grow_demo.main, argv, what)
    res = last_json(printed)
    require(rc == rc_want and res["n_growth_events"] >= 1 and res["overflow"] == 0
            and res["optimizer_state_consistent"], f"{what}: rc {rc}, {res}")
    n, ntl = res["steps"], -(-w // 32) * -(-h // 32)
    gt_fused = fused_fits(GROW_GT_ISECT, ntl, n_bg)
    gt_f, gt_c = (GT_VIEWS, 0) if gt_fused else (0, GT_VIEWS)
    events = rec["trainer"].growth_events
    fused = grow_fused_steps(rec["trainer"], n, res["seed_capacity"], ntl)
    classic = n - fused
    require(fused >= 1, f"{what}: no fused step; growth events {events}")
    require_launches(launches, dict(expand_fused=gt_f + fused, expand_pairs=gt_c + classic,
                                    rows_to_attr_major=gt_c + classic,
                                    attr_major_to_rows=classic, blend_forward=GT_VIEWS + n,
                                    blend_backward=n, dense_segment_sum=n),
                     f"{what}: {n} steps, {fused} fused by its growth events")
    total.update(launches)
    return dict(res, refines=grow_refines(err.getvalue()), fused_steps=fused,
                classic_steps=classic, growth_events=events, launches=launches,
                seconds=seconds)


def tpu_log_alive() -> dict:
    """JAX's TPU run of grow_demo at its defaults (the committed log): the
    alive count at each logged step."""
    return {r["step"]: r["alive"] for r in grow_refines(GROW_TPU_LOG.read_text())}


def tools_grow(total) -> dict:
    """grow_demo twice. At 960x540 from 100k seeds for GROW_STEPS steps
    (JAX's scene for seed 0): every refine's alive count beside JAX's TPU
    log's. At the size of the CPU comparison (GROW_FIXTURE's arguments, JAX
    on the CPU): every refine's capacity, buffer and overflow equal to
    JAX's and its alive count within GROW_ALIVE_TOL."""
    (w, h), n_bg = GROW_SIZE, GROW_N_BG
    full = grow_run(total, ["--width", str(w), "--height", str(h), "--n-bg", str(n_bg),
                            "--max-steps", str(GROW_STEPS)], "grow_demo")
    tpu = tpu_log_alive()
    for r in full["refines"]:
        j = tpu.get(r["step"])
        ratio = f"{r['alive'] / j:.4f}" if j else "-"
        log(f"# grow_demo step {r['step']}: alive {r['alive']} (JAX's TPU log: {j}, "
            f"ratio {ratio}) capacity {r['capacity']} buffer {r['max_isect']} "
            f"n_dup {r.get('n_dup')} n_cull {r.get('n_cull')} n_split {r.get('n_split')}")
    fx = json.loads(GROW_FIXTURE.read_text())
    # (JAX's exit code too: at this size the capacity grows less than 2x)
    small = grow_run(total, fx["argv"], "grow_demo at the CPU comparison's size", fx["rc"])
    require([r["step"] for r in small["refines"]] == [r["step"] for r in fx["refines"]],
            f"grow_demo small: steps {small['refines']} against JAX's {fx['refines']}")
    for got, want in zip(small["refines"], fx["refines"]):
        log(f"# grow_demo {fx['argv']} step {got['step']}: alive {got['alive']} "
            f"(JAX on the CPU {want['alive']}), capacity {got['capacity']} "
            f"({want['capacity']}), buffer {got['max_isect']} ({want['max_isect']}), "
            f"n_dup {got.get('n_dup')} ({want.get('n_dup')}), "
            f"n_cull {got.get('n_cull')} ({want.get('n_cull')})")
        require(all(got[k] == want[k] for k in ("capacity", "max_isect", "overflow"))
                and abs(got["alive"] - want["alive"]) <= GROW_ALIVE_TOL * want["alive"],
                f"grow_demo small, step {got['step']}: {got} against JAX's {want}")
    return dict(full, tpu_log_alive={r["step"]: tpu.get(r["step"]) for r in full["refines"]},
                cpu_size=dict(small, jax=fx["refines"]))


def tools_scaling(total) -> dict:
    """scaling_bench over worlds 1 and 2 at 200k gaussians, gloo on cuda:0,
    in wall mode and with --cost: world 1 in this process, world 2 as two
    ranks; every rank's fused four once a step (warm-up included), no
    render truncated, and world 2's fullest band between half and all of
    the image's pairs."""
    res = {}
    # steps a rank takes: a warm-up and --iters' 10 timed steps, or a
    # warm-up and the traced step
    for label, extra, steps in (("wall", [], 11), ("cost", ["--cost"], 2)):
        rc, printed, launches, seconds = tool_run(
            scaling_bench.main, ["--devices", "1", "2", *extra], f"scaling_bench {label}")
        r = last_json(printed)
        require(rc == 0 and r["note"].startswith("ranks time-sliced on one card")
                and r["truncated"] == {"1": False, "2": False},
                f"scaling_bench {label}: rc {rc}, {r}")
        want = dict.fromkeys(FUSED_KERNELS, steps)
        require_launches(launches, want, f"scaling_bench {label}, world 1")
        for world, ranks in r["launches"].items():
            for rank, got in enumerate(ranks):
                require(got == want, f"scaling_bench {label}, world {world} rank {rank}: "
                                     f"launches {got}, expected {want}")
                total.update(got)
        image, band = r["fullest_band_pairs"]["1"], r["fullest_band_pairs"]["2"]
        require(0 < image / 2 <= band <= image,
                f"scaling_bench {label}: fullest band {band} of the image's {image} pairs")
        res[label] = dict(r, seconds=seconds)
    return res


def tools_microbench(total) -> dict:
    """microbench_ops at JAX's sizes: kernels 6 and 7 launched once a timed
    call and once in warm-up, nothing else."""
    rc, printed, launches, seconds = tool_run(microbench_ops.main, [], "microbench_ops")
    res = last_json(printed)
    require(rc == 0 and all(np.isfinite(v) and v > 0 for v in res["rows"].values()),
            f"microbench_ops: rc {rc}, {res}")
    n = 1 + microbench_ops.ITERS
    require_launches(launches, dict(rows_to_attr_major=n, attr_major_to_rows=n),
                     "microbench_ops")
    total.update(launches)
    return dict(res, launches=launches, seconds=seconds)


CHILD_LAUNCHES = "[train_scene] kernel launches "


def tools_farm(total, work: Path) -> dict:
    """benchmark_farm: two tasks on a copy of the committed road block
    (FARM_STEPS steps each, --slots 2, both children on the card), then
    --resume: every child exits 0 with a finite eval_result.json and its
    log shows the fused four once a step and the forward pair once an eval
    view; the resumed run returns `cached` for both, starts no child and
    writes the same tables but for the status column."""
    block = nuplan_fixture().materialize(work / "road_block")
    out = work / "farm"
    tasks = [dict(name=n, data=str(block), travels=[0, 1], eval_travels=[2], steps=FARM_STEPS)
             for n in FARM_TASKS]
    (work / "tasks.json").write_text(json.dumps(tasks))
    argv = ["--tasks", str(work / "tasks.json"), "--out", str(out), "--slots", "2"]
    rc, printed, launches, seconds = tool_run(benchmark_farm.main, argv, "benchmark_farm")
    require(rc == 0 and f"{len(tasks)}/{len(tasks)} scenes complete" in printed,
            f"benchmark_farm: rc {rc}\n{printed}")
    require_launches(launches, {}, "benchmark_farm's own process")
    children = {}
    for n in FARM_TASKS:
        logged = (out / n / "train.log").read_text()
        line = [l for l in logged.splitlines() if l.startswith(CHILD_LAUNCHES)]
        require(line, f"farm task {n}: no launch line in its log:\n{logged[-2000:]}")
        got = json.loads(line[-1][len(CHILD_LAUNCHES):])
        result = json.loads((out / n / "eval_result.json").read_text())
        views = result["num_images"]
        require(np.isfinite(result["psnr"]) and views > 0, f"farm task {n}: {result}")
        require_launches(got, dict(expand_fused=FARM_STEPS + views,
                                   blend_forward=FARM_STEPS + views,
                                   blend_backward=FARM_STEPS, dense_segment_sum=FARM_STEPS),
                         f"farm task {n}: {FARM_STEPS} steps and {views} eval views")
        total.update(got)
        children[n] = dict(launches=got, psnr=result["psnr"], views=views,
                           log_mtime=(out / n / "train.log").stat().st_mtime_ns)
    first = [(out / f).read_text() for f in ("results_summary.csv", "paste_table.tsv")]
    rc2, printed2, launches2, seconds2 = tool_run(benchmark_farm.main, argv + ["--resume"],
                                                  "benchmark_farm --resume")
    again = [(out / f).read_text() for f in ("results_summary.csv", "paste_table.tsv")]
    require(rc2 == 0 and all((out / n / "train.log").stat().st_mtime_ns
                             == children[n]["log_mtime"] for n in FARM_TASKS),
            "benchmark_farm --resume started a child")
    rows = list(csv.DictReader(io.StringIO(again[0])))
    require([r["status"] for r in rows] == ["cached"] * len(tasks),
            f"benchmark_farm --resume: statuses {[r['status'] for r in rows]}")
    require([t.replace("cached", "ok") for t in again] == first,
            "benchmark_farm --resume: the tables differ beyond the status column")
    log(f"# tools: farm tables\n{again[1]}")
    return dict(children=children, seconds=seconds, resume_seconds=seconds2,
                table=again[1].splitlines())


def phase_tools(card: str):
    """Phase 18: the last six tools, each `main` run in-process on the card
    with the launch counters zeroed just before and read just after
    (`tool_run`); the ranks' and the farm's children's launches read from
    what they report. Returns (results, the launches of every run)."""
    t_phase = time.perf_counter()
    total = collections.Counter()
    work = Path(tempfile.mkdtemp(prefix="tools_", dir=ROOT / "build"))
    res = {}
    try:
        for name, run in (("validate_fused", lambda: tools_validate(total)),
                          ("onchip_smoke", lambda: tools_onchip(total, work)),
                          ("grow_demo", lambda: tools_grow(total)),
                          ("scaling_bench", lambda: tools_scaling(total)),
                          ("microbench_ops", lambda: tools_microbench(total)),
                          ("benchmark_farm", lambda: tools_farm(total, work))):
            t0 = time.perf_counter()
            res[name] = run()
            torch.cuda.empty_cache()
            log(f"# tools ({card}): {name} took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    total = {k: total[k] for k in KERNELS}
    res["launches"] = total
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"# tools ({card}): phase 18 took {res['phase_s']:.1f} s; launches {total}")
    return res, total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--focal", type=float, default=800.0)
    ap.add_argument("--n-bg", type=int, default=900_000)
    ap.add_argument("--n-sky", type=int, default=100_000)
    ap.add_argument("--n-inst", type=int, default=4096)
    ap.add_argument("--growth-n-bg", type=int, default=1_500_000,
                    help="phase 9's background (rescaled once if its views' pair counts "
                         "miss the growth window)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one view, one training step and the LPIPS and DINOv2 "
                         "forwards with torch.profiler (kernel time by name)")
    ap.add_argument("--ab", action="append", default=[], metavar="SOURCE=PATH",
                    help="also time another version of a kernel source (the same C "
                         "interface, e.g. a parent commit's csrc/expand_pairs.cu; "
                         "csrc/blend_forward.cu also before its tile_order argument) "
                         "against the checkout's at phase 5's inputs; repeatable")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory to write the full results to (chip_smoke.json)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_card()
    build_s = phase_build()
    prng_res = phase_prng(dev)
    goldens = phase_goldens(dev)
    params, aux, cfg, batches, main_res, (p_sd, a_sd, train_batches, views) = \
        phase_main(args, dev)
    batch = batches[0]
    state_sd = (jittered_state(p_sd, a_sd, args.seed), a_sd)
    trainer, train_res, train_captured, fused_grads = phase_train(
        args, dev, state_sd, train_batches)
    faint_captured = capture_faint_step(trainer)
    classic_res, classic_launches, classic_step_launches = phase_classic(
        params, aux, cfg, batches, train_config(args), state_sd, train_batches[0],
        fused_grads, dev)
    del fused_grads
    render_res, (frame_a, frame_kw), _ = phase_render_tool(args, params, aux, views, dev)
    render_captured = {}
    with capturing(render_captured):
        render_view(*frame_a, **frame_kw)
    growth_trainer, growth_res, growth_captured, growth_fused_captured, growth_launches = \
        phase_growth(args, dev)
    campaign_res, campaign_captured, campaign_launches, campaign_trainer, campaign_scene = \
        phase_campaign(card, dev)
    nuplan_res, nuplan_launches, held_out = phase_nuplan(card, dev)
    weights = (ROOT / "build" / "chip_smoke" / "lpips_alex_seeded.npz",
               ROOT / "build" / "chip_smoke" / "dinov2_vitb14_seeded.npz")
    weights[0].parent.mkdir(parents=True, exist_ok=True)
    try:
        deform_res, deform_launches, deform_trainers = phase_deformables(
            card, dev, campaign_scene, campaign_res)
        eval_export_res, eval_export_launches = phase_eval_export(
            card, dev, nuplan_res, held_out, weights, profile=args.profile)
        viewer_res, viewer_launches = phase_viewer(card, dev, held_out, weights)
        preprocess_res, preprocess_launches = phase_preprocess(
            card, dev, held_out["work"] / "road_block", nuplan_res["untrained_eval"]["psnr"])
    finally:
        shutil.rmtree(held_out["work"], ignore_errors=True)
        for path in weights:
            path.unlink(missing_ok=True)
    del held_out
    del campaign_scene
    obs_res, obs_launches = phase_observability(args, card, dev, state_sd, train_batches)
    torch.cuda.empty_cache()  # the ranks of phase 16 share the card
    parallel_res, parallel_launches = phase_parallel(args, card, state_sd, train_batches)
    torch.cuda.empty_cache()
    tools_res, tools_launches = phase_tools(card)
    by_path = dict(serving=main_res["launches"], training=train_res["launches"],
                   classic_renders=classic_launches, classic_step=classic_step_launches,
                   render_tool=render_res["launches"], growth=growth_launches,
                   campaign=campaign_launches, nuplan=nuplan_launches,
                   eval_export=eval_export_launches, viewer=viewer_launches,
                   observability=obs_launches, parallel=parallel_launches,
                   data_config=preprocess_launches, tools=tools_launches, **deform_launches)
    serving_captured = {}  # the kernel wrappers' arguments in one serving view
    with capturing(serving_captured), torch.no_grad():
        render_view(params, aux, cfg, batch, 10**9, device=dev)
    kernels = phase_kernels(by_path, serving_captured, train_captured, faint_captured,
                            render_captured, growth_captured, growth_fused_captured,
                            campaign_captured, dev)
    ab = phase_ab(args.ab, serving_captured, train_captured, faint_captured, render_captured,
                  growth_captured, capture_faint_step(growth_trainer),
                  growth_fused_captured) if args.ab else None
    prof = None
    if args.profile:
        prof = dict(
            view=phase_profile("one view", lambda: render_view(
                params, aux, cfg, batch, 10**9, device=dev)),
            train_step=phase_profile("one training step", lambda: trainer.train(1)),
            classic_frame=phase_profile(
                f"one {RENDER_SIZE[0]}x{RENDER_SIZE[1]} classic frame",
                lambda: render_view(*frame_a, **frame_kw)),
            classic_train_step=phase_profile("one classic training step",
                                             lambda: growth_trainer.train(1)),
            campaign_step=phase_profile(
                "one full-resolution training step of the campaign's final scene",
                lambda: campaign_trainer.train(1)),
            **{f"{name}_step": phase_profile(
                f"one {name} training step (phase 12's trained scene)",
                lambda t=t: t.train(1)) for name, t in deform_trainers.items()})

    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        summary = dict(card=card, build_seconds=build_s, prng=prng_res, goldens=goldens,
                       main=main_res,
                       train=train_res, classic=classic_res, render_tool=render_res,
                       growth=growth_res, campaign=campaign_res, nuplan=nuplan_res,
                       eval_export=eval_export_res, deformables=deform_res, viewer=viewer_res,
                       observability=obs_res, parallel=parallel_res, preprocess=preprocess_res,
                       tools=tools_res,
                       kernels=kernels, ab=ab,
                       profile=prof,
                       seconds=time.perf_counter() - t_start)
        (args.out / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
