"""Helpers of the benchmark's own tests: reduced cells that run on the CPU
in seconds."""

import copy

from bench_port import harness


# the port's CPU twins against the reference at the reduced size: float32
# rounding, and the rare flip of one pair at a cut-off, which a scene this
# sparse shows more (a few dozen instance gaussians make the pose
# gradients' norms move most; a splat dropped where the blend's sigma
# rounds below 0 at its own centre moves a pixel)
TINY_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-2, "grad_gap_own": 1e-2, "change_gap": 1e-3,
               "densify_gap": 1e-4,
               "rgb_mae": 1e-4, "acc_mae": 1e-4, "depth_rel_mae": 1e-4, "normal_mae": 1e-4,
               "u8_mae": 0.02}


def tiny_cell(workload: str) -> harness.Cell:
    """A cell as BENCHMARK.json has it, cut to a few thousand gaussians and
    a 128 x 96 image (the golden size of the port's CPU tests), judged by
    `TINY_LIMITS` (the cell's own limits are set for its full size)."""
    cell = copy.deepcopy(harness.Cell.load(workload))
    sc = cell.cfg["scene"]
    sc.update(background=1200, granule=256)
    if sc["skybox"]:
        sc["skybox"] = 120
    if sc["instances"]:
        sc.update(instances=2, instance_size=60, instance_granule=64)
    sc["frames_per_traversal"] = 2 if sc["traversals"] > 1 else 4
    cell.traffic.update(width=128, height=96)
    cell.limits = {k: TINY_LIMITS[k] for k in cell.limits}
    return cell
