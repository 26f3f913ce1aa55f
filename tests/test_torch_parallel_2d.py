"""mtgs_torch.parallel on 4 gloo ranks on the CPU: the 2D (data, tile)
step against the data-parallel step and JAX's `make_2d_train_step`, and
tile-sharded renders with a band past the last tile row.

One world of 4 ranks serves the module (`torch_parallel_cases.world4`).
The 2D step runs the ownership plan along `tile` (MTGS_DIST=1,
MTGS_BLK_SLACK=2.0: untruncated exchange blocks, as JAX's
`test_2d_mesh_cameras_x_tiles_matches_dp`), the data-parallel step the same
two views along `data` of the same mesh. JAX's step ran on a (2, 4) mesh
(`tests/fixtures/parallel_ref.npz`). Tolerances as in test_torch_parallel.py:
gradients 2e-4 max-scaled (`leaf_errors`), losses 1e-5 relative against the port and 1e-4
against JAX; the parameters after Adam's first step within its lr quantum
(2.5e-3, JAX's own: where a gradient is rounding noise the two may move
apart by lr), the densify statistics 2e-4.
"""

import numpy as np
import pytest

from mtgs_torch.parallel.mesh import launch
from tests import torch_parallel_cases as cases


@pytest.fixture(scope="module")
def world():
    return launch(cases.world4, 4, backend="gloo", device="cpu", timeout=240)


@pytest.fixture(scope="module")
def fx():
    return np.load(cases.FIXTURE)


def test_2d_mesh_matches_dp(world):
    """Cameras x tiles against cameras alone on the same two views: the
    loss, the data-mean gradients and absgrad, the updated parameters and
    the densify statistics; the tile axis ran the ownership plan."""
    got, dp = world[0]["mesh2d"], world[0]["dp"]
    assert got["ran"] == ["dist"] and dp["ran"] == []
    for k in ("total_loss", "psnr"):
        np.testing.assert_allclose(got["metrics"][k], dp["metrics"][k], rtol=1e-5)
    errs = cases.leaf_errors(got["grads"], dp["grads"])
    assert max(errs.values()) <= 2e-4, errs
    assert cases.max_scaled(got["sink"], dp["sink"]) <= 2e-4
    for k, v in dp["state"].items():
        tol = 2.5e-3 if k.startswith("params.") else 2e-4
        np.testing.assert_allclose(got["state"][k], v, atol=tol, rtol=tol, err_msg=k)


def test_2d_mesh_matches_jax(world, fx):
    """The 2D step against JAX's make_2d_train_step on a (2, 4) mesh."""
    got = world[0]["mesh2d"]
    for k in ("total_loss", "psnr"):
        np.testing.assert_allclose(got["metrics"][k], float(fx[f"mesh2d_metric.{k}"]),
                                   rtol=1e-4)
    errs = cases.leaf_errors(got["grads"], {k: fx[f"mesh2d_grad.{k}"] for k in got["grads"]})
    assert max(errs.values()) <= 2e-4, errs
    assert cases.max_scaled(got["sink"], fx["mesh2d_grad_sink"]) <= 2e-4
    for f in ("xys_grad_norm", "vis_counts", "max_2dsize"):
        np.testing.assert_allclose(got["state"][f"densify.background.{f}"],
                                   fx[f"mesh2d_densify.background.{f}"], rtol=2e-4, atol=1e-6,
                                   err_msg=f)
    for k in got["state"]:
        if k.startswith("params."):
            np.testing.assert_allclose(got["state"][k], fx[f"mesh2d_new.{k[7:]}"], atol=2.5e-3,
                                       err_msg=k)


def test_2d_mesh_ranks_alike(world):
    """Every rank of the 2D mesh ends the step with the same state bits."""
    assert cases.ranks_equal(world, ("mesh2d", "state"))
    assert cases.ranks_equal(world, ("dp", "state"))


@pytest.mark.parametrize("plan", ["band", "dist"])
def test_pad_band_empty(world, plan):
    """4 ranks over 3 tile rows (160x96): the last band lies past the image
    and has no pairs; render and gradients match the single-rank path."""
    got = world[0]["pad_band"][plan]
    with cases.threads(2):
        want = cases.raster_run(plan, None, height=96)
    assert got["ran"] == [plan]
    np.testing.assert_allclose(got["render"], want["render"], atol=2e-5)
    np.testing.assert_allclose(got["alpha"], want["alpha"], atol=1e-5)
    errs = {k: cases.max_scaled(got[f"grad_{k}"], want[f"grad_{k}"]) for k in cases.GRAD_NAMES}
    assert max(errs.values()) <= 1e-4, errs
    assert cases.ranks_equal(world, ("pad_band", plan))
