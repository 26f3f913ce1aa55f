"""mtgs_torch.parallel on 2 gloo ranks on the CPU, against the JAX
package's sharded functions and the port's single-rank path.

One world of 2 ranks serves the module (`torch_parallel_cases.world2`,
started once: ~4 s of process start-up); the single-rank references run in
this process. JAX's sharded functions take minutes to compile here, so
their results come from `tests/fixtures/parallel_ref.npz`
(`tests/make_parallel_fixture.py`: the 8-device virtual mesh, the same
numpy-seeded inputs; `test_fixture_regenerates`, marked slow, rebuilds it).
The cases mirror `tests/test_parallel.py`'s.

Tolerances. Against JAX (the fixture): render 2e-3, alpha 1e-3, gradients
2e-4 max-scaled (the golden tolerances: the same f32 formulation, sums in
another order; each parameter leaf's scale at least 1e-3 of the largest
leaf's, `leaf_errors`), losses 1e-4 relative. Against the port's single-rank path:
render 2e-5 and gradients 1e-4 max-scaled for the band, ownership and
classic plans (the same pairs in the same order per tile; the plain blend's
128-lane windows fall elsewhere in a band's slab), 1e-4 for the layered
plan (its composite regroups the blend's sums at the slab boundaries, ~1e-5
of the depth channel). Across ranks: the same bits.
"""

import subprocess
import sys

import numpy as np
import pytest

from mtgs_torch.parallel.mesh import launch
from tests import torch_parallel_cases as cases

PLANS = ("band", "dist", "layered", "classic")
SINGLE_TOL = dict(band=(2e-5, 1e-4), dist=(2e-5, 1e-4), classic=(2e-5, 1e-4),
                  layered=(1e-4, 1e-4))


@pytest.fixture(scope="module")
def world():
    return launch(cases.world2, 2, backend="gloo", device="cpu", timeout=240)


@pytest.fixture(scope="module")
def fx():
    return np.load(cases.FIXTURE)


@pytest.fixture(scope="module")
def single_raster():
    with cases.threads(2):
        return {p: cases.raster_run(p, None) for p in PLANS}


@pytest.fixture(scope="module")
def single_steps():
    with cases.threads(2):
        return dict(same=cases.step_single("dp", [0]), distinct=cases.step_single("dp", [0, 1]),
                    trainer=cases.trainer_single())


def grad_errors(got: dict, want: dict) -> dict:
    return {k: cases.max_scaled(got[f"grad_{k}"], want[f"grad_{k}"]) for k in cases.GRAD_NAMES}


def test_tf32_pinned_in_every_rank(world):
    assert all(r["tf32"] == (False, False) for r in world)


@pytest.mark.parametrize("plan", PLANS)
def test_tile_sharded_matches_single_rank(world, single_raster, plan):
    """rasterize(mesh=) under each plan: the plan that JAX's functions pick
    ran, and render, alpha and every gradient match the single-rank
    rasterizer, with the same bits on both ranks."""
    got, want = world[0]["raster"][plan], single_raster[plan]
    assert got["ran"] == [plan]
    assert want["ran"] == []
    r_tol, g_tol = SINGLE_TOL[plan]
    np.testing.assert_allclose(got["render"], want["render"], atol=r_tol)
    np.testing.assert_allclose(got["alpha"], want["alpha"], atol=1e-5)
    errs = grad_errors(got, want)
    assert max(errs.values()) <= g_tol, errs
    assert np.abs(got["grad_sink"]).max() > 0  # absgrad flows when sharded
    np.testing.assert_array_equal(got["radii"], want["radii"])
    np.testing.assert_allclose(got["depths"], want["depths"], atol=1e-6)
    # the capacity signal: the fullest rank scaled to the global capacity
    assert got["n_intersections"] >= want["n_intersections"]
    assert cases.ranks_equal(world, ("raster", plan))


@pytest.mark.parametrize("plan", PLANS)
def test_tile_sharded_matches_jax(world, fx, plan):
    """The same renders and gradients against JAX's rasterize(mesh=) under
    the same plan on 8 devices (classic: the forward)."""
    got = world[0]["raster"][plan]
    np.testing.assert_allclose(got["render"], cases.raster_image(fx, plan, "render"), atol=2e-3)
    np.testing.assert_allclose(got["alpha"], cases.raster_image(fx, plan, "alpha"), atol=1e-3)
    if plan == "classic":
        return
    errs = {k: cases.max_scaled(got[f"grad_{k}"], fx[f"raster_{plan}_grad_{k}"])
            for k in cases.GRAD_NAMES}
    assert max(errs.values()) <= 2e-4, errs


def test_dp_step_identical_views_matches_single_rank(world, single_steps):
    """DP over 2 ranks with the same view on both equals the single-rank
    step: the loss, the gradients, the updated parameters; the summed
    visibility counts are twice the single step's."""
    single = single_steps["same"]
    got = world[0]["dp_same"]
    np.testing.assert_allclose(got["metrics"]["total_loss"], single["metrics"]["total_loss"],
                               rtol=1e-6)
    errs = cases.leaf_errors(got["grads"], single["grads0"])
    assert max(errs.values()) <= 2e-4, errs
    for k, v in single["state"].items():
        if k.startswith("params."):
            np.testing.assert_allclose(got["state"][k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got["state"]["densify.background.vis_counts"],
                               2 * single["state"]["densify.background.vis_counts"])
    assert cases.ranks_equal(world, ("dp_same", "state"))


def test_dp_step_distinct_views_matches_mean_of_grads(world, fx, single_steps):
    """DP over 2 ranks on two views: the gradients are the mean of the two
    single-rank gradients, and the step matches JAX's make_dp_train_step
    (metrics, data-mean gradients and absgrad, densify statistics)."""
    single = single_steps["distinct"]
    got = world[0]["dp_distinct"]
    mean = {k: (single["grads0"][k] + single["grads1"][k]) / 2 for k in got["grads"]}
    errs = cases.leaf_errors(got["grads"], mean)
    assert max(errs.values()) <= 2e-4, errs
    errs = cases.leaf_errors(got["grads"], {k: fx[f"dp_grad.{k}"] for k in got["grads"]})
    assert max(errs.values()) <= 2e-4, errs
    assert cases.max_scaled(got["sink"], fx["dp_grad_sink"]) <= 2e-4
    for k in ("total_loss", "psnr"):
        np.testing.assert_allclose(got["metrics"][k], float(fx[f"dp_metric.{k}"]), rtol=1e-4)
    for f in ("xys_grad_norm", "vis_counts", "max_2dsize", "last_comp"):
        np.testing.assert_allclose(got["state"][f"densify.background.{f}"],
                                   fx[f"dp_densify.background.{f}"], rtol=2e-4, atol=1e-6,
                                   err_msg=f)
    assert np.isfinite(got["metrics"]["total_loss"])
    assert cases.ranks_equal(world, ("dp_distinct", "state"))


def test_dp_trainer_grows_capacity(world):
    """DPTrainer's host loop with its refines growing the background: the
    capacity and the alive count past the start, Adam's moments follow,
    every metric finite, and both ranks' parameters, moments and densify
    statistics the same bits after the refines."""
    got = world[0]["dp_trainer"]
    assert got["refines"] >= 5
    assert got["cap"] > got["cap0"]
    assert got["alive"] > got["cap0"]
    assert got["refine_overflow"] == 0
    assert got["mu_shape"] == got["means_shape"]
    for h in got["history"]:
        assert np.isfinite(h["total_loss"]) and np.isfinite(h["psnr"])
    assert cases.ranks_equal(world, ("dp_trainer", "state"))


def test_trainer_tile_mesh_matches_unsharded(world, single_steps):
    """loss_and_grads under a 2-rank tile mesh (the band plan) against the
    unsharded loss stack: the total, every gradient leaf and absgrad."""
    single = single_steps["trainer"]
    got = world[0]["trainer_mesh"]
    assert got["ran"] == ["band"]
    np.testing.assert_allclose(got["total"], single["total"], rtol=1e-5)
    errs = cases.leaf_errors(got["grads"], single["grads"])
    assert max(errs.values()) <= 2e-4, errs
    assert cases.max_scaled(got["sink"], single["sink"]) <= 2e-4
    assert np.abs(got["sink"]).max() > 0


def test_trainer_mesh_plan_survives_growth(world):
    """Trainer(mesh=) through two intersection-buffer growths: each rounded
    to the mesh granule (2 x 512), so every step stays on the band plan."""
    got = world[0]["trainer_mesh"]
    grown = [e for e in got["growth"] if e["node"] == "max_intersections"]
    assert len(grown) >= 2
    assert all(e["new"] % 1024 == 0 for e in grown)
    # rounded to 512 alone, a growth would have left the band plan (I / 2 % 512)
    assert any(-(-int(e["old"] * 1.5) // 512) * 512 % 1024 for e in grown)
    for s in got["steps"]:
        assert s["ran"] == ["band"], s
        assert np.isfinite(s["total_loss"])
    assert cases.ranks_equal(world, ("trainer_mesh", "steps"))


def test_dist_block_overflow_signals_growth(world):
    """The ownership plan with starved exchange blocks: the render and the
    gradients stay finite and n_intersections passes the capacity."""
    got = world[0]["overflow"]["dist"]
    assert got["ran"] == ["dist"]
    assert got["I_blk"] < got["I_s"]
    assert np.isfinite(got["loss"])
    assert all(np.isfinite(got[f"grad_{k}"]).all() for k in cases.GRAD_NAMES)
    assert got["n_intersections"] > 512 * 8


def test_layered_row_overflow_signals(world):
    """The layered plan with starved row blocks: finite, and the capacity
    signal saturated (I + 1)."""
    got = world[0]["overflow"]["layered"]
    assert got["ran"] == ["layered"]
    assert got["N_blk"] < got["n_local"]
    assert np.isfinite(got["loss"])
    assert all(np.isfinite(got[f"grad_{k}"]).all() for k in cases.GRAD_NAMES)
    assert got["n_intersections"] == cases.RASTER["max_intersections"] + 1


@pytest.mark.slow
def test_fixture_regenerates(tmp_path, fx):
    """tests/make_parallel_fixture.py rebuilds the committed fixture."""
    out = tmp_path / "parallel_ref.npz"
    subprocess.run([sys.executable, "tests/make_parallel_fixture.py", str(out)], check=True,
                   timeout=3600)
    new = np.load(out)
    assert sorted(new.files) == sorted(fx.files)
    for k in fx.files:
        np.testing.assert_allclose(new[k], fx[k], rtol=1e-6, atol=1e-7, err_msg=k)
