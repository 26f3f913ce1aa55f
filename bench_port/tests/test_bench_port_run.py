"""A run driven on the CPU at a reduced size: the port against the plain
reference, the result line's keys, the control and the faults that must
come out as not correct, and the refusal to run without a card."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_port import harness, program, scene
from bench_port.loops import train
from bench_port.reference.raster import Prec
from bench_port.tests.conftest import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
SEED = 40_000_000_017
CPU = torch.device("cpu")
TRAIN = ["mtgs_block3m.train", "gs3d_2m.train"]
RENDER = ["gs3d_2m.render540", "mtgs_block3m.render1080"]


def _run(workload, trace=False):
    return harness.run(workload, SEED, 0.2, trace, device="cpu", cell=tiny_cell(workload))


@pytest.mark.parametrize("workload", TRAIN + RENDER)
def test_port_agrees_with_the_reference(workload):
    r = _run(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("workload,trace", [(TRAIN[0], False), (RENDER[0], True)])
def test_result_line_has_the_contract_keys(workload, trace):
    r = _run(workload, trace)
    assert list(r) == (["correct", "attempted", "failed", "metrics", "device"]
                       + ["breakdown"] * trace + ["checks"])
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    cell = harness.Cell.load(workload)
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"setup_s", "peak_mem_gib"} <= set(r["metrics"])
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())


@pytest.mark.parametrize("workload", TRAIN + RENDER)
def test_control_is_not_correct(workload):
    """The reference in TF32 matmuls put in the program's place fails the
    cell's limits, and those of the reduced size."""
    cell = tiny_cell(workload)
    nums = _control_numbers(cell, workload, CPU)
    assert any(v > cell.limits[k] for k, v in nums.items()), nums
    full = harness.Cell.load(workload).limits
    assert any(v > full[k] for k, v in nums.items()), nums


def _control_numbers(cell, workload, dev):
    loop = harness.load_loop(cell.traffic["loop"])(cell, SEED, dev)
    n = len(loop.make_views())
    if loop.KIND == "train":
        views = scene.view_order(n, SEED)[:loop.checked]
        cand = loop.as_program(*loop.reference(views, Prec(tf32=True)), views)
        return train.numbers(cand, *loop.reference(views, Prec()))
    loop.kept = dict.fromkeys(scene.sample_views(n, cell.traffic["sample_views"], SEED))
    loop.kept = loop.reference_renders(Prec(tf32=True))
    return loop.compare({})


def _unchanged_state(monkeypatch):
    import mtgs_torch.train.trainer as trainer

    monkeypatch.setattr(trainer, "adam_update", lambda *a, **k: None)


def _half_batch(monkeypatch):
    import mtgs_torch.train.trainer as trainer

    real = trainer.loss_lib.compute_losses

    def half(cfg, *, mask, **kw):
        m = mask.clone()
        m[m.shape[0] // 2:] = 0
        return real(cfg, mask=m, **kw)

    monkeypatch.setattr(trainer.loss_lib, "compute_losses", half)


def _altered_answer(monkeypatch):
    real = program.render_view

    def altered(*a, **k):
        out = dict(real(*a, **k))
        out["rgb_appearance"] = torch.roll(out["rgb_appearance"], 1, dims=1)
        return out

    monkeypatch.setattr(program, "render_view", altered)


def _half_image(monkeypatch):
    real = program.render_view

    def half(*a, **k):
        out = dict(real(*a, **k))
        for key in ("rgb_appearance", "accumulation"):
            v = out[key].clone()
            v[v.shape[0] // 2:] = 0
            out[key] = v
        return out

    monkeypatch.setattr(program, "render_view", half)


@pytest.mark.parametrize("workload,fault", [
    (TRAIN[0], _unchanged_state), (TRAIN[0], _half_batch), (TRAIN[1], _unchanged_state),
    (TRAIN[1], _half_batch), (RENDER[0], _altered_answer), (RENDER[0], _half_image),
    (RENDER[1], _altered_answer)])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert _run(workload)["correct"] is False


def _cli(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                           "gs3d_2m.render540", "--seed", "3", "--seconds", "1",
                           "--trace", "0", *extra], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    p = _cli(ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_without_the_program_it_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout == ""
