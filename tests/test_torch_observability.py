"""Observability and the bench tools: mtgs_torch.utils.observability against
the JAX package's on the same inputs (no JAX compile), `Trainer.train`'s
writer, `tools/bench_train.py` and `tools/profile_raster.py` on the CPU.
"""

import gzip
import json
import sys

import numpy as np
import pytest
import torch

from mtgs_tpu.utils import observability as jobs
from mtgs_torch.data.synthetic import batch_iterator, build_scene_model, make_synthetic_scene
from mtgs_torch.tools import bench_train, profile_raster
from mtgs_torch.train.trainer import Trainer, TrainerConfig
from mtgs_torch.utils import observability as tobs

EVENTS = [  # a put_scalar / put_dict sequence over steps 0-12
    ("scalar", "loss", 0.5, 0), ("dict", {"psnr": 20.25, "loss": 0.4}, 0),
    ("scalar", "loss", 0.3, 1), ("dict", {"psnr": 21.5, "ms": 3}, 5),
    ("scalar", "loss", 0.25, 10), ("dict", {"psnr": 22.125, "rays": 1e6}, 10),
    ("scalar", "loss", 0.125, 12),
]


def replay(writer):
    for kind, *a in EVENTS:
        if kind == "scalar":
            writer.put_scalar(*a)
        else:
            writer.put_dict(*a)
    writer.flush()


@pytest.mark.parametrize("steps_per_log", [1, 5, 10])
def test_jsonl_writer_matches_jax(tmp_path, steps_per_log):
    paths = [tmp_path / "torch" / "log.jsonl", tmp_path / "jax" / "log.jsonl"]
    for mod, path in zip((tobs, jobs), paths):
        w = mod.JsonlWriter(str(path), steps_per_log=steps_per_log)
        replay(w)
        w.close()
    got, want = (p.read_text() for p in paths)
    assert got == want and got.count("\n") >= 1


@pytest.mark.parametrize("keys", [None, ["psnr"]])
def test_local_and_multi_writers_match_jax(capsys, tmp_path, keys):
    printed, logs = [], []
    for mod in (tobs, jobs):
        w = mod.JsonlWriter(str(tmp_path / mod.__name__ / "log.jsonl"), steps_per_log=1)
        replay(mod.MultiWriter([mod.LocalWriter(steps_per_log=5, keys=keys), w]))
        printed.append(capsys.readouterr().out)
        logs.append((tmp_path / mod.__name__ / "log.jsonl").read_text())
    assert printed[0] == printed[1] and logs[0] == logs[1]
    assert printed[0].splitlines()[0].startswith("step 0")


def test_tensorboard_writer_without_tensorboard(monkeypatch, tmp_path):
    """A no-op where torch.utils.tensorboard does not import."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = tobs.TensorboardWriter(str(tmp_path))
    w.put_dict({"loss": 1.0}, 0)
    w.flush()
    assert list(tmp_path.iterdir()) == []


def test_step_timer_matches_jax(monkeypatch):
    clock = iter(np.cumsum([1.0, 0.02, 0.03, 0.025, 0.5, 0.01]).tolist() * 2)
    monkeypatch.setattr("time.perf_counter", lambda: next(clock))
    ticks = []
    for mod in (tobs, jobs):
        t = mod.StepTimer(pixels_per_step=960 * 540)
        ticks.append([t.tick() for _ in range(6)])
    assert ticks[0] == ticks[1]
    assert ticks[0][0] == {} and set(ticks[0][1]) == {"step_ms", "rays_per_s"}


def test_time_function_summary_matches_jax():
    summaries = []
    for mod in (tobs, jobs):
        mod.reset_timers()

        @mod.time_function
        def work(x):
            return x + 1

        @mod.time_function(label="labelled")
        def other():
            raise ValueError("timed all the same")

        assert work(1) == 2 and work(2) == 3
        with pytest.raises(ValueError):
            other()
        summaries.append(mod.timing_summary())
        mod.reset_timers()
        assert mod.timing_summary() == {}
    got, want = summaries
    assert set(got) == set(want) == {"labelled",
                                     "test_time_function_summary_matches_jax.<locals>.work"}
    for k in got:
        assert set(got[k]) == set(want[k]) == {"calls", "total_s", "mean_ms"}
        assert got[k]["calls"] == want[k]["calls"]


def test_summarize_trace_matches_jax(tmp_path):
    """One hand-written trace, the newest of two, read by both."""
    events = [dict(ph="X", name="blend_forward_kernel", dur=250.0),
              dict(ph="X", name="aten::sort", dur=40.5), dict(ph="X", name="aten::sort", dur=9.5),
              dict(ph="X", name="blend_forward_kernel", dur=250.0), dict(ph="B", name="open"),
              dict(ph="X", name="no duration"), dict(ph="X", dur=7.0)]
    older = tmp_path / "a" / "0001.trace.json.gz"
    newer = tmp_path / "b" / "0002.trace.json.gz"
    for path, evs in ((older, events[:1]), (newer, events)):
        path.parent.mkdir()
        with gzip.open(path, "wt") as f:
            json.dump({"traceEvents": evs}, f)
    for top, iters in ((30, 1), (2, 2)):
        got = tobs.summarize_trace(str(tmp_path), top=top, iters=iters)
        assert got == jobs.summarize_trace(str(tmp_path), top=top, iters=iters)
    assert tobs.summarize_trace(str(tmp_path), iters=2)[0] == (0.25, 1, "blend_forward_kernel")
    assert tobs.summarize_trace(str(tmp_path / "none")) == []


def test_trace_writes_what_summarize_trace_reads(tmp_path):
    with tobs.trace(str(tmp_path / "tr")) as tr:
        x = torch.randn(64, 64)
        torch.sort(x @ x, dim=1)
    assert tr.path.endswith(".trace.json.gz")
    top = tobs.summarize_trace(str(tmp_path / "tr"), top=50)
    assert top and any(name == "aten::sort" for _, _, name in top)
    assert all(ms >= 0 and count >= 0 for ms, count, _ in top)


def test_train_with_writer_logs_every_metric(tmp_path):
    """Trainer.train(3, writer=...) at 32x32: every step's metrics, and
    step_ms / rays_per_s from the second step on; a run without a writer
    trains the same."""
    scene = make_synthetic_scene(seed=0, width=32, height=32, n_travels=1, n_frames=2,
                                 n_bg=150, n_instance=0, device="cpu")
    cfg = TrainerConfig(width=32, height=32, max_intersections=1 << 12)
    runs = []
    for writer in (tobs.JsonlWriter(str(tmp_path / "log.jsonl"), steps_per_log=1), None):
        params, aux = build_scene_model(scene, with_instances=False, device="cpu")
        trainer = Trainer(cfg, params, aux, batch_iterator(scene, device="cpu"), device="cpu")
        runs.append(trainer.train(3, writer=writer))
    rows = [json.loads(line) for line in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    keys = set(runs[0][0])
    assert {"total_loss", "psnr", "n_intersections", "gaussian_count"} <= keys
    for i, r in enumerate(rows):
        timing = {"step_ms", "rays_per_s"} if i else set()
        assert set(r) == keys | timing | {"step"}, i
        assert all(np.isfinite(v) for v in r.values())
        assert r["total_loss"] == float(runs[0][i]["total_loss"])
        if i:
            assert r["rays_per_s"] == pytest.approx(32 * 32 / (r["step_ms"] * 1e-3))
    assert [float(m["total_loss"]) for m in runs[0]] == [float(m["total_loss"]) for m in runs[1]]


def test_bench_train_smoke(capsys):
    """JAX's test_bench_train_smoke sizes and JSON assertions, on the CPU."""
    bench_train.main([
        "--n-bg", "400", "--n-instance", "50", "--width", "64",
        "--height", "64", "--max-isect", "8192", "--iters", "2",
        "--device", "cpu",
    ])
    captured = capsys.readouterr()
    rec = json.loads(captured.out.strip().splitlines()[-1])
    assert rec["unit"] == "iters/s" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 3.0, abs=1e-3)
    assert rec["device"] == "cpu" and rec["fused"] is False
    assert "# train step:" in captured.err and "# first step" in captured.err


def test_bench_train_gt_capacity():
    assert bench_train.gt_capacity(960, 540) == 6 << 20
    assert bench_train.gt_capacity(64, 64) == 1 << 17


@pytest.mark.parametrize("fused", [False, True])
def test_profile_raster_small(capsys, fused):
    """Every stage line and the roofline naming the H100, at a size the CPU
    runs: bench.py's layout cut to 3000 gaussians at 96x64."""
    res = profile_raster.main(["--device", "cpu", "--n-gauss", "3000", "--width", "96",
                               "--height", "64", "--max-isect", "16384", "--iters", "1"]
                              + ["--fused"] * fused)
    out = capsys.readouterr().out
    stages = (["projection", "proj+tile_spans", "+depth sort", "+expand", "+pair sort"]
              if fused else ["projection", "projection+binning"]) + ["full forward",
                                                                     "full fwd+bwd"]
    lines = [ln for ln in out.splitlines() if ln.endswith(" ms") and "|" not in ln]
    assert [ln.split("  ")[0].strip() for ln in lines] == stages
    assert ("tile_spans ~" if fused else "binning ~") in out
    assert "--- roofline (H100 SXM peaks at 700 W: f32 67 TFLOP/s, HBM 3.35 TB/s) ---" in out
    assert "SoL fwd+bwd" in out and "x off" in out
    roof = res["roofline"]
    assert 0 < roof["n_intersections"] <= 16384 and roof["stats"]["pair_blends"] > 0
    assert roof["sol_fwd_ms"] > 0 and roof["fwdbwd_x_off"] > 1


def test_bench_scene_matches_bench_py_layout():
    """profile_raster's copy of bench.py's scene: the same seeded draws."""
    means, quats, scales, opac, colors = profile_raster.make_scene(1000)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(means[:500, 0], rng.uniform(-60, 60, 500).astype(np.float32))
    assert means.shape == (1000, 3) and quats.shape == (1000, 4) and colors.shape == (1000, 3)
    assert np.all(np.abs(np.linalg.norm(means[833:], axis=1) - 400) < 1e-2)
    assert opac.min() >= 0.3 and opac.max() <= 0.95 and scales.dtype == np.float32


def test_tools_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench_train.main, profile_raster.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--iters", "1"])
