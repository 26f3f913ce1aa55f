"""The last six tools of mtgs_torch on the CPU: `benchmark_farm` (its
tables byte-equal to JAX's `aggregate`, the slot locks, `run_scene`'s child
command and statuses with `subprocess.run` stubbed), `validate_fused` (it
passes, and fails once either path is perturbed), `onchip_smoke`,
`grow_demo` (the JAX tools' JSON keys, read from their sources; its
trajectory against JAX's `grow_demo` on one scene), `scaling_bench`
(`make_scene` bit-equal to JAX's; one gloo world of 2 ranks; a truncated
render flagged), the microbench rows at small sizes, and that every entry
point raises without a card unless the CPU is asked for."""

import ast
import gzip
import io
import json
import re
import subprocess
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import make_nuplan_fixture as fixture
from mtgs_tpu.data import nuplan as jnuplan
from mtgs_tpu.data import synthetic as jsynthetic
from mtgs_tpu.tools import benchmark_farm as jfarm
from mtgs_tpu.tools import grow_demo as jgrow
from mtgs_tpu.tools import scaling_bench as jscaling
from mtgs_tpu.train import trainer as jtrainer
from mtgs_torch import configs
from mtgs_torch.data.image_io import read_image
from mtgs_torch.data.nuplan import parse_scene
from mtgs_torch.eval.pipeline import evaluate_scene
from mtgs_torch.models.gaussians import init_node_from_points
from mtgs_torch.models.scene_graph import init_scene
from mtgs_torch.tools import benchmark_farm as farm
from mtgs_torch.tools import (
    grow_demo, microbench_ops, onchip_smoke, scaling_bench, validate_fused,
)
from mtgs_torch.train.trainer import Batch

JAX_TOOLS = Path(jfarm.__file__).parent
TASKS = [dict(name="blockA", data="/data/blockA", travels=[0, 1], eval_travels=[2], steps=20),
         dict(name="blockB", data="/data/blockB"),
         dict(name="blockC", data="/data/blockC", travels=[1], method="mtgs_deformable")]
RESULT = {"psnr": 21.573419570922852, "ssim": 0.7125, "cc_psnr": 22.0, "lpips": 0.31,
          "depth_RMSE": 2.0, "depth_absRel": 0.1, "depth_delta1": 0.9, "fps": 30.5,
          "num_images": 4, "trv0_psnr": 21.0, "trv0_cc_psnr": 23.0, "trv0_ssim": 0.7,
          "trv2_psnr": 19.0, "trv2_cc_psnr": 20.5, "trv2_depth_RMSE": 2.5,
          "trv1_dinov2_sim": 0.8}


def tables(out: Path) -> tuple:
    return ((out / "results_summary.csv").read_bytes(), (out / "paste_table.tsv").read_bytes())


def both_tables(results, tasks, tmp_path) -> tuple:
    """(the port's tables, JAX's tables) of the same results."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    farm.aggregate(results, tasks, tmp_path / "t")
    jfarm.aggregate(results, tasks, tmp_path / "j")
    return tables(tmp_path / "t"), tables(tmp_path / "j")


def test_farm_tables_byte_equal_to_jax(tmp_path):
    results = [{"name": "blockA", "status": "ok", **RESULT},
               {"name": "blockB", "status": "failed(1)"},
               {"name": "blockC", "status": "cached", **RESULT, "dinov2_sim": 0.75}]
    got, want = both_tables(results, TASKS, tmp_path)
    assert got == want
    assert farm.METRICS == jfarm.METRICS


def test_farm_psnr_key_also_matches_cc_psnr(tmp_path):
    """Property (a), kept from JAX: `trv{i}_cc_psnr` ends with `_psnr`, so
    `seen_psnr` averages the psnr and cc_psnr values of the seen traversals."""
    results = [{"name": "blockA", "status": "ok", **RESULT}]
    got, want = both_tables(results, TASKS[:1], tmp_path)
    assert got == want
    rows = list(io.StringIO(got[1].decode()))
    row = dict(zip(rows[0].rstrip("\n").split("\t"), rows[1].rstrip("\n").split("\t")))
    assert float(row["seen_psnr"]) == (21.0 + 23.0) / 2        # trv0 psnr and cc_psnr
    assert float(row["unseen_psnr"]) == (19.0 + 20.5) / 2      # trv2 psnr and cc_psnr
    assert float(row["seen_cc_psnr"]) == 23.0


@pytest.fixture(scope="module")
def eval_split(tmp_path_factory):
    """The committed road block's eval split (train 0-1, eval 2), as the
    port and JAX parse it."""
    root = fixture.materialize(tmp_path_factory.mktemp("farm") / "road_block")
    kw = dict(split="val", train_travels=[0, 1], eval_travels=[2], load_points=False)
    return parse_scene(str(root), **kw), jnuplan.parse_scene(str(root), **kw)


def test_farm_held_out_views_land_in_seen(eval_split, tmp_path):
    """Property (b), kept from JAX: `evaluate_scene`'s `trv{i}` keys carry the
    batch's travel_index, the dense embedding index, and an eval traversal
    takes its nearest train traversal's. On the committed block the held-out
    traversal 2 reports as trv0, so the farm counts it as seen."""
    scene, jscene = eval_split
    assert {r.travel_id for r in scene.records} == {2}
    idx = sorted({r.travel_index for r in scene.records})
    assert idx == sorted({r.travel_index for r in jscene.records}) == [0]
    assert scene.nearest_train_travel_of_eval == jscene.nearest_train_travel_of_eval == {2: 0}

    rng = np.random.default_rng(0)
    xyz = np.stack([rng.uniform(-1, 1, 20), rng.uniform(-1, 1, 20),
                    rng.uniform(-6, -3, 20)], -1).astype(np.float32)
    params, aux = init_scene(init_node_from_points(xyz, rng.uniform(0, 255, (20, 3)),
                                                   capacity=32, device="cpu"), device="cpu")
    K = np.array([[20.0, 0, 16], [0, 20.0, 8], [0, 0, 1]], np.float32)
    batches = [Batch(image=rng.uniform(0, 1, (16, 32, 3)).astype(np.float32),
                     mask=np.ones((16, 32, 1), np.float32), c2w=np.eye(4, dtype=np.float32),
                     K=K, cam_idx=0, image_idx=0, travel_index=r.travel_index,
                     frame_idx=0, timestamp=0.0) for r in scene.records]
    cfg = configs.mtgs_config(32, 16).replace(max_intersections=1 << 12)
    res = evaluate_scene(params, aux, cfg, batches, device="cpu")
    assert "trv0_psnr" in res and not any(k.startswith("trv2_") for k in res)
    results = [{"name": "block", "status": "ok", **res}]
    task = [dict(name="block", data="-", travels=[0, 1], eval_travels=[2])]
    got, want = both_tables(results, task, tmp_path)
    assert got == want
    header = got[1].decode().splitlines()[0].split("\t")
    assert "seen_psnr" in header and "unseen_psnr" not in header


def test_slot_manager_under_contention(tmp_path):
    """Threads and a second manager (another farm process) racing for 3
    slots: each slot goes to one holder, the rest get None, a released slot
    is taken again."""
    slots = farm.SlotManager(tmp_path / ".locks", 3)
    other = farm.SlotManager(tmp_path / ".locks", 3)
    got, start = [], threading.Barrier(8)

    def take(mgr):
        start.wait()
        got.append(mgr.acquire())

    threads = [threading.Thread(target=take, args=(slots if i % 2 else other,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    held = sorted(s for s in got if s is not None)
    assert held == [0, 1, 2] and got.count(None) == 5
    assert sorted(p.name for p in (tmp_path / ".locks").iterdir()) == [
        "slot_0.lock", "slot_1.lock", "slot_2.lock"]
    assert slots.acquire() is None and other.acquire() is None
    other.release(1)
    assert slots.acquire() == 1 and slots.acquire() is None
    for s in range(3):
        slots.release(s)
    assert not list((tmp_path / ".locks").iterdir())


def stub_run(calls: list, rc: int = 0, write: bool = True):
    """A `subprocess.run` that records the child's command and writes the
    child's eval_result.json."""

    def run(cmd, stdout=None, stderr=None):
        calls.append(list(cmd))
        if write:
            out = Path(cmd[cmd.index("--out") + 1])
            (out / "eval_result.json").write_text(json.dumps(RESULT))
        return subprocess.CompletedProcess(cmd, rc)

    return run


def test_run_scene_command_and_statuses(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(subprocess, "run", stub_run(calls))
    slots = farm.SlotManager(tmp_path / ".locks", 1)
    for task in TASKS:
        j = jfarm.run_scene(task, tmp_path, slots, False)
        t = farm.run_scene(task, tmp_path, slots, False)
        assert j == t == {"name": task["name"], "status": "ok", **RESULT}
        jcmd, tcmd = calls[-2:]
        assert jcmd[1:3] == ["-m", "mtgs_tpu.tools.train_scene"]
        assert tcmd == [jcmd[0], "-m", "mtgs_torch.tools.train_scene", *jcmd[3:],
                        "--device", "cuda"]
        assert (tmp_path / task["name"] / "train.log").exists()
    # resumed: cached, no child
    n = len(calls)
    assert farm.run_scene(TASKS[0], tmp_path, slots, True) == {
        "name": "blockA", "status": "cached", **RESULT}
    assert len(calls) == n
    # a failing child, and a child that wrote no result
    monkeypatch.setattr(subprocess, "run", stub_run(calls, rc=3, write=False))
    assert farm.run_scene(TASKS[1], tmp_path / "f", slots, False) == {
        "name": "blockB", "status": "failed(3)"}
    monkeypatch.setattr(subprocess, "run", stub_run(calls, rc=0, write=False))
    assert farm.run_scene(TASKS[1], tmp_path / "g", slots, False) == {
        "name": "blockB", "status": "failed(0)"}
    assert not list((tmp_path / ".locks").iterdir())  # every slot released
    # "cuda:slot": the slot's own card
    monkeypatch.setattr(subprocess, "run", stub_run(calls))
    two = farm.SlotManager(tmp_path / ".two", 2)
    assert two.acquire() == 0
    farm.run_scene(TASKS[2], tmp_path / "h", two, False, device="cuda:slot")
    assert calls[-1][-2:] == ["--device", "cuda:1"]
    assert farm.slot_device("cpu", 1) == "cpu" and farm.slot_device("cuda", 1) == "cuda"


def test_farm_main_and_resume(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(subprocess, "run", stub_run(calls))
    tasks = tmp_path / "tasks.json"
    tasks.write_text(json.dumps(TASKS[:2]))
    out = tmp_path / "farm"
    argv = ["--tasks", str(tasks), "--out", str(out), "--slots", "2", "--device", "cpu"]
    assert farm.main(argv) == 0
    assert len(calls) == 2 and all(c[-2:] == ["--device", "cpu"] for c in calls)
    first = tables(out)
    assert farm.main(argv + ["--resume"]) == 0
    assert len(calls) == 2  # no child started
    again = tables(out)
    # the same tables, but for the status column (ok -> cached)
    assert [t.replace(b"cached", b"ok") for t in again] == list(first)
    assert b"cached" in again[0] and b"cached" not in first[0]
    assert farm.main(argv + ["--resume"]) == 0 and tables(out) == again


@pytest.fixture(scope="module")
def validate_runs():
    """The two paths' outputs at the CPU size, computed once."""
    dev = torch.device("cpu")
    scene, viewmat, K, gw = validate_fused.make_scene(1500, 128, 96, dev)
    from mtgs_torch.raster import RasterizeConfig

    outs = {}
    for fused in (False, True):
        cfg = RasterizeConfig(width=128, height=96, max_intersections=32768,
                              rasterize_mode="antialiased", render_mode="RGB+ED", fused=fused)
        outs[fused] = validate_fused.run(scene, viewmat, K, gw, cfg)
    return outs


VALIDATE_ARGS = ["--device", "cpu", "--n", "1500", "--width", "128", "--height", "96",
                 "--max-isect", "32768"]


def test_validate_fused_passes(capsys, validate_runs):
    assert validate_fused.main(VALIDATE_ARGS) == 0
    printed = capsys.readouterr().out
    assert "VALIDATE PASS" in printed
    ni = validate_runs[True][2]
    assert f"n_intersections classic={ni} fused={ni}" in printed and ni > 0
    assert validate_runs[False][2] == ni


def _perturbed(out, what):
    r, a, ni, grads, sg = out
    if what == "render":
        r = r + 1e-3
    elif what == "alpha":
        a = a + 1e-4
    elif what == "n_intersections":
        ni = ni + 1
    elif what == "absgrad":
        sg = sg * 1.01
    else:
        grads = [g * 1.01 if i == NAMES.index(what) else g for i, g in enumerate(grads)]
    return r, a, ni, grads, sg


NAMES = validate_fused.NAMES


@pytest.mark.parametrize("what", ["render", "alpha", "n_intersections", "absgrad", "means",
                                  "colors"])
def test_validate_fused_fails_on_a_perturbed_path(what, capsys, monkeypatch, validate_runs):
    """The classic path's output perturbed past a gate: VALIDATE FAIL, exit 1."""
    monkeypatch.setattr(validate_fused, "run", lambda scene, viewmat, K, gw, cfg: (
        validate_runs[True] if cfg.fused else _perturbed(validate_runs[False], what)))
    assert validate_fused.main(VALIDATE_ARGS) == 1
    assert "VALIDATE FAIL" in capsys.readouterr().out


def jax_printed_keys(tool: str) -> set:
    """The keys of the JSON line a JAX tool prints, read from its source: the
    `result` dict literal, or the `dict(...)` given to `json.dumps`."""
    tree = ast.parse((JAX_TOOLS / f"{tool}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            return {k.value for k in node.value.keys}
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Call)
                and getattr(node.args[0].func, "id", None) == "dict"):
            return {kw.arg for kw in node.args[0].keywords}
    raise AssertionError(f"no JSON line in {tool}.py")


def last_json(printed: str) -> dict:
    return json.loads(printed.strip().splitlines()[-1])


def test_grow_demo_grows(capsys):
    """The tool's CPU smoke sizes cut to 40 steps and a 2^16 buffer (the
    2^21 default's expansion over every slot dominates a CPU step)."""
    rc = grow_demo.main(["--device", "cpu", "--n-bg", "2000", "--target", "20000",
                         "--width", "128", "--height", "128", "--refine-every", "10",
                         "--max-steps", "40", "--max-isect", "65536"])
    res = last_json(capsys.readouterr().out)
    assert rc == 0
    assert set(res) == jax_printed_keys("grow_demo")
    assert res["overflow"] == 0 and res["optimizer_state_consistent"] is True
    assert res["final_capacity"] >= 2 * res["seed_capacity"] and res["value"] >= 4000
    assert res["n_growth_events"] >= 1 and res["steps"] == 40


GROW_LINE = re.compile(r"^# step (\d+): alive=(\d+) capacity=(\d+) overflow=(\d+) "
                       r"max_isect=(\d+)$", re.M)


def test_grow_demo_matches_jax(capsys, monkeypatch):
    """The port's grow_demo against JAX's, neither scene patched: one seed
    draws one scene in both packages and one key chain the duplicates'
    position noise (clone_sample_means at its default), at sizes where
    both the capacity and the intersection buffer grow: every refine's
    capacity, buffer and overflow equal, its alive count within 1% (the
    count crosses float thresholds: an average gradient > 1e-9, an opacity
    >= 0.005), the growth events equal, the JSON's values equal but the
    alive count and the time. JAX's trainer runs its Pallas path in
    interpret mode (its TPU path): on the CPU its XLA backward gives a
    visible gaussian that no pixel composites a rounding residue of
    absgrad (~1e-8 after the NDC scale, where the Pallas path and the port
    give 0), which the tool's 1e-9 threshold duplicates
    (tests/make_grow_fixture.py). JAX's ground truth renders through its
    plain reference blend (`--backend reference`: a third of the XLA
    backend's compile time here, the same counts), its draw compiled whole
    by `jax.jit` (one compile in place of one per eager op)."""
    argv = ["--n-bg", "1500", "--target", "100000", "--width", "48", "--height", "48",
            "--refine-every", "5", "--max-steps", "25", "--max-isect", "2560"]
    monkeypatch.setattr(jsynthetic, "_gt_gaussians",
                        jax.jit(jsynthetic._gt_gaussians, static_argnums=(1, 2, 3, 4)))
    config = jtrainer.TrainerConfig
    monkeypatch.setattr(jtrainer, "TrainerConfig", lambda **kw: config(
        **{**kw, "backend": "pallas", "interpret": True}))
    runs = []
    for main, extra in ((grow_demo.main, ["--device", "cpu"]),
                        (jgrow.main, ["--backend", "reference"])):
        rc = main(argv + extra)
        out = capsys.readouterr()
        events = re.search(r"^# growth events: (.*)$", out.err, re.M).group(1)
        runs.append((rc, last_json(out.out), GROW_LINE.findall(out.err), events))
    (rc, res, lines, events), (jrc, jres, jlines, jevents) = runs
    assert rc == jrc == 0 and events == jevents
    assert "'node': 'background'" in events and "'node': 'max_intersections'" in events
    assert [l[0] for l in lines] == [l[0] for l in jlines] == ["5", "10", "15", "20", "25"]
    for got, want in zip(lines, jlines):
        assert got[2:] == want[2:], (got, want)
        assert abs(int(got[1]) - int(want[1])) <= 0.01 * int(want[1]), (got, want)
    assert set(res) == set(jres)
    assert abs(res["value"] - jres["value"]) <= 0.01 * jres["value"]
    for key in set(res) - {"value", "vs_baseline", "elapsed_s"}:
        assert res[key] == jres[key], key


def test_onchip_smoke_on_the_cpu(capsys, tmp_path):
    rc = onchip_smoke.main(["--device", "cpu", "--width", "96", "--height", "64", "--n-bg",
                            "800", "--steps", "4", "--out", str(tmp_path)])
    res = last_json(capsys.readouterr().out)
    assert rc == 0
    assert set(res) == jax_printed_keys("onchip_smoke")
    assert res["eval_ok"] and res["interp_ok"] and res["viewer_ok"]
    assert res["backend"] == "cpu" and np.isfinite(res["value"])
    frames = sorted((tmp_path / "interp").glob("frame_*.png"))
    assert len(frames) >= 4 and read_image(frames[0]).shape == (64, 96, 3)
    assert json.loads((tmp_path / "eval_result.json").read_text())["psnr"] == res["value"]


@pytest.mark.parametrize("n, seed", [(1000, 0), (1001, 3)])
def test_scaling_make_scene_bit_equal_to_jax(n, seed):
    got = scaling_bench.make_scene(n, seed)
    want = jscaling.make_scene(n, seed)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, np.asarray(w))


def test_scaling_bench_gloo_world_on_the_cpu(capsys):
    """Worlds 1 and 2 as gloo ranks on the CPU (world 3 skipped: the buffer
    does not split in 3 x 512); the fullest band holds between half and all
    of the image's pairs, and nothing was truncated."""
    rc = scaling_bench.main(["--cpu", "--devices", "1", "2", "3", "--n-gauss", "4000",
                             "--width", "192", "--height", "128", "--max-isect", "16384",
                             "--iters", "2"])
    out = capsys.readouterr()
    res = last_json(out.out)
    assert rc == 0 and "skip n=3" in out.err
    assert set(res["per_device_ms"]) == {"1", "2"} and res["per_device_ms"]["2"] > 0
    assert set(res["scaling_efficiency"]) == {"2"}
    assert res["note"] == "gloo ranks on the CPU: algorithmic scaling only"
    image, band = res["fullest_band_pairs"]["1"], res["fullest_band_pairs"]["2"]
    assert 0 < image / 2 <= band <= image <= 16384
    assert res["truncated"] == {"1": False, "2": False}
    # JAX's wall-mode keys, and the port's
    assert {"metric", "value", "unit", "vs_baseline", "per_device_ms", "scaling_efficiency",
            "note", "per_rank_ms", "fullest_band_pairs", "truncated", "launches"} == set(res)
    with pytest.raises(ValueError, match="card"):
        scaling_bench.main(["--cpu", "--cost"])


def test_scaling_bench_flags_a_truncated_render(capsys):
    """A render whose pairs pass --max-isect is flagged and exits 1: it is
    no scaling figure."""
    rc = scaling_bench.main(["--cpu", "--devices", "1", "--n-gauss", "4000", "--width", "192",
                             "--height", "128", "--max-isect", "512", "--iters", "1"])
    out = capsys.readouterr()
    res = last_json(out.out)
    assert rc == 1 and res["truncated"] == {"1": True} and "truncated" in out.err
    assert res["fullest_band_pairs"]["1"] > 512


def test_scaling_kernel_ms_sets_collectives_apart(tmp_path):
    """`--cost` sums a trace's CUDA kernels, NCCL's collective kernels
    apart; host events do not count."""
    events = [dict(ph="X", cat="kernel", name="expand_fused_kernel", dur=1500),
              dict(ph="X", cat="kernel", name="void at::native::vectorized_elementwise", dur=250),
              dict(ph="X", cat="kernel", name="ncclDevKernel_AllGather_RING_LL(x)", dur=9000),
              dict(ph="X", cat="cpu_op", name="aten::sort", dur=4000),
              dict(ph="i", cat="kernel", name="marker")]
    path = tmp_path / "t.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    assert scaling_bench.kernel_ms(str(path)) == (1.75, 9.0)


def test_microbench_rows_small():
    rows = microbench_ops.run_rows(4096, 2048, 16, "cpu", iters=2)
    assert len(rows) == 27 and all(np.isfinite(v) and v >= 0 for v in rows.values())
    for name in ("sort + gather 16 payloads @cap=4096", "torch.sort STABLE @n",
                 "sort + gather 11 bf16 payloads @cap", "sort + gather 11 payloads @cap=3584",
                 "col gather attr-major [16, n] -> [16, cap]",
                 "kernel rows_to_attr_major [cap, 16]", "kernel attr_major_to_rows [16, cap]"):
        assert name in rows
    key = torch.tensor([3, 1, 2], dtype=torch.int32)
    s, a, b = microbench_ops.sort_gather(key, torch.tensor([30.0, 10, 20]),
                                         torch.tensor([0.3, 0.1, 0.2]))
    assert s.tolist() == [1, 2, 3] and a.tolist() == [10, 20, 30]
    assert b.tolist() == pytest.approx([0.1, 0.2, 0.3])


def test_tools_raise_without_a_card(monkeypatch, tmp_path):
    """Every entry point defaults to the card and raises without one, before
    it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tasks = tmp_path / "tasks.json"
    tasks.write_text(json.dumps(TASKS[:1]))
    for argv in (["--tasks", str(tasks), "--out", str(tmp_path / "farm")],
                 ["--tasks", str(tasks), "--out", str(tmp_path / "farm"),
                  "--device", "cuda:slot"]):
        with pytest.raises(RuntimeError, match="cuda"):
            farm.main(argv)
    mains = dict(validate_fused=(validate_fused.main, []),
                 onchip_smoke=(onchip_smoke.main, ["--out", str(tmp_path / "smoke")]),
                 grow_demo=(grow_demo.main, []),
                 scaling_bench=(scaling_bench.main, []),
                 scaling_cost=(scaling_bench.main, ["--cost"]),
                 microbench_ops=(microbench_ops.main, []))
    for name, (main, argv) in mains.items():
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["tasks.json"]
