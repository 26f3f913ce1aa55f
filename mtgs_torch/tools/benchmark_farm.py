"""Multi-scene benchmark farm; port of `mtgs_tpu/tools/benchmark_farm.py`.

Counterpart of the reference's batch harness
(`mtgs/tools/batch_exp/run_base_benchmarking.py` in OpenDriveLab/MTGS):
schedules one `mtgs_torch.tools.train_scene` run per road block across
card slots (file-lock based, resumable via an existing eval_result.json),
then aggregates per-scene metrics into seen/unseen/overall tables
(`results_summary.csv` + `paste_table.tsv`).

Every child trains on `--device`: "cuda" (the default) puts every slot on
the current card, "cuda:slot" gives slot k the card cuda:k (as
`parallel/mesh.py::rank_device` gives rank k its card), "cpu" trains on
the CPU. Nothing falls back from the card to the CPU. Several farm
processes over one shared filesystem coordinate through the lock files, as
the reference's GPUManager does (`run_base_benchmarking.py:22-45`).

The tables are the JAX farm's, byte for byte, with two properties of its
`aggregate` kept: a per-traversal key `trv{i}_{m}` counts for every metric
name it ends with (so `seen_psnr` / `unseen_psnr` average the psnr and
cc_psnr values together), and `i` is the eval batch's `travel_index`,
the dense embedding index (an eval traversal takes its nearest train
traversal's), which is compared with the task's traversal ids.

Run:  python -m mtgs_torch.tools.benchmark_farm --tasks tasks.json --out OUT
      [--slots N] [--resume] [--device cuda|cuda:slot|cpu]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from mtgs_torch import resolve_device

METRICS = [
    "psnr", "ssim", "cc_psnr", "lpips", "dinov2_sim",
    "depth_RMSE", "depth_absRel", "depth_delta1",
]


class SlotManager:
    """File-lock card-slot allocator (ref GPUManager)."""

    def __init__(self, lock_dir: Path, num_slots: int):
        self.lock_dir = lock_dir
        self.lock_dir.mkdir(parents=True, exist_ok=True)
        self.num_slots = num_slots

    def acquire(self) -> Optional[int]:
        for slot in range(self.num_slots):
            lock = self.lock_dir / f"slot_{slot}.lock"
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                return slot
            except FileExistsError:
                continue
        return None

    def release(self, slot: int):
        (self.lock_dir / f"slot_{slot}.lock").unlink(missing_ok=True)


def slot_device(device: str, slot: int) -> str:
    """The device a slot's child trains on: `device` itself, or with
    "cuda:slot" the slot's own card."""
    return f"cuda:{slot}" if device == "cuda:slot" else device


def run_scene(task: dict, out_root: Path, slots: SlotManager, resume: bool,
              device: str = "cuda") -> dict:
    name = task["name"]
    out_dir = out_root / name
    result_file = out_dir / "eval_result.json"
    if resume and result_file.exists():
        return {"name": name, "status": "cached", **json.loads(result_file.read_text())}

    slot = None
    while slot is None:
        slot = slots.acquire()
        if slot is None:
            time.sleep(10.0)
    try:
        cmd = [
            sys.executable, "-m", "mtgs_torch.tools.train_scene",
            "--data", task["data"], "--out", str(out_dir),
            "--method", task.get("method", "mtgs"),
            "--steps", str(task.get("steps", 30001)),
        ]
        for key, flag in (("travels", "--travels"), ("eval_travels", "--eval-travels")):
            if task.get(key):
                cmd += [flag] + [str(t) for t in task[key]]
        cmd += ["--device", slot_device(device, slot)]
        log = out_dir / "train.log"
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(log, "w") as lf:
            proc = subprocess.run(cmd, stdout=lf, stderr=subprocess.STDOUT)
        if proc.returncode != 0 or not result_file.exists():
            return {"name": name, "status": f"failed({proc.returncode})"}
        return {"name": name, "status": "ok", **json.loads(result_file.read_text())}
    finally:
        slots.release(slot)


def aggregate(results: List[dict], tasks: List[dict], out_root: Path):
    """seen/unseen/overall aggregation (ref :111-183)."""
    rows = []
    for res, task in zip(results, tasks):
        if "psnr" not in res:
            rows.append({"name": res["name"], "status": res.get("status", "?")})
            continue
        row: Dict[str, float] = {"name": res["name"], "status": res["status"]}
        seen = set(task.get("travels") or [])
        for m in METRICS:
            if m in res:
                row[f"overall_{m}"] = res[m]
            seen_vals, unseen_vals = [], []
            for k, v in res.items():
                if k.startswith("trv") and k.endswith(f"_{m}"):
                    trv = int(k[3:].split("_")[0])
                    (seen_vals if trv in seen else unseen_vals).append(v)
            if seen_vals:
                row[f"seen_{m}"] = sum(seen_vals) / len(seen_vals)
            if unseen_vals:
                row[f"unseen_{m}"] = sum(unseen_vals) / len(unseen_vals)
        rows.append(row)

    keys = sorted({k for r in rows for k in r})
    with open(out_root / "results_summary.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    with open(out_root / "paste_table.tsv", "w") as f:
        f.write("\t".join(keys) + "\n")
        for r in rows:
            f.write("\t".join(str(r.get(k, "")) for k in keys) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tasks", required=True,
                    help="JSON file: [{name, data, travels, eval_travels, method, steps}]")
    ap.add_argument("--out", required=True)
    ap.add_argument("--slots", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help='the children\'s torch device: "cuda", "cuda:slot" (slot k on '
                         'cuda:k) or "cpu" (only when asked for)')
    args = ap.parse_args(argv)
    resolve_device("cuda" if args.device == "cuda:slot" else args.device)
    if args.device == "cuda:slot" and torch.cuda.device_count() < args.slots:
        raise RuntimeError(f"--device cuda:slot with {args.slots} slots needs {args.slots} "
                           f"cards; {torch.cuda.device_count()} present")

    tasks = json.loads(Path(args.tasks).read_text())
    out_root = Path(args.out)
    out_root.mkdir(parents=True, exist_ok=True)
    slots = SlotManager(out_root / ".locks", args.slots)

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=args.slots) as pool:
        results = list(pool.map(
            lambda t: run_scene(t, out_root, slots, args.resume, args.device), tasks
        ))
    aggregate(results, tasks, out_root)
    ok = sum(1 for r in results if r.get("status") in ("ok", "cached"))
    print(f"[farm] {ok}/{len(results)} scenes complete -> {out_root}/results_summary.csv")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
