"""The `render` loop: `render_view(training=False)` one view after the
other in an order drawn from the seed, each view ending when its RGB is a
uint8 array in host memory; the outputs of a sample of views drawn from
the seed are kept, and the reference renders those views again."""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from bench_port import scene, work
from bench_port.loops import base
from bench_port.reference import train as ref_train
from bench_port.reference.raster import Prec

RENDER_STEP = 30000  # a trained scene's step (full SH degree)
KEPT = ("rgb_appearance", "depth", "accumulation", "normal")


def to_u8(rgb: torch.Tensor):
    return (torch.clamp(rgb, 0, 1) * 255).to(torch.uint8).cpu().numpy()


class Loop(base.Loop):
    KIND, UNIT = "render", "view"

    def build(self, raw: dict, views: List[dict], I: int):
        from bench_port import program

        self.program = program
        self.params, self.aux = self.program_scene(raw)
        self.tc = program.trainer_config(self.cfg, self.W, self.H, I)
        self.order = scene.view_order(len(views), self.seed)
        self.batches = [program.batch(v, None, self.dev) for v in views]
        self.sample = scene.sample_views(len(views), self.traffic["sample_views"], self.seed)
        self.kept: Dict[int, dict] = {}
        self.work_step = RENDER_STEP
        self.k = 0

    def _render(self, i: int, win):
        t0 = time.perf_counter()
        out = self.program.render_view(self.params, self.aux, self.tc, self.batches[i],
                                       RENDER_STEP, training=False, device=self.dev)
        t1 = time.perf_counter()
        u8 = to_u8(out["rgb_appearance"])
        t2 = time.perf_counter()
        if win is not None:
            win.latencies.append(t2 - t0)
            win.dispatch.append(t1 - t0)
            win.n_isect.append(out["n_intersections"])
            win.units += 1
        if i in self.sample:
            keep = {k: out[k] for k in KEPT if k in out}
            keep["u8"] = u8
            self.kept[i] = keep
        return out

    def setup_steps(self, win) -> dict:
        for i in sorted(set(self.order[:2]) | set(self.sample)):
            self._render(i, None)
        return {}

    def unit(self, win):
        i = self.order[self.k % len(self.order)]
        self.k += 1
        self._render(i, win)

    def traced_views(self, start_unit: int, n: int) -> List[int]:
        return [self.order[(start_unit + i) % len(self.order)] for i in range(n)]

    def program_params(self):
        return self.params, self.aux

    def unit_flops(self, n_gauss, n_params, fwd_ops, bwd_ops) -> float:
        return work.view_flops(n_gauss, self.cfg["preset"]["predict_normals"], fwd_ops,
                               self.W * self.H)

    def free(self):
        del self.params, self.aux, self.batches

    # ------------------------------------------------------------ the check

    def reference_renders(self, prec: Prec) -> Dict[int, dict]:
        """The reference's outputs of the sampled views, from the seed's
        scene made anew (the control puts them in the program's place)."""
        params, aux = self.reference_scene(self.make_scene())
        views = self.make_views()
        out = {}
        for i in self.kept:
            r = ref_train.render(self.cfg, params, aux, views[i], RENDER_STEP, self.W, self.H,
                                 prec, gather=self.gather)
            r["u8"] = to_u8(r["rgb_appearance"])
            out[i] = r
        return out

    def compare(self, setup: dict) -> Dict[str, float]:
        params, aux = self.reference_scene(self.make_scene())
        views = self.make_views()
        parts = []
        for i, kept in sorted(self.kept.items()):
            ref = ref_train.render(self.cfg, params, aux, views[i], RENDER_STEP, self.W,
                                   self.H, Prec(), gather=self.gather)
            parts.append(numbers(kept, ref))
            del ref
        return base.numbers_max(parts)


def numbers(kept: dict, ref: dict) -> Dict[str, float]:
    """Mean absolute gaps of one view's outputs: rgb (the exposure's
    output), accumulation, depth relative to the reference's where its
    accumulation passes 0.5, normals there, and the uint8 image in levels."""
    dev = ref["rgb_appearance"].device
    mae = lambda d: float(d.double().abs().mean())
    solid = ref["accumulation"][..., 0] > 0.5
    out = {"rgb_mae": mae(kept["rgb_appearance"].to(dev) - ref["rgb_appearance"]),
           "acc_mae": mae(kept["accumulation"].to(dev) - ref["accumulation"]),
           "depth_rel_mae": mae(((kept["depth"].to(dev) - ref["depth"]) / ref["depth"])[
               solid])}
    if "normal" in ref:
        out["normal_mae"] = mae((kept["normal"].to(dev) - ref["normal"])[solid])
    u8 = (torch.clamp(ref["rgb_appearance"], 0, 1) * 255).to(torch.uint8).cpu()
    out["u8_mae"] = mae(torch.as_tensor(kept["u8"]).float() - u8.float())
    return out
