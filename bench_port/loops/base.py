"""What every loop shares: the inputs made from the seed, the program's
and the reference's view of them, the benchmark's own pair count, and
the work counts of traced units.

A loop's life in a run (`harness.run`):

1. `make_scene()`, `make_views()`: the raw inputs, drawn from the seed;
2. `pair_counts(raw, views)`: the benchmark's count that sizes the
   program's pair buffer;
3. `build(raw, views, I)`: the program's objects (the raw scene is freed
   after it);
4. `setup_steps(win)`: the units that warm up the cell's shapes and whose
   outputs are checked, through the window's own call;
5. `unit(win)` until the window closes;
6. `traced_work(views)` (`--trace 1` runs), `free()`, then `compare(setup)`.

A new kind of scene node overrides the hooks that see the scene:
`make_scene`, `program_scene`, `reference_scene`, `reference_aux` and
`gather` (the reference's world-space gaussians of a view).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench_port import scene, work
from bench_port.reference import model as ref_model
from bench_port.reference import train as ref_train
from bench_port.reference.raster import Prec, project, tile_rects


class Loop:
    KIND = ""    # the family of end-to-end metrics: "train" (step_ms) or "render" (view_ms)
    UNIT = ""    # what one unit of the window is: "step" or "view"

    def __init__(self, cell, seed: int, dev):
        self.cell, self.seed, self.dev = cell, seed, torch.device(dev)
        self.cfg, self.traffic = cell.cfg, cell.traffic
        self.W, self.H = self.traffic["width"], self.traffic["height"]

    # ------------------------------------------------------------ the inputs

    def make_scene(self) -> dict:
        return scene.make_scene(self.cfg, self.seed, self.dev)

    def make_views(self) -> List[dict]:
        return scene.make_views(self.cfg, self.W, self.H)

    def program_scene(self, raw: dict):
        """The program's (SceneParams, SceneAux) of the raw scene."""
        from bench_port import program

        return program.scene_params(raw)

    def reference_scene(self, raw: dict):
        """The reference's (params, aux) of the raw scene."""
        return ref_model.flat_scene(raw)

    gather = staticmethod(ref_model.gather)

    def reference_aux(self, aux) -> dict:
        """The reference's fixed per-row tensors of the program's SceneAux
        (for the work counts of traced units, whose parameters are the
        program's at the trace's end)."""
        out = {"background.alive": aux.background.alive}
        if aux.skybox is not None:
            out["skybox.alive"] = aux.skybox.alive
        if aux.instances is not None:
            out["instances.node.alive"] = aux.instances.alive
            out.update({f"instances.{k}": getattr(aux.instances, k)
                        for k in ("present", "is_static", "sizes")})
        return out

    @torch.no_grad()
    def pair_counts(self, raw: dict, views: List[dict]) -> List[int]:
        """The benchmark's own count of each view's (tile, gaussian) pairs,
        the serving pose, by the program's rule (3-sigma box cut to the
        1/255 support), with a wider support margin than the program's:
        the buffer it sizes holds every pair."""
        params, aux = self.reference_scene(raw)
        preset, prec = self.cfg["preset"], Prec()
        counts = []
        for v in views:
            c2w = v["c2w"].to(self.dev)
            mask = ref_model.sh_mask(10 ** 9, 3, 1, self.dev)
            means, quats, scales, opac, _ = self.gather(params, aux, v, c2w[:3, 3], mask, prec)
            proj = project(means, quats, scales, ref_model.view_matrix(c2w, prec),
                           v["K"].to(self.dev), self.W, self.H,
                           antialiased=preset["rasterize_mode"] == "antialiased", prec=prec)
            op = opac * proj.comp
            x0, x1, y0, y1 = tile_rects(proj.means2d, proj.radii, proj.conics, op,
                                        proj.valid & (op > 0), self.W, self.H,
                                        preset["tile_size"], support_margin=1.0)
            counts.append(int(((x1 - x0).clamp(min=0) * (y1 - y0).clamp(min=0)).sum()))
        return counts

    # ------------------------------------------------------------ the work

    work_step = 0  # the step whose SH degree the traced units render at

    def program_params(self):
        """The program's (SceneParams, SceneAux) as they stand."""
        raise NotImplementedError

    def unit_flops(self, n_gauss: int, n_params: int, fwd_ops: float, bwd_ops: float) -> float:
        raise NotImplementedError

    def traced_work(self, views_idx: List[int]) -> dict:
        """The reference's blend statistics of the traced units' views with
        the program's parameters at the trace's end, and the float32
        operations a unit needs (averages over the traced units)."""
        from mtgs_torch.train.optim import named_leaves

        W, H = self.W, self.H
        views = self.make_views()
        sp, sa = self.program_params()
        params = {k: v.detach() for k, v in named_leaves(sp)}
        aux = self.reference_aux(sa)
        preset = self.cfg["preset"]
        c = 3 + (3 if preset["predict_normals"] else 0) + 1
        tiles = -(-W // preset["tile_size"]) * -(-H // preset["tile_size"])
        fwd_b = fwd_o = bwd_b = bwd_o = 0.0
        for i in views_idx:
            stats: dict = {}
            ref_train.render(self.cfg, params, aux, views[i], self.work_step, W, H, Prec(),
                             stats=stats,
                             gather=self.gather)
            b, o = work.blend_forward_work(stats, c, tiles, W * H)
            fwd_b, fwd_o = fwd_b + b, fwd_o + o
            b, o = work.blend_backward_work(stats, c, tiles, W * H)
            bwd_b, bwd_o = bwd_b + b, bwd_o + o
        n = len(views_idx)
        n_gauss = sum(int(v.numel()) for k, v in aux.items() if k.endswith("alive"))
        n_params = sum(int(v.numel()) for v in params.values())
        return dict(blend_forward=(fwd_b / n, fwd_o / n),
                    blend_backward=(bwd_b / n, bwd_o / n),
                    flops=self.unit_flops(n_gauss, n_params, fwd_o / n, bwd_o / n))


def rel_gap(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor, 1e-30)


def numbers_max(parts: List[Dict[str, float]]) -> Dict[str, float]:
    """The worst of each number over several parts (views, steps)."""
    out: Dict[str, float] = {}
    for p in parts:
        for k, v in p.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
