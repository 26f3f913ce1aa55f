"""The `train` loop: `Trainer.train` one step after the other on the views
in an order drawn from the seed, from the mix's `start_step`.

Set-up builds one Trainer, puts Adam's count at `start_step` and its
moments, drawn from the seed (`scene.adam_moments`, the configuration's
`grad_rms` and the mix's `moments`), into its state, and runs the first
`checked_steps` steps through the window's own call and feed; the window
goes on with the same object. The reference follows those steps from the
same inputs and moments: each step's loss, the first gradient as Adam
holds it, the parameters' change after the last step and the densify
statistics then.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from bench_port import scene, work
from bench_port.loops import base
from bench_port.loops.base import rel_gap
from bench_port.reference import train as ref_train
from bench_port.reference.raster import Prec

DENSIFY = ("xys_grad_norm", "vis_counts", "max_2dsize")
CHUNK = 1 << 24


class Loop(base.Loop):
    KIND, UNIT = "train", "step"

    def __init__(self, cell, seed: int, dev):
        super().__init__(cell, seed, dev)
        self.start, self.checked = self.traffic["start_step"], self.traffic["checked_steps"]
        self.work_step = self.start

    def moments(self, alive: Dict[str, torch.Tensor]):
        """The function (leaf path, shape) -> Adam's (mu, nu) at the start."""
        cfg, tr = self.cfg, self.traffic
        return lambda path, shape: scene.adam_moments(
            path, shape, alive, cfg["grad_rms"], tr["moments"], self.seed, self.dev)

    def build(self, raw: dict, views: List[dict], I: int):
        from bench_port import program
        from mtgs_torch.train.optim import named_leaves

        self.named_leaves = named_leaves
        self.order = scene.view_order(len(views), self.seed)
        self.batches = [program.batch(v, scene.make_targets(v, self.W, self.H, self.seed, i,
                                                            self.dev), self.dev)
                        for i, v in enumerate(views)]
        params, aux = self.program_scene(raw)
        tc = program.trainer_config(self.cfg, self.W, self.H, I)
        self.trainer = program.Trainer(tc, params, aux, data=self._feed(),
                                       optim_config=program.optimizer_table(
                                           self.cfg["max_steps"]),
                                       seed=self.seed & 0x7FFFFFFF, device=self.dev)
        st = self.trainer.state
        st.step = self.start
        st.adam.count.fill_(self.start)
        self.draw = self.moments(scene.alive_by_node(raw))
        nus = dict(named_leaves(st.adam.nu))
        for path, mu in named_leaves(st.adam.mu):
            m, v = self.draw(path, tuple(mu.shape))
            mu.copy_(m)
            nus[path].copy_(v)
            del m, v

    def _feed(self):
        k = 0
        while True:
            yield self.batches[self.order[k % len(self.order)]]
            k += 1

    @torch.no_grad()
    def _first_grad_norms(self) -> Dict[str, float]:
        """Each leaf's first gradient as Adam got it, worked out from its
        state after one step: (mu_1 - b1 mu_0) / (1 - b1), in float64."""
        b1 = self.trainer.optim_config.b1
        out = {}
        for path, mu1 in self.named_leaves(self.trainer.state.adam.mu):
            mu0 = self.draw(path, tuple(mu1.shape))[0].reshape(-1)
            a = mu1.reshape(-1)
            ss = 0.0
            for s in range(0, a.numel(), CHUNK):
                d = (a[s:s + CHUNK].double() - b1 * mu0[s:s + CHUNK].double()) / (1 - b1)
                ss += float((d * d).sum())
            out[path] = ss ** 0.5
            del mu0
        return out

    def setup_steps(self, win) -> dict:
        st = self.trainer.state
        init = {k: v.detach().clone() for k, v in self.named_leaves(st.params)}
        losses = []
        for i in range(self.checked):
            m = self.trainer.train(1)[0]
            losses.append(m["total_loss"])
            win.n_isect.append(m["n_intersections"])
            if i == 0:
                grads = self._first_grad_norms()
        dens = st.densify
        kinds = [k for k in ("background", "skybox", "instances") if k in dens]
        densify = {f: torch.cat([getattr(dens[k], f).reshape(-1) for k in kinds])
                   for f in DENSIFY}
        change = {k: float((v.detach() - init[k]).norm())
                  for k, v in self.named_leaves(st.params)}
        del init
        return dict(losses=[float(x) for x in losses], grads=grads, change=change,
                    densify=densify,
                    views=[self.order[i % len(self.order)] for i in range(self.checked)])

    def unit(self, win):
        m = self.trainer.train(1)[0]
        win.dispatch.append(self.trainer.loop_stats["dispatch_s"])
        win.n_isect.append(m["n_intersections"])
        win.units += 1

    def traced_views(self, start_unit: int, n: int) -> List[int]:
        return [self.order[(self.checked + start_unit + i) % len(self.order)]
                for i in range(n)]

    def program_params(self):
        return self.trainer.state.params, self.trainer.aux

    def unit_flops(self, n_gauss, n_params, fwd_ops, bwd_ops) -> float:
        preset = self.cfg["preset"]
        return work.step_flops(n_gauss, preset["predict_normals"],
                               preset["loss"]["depth_lambda"] > 0, fwd_ops, bwd_ops,
                               self.W * self.H, n_params)

    def free(self):
        del self.trainer, self.batches

    # ------------------------------------------------------------ the check

    def reference(self, views_idx: List[int], prec: Prec, targets_fn=None):
        """The reference's steps over the checked views, from the seed's
        inputs and moments made anew: (its output, the parameters before)."""
        raw = self.make_scene()
        views = self.make_views()
        targets = [scene.make_targets(views[i], self.W, self.H, self.seed, i, self.dev)
                   for i in views_idx]
        if targets_fn is not None:
            targets = [targets_fn(t) for t in targets]
        params, aux = self.reference_scene(raw)
        draw = self.moments(scene.alive_by_node(raw))
        del raw
        params0 = {k: v.clone() for k, v in params.items()}
        ref = ref_train.train_steps(self.cfg, params, aux, [views[i] for i in views_idx],
                                    targets, self.start, self.W, self.H, prec, moments=draw,
                                    gather=self.gather)
        return ref, params0

    def as_program(self, ref: dict, params0: dict, views_idx: List[int]) -> dict:
        """The reference's steps reported as the program's checked steps are
        (the control and the faults stand in for the program so)."""
        return dict(losses=ref["losses"],
                    grads={k: float(v.norm()) for k, v in ref["grads"].items()},
                    change={k: float((ref["params"][k] - params0[k]).norm()) for k in params0},
                    densify=ref["densify"], views=views_idx)

    def compare(self, setup: dict) -> Dict[str, float]:
        ref, params0 = self.reference(setup["views"], Prec())
        return numbers(setup, ref, params0)


def median_leaf(g_ref: Dict[str, float]) -> float:
    """The median norm over the leaves the reference gives a gradient to: a
    view that shows no car leaves the instances' leaves without one, and
    they are not a leaf's scale."""
    return statistics.median([g for g in g_ref.values() if g > 0.0] or [0.0])


def numbers(prog: dict, ref: dict, params0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """loss_gap: the worst checked step's |loss - ref| / |ref|; grad_gap:
    the worst leaf's gap of first-gradient norms over max(its reference
    norm, the median leaf's); grad_gap_own: the worst gap of those over
    its own reference norm, of the leaves whose reference gradient is at
    least a thousandth of the median leaf's (a small leaf cannot hide under
    the median); change_gap: as grad_gap, of the parameters' change after
    the checked steps, over those leaves; densify_gap: the worst of the
    densify statistics' norm gaps after the checked steps (all gaussians)."""
    out = {"loss_gap": max(rel_gap(a, b, 0.0) for a, b in zip(prog["losses"], ref["losses"]))}
    g_ref = {k: float(v.norm()) for k, v in ref["grads"].items()}
    med_g = median_leaf(g_ref)
    extra = set(prog["grads"]) - set(g_ref)
    if any(prog["grads"][k] != 0.0 or prog["change"][k] != 0.0 for k in extra):
        raise ValueError(f"the program moves leaves the reference lacks: {sorted(extra)}")
    out["grad_gap"] = max(rel_gap(prog["grads"][k], g, med_g) for k, g in g_ref.items())
    moved = [k for k, g in g_ref.items() if g >= 1e-3 * med_g]
    out["grad_gap_own"] = max(rel_gap(prog["grads"][k], g_ref[k], 0.0) for k in moved)
    c_ref = {k: float((ref["params"][k] - params0[k]).norm()) for k in moved}
    med_c = statistics.median(c_ref.values())
    out["change_gap"] = max(rel_gap(prog["change"][k], c, med_c) for k, c in c_ref.items())
    out["densify_gap"] = max(
        rel_gap(float(prog["densify"][k].norm()), float(ref["densify"][k].norm()), 0.0)
        for k in DENSIFY)
    return out


def leaf_table(prog: dict, ref: dict, params0: Dict[str, torch.Tensor]) -> Dict[str, dict]:
    """Each leaf's first-gradient and change norms on both sides, its
    reference gradient over the median leaf's, and its gap against its own
    norm and against the floor `numbers` uses."""
    g_ref = {k: float(v.norm()) for k, v in ref["grads"].items()}
    med_g = median_leaf(g_ref)
    out = {}
    for k, g in g_ref.items():
        c = float((ref["params"][k] - params0[k]).norm())
        out[k] = dict(numel=ref["grads"][k].numel(), grad_ref=g, grad=prog["grads"][k],
                      to_median=g / med_g if med_g else 0.0,
                      gap_own=rel_gap(prog["grads"][k], g, 0.0),
                      gap=rel_gap(prog["grads"][k], g, med_g),
                      change_ref=c, change=prog["change"][k],
                      change_gap_own=rel_gap(prog["change"][k], c, 0.0))
    return out
