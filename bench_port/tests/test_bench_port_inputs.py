"""The benchmark's inputs are made by the seed alone, and its yardstick's
arithmetic matches a count made by hand."""

import torch

from bench_port import imports, scene, work
from bench_port.reference import raster
from bench_port.tests.conftest import tiny_cell


def _flat(x, prefix=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(x, torch.Tensor):
        yield prefix, x


def test_scene_and_targets_are_deterministic_by_seed():
    cfg = tiny_cell("mtgs_block3m.train").cfg
    seed = 2 ** 33 + 7  # above 32 bits, as the driver's are
    a, b = scene.make_scene(cfg, seed, "cpu"), scene.make_scene(cfg, seed, "cpu")
    c = scene.make_scene(cfg, seed + 1, "cpu")
    fa, fb, fc = dict(_flat(a)), dict(_flat(b)), dict(_flat(c))
    assert fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)
    assert not torch.equal(fa["background.means."], fc["background.means."])
    views = scene.make_views(cfg, 128, 96)
    t1 = scene.make_targets(views[0], 128, 96, seed, 0, "cpu")
    t2 = scene.make_targets(views[0], 128, 96, seed, 0, "cpu")
    assert all(torch.equal(t1[k], t2[k]) for k in t1)
    assert scene.view_order(24, seed) == scene.view_order(24, seed)
    assert sorted(scene.view_order(24, seed)) == list(range(24))


def test_blend_work_matches_a_hand_count_on_two_tiles():
    """One broad, opaque gaussian over a 64 x 32 image of two tiles: every
    pixel evaluates and composites it at alpha clamped to 0.999, and each
    tile reads it once."""
    c = 4
    table = torch.tensor([[32.0, 16.0, 1e-8, 0.0, 1e-8, 1.0, 0.5, 0.5, 0.5, 10.0]])
    stats = {}
    for t in (0, 1):
        raster.blend_block(table, torch.zeros(1, dtype=torch.long), torch.zeros(1).long(),
                           torch.ones(1).long(), torch.tensor([t]), 32, 2, c,
                           raster.Prec(), 8, stats)
    assert stats == dict(pair_support=2048, pair_blends=2048, pair_clamped=2048,
                         pairs_read=2)
    nbytes, ops = work.blend_forward_work(stats, c, 2, 2048)
    assert nbytes == 4 * ((6 + 4) * 2 + 3 * 2 + 5 * 2048)
    assert ops == 14 * 2048 + (6 + 8) * 2048
    nbytes, ops = work.blend_backward_work(stats, c, 2, 2048)
    assert nbytes == 4 * (2 * 10 * 2 + 3 * 2 + 10 * 2048)
    assert ops == 14 * 2048 + (30 + 16) * 2048 - 15 * 2048
    assert work.least_seconds(3.35e12, 0) == 1.0 and work.least_seconds(0, 67e12) == 1.0


def test_import_check_compares_whole_top_level_names():
    assert imports.forbidden_loaded(["mtgs_torch.raster", "numpy", "jaxtyping"]) == []
    assert imports.forbidden_loaded(["jax.numpy", "mtgs_tpu.raster", "flax"]) == [
        "flax", "jax", "mtgs_tpu"]
    assert imports.forbidden_loaded() == []
