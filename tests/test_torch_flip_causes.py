"""chip_smoke.py's cause test for the blend checks' flip allowance, on the
CPU: a pixel where one pair's alpha lies on either side of the 1/255
cut-off in the two blends is a cut-off flip; a pixel off by as much with
no pair near a cut-off shows no cause."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mtgs_torch.raster import blend
from mtgs_torch.raster.chunk_math import ALPHA_MIN, conic_coefficients, pixel_features, sigma
from tests.test_torch_kernels import make_blend_inputs

TILE, TX, TY, C_TOTAL = 16, 3, 2, 4


@pytest.fixture(scope="module")
def cutoff_pair():
    """Two blends of the same pairs but one opacity, which puts one pair's
    alpha at one pixel a float32 step above 1/255 in `want` and below it
    in `got`; (got, want, want's arguments, the tile, the pixel)."""
    slab, ranges = make_blend_inputs(3, tiles_x=TX, tiles_y=TY, tile_size=TILE,
                                     c_total=C_TOTAL, max_per_tile=300)
    slab = torch.from_numpy(slab)
    ranges = [torch.from_numpy(r) for r in ranges]
    offs, heads, counts, _ = ranges
    t = 4
    c0, n = int(offs[t] + heads[t]), int(counts[t])
    ox, oy = torch.tensor(float((t % TX) * TILE)), torch.tensor(float((t // TX) * TILE))
    S = sigma(conic_coefficients(slab[:6, c0:c0 + n], ox, oy)[:, None, :],
              pixel_features(TILE, "cpu"))[0]                          # [PIX, n]
    raw = slab[5, c0:c0 + n] * torch.exp(-S)
    p, i = (int(v) for v in ((raw > ALPHA_MIN) & (raw < 0.02)).nonzero()[0])
    lo, hi = 0.0, float(slab[5, c0 + i])
    for _ in range(200):  # the float32 opacities either side of alpha = 1/255 there
        mid = float(np.float32((lo + hi) / 2))
        if float(torch.tensor(mid) * torch.exp(-S[p, i])) >= ALPHA_MIN:
            hi = mid
        else:
            lo = mid
    kw = dict(tile_size=TILE, tiles_x=TX, c_total=C_TOTAL)
    args = {}
    for name, op in (("want", hi), ("got", lo)):
        s2 = slab.clone()
        s2[5, c0 + i] = op
        args[name] = (s2, *ranges)
    want = blend.blend_forward_plain(*args["want"], **kw)
    got = blend.blend_forward_plain(*args["got"], **kw)
    return got, want, args["want"], kw, t, p


def test_cutoff_flip_is_a_cause(cutoff_pair):
    got, want, a, kw, t, p = cutoff_pair
    assert float(cs.blend_errors(got, want)[t, p]) > cs.BLEND_TOL
    pixels = torch.zeros(want[1].shape, dtype=torch.bool)
    pixels[t, p] = True
    causes, diag = cs.flip_causes(got, want, a, kw, pixels)
    assert causes == dict(termination=0, cutoff=1, none=0) and not diag


def test_error_without_a_cutoff_has_no_cause(cutoff_pair):
    _, want, a, kw, t, p = cutoff_pair
    moved = (want[0].clone(), want[1])
    moved[0][t, 0, p + 1] += 0.01
    pixels = torch.zeros(want[1].shape, dtype=torch.bool)
    pixels[t, p + 1] = True
    causes, diag = cs.flip_causes(moved, want, a, kw, pixels)
    assert causes == dict(termination=0, cutoff=0, none=1) and len(diag) == 1
