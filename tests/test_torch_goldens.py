"""mtgs_torch `rasterize` forward vs the gsplat-math goldens.

The fixtures in `tests/goldens/` come from `make_goldens.py`, an
independent float64 implementation of gsplat v1.4's projection and tiled
blend. The port's forward (fused branch: expand, pair sort, blend) is
held to the tolerances of `test_goldens.py`: render 2e-3, alpha 1e-3.
On the CPU the wrappers run their plain versions; `test_torch_kernels.py`
holds the CUDA kernels to those on the card.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mtgs_torch.raster import RasterizeConfig, rasterize

GOLDEN_DIR = Path(__file__).parent / "goldens"
CASES = ["classic_rgb", "antialiased_rgbed", "antialiased_rgbed_tile16",
         "deep_stack_classic"]


@pytest.mark.parametrize("name", CASES)
def test_forward_matches_gsplat_golden(name):
    g = np.load(GOLDEN_DIR / f"{name}.npz")
    cfg = RasterizeConfig(
        width=int(g["W"]), height=int(g["H"]), tile_size=int(g["tile_size"]),
        rasterize_mode="antialiased" if bool(g["antialiased"]) else "classic",
        render_mode="RGB+ED" if bool(g["with_depth"]) else "RGB",
        max_intersections=1 << 16,
    )
    args = [torch.from_numpy(np.asarray(g[k], np.float32))
            for k in ("means", "quats", "scales", "opac", "colors", "viewmat", "K")]
    render, alpha, info = rasterize(*args, cfg)
    assert 0 < int(info["n_intersections"]) <= cfg.max_intersections
    np.testing.assert_allclose(render.numpy(), g["render"], atol=2e-3,
                               err_msg="render differs from gsplat-math golden")
    np.testing.assert_allclose(alpha.numpy(), g["alpha"], atol=1e-3)
