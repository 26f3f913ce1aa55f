"""`mtgs_torch.core.xla_math` against XLA's CPU code (`jax.jit` of the
`jnp` function), bit for bit.

The inputs span what the JAX package feeds these functions on its draw
paths: `exp` of `normal * 0.2-0.3 - 1.35-1.8` (the synthetic scales), `sin`
and `cos` of [0, 2 pi) (`random_quats`, the backdrop ring), of the ground's
`x * 0.5-0.9` and the facades' `z * 4` at the campaign's extents, and past
|x| = 120, where glibc's sinf and cosf take their large reduction; `sqrt`
of [0, 1] and of erf_inv's tail, [5, 40). Then the special values: zeros,
infinities, NaN, a subnormal, large arguments and `exp`'s clamp and flush
edges. The inputs come from numpy; 2^20 a function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtgs_torch.core import xla_math

N = 1 << 18   # four ranges of N a function


RANGES = {
    "exp": [(-4.0, 1.0), (-2.5, -0.5), (-90.0, 90.0), (-88.0, -86.0)],
    "sin": [(0.0, 2 * np.pi), (-45.0, 45.0), (0.0, 80.0), (-130.0, 130.0)],
    "cos": [(0.0, 2 * np.pi), (-45.0, 45.0), (0.0, 80.0), (-130.0, 130.0)],
    "sqrt": [(0.0, 1.0), (5.0, 40.0), (0.0, 1e-3), (0.0, 1e6)],
}
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1.0, -1.0, 2.0 ** -12,
                    0.75, 120.0, -120.0, np.float32(120.0) * (1 - 2.0 ** -24), 1e5, -1e5,
                    1e30, -1e30, 3.4e38, -3.4e38, 88.7, 88.72, 88.8, 89.0, -87.33, -87.5,
                    -87.8, -88.0, -100.0, np.pi, 2 * np.pi], np.float32)


def same_bits(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))


def inputs(name: str) -> np.ndarray:
    rng = np.random.default_rng(16)
    return np.concatenate([rng.uniform(lo, hi, N) for lo, hi in RANGES[name]]
                          ).astype(np.float32)


@pytest.mark.parametrize("name", sorted(RANGES))
def test_matches_xla_on_the_draw_ranges(name):
    x = inputs(name)
    want = np.asarray(jax.jit(getattr(jnp, name))(x))
    got = getattr(xla_math, name)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    bad = ~same_bits(got, want)
    assert not bad.any(), (int(bad.sum()), x[bad][:4], got[bad][:4], want[bad][:4])


@pytest.mark.parametrize("name", sorted(RANGES))
def test_special_values_match_xla(name):
    want = np.asarray(jax.jit(getattr(jnp, name))(SPECIAL))
    got = getattr(xla_math, name)(torch.from_numpy(SPECIAL)).numpy()
    bad = ~same_bits(got, want)
    assert not bad.any(), (SPECIAL[bad], got[bad], want[bad])
