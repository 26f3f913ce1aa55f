"""mtgs_torch expand_fused (plain twin) vs the JAX Pallas kernel.

The JAX side runs `mtgs_tpu.raster.expand_fused.expand_fused` in interpret
mode, fed the table built by its own `table_index_rows` and
`binning.window_anchors`. Every one of the I slots — dead ones included —
must be equal in key, src and attrs (values compared exactly; the TPU
kernel's copies are one-hot selections, exact in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtgs_tpu  # noqa: F401  (sets JAX's f32 matmul precision)
from mtgs_tpu.raster import binning as jbinning
from mtgs_tpu.raster import expand_fused as jexp
from mtgs_torch.raster.expand_fused import expand_fused, expand_fused_plain
from tests.test_torch_kernels import make_expand_inputs


def jax_expand(table, offsets, packed, total, I, *, tiles_x, num_tiles):
    nw, n = table.shape
    n_pad = ((n + jexp.ALIGN - 1) // jexp.ALIGN) * jexp.ALIGN + jexp.WINA
    rows = [jnp.pad(jnp.asarray(r), (0, n_pad - n)) for r in table]
    rows += jexp.table_index_rows(jnp.asarray(offsets), jnp.asarray(packed), n, n_pad, I)
    w_tab = ((nw + 5 + 7) // 8) * 8
    rows += [jnp.zeros((n_pad,), jnp.float32)] * (w_tab - nw - 5)
    gal = jbinning.window_anchors(jnp.asarray(offsets), I)
    key, src, attrs = jexp.expand_fused(
        jnp.stack(rows), gal, jnp.asarray(total), I, nw=nw, tiles_x=tiles_x,
        num_tiles=num_tiles, n_gauss=n, interpret=True)
    return np.asarray(key), np.asarray(src), np.asarray(attrs)


# (n_live, n_dead, I): dead slots with a short zero-pair tail (the last
# gaussian inside the straddling block's table window), a long tail (outside
# it), a truncating capacity (total > I), and every gaussian empty.
CASES = [
    (300, 5, 2048),
    (200, 700, 2048),
    (900, 20, 1024),
    (0, 64, 512),
]


@pytest.mark.parametrize("n_live,n_dead,I", CASES)
def test_expand_plain_matches_jax_kernel(n_live, n_dead, I):
    tiles_x, tiles_y, nw = 6, 4, 13
    table, offsets, packed, total = make_expand_inputs(
        n_live + n_dead, n_live=n_live, n_dead=n_dead, nw=nw,
        tiles_x=tiles_x, tiles_y=tiles_y)
    if n_live == 900:
        assert total > I  # the truncating case really truncates
    num_tiles = tiles_x * tiles_y
    jk, js, ja = jax_expand(table, offsets, packed, total, I,
                            tiles_x=tiles_x, num_tiles=num_tiles)
    tk, ts, ta = expand_fused(
        torch.from_numpy(table), torch.from_numpy(offsets), torch.from_numpy(packed),
        torch.tensor([total], dtype=torch.int32), I, tiles_x=tiles_x,
        num_tiles=num_tiles)
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert ta.shape == ja.shape == (16, I)
    np.testing.assert_array_equal(ta.numpy(), ja)
    if n_dead == 700:  # both dead-slot outcomes occur
        dead = np.arange(I) >= total
        assert (js[dead] == 0).any() and (js[dead] == n_live + n_dead - 1).any()


def test_expand_wrapper_uses_plain_on_cpu():
    table, offsets, packed, total = make_expand_inputs(
        1, n_live=50, n_dead=3, nw=10, tiles_x=4, tiles_y=3)
    args = (torch.from_numpy(table), torch.from_numpy(offsets),
            torch.from_numpy(packed), torch.tensor([total], dtype=torch.int32), 512)
    a = expand_fused(*args, tiles_x=4, num_tiles=12)
    b = expand_fused_plain(*args, tiles_x=4, num_tiles=12)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="does not fit"):
        expand_fused(*args[:4], 500, tiles_x=4, num_tiles=12)
