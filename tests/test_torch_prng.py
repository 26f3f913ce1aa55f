"""`mtgs_torch.core.prng` against `jax.random` on the CPU.

Keys, splits, `fold_in`, the raw bits, `uniform`, `randint`,
`bernoulli` and `normal` must be bit-equal to JAX's (threefry2x32,
partitionable, the JAX defaults): `normal`'s erf_inv runs XLA's float32
polynomial over XLA's CPU log1p with the multiply-adds XLA fuses, and
takes the tail branch's square root correctly rounded, as XLA's CPU code
does (`core/xla_math.py`). The seeds come from numpy; the bounds and
spans are those `data/synthetic.py` draws with.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtgs_torch.core import prng

SEEDS = [int(s) for s in np.random.default_rng(15).integers(0, 2**31 - 1, 3)]


def raw(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**32 + 5, -1])
def test_key_matches_jax(seed):
    """JAX takes the seed in its default 32-bit mode: the low word, the
    high word 0 (so 2^32 + 5 is seed 5, and -1 is 0xFFFFFFFF)."""
    assert np.array_equal(prng.key(seed).numpy(), raw(jax.random.key(seed)))


@pytest.mark.parametrize("n", [1, 2, 5, 16])
def test_split_matches_jax(n):
    for seed in [0] + SEEDS:
        want = raw(jax.random.split(jax.random.key(seed), n))
        got = prng.split(prng.key(seed), n)
        assert got.shape == (n, 2) and got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want)


def test_split_chains_and_fold_in_match_jax():
    """Three splits deep, down the first and the last key, then fold_in."""
    for seed in SEEDS:
        jk, tk = jax.random.key(seed), prng.key(seed)
        for n, pick in ((5, 0), (16, 15), (3, 1)):
            jk, tk = jax.random.split(jk, n)[pick], prng.split(tk, n)[pick]
            assert np.array_equal(tk.numpy(), raw(jk))
        for data in (17, 0, 2**32 - 1):
            assert np.array_equal(prng.fold_in(tk, data).numpy(),
                                  raw(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("shape", [(), (7,), (1001, 3), (4, 5, 3)])
def test_random_bits_match_jax(shape):
    key = jax.random.key(SEEDS[0])
    want = np.asarray(jax.random.bits(key, shape)).astype(np.int64)
    got = prng.random_bits(prng.key(SEEDS[0]), shape)
    assert got.shape == shape and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-60.0, 60.0), (-12.0, 12.0), (0.15, 0.9),
                                    (7.0, 15.0), (5.4, 10.8), (1.5, 4.0), (-1.0, 1.0),
                                    (4.5, 7.0), (0.8, 2.5), (0.1, 0.8), (0.0, 2 * np.pi),
                                    (0.0, 15.0), (-0.5, 0.5)])
def test_uniform_matches_jax(bounds):
    lo, hi = bounds
    for seed in [0] + SEEDS[:1]:
        key = jax.random.split(jax.random.key(seed), 16)[4]
        want = np.asarray(jax.random.uniform(key, (1001, 3), minval=lo, maxval=hi))
        got = prng.uniform(prng.split(prng.key(seed), 16)[4], (1001, 3), lo, hi)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want), np.abs(got.numpy() - want).max()


@pytest.mark.parametrize("span", [(0, 4), (0, 15), (0, 6), (0, 37), (0, 2**31 - 1),
                                  (-5, 2**31 - 1), (3, 3)])
def test_randint_matches_jax(span):
    lo, hi = span
    for seed in [0] + SEEDS[:1]:
        want = np.asarray(jax.random.randint(jax.random.key(seed), (2001,), lo, hi))
        got = prng.randint(prng.key(seed), (2001,), lo, hi)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_bernoulli_matches_jax():
    for seed in [0] + SEEDS:
        want = np.asarray(jax.random.bernoulli(jax.random.key(seed), 0.5, (1001,)))
        got = prng.bernoulli(prng.key(seed), 0.5, (1001,))
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
        assert 0.4 < float(got.float().mean()) < 0.6


@pytest.mark.parametrize("shape", [(), (7,), (1001, 3), (4, 5, 3)])
def test_normal_matches_jax(shape):
    for seed in [0] + SEEDS:
        want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
        got = prng.normal(prng.key(seed), shape)
        assert got.shape == shape and got.dtype == torch.float32
        assert ulps(got.numpy(), want).max(initial=0) == 0


def test_normal_tail_and_bulk_match_jax():
    """300k draws reach both branches of erf_inv (w < 5 and w >= 5) and
    both of log1p (|x| below and above sqrt(2) - 1); every draw is JAX's."""
    want = np.asarray(jax.random.normal(jax.random.key(3), (300_000,)))
    got = prng.normal(prng.key(3), (300_000,)).numpy()
    assert ulps(got, want).max() == 0
    assert np.abs(want).max() > 4.0       # the tail branch was drawn


def test_erf_inv_matches_xla():
    x = np.linspace(-0.999999, 0.999999, 20001, dtype=np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    assert ulps(got, want).max() == 0
    edge = prng.erf_inv(torch.tensor([1.0, -1.0, 0.0]))
    assert edge[0] == float("inf") and edge[1] == float("-inf") and edge[2] == 0.0


def test_erf_inv_tail_matches_xla():
    """Every float32 with 0.9966 <= |x| < 1 (114,086 inputs, the whole of
    the tail branch, w >= 5): torch's float32 sqrt on the CPU is not
    correctly rounded there, XLA's is."""
    pos = np.arange(np.float32(0.9966).view(np.int32), np.float32(1.0).view(np.int32),
                    dtype=np.int32).view(np.float32)
    x = np.concatenate([pos, -pos])
    assert x.size == 114_086
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    assert ulps(got, want).max() == 0
