"""JAX's random streams on torch tensors: threefry2x32 keys and samplers.

The port's own copy of the semantics of `jax.random` under JAX's defaults
(`jax_default_prng_impl = threefry2x32`, `jax_threefry_partitionable =
True`), so that one seed gives the same synthetic scene, the same refine
noise and the same initial weights in the port as in the JAX package.
Everything is deterministic integer arithmetic on the caller's device:

- a key is an int64 tensor [2] (the high and low 32-bit words), a batch
  of keys [..., 2]; every word lies in [0, 2^32);
- `threefry2x32` is the 20-round hash with JAX's rotation constants;
- `split`, `fold_in` and `random_bits` apply it to JAX's counters (a
  64-bit iota as two 32-bit words for `split` and the bits, the pair
  (0, data) for `fold_in`), the bits being `bits1 ^ bits2`;
- `uniform`, `normal`, `randint` and `bernoulli` transform the bits as
  `jax/_src/random.py` does, in float32 and with the same draw order, so
  the shape of a draw and the keys it splits are part of its stream.

`normal` takes XLA's float32 `ErfInv` (Giles' single-precision
polynomial) over XLA's CPU log1p (Cephes), with the multiply-adds that
XLA's CPU compiler fuses computed as fused and the tail branch's square
root correctly rounded, as XLA's `vsqrtps` gives it (`core/xla_math.py`;
torch's float32 sqrt on the CPU is not correctly rounded). On the CPU
every draw is JAX's: 2^20 x 3 draws of seed 0, 300k and 900k of seeds 3
and 123, and erf_inv on all 114,086 float32 of its tail branch, none a
bit apart. The other samplers are bit-equal to JAX's too. Every step is an
elementwise torch operation that rounds correctly on either device, so
the card draws the CPU's bits (`chip_smoke.py` phase 2b: a 2^20 x 3 draw
and the tail branch, card against CPU).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

from mtgs_torch.core import xla_math

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
Shape = Union[int, Sequence[int]]

# XLA's float32 ErfInv: the two branches' coefficients, w < 5 and w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(d) for d in shape)


def key(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.key(seed)`'s raw key, int64 [2] on `device`: the seed's
    high and low 32-bit words as JAX's default 32-bit mode takes them, the
    seed wrapped to 32 bits (2^32 + 5 is seed 5), so the high word is 0."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 with 20 rounds (JAX's `_threefry2x32_lowering`): the
    key words k1, k2 (scalars or tensors broadcasting with the counters)
    and the counter words x1, x2, all in [0, 2^32); returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a, b = (x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = a ^ _rotl(b, r)
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def _counters(shape: Tuple[int, ...], device):
    """JAX's `iota_2x32_shape`: a 64-bit iota over `shape` as (high, low)."""
    n = math.prod(shape)
    iota = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return iota >> 32, iota & MASK


def _hash(key: torch.Tensor, shape: Tuple[int, ...]):
    if key.shape != (2,):
        raise ValueError(f"a key is an int64 tensor [2], got {tuple(key.shape)}")
    hi, lo = _counters(shape, key.device)
    return threefry2x32(key[0], key[1], hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: `num` keys [num, 2]."""
    bits1, bits2 = _hash(key, (int(num),))
    return torch.stack([bits1, bits2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: the key hashed with the counter
    pair (0, data), data taken as uint32."""
    x = torch.tensor([0, int(data) & MASK], dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[0], key[1], x[:1], x[1:])
    return torch.cat([a, b])


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element (`bits1 ^ bits2`), int64 in [0, 2^32)."""
    bits1, bits2 = _hash(key, _shape(shape))
    return bits1 ^ bits2


def _unit(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """float32 in [0, 1): the top 23 bits as the mantissa of [1, 2), less 1."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform`: float32 in [minval, maxval), computed in
    float32 as (u * (maxval - minval) + minval) clamped below at minval."""
    shape = _shape(shape)
    lo, hi = _f32(minval, key.device), _f32(maxval, key.device)
    return torch.maximum(lo, xla_math.fma(_unit(key, shape), hi - lo, lo))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv (Giles' single-precision approximation), with
    XLA's CPU log1p and its fused multiply-adds."""
    w = -xla_math.log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, xla_math.sqrt(w) - 3.0)
    coef = lambda i: torch.where(small, _f32(_ERFINV_SMALL[i], x.device),
                                 _f32(_ERFINV_LARGE[i], x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_SMALL)):
        p = xla_math.fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """`jax.random.normal`: sqrt(2) * erf_inv(u), u uniform on
    (nextafter(-1, 0), 1), in float32."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return _f32(math.sqrt(2.0), key.device) * erf_inv(u)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """`jax.random.randint` for int32: two 32-bit draws (from the key's
    two halves) folded modulo the span in uint32 arithmetic, as JAX does;
    int32 in [minval, maxval)."""
    shape = _shape(shape)
    lo_i32, hi_i32 = -(1 << 31), (1 << 31) - 1
    out_of_range = maxval > hi_i32
    minval = min(max(int(minval), lo_i32), hi_i32)
    maxval = min(max(int(maxval), lo_i32), hi_i32)
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & MASK
    if maxval <= minval:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK
    if span == 0:   # the full 2^32 range: XLA's x % 0 is x, so the low draw
        offset = lower
    else:
        mult = (1 << 16) % span
        mult = ((mult * mult) & MASK) % span
        offset = ((((higher % span) * mult) & MASK) + lower % span) & MASK
        offset = offset % span
    out = (minval + offset) & MASK
    return torch.where(out >= (1 << 31), out - (1 << 32), out).to(torch.int32)


def bernoulli(key: torch.Tensor, p: float = 0.5, shape: Shape = ()) -> torch.Tensor:
    """`jax.random.bernoulli` (mode 'low'): uniform < p, bool."""
    return _unit(key, _shape(shape)) < _f32(p, key.device)
