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
XLA's CPU compiler fuses computed as fused (`_fma`, exact in float64); a
few draws in a hundred thousand still land 1-2 ulp from JAX's, where
XLA's compiler fuses differently in context. The other samplers are
bit-equal to JAX's. All of it is elementwise torch with correctly rounded
operations, so the card draws what the CPU draws.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
Shape = Union[int, Sequence[int]]

# XLA's float32 ErfInv: the two branches' coefficients, w < 5 and w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's CPU log1p: Cephes' rational approximation below |x| = sqrt(2) - 1,
# log(1 + x) above it, by Cephes' polynomial log (float32 constants)
_LOG1P_SMALL = 0.41421356
_LOG1P_DEN = (1.0, 15.062909083469192, 83.04756596796721, 221.76239823732856,
              309.0987222531206, 216.42788614495947, 60.118660497603844)
_LOG1P_NUM = (4.5270000862445199635215e-5, 0.49854102823193376, 6.578732594206104,
              29.911919328553073, 60.94966798098779, 57.11296359058554, 20.03955349920128)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF = 0.707106781186547524


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


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as XLA's CPU backend contracts it:
    the product is exact in float64, and a sum that rounds in float64 onto
    a float32 tie is moved off it by the sign of its rounding error."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)          # s + err == p + c exactly
    tie = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    inf = torch.full_like(s, math.inf)
    s = torch.where(tie & (err > 0), torch.nextafter(s, inf), s)
    s = torch.where(tie & (err < 0), torch.nextafter(s, -inf), s)
    return s.float()


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform`: float32 in [minval, maxval), computed in
    float32 as (u * (maxval - minval) + minval) clamped below at minval."""
    shape = _shape(shape)
    lo, hi = _f32(minval, key.device), _f32(maxval, key.device)
    return torch.maximum(lo, _fma(_unit(key, shape), hi - lo, lo))


def _log(y: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log of y > 0 (Cephes): y = m * 2^e with m in
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial in m - 1, its products
    fused where XLA's compiler fuses them."""
    c = lambda v: _f32(v, y.device)
    bits = torch.maximum(y, c(2.0 ** -126)).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < c(_SQRT_HALF)
    e = e - low.float()
    x = (m - 1.0) + torch.where(low, m, c(0.0))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y0 = _fma(_fma(x, c(p[0]), c(p[1])), x, c(p[2]))
    y1 = _fma(_fma(x, c(p[3]), c(p[4])), x, c(p[5]))
    y2 = _fma(_fma(x, c(p[6]), c(p[7])), x, c(p[8]))
    t = _fma(_fma(y0, x3, y1), x3, y2)
    t = _fma(t, x3, e * c(_LOG_Q1))
    return _fma(e, c(_LOG_Q2), _fma(-x2, c(0.5), x) + t)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log1p (x > -1)."""
    c = lambda v: _f32(v, x.device)
    x2 = x * x
    den = torch.ones_like(x)
    for k in _LOG1P_DEN[1:]:
        den = _fma(den, x, c(k))
    num = torch.full_like(x, _LOG1P_NUM[0])
    for k in _LOG1P_NUM[1:]:
        num = _fma(num, x, c(k))
    small = x + _fma(x2, c(-0.5), (x * x2) * (num / den))
    return torch.where(x.abs() < c(_LOG1P_SMALL), small, _log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv (Giles' single-precision approximation), with
    XLA's CPU log1p and its fused multiply-adds."""
    w = -_log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(small, _f32(_ERFINV_SMALL[i], x.device),
                                 _f32(_ERFINV_LARGE[i], x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_SMALL)):
        p = _fma(p, w, coef(i))
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
