"""XLA's CPU float32 elementwise math on torch tensors, bit for bit.

The JAX package transforms its random draws with `jnp.sqrt`, `jnp.exp`,
`jnp.sin`, `jnp.cos` and `jax.lax.erf_inv`'s `log1p`, which XLA's CPU
backend compiles to its own code. The port promises JAX's draws (the
synthetic ground truth, `random_quats`, the refine noise), so it computes
these functions as XLA's CPU backend does, not with torch's own kernels:

- `fma`: a float32 multiply-add rounded once, as XLA's compiler contracts
  a product into the sum that follows it;
- `sqrt`: XLA emits `vsqrtps`, which is correctly rounded; torch's float32
  sqrt on the CPU is not (0.7% of uniform inputs in [5, 40) land 1 ulp
  off with torch 2.13 on an AVX-512 CPU), so the float64 root, rounded
  once, gives the correctly rounded one;
- `log`, `log1p`: XLA's CPU log1p, Cephes' rational approximation below
  |x| = sqrt(2) - 1 and Cephes' polynomial log above it;
- `exp`: XLA's own polynomial (`exp(x) = 2^n * exp(r)` with a Cody-Waite
  reduction by ln 2, a degree-6 polynomial in r, its products fused, and
  results below 2^-126 flushed to zero, as XLA's CPU runtime runs with
  flush-to-zero), read from what XLA 0.9 compiles for `jax.jit(jnp.exp)`;
- `sin`, `cos`: XLA's CPU backend calls the process's libm `sinf` and
  `cosf`. These are glibc's (2.28 onwards; the tables below are glibc
  2.36's, read from its libm.so): the argument in float64, reduced by
  pi/2 (one fused multiply-subtract below |x| = 120, an exact 2/pi
  product in integers above), and a float64 polynomial whose multiply-adds
  glibc's FMA build fuses, rounded to float32 once.

Every step is an elementwise torch operation that rounds correctly on the
CPU and on the card (float32 and float64 multiply, add, divide and square
root, comparisons, integer arithmetic); a fused multiply-add is built from
exact parts. So the card computes the CPU's bits.
"""

from __future__ import annotations

import math

import torch

# Cephes' log1p (rational, |x| < sqrt(2) - 1) and log (polynomial), float32
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

# XLA's CPU exp: the input clamp, log2(e), ln 2 in two parts, the polynomial
_EXP_LO, _EXP_HI = -87.8000030517578125, 88.8000030517578125
_EXP_LOG2E = 1.4426950216293335
_EXP_LN2_HI, _EXP_LN2_LO = 0.693359375, -2.1219444170128554e-4
_EXP_P = (1.9875691214110702e-4, 1.398199936375022e-3, 8.333452045917511e-3,
          4.166579619050026e-2, 0.1666666567325592, 0.5)

# glibc's sinf / cosf (sysdeps/ieee754/flt-32/sincosf.h, s_sincosf_data.c)
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")     # 2/pi * 2^24
_HPI = float.fromhex("0x1.921fb54442d18p+0")          # pi/2
_HPI_HI = float.fromhex("0x1.921fb5p+0")               # pi/2's top 25 bits: n * hi is exact
_HPI_LO = _HPI - _HPI_HI                                # exact
_PI63 = float.fromhex("0x1.921fb54442d18p-62")        # 2 pi * 2^-64
_C = tuple(float.fromhex(h) for h in (                  # c0 .. c4
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5", "-0x1.6c087e89a359dp-10",
    "0x1.99343027bf8c3p-16"))
_S = tuple(float.fromhex(h) for h in (                  # s1 .. s3
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))
# 4/pi as glibc's __inv_pio4: entry i holds 2/pi's bits 8(i - 3) + 1 .. 8i + 8
_TWO_OVER_PI = int("A2F9836E4E441529FC2757D1F534DDC0DB6295993C439041", 16)
_INV_PIO4 = tuple((_TWO_OVER_PI >> (192 - 8 * (i + 1))) & 0xFFFFFFFF for i in range(24))
_MASK = 0xFFFFFFFF
_SPLIT = 134217729.0                                    # 2^27 + 1 (Veltkamp)


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
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


def _fma64(a: torch.Tensor, b, c) -> torch.Tensor:
    """float64 a * b + c as a fused multiply-add gives it: the product
    split exactly (Dekker), the three parts summed with one final rounding
    (an ulp off only where the exact sum lies within a 2^-50 ulp of a
    float64 tie)."""
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    c = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    p = a * b
    t = _SPLIT * a
    ah = t - (t - a)
    t = _SPLIT * b
    bh = t - (t - b)
    al, bl = a - ah, b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl     # p + e == a * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)                        # s + err == p + c
    return s + (err + e)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, a subnormal input taken as
    zero of its sign (XLA's CPU runtime runs with denormals-are-zero): the
    float64 root of a float32 rounds once to float32 without a
    double-rounding error."""
    x = torch.where(x.abs() < 2.0 ** -126, x * 0.0, x)
    return torch.sqrt(x.double()).float()


def log(y: torch.Tensor) -> torch.Tensor:
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
    y0 = fma(fma(x, c(p[0]), c(p[1])), x, c(p[2]))
    y1 = fma(fma(x, c(p[3]), c(p[4])), x, c(p[5]))
    y2 = fma(fma(x, c(p[6]), c(p[7])), x, c(p[8]))
    t = fma(fma(y0, x3, y1), x3, y2)
    t = fma(t, x3, e * c(_LOG_Q1))
    return fma(e, c(_LOG_Q2), fma(-x2, c(0.5), x) + t)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log1p (x > -1)."""
    c = lambda v: _f32(v, x.device)
    x2 = x * x
    den = torch.ones_like(x)
    for k in _LOG1P_DEN[1:]:
        den = fma(den, x, c(k))
    num = torch.full_like(x, _LOG1P_NUM[0])
    for k in _LOG1P_NUM[1:]:
        num = fma(num, x, c(k))
    small = x + fma(x2, c(-0.5), (x * x2) * (num / den))
    return torch.where(x.abs() < c(_LOG1P_SMALL), small, log(x + 1.0))


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 exp: x clamped to [-87.8, 88.8], n = floor(x log2(e)
    + 1/2) clamped to [-127, 127], r = x - n ln 2 (two fused steps), exp(r)
    by a polynomial with fused steps, times 2^n built from its bits (2^-127
    is 0, so exp(x) is 0 there); NaN stays NaN, +inf gives inf, and a result
    below 2^-126 is flushed to 0."""
    c = lambda v: _f32(v, x.device)
    xc = torch.minimum(c(_EXP_HI), torch.maximum(c(_EXP_LO), x))
    fx = torch.floor(fma(xc, c(_EXP_LOG2E), c(0.5))).clamp(-127.0, 127.0)
    r = fma(-fx, c(_EXP_LN2_HI), xc)
    r = fma(-fx, c(_EXP_LN2_LO), r)
    y = fma(c(_EXP_P[0]), r, c(_EXP_P[1]))
    for k in _EXP_P[2:]:
        y = fma(y, r, c(k))
    y = fma(y, r * r, r) + 1.0
    n = torch.nan_to_num(fx).to(torch.int32)
    scale = ((n + 127) << 23).view(torch.float32)
    p = y.double() * scale.double()        # exact: scale is 0 or a power of two
    return torch.where(p < 2.0 ** -126, torch.zeros_like(p), p).float()


def _reduce_large(bits: torch.Tensor):
    """glibc's `reduce_large`: |y| (its float32 bits, |y| >= 120) modulo
    pi/2 from the 32 x 96-bit product with 4/pi in 2.62 fixed point, kept
    as 32-bit words in int64 (each product of a 31-bit and a 32-bit word
    fits); returns (r in float64 within [-pi/4, pi/4], quadrant n)."""
    idx = (bits >> 26) & 15
    xi = ((bits & 0xFFFFFF) | 0x800000) << ((bits >> 23) & 7)
    table = torch.tensor(_INV_PIO4, dtype=torch.int64, device=bits.device)
    hi = (xi * table[idx]) & _MASK                 # uint32 product
    mid = xi * table[idx + 4]
    lo = ((xi * table[idx + 8]) >> 32) + (mid & _MASK)
    hi = (hi + (mid >> 32) + (lo >> 32)) & _MASK   # the 64-bit sum, mod 2^64
    lo = lo & _MASK
    n = ((hi + (1 << 29)) & _MASK) >> 30           # (res + 2^61) >> 62
    hi = (hi - (n << 30)) & _MASK                  # res - (n << 62)
    signed = torch.where(hi >= (1 << 31), hi - (1 << 32), hi) * (1 << 32) + lo
    return signed.double() * _PI63, n


def _sincos(y: torch.Tensor, cosine: bool) -> torch.Tensor:
    """glibc's sinf (cosine False) or cosf of float32 y, branch for branch
    on the top 12 bits of |y|: below 2^-12 y (or 1), below 120 the fast
    reduction (below 0.75, where glibc reduces nothing, it gives n = 0 and
    r = y), else the large one; inf and NaN give NaN."""
    bits = y.view(torch.int32).to(torch.int64) & _MASK
    top = (bits >> 20) & 0x7FF
    x = y.double()
    # |y| < 120: n = round(y 2/pi) by glibc's scaled truncation, and
    # y - n pi/2 rounded once (pi/2 in two parts; y - n hi is exact)
    n = ((x * _HPI_INV).trunc().to(torch.int64) + 0x800000) >> 24
    nd = n.double()
    r = (x - nd * _HPI_HI) - nd * _HPI_LO
    r_large, n_large = _reduce_large(bits)
    large = top >= 0x42F
    par = torch.where(large, n_large, n)
    # the sign and table index take y's sign in the large branch
    q = torch.where(large, n_large + (bits >> 31), n)
    r = torch.where(large, r_large, r)
    r = torch.where(((q & 3) == 1) | ((q & 3) == 2), -r, r)
    if cosine:
        par = par ^ 1
    x2 = r * r
    # the sine polynomial (par even)
    x3 = r * x2
    s1 = _fma64(x2, _S[2], _S[1])
    sin_p = _fma64(x3 * x2, s1, _fma64(x3, _S[0], r))
    # the cosine polynomial (par odd), its coefficients negated if q & 2
    cs = torch.where((q & 2) != 0, -1.0, 1.0).to(torch.float64)
    c = [cs * v for v in _C]
    x4 = x2 * x2
    c2 = _fma64(x2, c[4], c[3])
    cos_p = _fma64(x4 * x2, c2, _fma64(x4, c[2], _fma64(x2, c[1], c[0])))
    out = torch.where((par & 1) == 0, sin_p, cos_p).float()
    out = torch.where(top < 0x398, torch.ones_like(y) if cosine else y, out)
    return torch.where(top >= 0x7F8, torch.full_like(y, math.nan), out)


def sin(y: torch.Tensor) -> torch.Tensor:
    """glibc's float32 sinf, as XLA's CPU backend calls it."""
    return _sincos(y, cosine=False)


def cos(y: torch.Tensor) -> torch.Tensor:
    """glibc's float32 cosf, as XLA's CPU backend calls it."""
    return _sincos(y, cosine=True)
