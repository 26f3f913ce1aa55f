"""Per-tile blend constants and the chunk math (plain PyTorch).

Port of `mtgs_tpu/raster/chunk_math.py` (:48-56 constants, `_chunk_common`
:163-224, `forward_chunk` :227-246 and `backward_chunk` :249-320),
batched over a leading tile axis. It is the arithmetic of the plain
blends (`blend.blend_forward_plain`, `blend.blend_backward_plain`) and
states what the CUDA kernels (`csrc/blend_forward.cu`,
`csrc/blend_backward.cu`) must compute.

Blend semantics match gsplat v1.4 / classic 3DGS:
  alpha = min(0.999, opacity * exp(-sigma)); skip if sigma < 0 or
  alpha < 1/255; stop (excluding the terminator) once the running
  log-transmittance sum_i log1p(-alpha_i) would fall to log(1e-4).

sigma is evaluated in the tile-local expanded form of the JAX kernel:
Q = 6 per-gaussian coefficients, sigma = Q . [x², y², xy, x, y, 1] at
tile-local pixel centres (+0.5). The sum is written out in one fixed
order of separately rounded products and adds; the CUDA kernel uses the
same order with `__fmul_rn`/`__fadd_rn`, so on the card both compute the
same sigma bit for bit and the 1/255 and sigma >= 0 cut-offs fall alike.
"""

from __future__ import annotations

import torch

CHUNK = 128          # intersections per chunk (the slab's window width)
NUM_GEOM = 6         # geometry rows: mx, my, cA, cB, cC, opacity
MAX_CH = 8           # colour rows: up to 7 channels + depth
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
LOG_T_EPS = -9.210340371976182  # log(1e-4)


def round8(x: int) -> int:
    """x rounded up to a multiple of 8 (the slab's row count for x rows)."""
    return ((x + 7) // 8) * 8


def pixel_features(tile_size: int, device) -> torch.Tensor:
    """[6, PIX] tile-local pixel monomials x², y², xy, x, y, 1 (x, y at
    pixel centres); every entry is exact in f32."""
    p = torch.arange(tile_size * tile_size, device=device)
    x = (p % tile_size).to(torch.float32) + 0.5
    y = (p // tile_size).to(torch.float32) + 0.5
    return torch.stack([x * x, y * y, x * y, x, y, torch.ones_like(x)])


def conic_coefficients(geom: torch.Tensor, origin_x: torch.Tensor,
                       origin_y: torch.Tensor) -> torch.Tensor:
    """[6, ..., n] Q rows from geom [6, ..., n] (mx, my, cA, cB, cC, op)
    and tile origins broadcastable to [..., n]."""
    mxl = geom[0] - origin_x
    myl = geom[1] - origin_y
    cA, cB, cC = geom[2], geom[3], geom[4]
    return torch.stack([
        0.5 * cA,
        0.5 * cC,
        cB,
        -(cA * mxl + cB * myl),
        -(cC * myl + cB * mxl),
        0.5 * (cA * mxl * mxl + cC * myl * myl) + cB * mxl * myl,
    ])


def sigma(Q: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Q [6, A, n], F [6, PIX] -> sigma [A, PIX, n], summed left to right."""
    s = F[0][None, :, None] * Q[0][:, None, :]
    for k in range(1, 6):
        s = s + F[k][None, :, None] * Q[k][:, None, :]
    return s


def _chunk_common(slab, origin_x, origin_y, F, lane_lo, lane_hi, log_t_all):
    """The per-chunk quantities the forward and the backward share
    (`_chunk_common` of the JAX package), each [A, PIX, CHUNK]."""
    Q = conic_coefficients(slab[:NUM_GEOM], origin_x[:, None], origin_y[:, None])
    S = sigma(Q, F)
    E = torch.exp(-S)
    raw = slab[5][:, None, :] * E
    lane = torch.arange(slab.shape[-1], device=slab.device)
    in_range = (lane[None, :] >= lane_lo[:, None]) & (lane[None, :] < lane_hi[:, None])
    contrib = (S >= 0.0) & (raw >= ALPHA_MIN) & in_range[:, None, :]
    alpha = torch.clamp(raw, max=ALPHA_MAX) * contrib
    L = torch.log1p(-alpha)
    incl = torch.cumsum(L, dim=-1) + log_t_all[..., None]
    mask = (incl > LOG_T_EPS).to(L.dtype)
    T = torch.exp(incl - L)
    w = alpha * T * mask
    return dict(E=E, raw=raw, in_range=in_range, contrib=contrib, alpha=alpha,
                L=L, incl=incl, mask=mask, T=T, w=w)


def forward_chunk(slab, origin_x, origin_y, F, lane_lo, lane_hi,
                  log_t_all, log_t_out, rgb, stats=None):
    """Blend one CHUNK of intersections into A tiles' accumulators.

    slab [6 + c, A, CHUNK]; origin_x/y, lane_lo/lane_hi [A]: lanes
    outside [lo, hi) belong to adjacent tiles and are no-ops.
    log_t_all / log_t_out [A, PIX], rgb [A, c, PIX]. Returns the new
    (log_t_all, log_t_out, rgb). If `stats` is a dict, stats["pair_evals"]
    is incremented by the (pixel, intersection) pairs a front-to-back
    loop with early exit must evaluate, stats["pair_support"] by those of
    them whose alpha reaches 1/255 (the rest lie outside the splat's
    support, which a kernel can bound without evaluating them),
    stats["pair_blends"] by those that are composited, stats["pair_clamped"]
    by those composited at alpha clamped to ALPHA_MAX, and
    stats["pairs_read"] by the intersections each tile must read: those up
    to the furthest one any of its pixels evaluates (summed over chunks,
    each tile's furthest needed index less its start, plus one).
    """
    c = _chunk_common(slab, origin_x, origin_y, F, lane_lo, lane_hi, log_t_all)
    L, incl, mask, in_range = c["L"], c["incl"], c["mask"], c["in_range"]
    contrib, w = c["contrib"], c["w"]
    lane = torch.arange(slab.shape[-1], device=slab.device)
    rgb = rgb + torch.einsum("can,apn->acp", slab[NUM_GEOM:], w)
    if stats is not None:
        live_before = ((incl - L) > LOG_T_EPS) & in_range[:, None, :]
        stats["pair_evals"] = stats.get("pair_evals", 0) + int(live_before.sum())
        support = int((live_before & contrib).sum())
        stats["pair_support"] = stats.get("pair_support", 0) + support
        blended = int((contrib & (mask > 0)).sum())
        stats["pair_blends"] = stats.get("pair_blends", 0) + blended
        clamped = int((contrib & (mask > 0) & (c["raw"] > ALPHA_MAX)).sum())
        stats["pair_clamped"] = stats.get("pair_clamped", 0) + clamped
        # a pixel that evaluates a lane evaluates every in-range lane before
        # it, so a tile reads its lanes from lo up to its last evaluated one
        last = torch.where(live_before.any(dim=1), lane, -1).amax(dim=-1)
        read = torch.clamp(last + 1 - torch.clamp(lane_lo, min=0), min=0)
        stats["pairs_read"] = stats.get("pairs_read", 0) + int(read.sum())
    return (log_t_all + L.sum(-1), log_t_out + (L * mask).sum(-1), rgb)


def backward_chunk(slab, origin_x, origin_y, F, lane_lo, lane_hi, g_rgb, g_t,
                   t_final, total_dot, log_t_all, wg_cum):
    """Replay one CHUNK of A tiles front to back; per-intersection gradients.

    slab, origin_x/y, F, lane_lo/hi as in `forward_chunk`; g_rgb [A, c,
    PIX] and g_t [A, PIX] are the cotangents of the forward's rgb and
    t_final; t_final [A, PIX]; total_dot [A, PIX] = sum_ch g_rgb * rgb
    (the forward's colour). Carries log_t_all (over every alpha-passing
    intersection, as the forward) and wg_cum (inclusive sum of w * gdot),
    both [A, PIX].

    Returns (g_slab [6 + c, A, CHUNK] with rows g_mx, g_my, g_cA, g_cB,
    g_cC, g_opac, g_colours; log_t_all; wg_cum). Lanes outside [lo, hi)
    get exact zeros.
    """
    c = _chunk_common(slab, origin_x, origin_y, F, lane_lo, lane_hi, log_t_all)
    alpha, mask, T, w = c["alpha"], c["mask"], c["T"], c["w"]
    col = slab[NUM_GEOM:]
    gdot = torch.einsum("acp,can->apn", g_rgb, col)      # sum_ch g_rgb * col
    wg = w * gdot
    incl_wg = torch.cumsum(wg, dim=-1) + wg_cum[..., None]
    suffix = total_dot[..., None] - incl_wg   # w * gdot of the later composited ones
    one_m = 1.0 - alpha
    ga = (T * gdot - suffix / one_m - (g_t * t_final)[..., None] / one_m) \
        * mask * c["contrib"]
    notclamp = (c["raw"] <= ALPHA_MAX).to(alpha.dtype)
    g_sigma = -alpha * ga * notclamp                     # [A, PIX, CHUNK]
    g_opac = (c["E"] * ga * notclamp).sum(dim=1)         # [A, CHUNK]
    M = torch.einsum("kp,apn->kan", F, g_sigma)          # the six pixel moments
    m_xx, m_yy, m_xy, m_x, m_y, m_0 = M
    mxl = slab[0] - origin_x[:, None]
    myl = slab[1] - origin_y[:, None]
    cA, cB, cC = slab[2], slab[3], slab[4]
    dx_sum = m_x - mxl * m_0                             # sum_p g_sigma * (x - mx)
    dy_sum = m_y - myl * m_0
    g_cA = 0.5 * (m_xx - 2.0 * mxl * m_x + mxl * mxl * m_0)
    g_cB = m_xy - mxl * m_y - myl * m_x + mxl * myl * m_0
    g_cC = 0.5 * (m_yy - 2.0 * myl * m_y + myl * myl * m_0)
    g_mx = -(cA * dx_sum + cB * dy_sum)
    g_my = -(cC * dy_sum + cB * dx_sum)
    g_col = torch.einsum("acp,apn->can", g_rgb, w)
    g_slab = torch.cat([torch.stack([g_mx, g_my, g_cA, g_cB, g_cC, g_opac]), g_col])
    return g_slab, log_t_all + c["L"].sum(-1), wg_cum + wg.sum(-1)
