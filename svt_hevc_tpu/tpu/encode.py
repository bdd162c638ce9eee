"""Device encode pass: the EncDec hot loop as batched jitted device stages.

This is the data-parallel redesign of the reference's EncDec process
(EbEncDecProcess.c EncDecKernel :2630 -> EbCodingLoop.c EncodePass :2989):
instead of a per-LCU sequential loop, every pixel-domain stage runs
densely over the whole picture:

  - ``luma_phase_planes`` / ``chroma_phase_planes``: the reference
    interpolates subpel windows per PU on demand (EbMcp.c :99-804); here
    the reference picture is interpolated ONCE at every fractional phase
    (16 luma, 64 chroma), so motion compensation for any MV becomes a
    pure block gather.
  - ``dense_md_p``: dense mode decision (the FULL85 densification,
    EbProductCodingLoop.c ModeDecisionLcu :4691 /
    GetEightHorizontalSearchPointResultsAll85PUs EbMotionEstimation.c
    :156): integer SAD stacks around HME centers for all 8x8 blocks,
    summed bottom-up to 16/32/64 (valid because blocks share their
    parent's search center), then staged half/quarter-pel refinement per
    CU size — every step a full-plane vectorized pass, no per-block
    loops.
  - ``encode_pass_p``: given the decided CU tree + MV field, one jitted
    graph computes motion-compensated prediction (block gather from the
    phase planes), residuals, forward transform + quantization +
    dequantization + inverse transform densely at every TU size, selects
    the decided size per block, and reconstructs. Integer-exact int32
    arithmetic reproduces the host/decoder bit-for-bit.

Sequential logic (CU-tree syntax, merge/AMVP legalization, CABAC) stays
on the host — see pipeline/fast_path.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.inter import CHROMA_FILTERS, LUMA_FILTERS
from ..core.quant import INV_QUANT_SCALES, QUANT_SCALES
from ..core.transforms import DCT

# full-pel MV headroom on each side of the coded picture; decided MVs are
# clamped to +/-(PAD-8) full-pel so every interpolation window stays
# inside the extended planes (the reference pads reference pictures the
# same way, EbMcp.c GeneratePadding :1017)
PAD = 64

_LUMA_F = np.stack([np.asarray(LUMA_FILTERS[p], np.int32) for p in range(4)])
_CHROMA_F = np.stack([np.asarray(CHROMA_FILTERS[p], np.int32)
                      for p in range(8)])


def _edge_pad(p: jnp.ndarray, n: int) -> jnp.ndarray:
    return jnp.pad(p, n, mode="edge")


@functools.partial(jax.jit, static_argnames=("bit_depth",))
def luma_phase_planes(ref: jnp.ndarray, bit_depth: int = 8) -> jnp.ndarray:
    """All 16 quarter-pel interpolations of a luma plane, 14-bit domain.

    ref: (H, W) int32 coded-dims reconstruction. Returns
    (4, 4, H+2*PAD, W+2*PAD) int32 indexed [fy][fx]; entry [0][0] is the
    integer plane shifted to the 14-bit domain. Bit-exact with
    core.inter.interp_luma_raw for every phase (the generic two-pass
    filter reduces exactly to the reference's single-pass forms because
    the phase-0 tap row is 64*identity and the shift pairs compose
    losslessly)."""
    shift1 = bit_depth - 8
    ext = _edge_pad(ref.astype(jnp.int32), PAD + 4)      # taps need 3/4
    hp, wp = ref.shape[0] + 2 * PAD, ref.shape[1] + 2 * PAD
    filt = jnp.asarray(_LUMA_F)

    # horizontal pass: hx[fx][y, x] over the PAD-extended grid
    def hpass(fx):
        acc = jnp.zeros((hp + 8, wp), jnp.int32)
        for k in range(8):
            acc = acc + filt[fx, k] * jax.lax.dynamic_slice(
                ext, (0, 1 + k), (hp + 8, wp))
        return acc >> shift1

    hx = jnp.stack([hpass(fx) for fx in range(4)])       # (4, hp+8, wp)

    def vpass(fy):
        def one(h):
            acc = jnp.zeros((hp, wp), jnp.int32)
            for k in range(8):
                acc = acc + filt[fy, k] * jax.lax.dynamic_slice(
                    h, (1 + k, 0), (hp, wp))
            return acc >> 6
        return jax.vmap(one)(hx)                          # (4, hp, wp)

    return jnp.stack([vpass(fy) for fy in range(4)])      # (4, 4, hp, wp)


@functools.partial(jax.jit, static_argnames=("bit_depth",))
def chroma_phase_planes(ref: jnp.ndarray, bit_depth: int = 8) -> jnp.ndarray:
    """All 64 eighth-pel interpolations of a chroma plane (4:2:0), 14-bit
    domain: (8, 8, Hc+PAD, Wc+PAD) int32 indexed [fy][fx]. Chroma pad is
    PAD/2 (chroma MV offset is mv>>3 of a quarter-luma-pel MV)."""
    shift1 = bit_depth - 8
    padc = PAD // 2
    ext = _edge_pad(ref.astype(jnp.int32), padc + 2)     # taps need 1/2
    hp, wp = ref.shape[0] + 2 * padc, ref.shape[1] + 2 * padc
    filt = jnp.asarray(_CHROMA_F)

    def hpass(fx):
        acc = jnp.zeros((hp + 4, wp), jnp.int32)
        for k in range(4):
            acc = acc + filt[fx, k] * jax.lax.dynamic_slice(
                ext, (0, 1 + k), (hp + 4, wp))
        return acc >> shift1

    hx = jnp.stack([hpass(fx) for fx in range(8)])

    def vpass(fy):
        def one(h):
            acc = jnp.zeros((hp, wp), jnp.int32)
            for k in range(4):
                acc = acc + filt[fy, k] * jax.lax.dynamic_slice(
                    h, (1 + k, 0), (hp, wp))
            return acc >> 6
        return jax.vmap(one)(hx)

    return jnp.stack([vpass(fy) for fy in range(8)])


# --------------------------------------------------------------- MC gather

def _gather_blocks(planes: jnp.ndarray, ph: jnp.ndarray, sy: jnp.ndarray,
                   sx: jnp.ndarray, n: int, h: int, w: int) -> jnp.ndarray:
    """Gather (n, n) blocks from a (P, Hp, Wp) phase-plane stack into an
    (h, w) plane. ph/sy/sx: per-block phase index and top-left coords in
    the padded planes, shape (h//n, w//n)."""
    a = jnp.arange(n)
    out = planes[ph[:, :, None, None],
                 sy[:, :, None, None] + a[None, None, :, None],
                 sx[:, :, None, None] + a[None, None, None, :]]
    return out.transpose(0, 2, 1, 3).reshape(h, w)


def mc_pred_luma(raw: jnp.ndarray, mv8: jnp.ndarray,
                 bit_depth: int = 8) -> jnp.ndarray:
    """Uni-pred luma plane from the (4, 4, Hp, Wp) raw phase stack and a
    per-8x8-block quarter-pel MV field (nby, nbx, 2) [mvx, mvy]."""
    hp, wp = raw.shape[2], raw.shape[3]
    h, w = hp - 2 * PAD, wp - 2 * PAD
    nby, nbx = h // 8, w // 8
    mvx, mvy = mv8[..., 0], mv8[..., 1]
    ph = (mvy & 3) * 4 + (mvx & 3)
    by = jnp.arange(nby) * 8
    bx = jnp.arange(nbx) * 8
    sy = by[:, None] + (mvy >> 2) + PAD
    sx = bx[None, :] + (mvx >> 2) + PAD
    got = _gather_blocks(raw.reshape(16, hp, wp), ph, sy, sx, 8, h, w)
    shift = 14 - bit_depth
    return jnp.clip((got + (1 << (shift - 1))) >> shift,
                    0, (1 << bit_depth) - 1)


def mc_pred_chroma(raw: jnp.ndarray, mv8: jnp.ndarray,
                   bit_depth: int = 8) -> jnp.ndarray:
    """Uni-pred chroma plane (4:2:0): per-8x8-luma-block MV -> per-4x4
    chroma block gather from the (8, 8, Hcp, Wcp) raw stack."""
    hp, wp = raw.shape[2], raw.shape[3]
    padc = PAD // 2
    h, w = hp - 2 * padc, wp - 2 * padc
    nby, nbx = h // 4, w // 4
    mvx, mvy = mv8[..., 0], mv8[..., 1]
    ph = (mvy & 7) * 8 + (mvx & 7)
    by = jnp.arange(nby) * 4
    bx = jnp.arange(nbx) * 4
    sy = by[:, None] + (mvy >> 3) + padc
    sx = bx[None, :] + (mvx >> 3) + padc
    got = _gather_blocks(raw.reshape(64, hp, wp), ph, sy, sx, 4, h, w)
    shift = 14 - bit_depth
    return jnp.clip((got + (1 << (shift - 1))) >> shift,
                    0, (1 << bit_depth) - 1)


# ----------------------------------------------------- direct per-block MC
#
# Memory-lean motion compensation: instead of materializing every
# fractional interpolation of the reference up front (16 luma + 64
# chroma full planes, ~0.5 GB at 1080p, held across the whole fused
# graph), gather one (n+taps-1)^2 integer-pel window per block and apply
# the two separable spec filters per block with accumulation loops.
# Bit-exact with the phase-plane path (tests/test_tpu_encode.py): the
# shift pairing (H >> (bit_depth-8), V >> 6) is applied in the same
# order on the same integers. The reference interpolates per-PU windows
# on demand exactly like this (EbMcp.c :99-804).

def _win_gather(ext: jnp.ndarray, by, bx, m: int) -> jnp.ndarray:
    """(gy, gx, m, m) windows from plane `ext`; by/bx: (gy, gx) top-left
    coords of each window (already in ext coordinates)."""
    a = jnp.arange(m)
    return ext[by[:, :, None, None] + a[None, None, :, None],
               bx[:, :, None, None] + a[None, None, None, :]]


def _mc_raw_luma_direct(ref_ext: jnp.ndarray, mv8: jnp.ndarray,
                        bit_depth: int = 8) -> jnp.ndarray:
    """Luma MC in the 14-bit intermediate domain from an edge-padded
    (PAD+4 each side) integer reference; mv8: (nby, nbx, 2) quarter-pel
    MVs per 8x8 block. Returns the (h, w) unrounded intermediate."""
    shift1 = bit_depth - 8
    hp, wp = ref_ext.shape
    h, w = hp - 2 * (PAD + 4), wp - 2 * (PAD + 4)
    nby, nbx = h // 8, w // 8
    mvx, mvy = mv8[..., 0], mv8[..., 1]
    fx, fy = mvx & 3, mvy & 3
    by = (jnp.arange(nby) * 8)[:, None] + (mvy >> 2) + PAD + 1
    bx = (jnp.arange(nbx) * 8)[None, :] + (mvx >> 2) + PAD + 1
    win = _win_gather(ref_ext, by, bx, 15)            # (nby, nbx, 15, 15)
    filt = jnp.asarray(_LUMA_F)
    fh = filt[fx]                                     # (nby, nbx, 8)
    fv = filt[fy]
    mid = jnp.zeros((nby, nbx, 15, 8), jnp.int32)
    for k in range(8):
        mid = mid + fh[..., k, None, None] * win[..., :, k:k + 8]
    mid = mid >> shift1
    out = jnp.zeros((nby, nbx, 8, 8), jnp.int32)
    for k in range(8):
        out = out + fv[..., k, None, None] * mid[..., k:k + 8, :]
    out = out >> 6
    return out.transpose(0, 2, 1, 3).reshape(h, w)


def _mc_pred_luma_direct(ref_ext: jnp.ndarray, mv8: jnp.ndarray,
                         bit_depth: int = 8) -> jnp.ndarray:
    """Rounded uni-pred luma plane (the direct-MC form of
    mc_pred_luma)."""
    got = _mc_raw_luma_direct(ref_ext, mv8, bit_depth)
    shift = 14 - bit_depth
    return jnp.clip((got + (1 << (shift - 1))) >> shift,
                    0, (1 << bit_depth) - 1)


def _mc_raw_chroma_direct(ref_c_ext: jnp.ndarray, mv8: jnp.ndarray,
                          bit_depth: int = 8) -> jnp.ndarray:
    """Chroma (4:2:0) MC in the 14-bit domain from an edge-padded
    (PAD//2+2 each side) chroma plane; mv8 is the per-8x8-LUMA-block MV
    map (chroma offset = mv >> 3 with 8 phases)."""
    shift1 = bit_depth - 8
    padc = PAD // 2
    hp, wp = ref_c_ext.shape
    h, w = hp - 2 * (padc + 2), wp - 2 * (padc + 2)
    nby, nbx = h // 4, w // 4
    mvx, mvy = mv8[..., 0], mv8[..., 1]
    fx, fy = mvx & 7, mvy & 7
    by = (jnp.arange(nby) * 4)[:, None] + (mvy >> 3) + padc + 1
    bx = (jnp.arange(nbx) * 4)[None, :] + (mvx >> 3) + padc + 1
    win = _win_gather(ref_c_ext, by, bx, 7)           # (nby, nbx, 7, 7)
    filt = jnp.asarray(_CHROMA_F)
    fh = filt[fx]
    fv = filt[fy]
    mid = jnp.zeros((nby, nbx, 7, 4), jnp.int32)
    for k in range(4):
        mid = mid + fh[..., k, None, None] * win[..., :, k:k + 4]
    mid = mid >> shift1
    out = jnp.zeros((nby, nbx, 4, 4), jnp.int32)
    for k in range(4):
        out = out + fv[..., k, None, None] * mid[..., k:k + 4, :]
    out = out >> 6
    return out.transpose(0, 2, 1, 3).reshape(h, w)


def _mc_pred_chroma_direct(ref_c_ext: jnp.ndarray, mv8: jnp.ndarray,
                           bit_depth: int = 8) -> jnp.ndarray:
    got = _mc_raw_chroma_direct(ref_c_ext, mv8, bit_depth)
    shift = 14 - bit_depth
    return jnp.clip((got + (1 << (shift - 1))) >> shift,
                    0, (1 << bit_depth) - 1)


def _ext_y(ref: jnp.ndarray) -> jnp.ndarray:
    """Edge-padded luma plane for direct MC (PAD+4 per side)."""
    return _edge_pad(ref.astype(jnp.int32), PAD + 4)


def _ext_c(ref_c: jnp.ndarray) -> jnp.ndarray:
    """Edge-padded chroma plane for direct MC (PAD//2+2 per side)."""
    return _edge_pad(ref_c.astype(jnp.int32), PAD // 2 + 2)


def _mc_luma(ref_ext: jnp.ndarray, mv8: jnp.ndarray, bit_depth: int,
             rounded: bool) -> jnp.ndarray:
    """Per-8x8-block luma MC from the (PAD+4)-padded integer reference.
    MVs are clamped to the padded reach: a gather clips out-of-range
    indices silently, so an unclamped MV would read the wrong samples."""
    lim = (PAD - 9) * 4
    mv8 = jnp.clip(mv8, -lim, lim)
    fn = _mc_pred_luma_direct if rounded else _mc_raw_luma_direct
    return fn(ref_ext, mv8, bit_depth)


def _mc_chroma(ref_c_ext: jnp.ndarray, mv8: jnp.ndarray, bit_depth: int,
               rounded: bool) -> jnp.ndarray:
    """Per-4x4-block chroma MC (4:2:0) from the (PAD//2+2)-padded
    integer chroma plane."""
    lim = (PAD - 9) * 4
    mv8 = jnp.clip(mv8, -lim, lim)
    fn = _mc_pred_chroma_direct if rounded else _mc_raw_chroma_direct
    return fn(ref_c_ext, mv8, bit_depth)


# ------------------------------------------------------------ dense T/Q/IQ/IT

def _blocks(plane: jnp.ndarray, n: int) -> jnp.ndarray:
    h, w = plane.shape
    return (plane.reshape(h // n, n, w // n, n)
            .transpose(0, 2, 1, 3).reshape(-1, n, n))


def _unblocks(b: jnp.ndarray, n: int, h: int, w: int) -> jnp.ndarray:
    return (b.reshape(h // n, w // n, n, n)
            .transpose(0, 2, 1, 3).reshape(h, w))


def _tu_zero_rd(bb, lv, r, lam):
    """Per-TU RD zero-out: kill a TU's coefficients when coding them buys
    less SSE than lambda * (estimated coefficient bits). The encoder-side
    analogue of the reference's CBF escape / PM masking quantizer
    (EbTransforms.c PerformTwoStagePm :2219, CBF full-loop escape
    EbEncDecProcess.c:2156): purely an encoder decision — the decoder
    just sees cbf=0. bb/lv/r: (B, n, n) residual / levels / recon
    residual; lam: traced float32 SSE-domain lambda. Returns masked
    (lv, r).

    The rate model counts the dominant scan overhead, not just the
    values: per nonzero 4x4 coefficient group ~7 bits (group flag + the
    16 significance bins), ~2 bits + 2*bit_length per nonzero level, and
    ~12 bits of cbf/last-position fixed cost — calibrated against the
    real CABAC output of typical P residual (scattered small levels in
    large TUs cost far more in significance scanning than in values)."""
    n = lv.shape[-1]
    d0 = jnp.sum(bb * bb, (-2, -1)).astype(jnp.float32)
    dr = bb - r
    d1 = jnp.sum(dr * dr, (-2, -1)).astype(jnp.float32)
    a = jnp.abs(lv)
    blen = (a[..., None] >= (1 << jnp.arange(15))).sum(-1)   # bit_length
    vbits = jnp.sum(jnp.where(a > 0, 2 + 2 * blen, 0),
                    (-2, -1)).astype(jnp.float32)
    if n >= 8:
        g = a.reshape(*a.shape[:-2], n // 4, 4, n // 4, 4).sum((-3, -1))
        ngroups = (g > 0).sum((-2, -1)).astype(jnp.float32)
    else:
        ngroups = (jnp.sum(a, (-2, -1)) > 0).astype(jnp.float32)
    bits = vbits + 7.0 * ngroups + 12.0
    keep = ((d0 - d1) >= lam * bits)[..., None, None]
    return jnp.where(keep, lv, 0), jnp.where(keep, r, 0)


def _tu_bits_est(lv):
    """Per-TU coefficient-bit estimate of a (B, n, n) levels batch (the
    _tu_zero_rd rate model)."""
    n = lv.shape[-1]
    a = jnp.abs(lv)
    blen = (a[..., None] >= (1 << jnp.arange(15))).sum(-1)
    vbits = jnp.sum(jnp.where(a > 0, 2 + 2 * blen, 0),
                    (-2, -1)).astype(jnp.float32)
    if n >= 8:
        g = a.reshape(*a.shape[:-2], n // 4, 4, n // 4, 4).sum((-3, -1))
        ngroups = (g > 0).sum((-2, -1)).astype(jnp.float32)
    else:
        ngroups = (jnp.sum(a, (-2, -1)) > 0).astype(jnp.float32)
    # ~12 bits per nonzero 4x4 group: the 16 significance bins plus the
    # group flag cost more than the _tu_zero_rd proxy's 7 when the group
    # exists only to carry isolated +-1 levels (the case this trial
    # targets); calibrated vs real CABAC output
    return vbits + 12.0 * ngroups


def _tu_rd_better(bb, lv, r, lv2, r2, lam):
    """True for TUs where the (lv2, r2) alternative wins D + lambda*R
    against (lv, r). Shapes (B, n, n); returns (B, 1, 1) bool."""
    d = bb - r
    d2 = bb - r2
    j = (jnp.sum(d * d, (-2, -1)).astype(jnp.float32)
         + lam * _tu_bits_est(lv))
    j2 = (jnp.sum(d2 * d2, (-2, -1)).astype(jnp.float32)
          + lam * _tu_bits_est(lv2))
    return (j2 < j)[..., None, None]


def dense_tq_size(resid: jnp.ndarray, n: int, qp, *, bit_depth: int = 8,
                  is_intra: bool = False, lam=None):
    """Forward DCT + quant + dequant + inverse DCT for EVERY aligned
    (n, n) block of a residual plane. qp: traced int32 scalar. Returns
    (levels plane int32, reconstructed-residual plane int32). Bit-exact
    with core.transforms/core.quant (HM-style shifts, int32-safe for
    8/10-bit). lam: optional SSE-domain lambda enabling the per-TU RD
    zero-out (_tu_zero_rd)."""
    h, w = resid.shape
    t = jnp.asarray(DCT[n].astype(np.int32))
    log2n = n.bit_length() - 1
    s1 = log2n + bit_depth - 9
    s2 = log2n + 6
    b = _blocks(resid.astype(jnp.int32), n)
    tmp = (jnp.einsum("byx,kx->byk", b, t) + (1 << (s1 - 1))) >> s1
    coef = (jnp.einsum("iy,byj->bij", t, tmp) + (1 << (s2 - 1))) >> s2

    # scalar quant (core.quant.quantize); qP includes QpBdOffset (8.6.3)
    qp = qp + 6 * (bit_depth - 8)
    qbits = 14 + qp // 6 + (15 - bit_depth - log2n)
    f = jnp.asarray(QUANT_SCALES.astype(np.int32))[qp % 6]
    off_num = 171 if is_intra else 85
    offset = off_num << (qbits - 9)
    lv = jnp.minimum((jnp.abs(coef) * f + offset) >> qbits, 32767)
    lv = jnp.sign(coef) * lv

    # dequant (core.quant.dequantize)
    dq_shift = log2n + bit_depth - 9      # 6 - transform_shift
    scale = jnp.asarray(INV_QUANT_SCALES.astype(np.int32))[qp % 6] << (qp // 6)

    def inv(levels):
        d = (levels * scale + (1 << (dq_shift - 1))) >> dq_shift
        d = jnp.clip(d, -32768, 32767)
        e = jnp.clip((jnp.einsum("ky,bkx->byx", t, d) + 64) >> 7,
                     -32768, 32767)
        bd_shift = 20 - bit_depth
        return jnp.clip((jnp.einsum("byk,kx->byx", e, t)
                         + (1 << (bd_shift - 1))) >> bd_shift,
                        -32768, 32767)

    r = inv(lv)
    if lam is not None:
        if not is_intra:
            # RDOQ-lite (reference analogue: the PM/RDOQ quantizer,
            # EbTransforms.c PerformTwoStagePm :2219): scattered +-1
            # levels dominate inter residual CABAC cost (each drags a
            # 4x4 group's significance scan); trial-decode the TU with
            # all ones killed and keep it when D + lambda*R improves.
            lv1 = jnp.where(jnp.abs(lv) <= 1, 0, lv)
            r1 = inv(lv1)
            keep1 = _tu_rd_better(b, lv, r, lv1, r1, lam)
            lv = jnp.where(keep1, lv1, lv)
            r = jnp.where(keep1, r1, r)
        lv, r = _tu_zero_rd(b, lv, r, lam)
    return (_unblocks(lv, n, h, w), _unblocks(r, n, h, w))


def _select_by_log2(maps: dict[int, jnp.ndarray], log2_map: jnp.ndarray,
                    gran: int) -> jnp.ndarray:
    """Per-pixel select between same-shaped planes keyed by TU log2 size.
    log2_map: per-(gran x gran)-block log2 values."""
    out = None
    for lg, plane in maps.items():
        m = jnp.repeat(jnp.repeat(log2_map == lg, gran, 0), gran, 1)
        out = jnp.where(m, plane, out) if out is not None else \
            jnp.where(m, plane, 0)
    return out


def _nz_map(lv: jnp.ndarray, n: int) -> jnp.ndarray:
    h, w = lv.shape
    return (jnp.abs(lv).reshape(h // n, n, w // n, n).sum((1, 3)) > 0)


def _pool_min(m, k: int):
    h, w = m.shape
    return m.reshape(h // k, k, w // k, k).min((1, 3))


def _pool_max(m, k: int):
    h, w = m.shape
    return m.reshape(h // k, k, w // k, k).max((1, 3))


def _plane_tu_bits(lv, n: int):
    """Per-(n, n)-TU coefficient-rate proxy over a levels plane: value
    bits + per-nonzero-4x4-group scan overhead + fixed cbf/last cost
    (same model as _tu_zero_rd)."""
    a = jnp.abs(lv)
    blen = (a[..., None] >= (1 << jnp.arange(15))).sum(-1)
    vb = jnp.where(a > 0, 3 + 2 * blen, 0)
    vbits = _boxsum(vb, n).astype(jnp.float32)
    g4 = (_boxsum(a, 4) > 0).astype(jnp.int32)
    groups = _boxsum(g4, n // 4).astype(jnp.float32)
    return vbits + 7.0 * groups + 12.0


def _tu_tree_dp(res_y, rr_s, lv_s, cu_log2_8, inter8, tu_cap8, lam):
    """Residual quadtree decision (the reference's RQT): per-8-block TU
    size in [max(cu-2, 3) .. min(cu, 5)] minimizing D + lambda*bits over
    the already-quantized per-size planes. Localized content stops
    paying full-TU significance scans (7.3.8.8 split_transform_flag)."""
    INF = jnp.float32(3e38)
    res_y = res_y.astype(jnp.int32)
    # depth budget: max_transform_hierarchy_depth_inter=2 counts the
    # forced 64->32 split, so a 64 CU bottoms out at TU16 (7.3.8.8) —
    # lo8 must be cu_log2-2 WITHOUT clamping cu_log2 to 5 first
    lo8 = jnp.maximum(cu_log2_8 - 2, 3)
    cost = {}
    for lg in (3, 4, 5):
        n = 1 << lg
        k = n // 8
        e = res_y - rr_s[lg].astype(jnp.int32)
        d1 = _boxsum(e * e, n).astype(jnp.float32)
        rd = d1 + lam * (_plane_tu_bits(lv_s[lg], n) + 2.0)
        valid = (_pool_min(tu_cap8, k) >= lg) & (_pool_max(lo8, k) <= lg)
        cost[lg] = jnp.where(valid, rd, INF)

    best = cost[3]
    split = {}
    for lg in (4, 5):
        agg = _boxsum(best, 2) + lam * 1.0
        split[lg] = agg < cost[lg]
        best = jnp.where(split[lg], agg, cost[lg])

    nby, nbx = tu_cap8.shape
    tu8 = jnp.full((nby, nbx), 3, jnp.int32)
    undecided = jnp.ones((nby, nbx), bool)

    def rep(m, k):
        return jnp.repeat(jnp.repeat(m, k, 0), k, 1)

    for lg in (5, 4):
        leaf = undecided & ~rep(split[lg], 1 << (lg - 3))
        tu8 = jnp.where(leaf, lg, tu8)
        undecided = undecided & ~leaf
    # intra blocks keep TU == min(CU, 32) (the wavefront's structure)
    return jnp.where(inter8, tu8, tu_cap8)


def _mc_gather_raw_luma(raw: jnp.ndarray, mv8: jnp.ndarray) -> jnp.ndarray:
    """Luma MC gather in the 14-bit intermediate domain (no rounding) —
    the bi-prediction input form (8.5.4.2.3.2 averages the intermediates,
    core.inter.interp_luma_raw)."""
    hp, wp = raw.shape[2], raw.shape[3]
    h, w = hp - 2 * PAD, wp - 2 * PAD
    mvx, mvy = mv8[..., 0], mv8[..., 1]
    ph = (mvy & 3) * 4 + (mvx & 3)
    by = jnp.arange(h // 8) * 8
    bx = jnp.arange(w // 8) * 8
    sy = by[:, None] + (mvy >> 2) + PAD
    sx = bx[None, :] + (mvx >> 2) + PAD
    return _gather_blocks(raw.reshape(16, hp, wp), ph, sy, sx, 8, h, w)


def _mc_gather_raw_chroma(raw: jnp.ndarray, mv8: jnp.ndarray) -> jnp.ndarray:
    hp, wp = raw.shape[2], raw.shape[3]
    padc = PAD // 2
    h, w = hp - 2 * padc, wp - 2 * padc
    mvx, mvy = mv8[..., 0], mv8[..., 1]
    ph = (mvy & 7) * 8 + (mvx & 7)
    by = jnp.arange(h // 4) * 4
    bx = jnp.arange(w // 4) * 4
    sy = by[:, None] + (mvy >> 3) + padc
    sx = bx[None, :] + (mvx >> 3) + padc
    return _gather_blocks(raw.reshape(64, hp, wp), ph, sy, sx, 4, h, w)


def _bi_select(a, b, use0, use1, k: int, bit_depth: int):
    """Per-block uni/bi combine of two 14-bit MC gathers: uni rounds one
    intermediate (8.5.4.2.3.1), bi averages both (8.5.4.2.3.2). use0/use1:
    (nby, nbx) bool at 8x8-luma granularity; k: pixels per map cell in
    this plane (8 luma, 4 chroma 4:2:0)."""
    maxval = (1 << bit_depth) - 1
    s_u = 14 - bit_depth
    s_b = 15 - bit_depth
    uni0 = (a + (1 << (s_u - 1))) >> s_u
    uni1 = (b + (1 << (s_u - 1))) >> s_u
    bi = (a + b + (1 << (s_b - 1))) >> s_b
    m0 = jnp.repeat(jnp.repeat(use0, k, 0), k, 1)
    m1 = jnp.repeat(jnp.repeat(use1, k, 0), k, 1)
    out = jnp.where(m0 & m1, bi, jnp.where(m1, uni1, uni0))
    return jnp.clip(out, 0, maxval)


def mc_pred_b(raws0, raws1, mv8_2l, use0, use1, bit_depth: int = 8):
    """B-picture MC prediction of all three planes: per-8x8-block
    uni-L0 / uni-L1 / bi selection. raws0/raws1: (raw_y, raw_cb, raw_cr)
    phase stacks of each list's reference; mv8_2l: (2, nby, nbx, 2)."""
    a_y = _mc_gather_raw_luma(raws0[0], mv8_2l[0])
    b_y = _mc_gather_raw_luma(raws1[0], mv8_2l[1])
    a_cb = _mc_gather_raw_chroma(raws0[1], mv8_2l[0])
    b_cb = _mc_gather_raw_chroma(raws1[1], mv8_2l[1])
    a_cr = _mc_gather_raw_chroma(raws0[2], mv8_2l[0])
    b_cr = _mc_gather_raw_chroma(raws1[2], mv8_2l[1])
    return (_bi_select(a_y, b_y, use0, use1, 8, bit_depth),
            _bi_select(a_cb, b_cb, use0, use1, 4, bit_depth),
            _bi_select(a_cr, b_cr, use0, use1, 4, bit_depth))


@functools.partial(jax.jit, static_argnames=("bit_depth", "tu_split"))
def encode_pass_p(src_y, src_cb, src_cr, raw_y, raw_cb, raw_cr,
                  mv8, inter8, tu_log2_8, qp, qp_c, bit_depth: int = 8,
                  lam=None, tu_split: bool = False, cu_log2_8=None):
    """The normative inter encode pass for one P picture, fully batched.

    src_*: coded-dims int32 source planes. raw_*: phase-plane stacks of
    the (single) L0 reference. mv8: (nby, nbx, 2) quarter-pel MV per 8x8
    block. inter8: bool map (intra blocks get zero residual here; the
    host wavefront walk reconstructs them). tu_log2_8: luma TU log2 per
    8x8 block (3..5 = min(CU size, 32)).

    Returns dict of int16/uint16 planes: lv_y/lv_cb/lv_cr (quantized
    levels, decided TU size), rec_y/rec_cb/rec_cr (reconstruction),
    nz8_y / nz4_cb / nz4_cr (per-TU-granule nonzero flags).
    """
    pred_y = mc_pred_luma(raw_y, mv8, bit_depth)
    pred_cb = mc_pred_chroma(raw_cb, mv8, bit_depth)
    pred_cr = mc_pred_chroma(raw_cr, mv8, bit_depth)
    return _encode_pass_core(src_y, src_cb, src_cr, pred_y, pred_cb,
                             pred_cr, inter8, tu_log2_8, qp, qp_c,
                             bit_depth, lam, tu_split, cu_log2_8)


def encode_pass_p_direct(src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr,
                         mv8, inter8, tu_log2_8, qp, qp_c,
                         bit_depth: int = 8, lam=None,
                         tu_split: bool = False, cu_log2_8=None):
    """encode_pass_p computing MC directly from the reference planes
    (per-block window gather + spec filters) instead of phase-plane
    stacks — bit-identical output, ~0.5 GB less live device memory at
    1080p."""
    pred_y = _mc_luma(_ext_y(ref_y), mv8, bit_depth, True)
    pred_cb = _mc_chroma(_ext_c(ref_cb), mv8, bit_depth, True)
    pred_cr = _mc_chroma(_ext_c(ref_cr), mv8, bit_depth, True)
    return _encode_pass_core(src_y, src_cb, src_cr, pred_y, pred_cb,
                             pred_cr, inter8, tu_log2_8, qp, qp_c,
                             bit_depth, lam, tu_split, cu_log2_8)


def mc_pred_b_direct(ref0_3, ref1_3, mv8_2l, use0, use1,
                     bit_depth: int = 8):
    """B-picture MC prediction of all three planes by direct per-block
    filtering (the memory-lean form of mc_pred_b; two phase-plane stacks
    at 1080p held >1 GB). ref0_3/ref1_3: (y, cb, cr) integer reference
    planes per list."""
    a_y = _mc_luma(_ext_y(ref0_3[0]), mv8_2l[0], bit_depth, False)
    b_y = _mc_luma(_ext_y(ref1_3[0]), mv8_2l[1], bit_depth, False)
    a_cb = _mc_chroma(_ext_c(ref0_3[1]), mv8_2l[0], bit_depth, False)
    b_cb = _mc_chroma(_ext_c(ref1_3[1]), mv8_2l[1], bit_depth, False)
    a_cr = _mc_chroma(_ext_c(ref0_3[2]), mv8_2l[0], bit_depth, False)
    b_cr = _mc_chroma(_ext_c(ref1_3[2]), mv8_2l[1], bit_depth, False)
    return (_bi_select(a_y, b_y, use0, use1, 8, bit_depth),
            _bi_select(a_cb, b_cb, use0, use1, 4, bit_depth),
            _bi_select(a_cr, b_cr, use0, use1, 4, bit_depth))


def encode_pass_b_direct(src_y, src_cb, src_cr, ref0_3, ref1_3, mv8_2l,
                         ref8_2l, tu_log2_8, qp, qp_c, bit_depth: int = 8,
                         lam=None, tu_split: bool = False, cu_log2_8=None):
    """encode_pass_b with direct per-block MC from the reference planes."""
    use0 = ref8_2l[0] >= 0
    use1 = ref8_2l[1] >= 0
    inter8 = use0 | use1
    pred_y, pred_cb, pred_cr = mc_pred_b_direct(ref0_3, ref1_3, mv8_2l,
                                                use0, use1, bit_depth)
    return _encode_pass_core(src_y, src_cb, src_cr, pred_y, pred_cb,
                             pred_cr, inter8, tu_log2_8, qp, qp_c,
                             bit_depth, lam, tu_split, cu_log2_8)


def _encode_pass_core(src_y, src_cb, src_cr, pred_y, pred_cb, pred_cr,
                      inter8, tu_log2_8, qp, qp_c, bit_depth: int,
                      lam, tu_split: bool, cu_log2_8):
    """Residual -> dense T/Q/IQ/IT at every TU size -> RQT DP ->
    reconstruction, shared by the P and B encode passes."""
    maxval = (1 << bit_depth) - 1
    m8 = inter8.astype(jnp.int32)
    mask_y = jnp.repeat(jnp.repeat(m8, 8, 0), 8, 1)
    mask_c = jnp.repeat(jnp.repeat(m8, 4, 0), 4, 1)
    res_y = (src_y - pred_y) * mask_y
    res_cb = (src_cb - pred_cb) * mask_c
    res_cr = (src_cr - pred_cr) * mask_c

    lv_y_s, rr_y_s = {}, {}
    for lg in (3, 4, 5):
        lv, rr = dense_tq_size(res_y, 1 << lg, qp, bit_depth=bit_depth,
                               lam=lam)
        lv_y_s[lg], rr_y_s[lg] = lv, rr
    if tu_split and lam is not None and cu_log2_8 is not None:
        tu_log2_8 = _tu_tree_dp(res_y, rr_y_s, lv_y_s, cu_log2_8, inter8,
                                tu_log2_8, lam)
    lv_y = _select_by_log2(lv_y_s, tu_log2_8, 8)
    rr_y = _select_by_log2(rr_y_s, tu_log2_8, 8)

    # chroma TU log2 = luma TU log2 - 1, clamped to [2, 4] (4:2:0: an
    # 8-node -> one 4x4 chroma TB; CU64 -> four 32-luma nodes -> 16)
    ctu_log2_8 = jnp.clip(tu_log2_8 - 1, 2, 4)
    # chroma granularity: the luma 8x8 block maps to a 4x4 chroma block
    lv_cb_s, rr_cb_s, lv_cr_s, rr_cr_s = {}, {}, {}, {}
    for lg in (2, 3, 4):
        lv, rr = dense_tq_size(res_cb, 1 << lg, qp_c, bit_depth=bit_depth,
                               lam=lam)
        lv_cb_s[lg], rr_cb_s[lg] = lv, rr
        lv, rr = dense_tq_size(res_cr, 1 << lg, qp_c, bit_depth=bit_depth,
                               lam=lam)
        lv_cr_s[lg], rr_cr_s[lg] = lv, rr
    lv_cb = _select_by_log2(lv_cb_s, ctu_log2_8, 4)
    rr_cb = _select_by_log2(rr_cb_s, ctu_log2_8, 4)
    lv_cr = _select_by_log2(lv_cr_s, ctu_log2_8, 4)
    rr_cr = _select_by_log2(rr_cr_s, ctu_log2_8, 4)

    rec_y = jnp.clip(pred_y + rr_y, 0, maxval)
    rec_cb = jnp.clip(pred_cb + rr_cb, 0, maxval)
    rec_cr = jnp.clip(pred_cr + rr_cr, 0, maxval)

    return {
        "lv_y": lv_y.astype(jnp.int16),
        "lv_cb": lv_cb.astype(jnp.int16),
        "lv_cr": lv_cr.astype(jnp.int16),
        "rec_y": rec_y.astype(jnp.uint16),
        "rec_cb": rec_cb.astype(jnp.uint16),
        "rec_cr": rec_cr.astype(jnp.uint16),
        "nz4_y": _nz_map(lv_y, 4).astype(jnp.uint8),
        "nz4_cb": _nz_map(lv_cb, 4).astype(jnp.uint8),
        "nz4_cr": _nz_map(lv_cr, 4).astype(jnp.uint8),
        "tu8": tu_log2_8.astype(jnp.int32),
    }


@functools.partial(jax.jit, static_argnames=("bit_depth", "tu_split"))
def encode_pass_b(src_y, src_cb, src_cr, raws0, raws1, mv8_2l,
                  ref8_2l, tu_log2_8, qp, qp_c, bit_depth: int = 8,
                  lam=None, tu_split: bool = False, cu_log2_8=None):
    """The inter encode pass for one B picture: per-8x8-block uni-L0 /
    uni-L1 / bi prediction (8.5.4.2.3), then the shared residual core.
    ref8_2l: (2, nby, nbx) int32 per-list ref idx (-1 = unused);
    intra blocks have both lists -1. Reference analogue: the encode
    pass's bi-pred MC (EbMcp.c BiPredAverageKernel family)."""
    use0 = ref8_2l[0] >= 0
    use1 = ref8_2l[1] >= 0
    inter8 = use0 | use1
    pred_y, pred_cb, pred_cr = mc_pred_b(raws0, raws1, mv8_2l, use0, use1,
                                         bit_depth)
    return _encode_pass_core(src_y, src_cb, src_cr, pred_y, pred_cb,
                             pred_cr, inter8, tu_log2_8, qp, qp_c,
                             bit_depth, lam, tu_split, cu_log2_8)


# ---------------------------------------------------------------- dense MD

def _boxsum(m: jnp.ndarray, k: int) -> jnp.ndarray:
    """(..., H, W) -> (..., H//k, W//k) block sums."""
    s = m.shape
    return m.reshape(*s[:-2], s[-2] // k, k, s[-1] // k, k).sum((-3, -1))


def _recenter8(ref_ext: jnp.ndarray, cy8: jnp.ndarray,
               cx8: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """Recentred integer reference: each 8x8 block displaced by its own
    full-pel center (cy8, cx8). ref_ext padded by PAD."""
    nby, nbx = h // 8, w // 8
    by = jnp.arange(nby) * 8
    bx = jnp.arange(nbx) * 8
    a = jnp.arange(8)
    sy = by[:, None] + cy8 + PAD
    sx = bx[None, :] + cx8 + PAD
    out = ref_ext[sy[:, :, None, None] + a[None, None, :, None],
                  sx[:, :, None, None] + a[None, None, None, :]]
    return out.transpose(0, 2, 1, 3).reshape(h, w)


def _sad_stack8(src: jnp.ndarray, rec: jnp.ndarray, r: int) -> jnp.ndarray:
    """SAD of every 8x8 block vs the recentred ref displaced by every
    (dy, dx) in [-r, r]^2: returns (2r+1, 2r+1, nby, nbx) int32.

    lax.scan over displacements rather than vmap: each step's full-plane
    |src - shift| intermediate is reused buffer-to-buffer instead of a
    (2r+1)^2-wide batch materializing in device memory, and the compiled
    body is
    emitted once instead of unrolled (compile time + code size)."""
    h, w = src.shape
    pad = jnp.pad(rec, r, mode="edge")
    disp = jnp.stack(jnp.meshgrid(jnp.arange(2 * r + 1),
                                  jnp.arange(2 * r + 1),
                                  indexing="ij"), -1).reshape(-1, 2)

    # chunk the scan (one row of displacements per step): per-step
    # dispatch overhead amortizes over 2r+1 SAD passes while the live
    # set stays one chunk wide
    def body(carry, drow):
        out = []
        for i in range(2 * r + 1):
            sh = jax.lax.dynamic_slice(pad, (drow[i, 0], drow[i, 1]),
                                       (h, w))
            out.append(_boxsum(jnp.abs(src - sh), 8))
        return carry, jnp.stack(out)

    _, s = jax.lax.scan(body, 0, disp.reshape(2 * r + 1, 2 * r + 1, 2))
    return s.reshape(2 * r + 1, 2 * r + 1, h // 8, w // 8)


def _subpel_pred8(raw16: jnp.ndarray, mvq8x: jnp.ndarray, mvq8y: jnp.ndarray,
                  h: int, w: int, bit_depth: int) -> jnp.ndarray:
    """Rounded prediction plane where every 8x8 block uses its own
    quarter-pel MV (raw16: (16, Hp, Wp) flat phase stack)."""
    nby, nbx = h // 8, w // 8
    ph = (mvq8y & 3) * 4 + (mvq8x & 3)
    by = jnp.arange(nby) * 8
    bx = jnp.arange(nbx) * 8
    sy = by[:, None] + (mvq8y >> 2) + PAD
    sx = bx[None, :] + (mvq8x >> 2) + PAD
    got = _gather_blocks(raw16, ph, sy, sx, 8, h, w)
    shift = 14 - bit_depth
    return jnp.clip((got + (1 << (shift - 1))) >> shift,
                    0, (1 << bit_depth) - 1)


_HALF_OFFS = ((-2, -2), (-2, 0), (-2, 2), (0, -2), (0, 2), (2, -2), (2, 0),
              (2, 2))
_QUARTER_OFFS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1),
                 (1, 0), (1, 1))


def _refine_subpel(src, raw16, mvqx, mvqy, best, k: int, bit_depth: int):
    """One 8-neighbor refinement stage at +/-`step` quarter-pel around the
    per-k-block best (mvqx, mvqy); SADs summed at k-granularity. Returns
    updated (mvqx, mvqy, best)."""
    h, w = src.shape

    def up(m):
        rep = k // 8
        return jnp.repeat(jnp.repeat(m, rep, 0), rep, 1)

    for offs in (_HALF_OFFS, _QUARTER_OFFS):
        cx, cy = mvqx, mvqy          # stage anchors: candidates sit around
        for oy, ox in offs:          # the previous stage's winner
            tx, ty = cx + ox, cy + oy
            pred = _subpel_pred8(raw16, up(tx), up(ty), h, w, bit_depth)
            sad = _boxsum(jnp.abs(src - pred), k)
            take = sad < best
            mvqx = jnp.where(take, tx, mvqx)
            mvqy = jnp.where(take, ty, mvqy)
            best = jnp.where(take, sad, best)
    return mvqx, mvqy, best


def _refine_subpel_dense(src, ref_ext, int_mvx, int_mvy, best, k: int,
                         bit_depth: int, lam_me=None, cqx=None, cqy=None):
    """Exhaustive +/-3 quarter-pel refinement around the per-k-block best
    INTEGER MV, without per-candidate gathers: recenter the reference once
    at the integer MVs (one gather), interpolate the 16 subpel phases of
    the recentred plane with convolutions, then every candidate offset is
    a STATIC slice of a phase plane — fused map-reduces.

    The interpolation of the recentred plane differs from true subpel MC
    only inside the 8-tap support of block boundaries; this is a search
    metric (the encode pass re-interpolates the winner exactly), matching
    the reference's approximate AVC-style subpel search filters
    (EbMotionEstimation.c EbHevcInterpolateSearchRegionAVC :645).

    Covers the same +/-3 qpel reach as the staged half->quarter search.
    Returns (mvqx, mvqy, best) with MVs in quarter-pel."""
    h, w = src.shape
    maxval = (1 << bit_depth) - 1
    rep = k // 8

    def up(m):
        return jnp.repeat(jnp.repeat(m, rep, 0), rep, 1)

    rec = _mc_luma(ref_ext, jnp.stack([up(int_mvx) * 4,
                                       up(int_mvy) * 4], -1),
                   bit_depth, True)
    raw = luma_phase_planes(rec, bit_depth=bit_depth)
    raw16 = raw.reshape(16, raw.shape[2], raw.shape[3])
    shift = 14 - bit_depth
    # candidate offsets as scan inputs (one compiled body instead of 48
    # unrolled full-plane passes); the ORDER matches the original nested
    # fy/fx loop so strict-< tie-breaking picks identical winners
    offs = np.asarray([(fy, fx) for fy in range(-3, 4)
                       for fx in range(-3, 4) if not (fy == 0 and fx == 0)],
                      np.int32)
    xs = {
        "plane": jnp.asarray((offs[:, 0] & 3) * 4 + (offs[:, 1] & 3)),
        "cy": jnp.asarray((offs[:, 0] >> 2) + PAD),
        "cx": jnp.asarray((offs[:, 1] >> 2) + PAD),
        "fy": jnp.asarray(offs[:, 0]),
        "fx": jnp.asarray(offs[:, 1]),
    }

    CH = 6                      # offsets per scan step (48 = 8 steps)
    xs = {kk: v.reshape(-1, CH) for kk, v in xs.items()}

    def body(carry, x):
        mvqx, mvqy, best = carry
        for i in range(CH):     # in-order: tie-breaking identical to
            plane = jax.lax.dynamic_slice(      # the unrolled original
                raw16, (x["plane"][i], x["cy"][i], x["cx"][i]),
                (1, h, w))[0]
            pred = jnp.clip((plane + (1 << (shift - 1))) >> shift,
                            0, maxval)
            sad = _boxsum(jnp.abs(src - pred), k)
            if lam_me is not None:
                # mv rate vs the search-center predictor proxy (same
                # model as best_of): a quarter-pel "improvement" must
                # beat its own MVD bits or it fragments the field
                sad = sad + lam_me * (
                    _mvd_bits_dev(int_mvx * 4 + x["fx"][i] - cqx)
                    + _mvd_bits_dev(int_mvy * 4 + x["fy"][i] - cqy))
            take = sad < best
            mvqx = jnp.where(take, int_mvx * 4 + x["fx"][i], mvqx)
            mvqy = jnp.where(take, int_mvy * 4 + x["fy"][i], mvqy)
            best = jnp.where(take, sad, best)
        return (mvqx, mvqy, best), None

    (mvqx, mvqy, best), _ = jax.lax.scan(
        body, (int_mvx * 4, int_mvy * 4, best), xs)
    return mvqx, mvqy, best


@functools.partial(jax.jit, static_argnames=("bit_depth", "subpel_min"))
def dense_md_p(src: jnp.ndarray, ref: jnp.ndarray, raw_y=None,
               hme_mv: jnp.ndarray = None, bit_depth: int = 8,
               qp=None, subpel_min: int = 16) -> dict:
    """Dense inter search for every CU size of a P picture.

    src/ref: (H, W) int32 coded planes (64-aligned). raw_y: unused
    (kept for call-compat; the search interpolates recentred planes
    itself). hme_mv: (H//16, W//16, 2) quarter-pel integer HME field.

    Strategy (the FULL85 densification): integer SAD stacks at 8x8
    granularity around shared per-16 and per-64 HME centers, bottom-up
    sums to each CU size, argmin -> per-size integer MV, then staged
    half/quarter refinement per size. Returns per-size quarter-pel MV
    maps + SAD maps, plus the zero-MV SAD per size (skip detection).
    """
    h, w = src.shape
    srcf = src.astype(jnp.int32)
    ref_ext = _ext_y(ref)
    lim = (PAD - 9) * 4
    # MV rate in the search loop (the reference's ME cost is
    # SAD + lambda * mv_bits vs the predictor, EbMotionEstimation.c
    # MV_COST): candidates pay their distance from the HME center, so
    # the search stops chasing noise matches that cost real MVD bits
    # and fragment the motion field (every fragment is a lost merge)
    lam_me = (jnp.int32(0) if qp is None
              else ME_LAMBDA_SCALE * jnp.asarray(LAMBDA_SAD)[qp])

    # per-16 full-pel centers from HME, clamped into the padded range
    c16x = jnp.clip(hme_mv[..., 0] >> 2, -(PAD - 12), PAD - 12)
    c16y = jnp.clip(hme_mv[..., 1] >> 2, -(PAD - 12), PAD - 12)

    def up2(m):
        return jnp.repeat(jnp.repeat(m, 2, 0), 2, 1)

    # ---- fine stack: per-16 centers, +/-2 int window; valid for 8 & 16
    rec_f = _mc_luma(ref_ext, jnp.stack([up2(c16x) * 4,
                                         up2(c16y) * 4], -1),
                     bit_depth, True)
    stack8 = _sad_stack8(srcf, rec_f, 2)                  # (5,5,nb8y,nb8x)
    s2, _, nb8y, nb8x = 5, 5, h // 8, w // 8
    stack16 = _boxsum(stack8.reshape(25, nb8y, nb8x), 2).reshape(
        5, 5, nb8y // 2, nb8x // 2)

    def best_of(stack, cyk, cxk, r):
        d = jnp.arange(-r, r + 1)
        rate = (_mvd_bits_dev(4 * d)[:, None]
                + _mvd_bits_dev(4 * d)[None, :]).reshape(-1, 1, 1)
        s = (stack.reshape((2 * r + 1) ** 2, *stack.shape[2:])
             + lam_me * rate)
        k = jnp.argmin(s, axis=0)
        sad = jnp.min(s, axis=0)
        mvy = (k // (2 * r + 1) - r + cyk) * 4
        mvx = (k % (2 * r + 1) - r + cxk) * 4
        return (jnp.clip(mvx, -lim, lim), jnp.clip(mvy, -lim, lim), sad)

    mv8x, mv8y, sad8 = best_of(stack8, up2(c16y), up2(c16x), 2)
    mv16x, mv16y, sad16 = best_of(stack16, c16y, c16x, 2)

    # ---- coarse stack: per-64 centers (median-free: center of the 16
    # with min HME SAD would need the sad field; use the mean MV), +/-3
    nb64y, nb64x = h // 64, w // 64
    c64x = (c16x.reshape(nb64y, 4, nb64x, 4).mean((1, 3))).astype(jnp.int32)
    c64y = (c16y.reshape(nb64y, 4, nb64x, 4).mean((1, 3))).astype(jnp.int32)

    def up8(m):
        return jnp.repeat(jnp.repeat(m, 8, 0), 8, 1)

    rec_c = _mc_luma(ref_ext, jnp.stack([up8(c64x) * 4,
                                         up8(c64y) * 4], -1),
                     bit_depth, True)
    stack8c = _sad_stack8(srcf, rec_c, 3)                 # (7,7,nb8y,nb8x)
    stack32 = _boxsum(stack8c.reshape(49, nb8y, nb8x), 4).reshape(
        7, 7, nb8y // 4, nb8x // 4)
    stack64 = _boxsum(stack8c.reshape(49, nb8y, nb8x), 8).reshape(
        7, 7, nb64y, nb64x)

    def up4(m):
        return jnp.repeat(jnp.repeat(m, 2, 0), 2, 1)

    mv32x, mv32y, sad32 = best_of(stack32, up4(c64y), up4(c64x), 3)
    mv64x, mv64y, sad64 = best_of(stack64, c64y, c64x, 3)

    # ---- dense subpel refinement per size (16/32/64; 8 stays integer,
    # like the reference's block-size-gated subpel at fast presets):
    # recentre-and-filter, so candidates are static slices, not gathers
    lam_sub = None if qp is None else lam_me
    # per-preset sub-pel gating by block size (reference:
    # PictureLevelSubPelSettingsOq — selective sub-pel at fast presets)
    if subpel_min <= 16:
        mv16x, mv16y, sad16 = _refine_subpel_dense(
            srcf, ref_ext, mv16x >> 2, mv16y >> 2, sad16, 16, bit_depth,
            lam_me=lam_sub, cqx=c16x * 4, cqy=c16y * 4)
    if subpel_min <= 32:
        mv32x, mv32y, sad32 = _refine_subpel_dense(
            srcf, ref_ext, mv32x >> 2, mv32y >> 2, sad32, 32, bit_depth,
            lam_me=lam_sub, cqx=up4(c64x) * 4, cqy=up4(c64y) * 4)
    mv64x, mv64y, sad64 = _refine_subpel_dense(
        srcf, ref_ext, mv64x >> 2, mv64y >> 2, sad64, 64, bit_depth,
        lam_me=lam_sub, cqx=c64x * 4, cqy=c64y * 4)

    # ---- zero-MV SAD per size (merge/skip candidate evaluation)
    p4 = PAD + 4
    zdiff = jnp.abs(srcf - ref_ext[p4:p4 + h, p4:p4 + w])
    z8 = _boxsum(zdiff, 8)

    out = {
        "mv8": jnp.stack([mv8x, mv8y], -1).astype(jnp.int16),
        "sad8": jnp.minimum(sad8, 1 << 30).astype(jnp.int32),
        "mv16": jnp.stack([mv16x, mv16y], -1).astype(jnp.int16),
        "sad16": sad16.astype(jnp.int32),
        "mv32": jnp.stack([mv32x, mv32y], -1).astype(jnp.int16),
        "sad32": sad32.astype(jnp.int32),
        "mv64": jnp.stack([mv64x, mv64y], -1).astype(jnp.int16),
        "sad64": sad64.astype(jnp.int32),
        "zsad8": z8.astype(jnp.int32),
    }
    return out


# ------------------------------------------------------------ packed transfer
#
# Every per-frame stage ships ONE flat buffer to the host instead of a
# dict of arrays (one device->host transfer per picture); the host slices
# it back apart (specs = [(shape, dtype), ...]).

MD_KEYS = ("mv8", "sad8", "mv16", "sad16", "mv32", "sad32",
           "mv64", "sad64", "zsad8")
EP_KEYS = ("lv_y", "lv_cb", "lv_cr", "rec_y", "rec_cb", "rec_cr",
           "nz4_y", "nz4_cb", "nz4_cr")


def _pack(arrs, dtype):
    return jnp.concatenate([a.ravel().astype(dtype) for a in arrs])


def unpack(flat: np.ndarray, specs):
    """Split a fetched flat buffer back into named arrays."""
    out = {}
    off = 0
    for name, shape, dt in specs:
        n = int(np.prod(shape))
        out[name] = np.ascontiguousarray(
            flat[off:off + n]).astype(dt).reshape(shape)
        off += n
    return out


@functools.partial(jax.jit, static_argnames=("w64", "h64"))
def prep_planes(y, cb, cr, w64: int, h64: int):
    """Upload-side prep: edge-pad raw-dtype (uint8/uint16) planes to the
    64-aligned coded grid as int32 device arrays. Shipping the native
    dtype quarters the host->device bytes vs int32 upload."""
    def pad(p, ww, hh):
        ph, pw = p.shape
        return jnp.pad(p.astype(jnp.int32), ((0, hh - ph), (0, ww - pw)),
                       mode="edge")
    return (pad(y, w64, h64), pad(cb, w64 // 2, h64 // 2),
            pad(cr, w64 // 2, h64 // 2))


@functools.partial(jax.jit, static_argnames=("bit_depth",))
def dense_md_p_packed(src, ref, raw_y, hme_mv, bit_depth: int = 8):
    out = dense_md_p(src, ref, raw_y, hme_mv, bit_depth=bit_depth)
    return _pack([out[k] for k in MD_KEYS], jnp.int32)


def md_specs(h64: int, w64: int):
    sp = []
    for n in (8, 16, 32, 64):
        g = (h64 // n, w64 // n)
        sp.append((f"mv{n}", (*g, 2), np.int32))
        sp.append((f"sad{n}", g, np.int32))
    sp.append(("zsad8", (h64 // 8, w64 // 8), np.int32))
    return sp


@functools.partial(jax.jit, static_argnames=("bit_depth",))
def encode_pass_p_packed(src_y, src_cb, src_cr, raw_y, raw_cb, raw_cr,
                         mv8, inter8, tu_log2_8, qp, qp_c,
                         bit_depth: int = 8):
    out = encode_pass_p(src_y, src_cb, src_cr, raw_y, raw_cb, raw_cr,
                        mv8, inter8, tu_log2_8, qp, qp_c,
                        bit_depth=bit_depth)
    return _pack([out[k] for k in EP_KEYS], jnp.int16)


def ep_specs(h64: int, w64: int):
    hc, wc = h64 // 2, w64 // 2
    return [("lv_y", (h64, w64), np.int32),
            ("lv_cb", (hc, wc), np.int32),
            ("lv_cr", (hc, wc), np.int32),
            ("rec_y", (h64, w64), np.int32),
            ("rec_cb", (hc, wc), np.int32),
            ("rec_cr", (hc, wc), np.int32),
            ("nz4_y", (h64 // 4, w64 // 4), bool),
            ("nz4_cb", (h64 // 8, w64 // 8), bool),
            ("nz4_cr", (h64 // 8, w64 // 8), bool)]


@functools.partial(jax.jit, static_argnames=("ctb", "h", "w", "bit_depth"))
def sao_stats_frame_packed(pre_y, pre_cb, pre_cr, src_y, src_cb, src_cr,
                           ctb: int, h: int, w: int, bit_depth: int = 8):
    """SAO statistics for all three planes in one launch, packed into a
    single int32 buffer. pre_*/src_* are raw-dtype (uint8/uint16) planes
    at 64-aligned coded dims; validity is derived from (h, w)."""
    flats = []
    for comp, (pre, src) in enumerate(((pre_y, src_y), (pre_cb, src_cb),
                                       (pre_cr, src_cr))):
        hp, wp = pre.shape
        cy = ctb if comp == 0 else ctb // 2
        cx = ctb if comp == 0 else ctb // 2
        hv = h if comp == 0 else h // 2
        wv = w if comp == 0 else w // 2
        valid = ((jnp.arange(hp)[:, None] < hv)
                 & (jnp.arange(wp)[None, :] < wv)).astype(jnp.float32)
        out = sao_stats_plane(pre.astype(jnp.int32), src.astype(jnp.int32),
                              valid, cy, cx, bit_depth=bit_depth)
        flats.extend(out[k] for k in ("eo_cnt", "eo_sum", "bo_cnt", "bo_sum"))
    return _pack(flats, jnp.int32)


def sao_specs(ctb: int, h64: int, w64: int):
    sp = []
    for comp in range(3):
        c = ctb  # CTB grid is the same for chroma (half plane, half CTB)
        ny = h64 // c if comp == 0 else (h64 // 2) // (c // 2)
        nx = w64 // c if comp == 0 else (w64 // 2) // (c // 2)
        sp.append((f"eo_cnt{comp}", (ny, nx, 4, 5), np.int64))
        sp.append((f"eo_sum{comp}", (ny, nx, 4, 5), np.int64))
        sp.append((f"bo_cnt{comp}", (ny, nx, 32), np.int64))
        sp.append((f"bo_sum{comp}", (ny, nx, 32), np.int64))
    return sp


# --------------------------------------------------- fused device fast path

def _mvd_bits_dev(v: jnp.ndarray) -> jnp.ndarray:
    """jax mirror of pipeline.fast_path._mvd_bits_arr (approximate MVD
    rate): 1 bit for 0, 3 for +/-1, else 4 + 2*bit_length(|v|-2 clamped
    to >=1). Integer-exact vs the numpy version."""
    a = jnp.abs(v)
    big = jnp.maximum(a - 2, 1)
    blen = (big[..., None] >= (1 << jnp.arange(12))).sum(-1)  # bit_length
    out = 4 + 2 * blen
    out = jnp.where(a == 1, 3, out)
    return jnp.where(a == 0, 1, out).astype(jnp.int32)


_H2_NP = np.array([[1, 1], [1, -1]], np.int32)
_H4_NP = np.block([[_H2_NP, _H2_NP], [_H2_NP, -_H2_NP]])
_H8_NP = np.block([[_H4_NP, _H4_NP], [_H4_NP, -_H4_NP]])


def _satd8_map(diff: jnp.ndarray) -> jnp.ndarray:
    """Per-8x8-block integer Hadamard SATD of a residual plane (~2x SAD
    scale, core.ctu._satd_host form). SATD is the MD metric that does
    NOT reward the noise-smoothing of subpel interpolation the way SAD
    does — the reason the reference's fractional search and MD fast loop
    rank with HAD costs (EbComputeSAD / Compute8x8Satd)."""
    h, w = diff.shape
    b = _blocks(diff.astype(jnp.int32), 8)
    h8 = jnp.asarray(_H8_NP)
    t = jnp.einsum("ij,bjk,lk->bil", h8, b, h8)
    s = jnp.abs(t).sum((-2, -1)) // 4
    return s.reshape(h // 8, w // 8)


def _plane_tu_bits_rd(lv, n: int):
    """Per-TU coefficient-rate estimate like _plane_tu_bits, but an
    all-zero TU costs 1 bit (its cbf flag) instead of the fixed last-pos
    charge — the skip/cbf=0 escape the MD full loop must see."""
    a = jnp.abs(lv)
    blen = (a[..., None] >= (1 << jnp.arange(15))).sum(-1)
    vb = jnp.where(a > 0, 3 + 2 * blen, 0)
    vbits = _boxsum(vb, n).astype(jnp.float32)
    g4 = (_boxsum(a, 4) > 0).astype(jnp.int32)
    groups = _boxsum(g4, n // 4).astype(jnp.float32)
    return jnp.where(vbits > 0, vbits + 7.0 * groups + 12.0, 1.0)


def _rd_leaf_cost(srcf, pred, s: int, qp, lam_sse, sig_bits,
                  bit_depth: int):
    """True-RD cost of coding every (s, s) CU with prediction plane
    `pred`: transform/quant/dequant at TU min(s, 32), reconstruction
    SSE + lambda * (residual bits + signalling bits). The densified form
    of the reference's MD full loop (EbProductCodingLoop.c
    PerformFullLoop :907 — where merge/skip candidates beat ME residual
    coding on real rate, which SATD-stage costs cannot see)."""
    tun = min(s, 32)
    resid = srcf - pred
    lv, rr = dense_tq_size(resid, tun, qp, bit_depth=bit_depth,
                           is_intra=False, lam=lam_sse)
    d = _boxsum((resid - rr) * (resid - rr), s).astype(jnp.float32)
    rbits = _boxsum(_plane_tu_bits_rd(lv, tun), s // tun)
    return d + lam_sse * (rbits + sig_bits.astype(jnp.float32))


def _rd_leaf_cost_intra(srcf, pred, s: int, qp, lam_sse, bit_depth: int):
    """True-RD intra leaf cost at CU size s: T/Q at TU min(s, 32) of the
    open-loop residual, post-quant SSE + lambda * (coefficient bits +
    mode signalling)."""
    tun = min(s, 32)
    resid = srcf - pred
    lv, rr = dense_tq_size(resid, tun, qp, bit_depth=bit_depth,
                           is_intra=True, lam=lam_sse)
    d = _boxsum((resid - rr) * (resid - rr), s).astype(jnp.float32)
    rbits = _boxsum(_plane_tu_bits_rd(lv, tun), s // tun)
    return d + lam_sse * (rbits + 4.0)


def _scale_mv_dev(mv, tb, td):
    """Device mirror of core.inter._scale_mv_td (8.5.3.2.8): truncation
    toward zero, identical clamps — candidate MVs must match the host
    TMVP derivation bit-for-bit or the emit walk cannot merge them."""
    tb = jnp.clip(tb, -128, 127)
    td = jnp.clip(td, -128, 127)
    same = (td == tb) | (td == 0)
    td_s = jnp.where(same, 1, td)
    n = 16384 + (jnp.abs(td_s) >> 1)
    tx = jnp.sign(td_s) * (n // jnp.abs(td_s))      # trunc toward zero
    dsf = jnp.clip((tb * tx + 32) >> 6, -4096, 4095)
    v = dsf * mv
    mag = (jnp.abs(v) + 127) >> 8
    out = jnp.clip(jnp.where(v >= 0, mag, -mag), -32768, 32767)
    return jnp.where(same, mv, out)


def _tmvp_candidate(col16_mv, col16_valid, s: int, gshape,
                    ctb_log2: int, w: int, h: int):
    """Per-s-block TMVP merge candidate from the collocated picture's
    16x16-compressed motion (8.5.3.2.7 sampling: bottom-right block if
    inside the picture and the same CTB row, else the center block).
    Returns (mv (gy, gx, 2), valid (gy, gx))."""
    gy, gx = gshape
    y0 = jnp.arange(gy) * s
    x0 = jnp.arange(gx) * s
    mh, mw = col16_valid.shape
    br_row_ok = ((y0 + s < h) & ((y0 + s) >> ctb_log2 == y0 >> ctb_log2))
    br_ok = br_row_ok[:, None] & (x0 + s < w)[None, :]
    ybr = jnp.clip((y0 + s) >> 4, 0, mh - 1)
    xbr = jnp.clip((x0 + s) >> 4, 0, mw - 1)
    yc = jnp.clip((y0 + s // 2) >> 4, 0, mh - 1)
    xc = jnp.clip((x0 + s // 2) >> 4, 0, mw - 1)
    v_br = col16_valid[ybr[:, None], xbr[None, :]] & br_ok
    mv_br = col16_mv[ybr[:, None], xbr[None, :]]
    v_c = col16_valid[yc[:, None], xc[None, :]]
    mv_c = col16_mv[yc[:, None], xc[None, :]]
    take_br = v_br
    mv = jnp.where(take_br[..., None], mv_br, mv_c)
    return mv, take_br | v_c


def decide_tree_dev(md: dict, ois: dict, ctb_log2: int,
                    min_intra_log2: int = 3,
                    w: int | None = None, h: int | None = None,
                    qp=None, src=None, ref=None, raw16=None,
                    bit_depth: int = 8,
                    col_mv8=None, col_valid8=None, tb=None, td=None):
    """Device mirror of pipeline.fast_path.decide_tree: bottom-up
    quadtree DP over the dense cost maps. All costs are integer-valued
    (integer SAD-domain lambda, split charge 2 -> int32), so decisions
    match the numpy host version bit-for-bit. min_intra_log2: smallest
    intra CU offered (the P fast path restricts intra to >=16, the
    analogue of the reference's CU-8x8 gating,
    EbPictureDecisionProcess.c:425). w/h: coded dims — CUs crossing the
    picture boundary are forced to split (the syntax forces the same
    split, 7.3.8.4). qp: traced scalar selecting the per-QP lambda (the
    reference drives MD with QP-indexed lambda tables,
    EbLambdaRateTables.h:55); None keeps the legacy constant 3. Returns
    (cu_log2_8, inter8, mv8, mode8)."""
    INF = jnp.int32(1 << 30)
    lim_q = (PAD - 9) * 4        # quarter-pel MV reach of the padding
    lam = jnp.int32(3) if qp is None else jnp.asarray(LAMBDA_SAD)[qp]
    satd_mode = src is not None
    if satd_mode:
        # SATD metric (see _satd8_map): SAD rewards the noise-smoothing
        # of subpel interpolation, decorating static content with fake
        # sub-pel MVs that break the merge/skip chain; SATD does not.
        lam = 2 * lam                   # SATD ~ 2x SAD scale
        # SSE-domain lambda for the stage-2 full loop (core.rdo
        # lambda_sse form, device-traced in qp). P/B slices weight the
        # mode-decision lambda above the I-slice base (HM/reference
        # inter-slice lambda weights, EbLambdaRateTables.h): inter
        # residual is droppable — the decoder coasts on prediction —
        # so rate is charged harder than in an intra slice.
        lam_sse = P_LAMBDA_SCALE * jnp.float32(0.57) * jnp.exp2(
            (qp.astype(jnp.float32) - 12.0) / 3.0)
        # SATD-cost -> J-domain conversion for leaves that only have a
        # SATD estimate (intra): J ~ (lam_sse / lam_satd) * C_satd
        j_ratio = lam_sse / jnp.maximum(lam.astype(jnp.float32), 1.0)
        srcf = src.astype(jnp.int32)
        h_, w_ = srcf.shape
        # ~20 candidate predictions are generated per picture; each is a
        # per-block MC through _mc_luma, so no phase-plane stack is ever
        # materialized
        ref_ext4 = _ext_y(ref)
        satd_z8 = _satd8_map(srcf - ref.astype(jnp.int32))
        zs = {8: satd_z8}
        col16_mv = col16_v = None
        if col_mv8 is not None:
            # col_mv8/col_valid8 arrive 16x16-compressed (spec motion
            # compression, the producing graph subsamples its decided
            # 8-grid at stride 2); POC-scale once — single active
            # reference => one tb/td per picture
            col16_v = col_valid8
            col16_mv = _scale_mv_dev(col_mv8.astype(jnp.int32), tb, td)
    else:
        zs = {8: md["zsad8"].astype(jnp.int32)}
    for s in (16, 32, 64):
        zs[s] = _boxsum(zs[s // 2], 2)

    leaf_cost, leaf_inter, leaf_mv, leaf_mode = {}, {}, {}, {}
    sizes = [s for s in (8, 16, 32, 64) if (1 << ctb_log2) >= s]
    for s in sizes:
        mv = md[f"mv{s}"].astype(jnp.int32)
        if satd_mode:
            # ---- merge-aware candidate set (the whole point of a P
            # picture: the reference codes most CUs as merge/skip with a
            # neighbor's MV, EbModeDecision.c:1608 merge candidates + NFL).
            # Candidates: the ME winner (AMVP-signalled, MVD bits charged
            # RELATIVE TO the left-neighbor predictor, not to zero — the
            # emit path signals mvd = mv - AMVP cand, core/inter.py
            # amvp_candidates), the left / top neighbors' ME winners at
            # ~merge_idx cost (if chosen, the emit walk's merge scan
            # _compute_plan finds them in the real merge list and codes
            # 2-3 bins), and zero MV (merge-priced only when a neighbor
            # is also zero, else AMVP-priced).
            rep = s // 8
            mvL = jnp.concatenate([mv[:, :1], mv[:, :-1]], 1)
            mvT = jnp.concatenate([mv[:1], mv[:-1]], 0)

            def up(m):
                return jnp.repeat(jnp.repeat(m, rep, 0), rep, 1)

            def pred_of(mv_c):
                mvf = jnp.stack([up(mv_c[..., 0]), up(mv_c[..., 1])], -1)
                return _mc_luma(ref_ext4, mvf, bit_depth, True)

            def satd_of(pred):
                return _boxsum(_satd8_map(srcf - pred), rep)

            # candidates are evaluated one at a time (SATD consumed
            # immediately) and only the two RD finalists' predictions are
            # re-generated by MV afterwards — no candidate plane is held
            # across the stage (the phase-plane design kept 5 full preds
            # per size live; at 1080p that alone was ~160 MB)
            d_me = satd_of(pred_of(mv))
            d_l = satd_of(pred_of(mvL))
            d_t = satd_of(pred_of(mvT))
            bits_me = (_mvd_bits_dev(mv[..., 0] - mvL[..., 0])
                       + _mvd_bits_dev(mv[..., 1] - mvL[..., 1])
                       + AMVP_BASE_BITS)
            zerL = (mvL == 0).all(-1)
            zerT = (mvT == 0).all(-1)
            bits_z = jnp.where(zerL | zerT, 3, 10)
            zero_mv = jnp.zeros_like(mv)
            cands_d = [d_me, d_l, d_t, zs[s]]
            cands_bits = [bits_me,
                          jnp.full_like(bits_me, 2),
                          jnp.full_like(bits_me, 3),
                          bits_z]
            cands_mv = [mv, mvL, mvT, zero_mv]
            if col16_mv is not None:
                # the collocated (TMVP) merge candidate — what lets the
                # emit walk chain temporal merges like the reference does
                # (its P pictures code almost everything as merge/skip,
                # with the TMVP carrying the global motion; measured:
                # its CIF IPPP streams contain ~2 MVD CUs per frame)
                mv_t, v_t = _tmvp_candidate(col16_mv, col16_v, s,
                                            mv.shape[:2], ctb_log2, w, h)
                # POC scaling can produce MVs beyond the padded reach;
                # clamp at candidate creation so the decided/signalled
                # MV always equals the MV the prediction used
                mv_t = jnp.clip(mv_t, -lim_q, lim_q)
                d_tm = jnp.where(v_t, satd_of(pred_of(mv_t)),
                                 jnp.int32(1 << 29))
                cands_d.append(d_tm)
                cands_bits.append(jnp.full_like(bits_me, TMVP_BITS))
                cands_mv.append(mv_t)
            bits_stack = jnp.stack(cands_bits)
            c_stack = jnp.stack(cands_d) + lam * bits_stack
            mv_stack = jnp.stack(cands_mv)
            k = jnp.argmin(c_stack, 0)
            inter_c = jnp.min(c_stack, 0)
            # cheapest-signalling (merge-class) runner-up: best of
            # left/top/zero/tmvp by SATD stage cost
            kc = jnp.argmin(c_stack[1:], 0) + 1

            def take(stack, idx):
                return jnp.take_along_axis(stack, idx[None], axis=0)[0]

            def take_mv(idx):
                return jnp.take_along_axis(mv_stack, idx[None, ..., None],
                                           axis=0)[0]

            mv_sel = take_mv(k)
            # ---- stage 2: true-RD full loop between the SATD winner
            # and the merge-class runner-up (post-quantization SSE +
            # real residual bits; flips marginal ME wins back to
            # merge/skip exactly like the reference's full loop). The
            # finalists' predictions are regenerated from their MVs (a
            # candidate's pred is a pure function of its MV), so no
            # candidate plane outlives its SATD evaluation.
            j_sel = _rd_leaf_cost(srcf, pred_of(mv_sel), s, qp, lam_sse,
                                  take(bits_stack, k), bit_depth)
            j_cheap = _rd_leaf_cost(srcf, pred_of(take_mv(kc)), s, qp,
                                    lam_sse, take(bits_stack, kc),
                                    bit_depth)
            use_cheap = (j_cheap < j_sel + lam_sse * MERGE_BIAS_BITS) \
                & (k != kc)
            inter_j = jnp.where(use_cheap, jnp.minimum(j_cheap, j_sel),
                                j_sel)
            mv_sel = jnp.where(use_cheap[..., None], take_mv(kc), mv_sel)
        else:
            bits = _mvd_bits_dev(mv[..., 0]) + _mvd_bits_dev(mv[..., 1])
            dist = md[f"sad{s}"].astype(jnp.int32)
            ic = dist + lam * (bits + 4)
            zc = zs[s] + lam * 3
            use_zero = zc < ic
            inter_c = jnp.where(use_zero, zc, ic)
            mv_sel = jnp.where(use_zero[..., None], 0, mv)
        if s <= 32 and s >= (1 << min_intra_log2):
            mode_map, cost_map = ois[s]
            intra_c = 2 * cost_map + lam * 6
            # intra gating in P/B: the open-loop cost predicts from CLEAN
            # source neighbors and reads ~0 on predictable content, which
            # would misclassify most of a static picture as intra (each
            # intra CU then pays mode + cbf + residual syntax that skip
            # never pays). Allow intra only where inter prediction
            # genuinely fails — per-pixel inter residual above a
            # lambda-scaled threshold (the reference's fast presets gate
            # intra in inter pictures the same way,
            # EbModeDecision.c intra candidate injection conditions)
            fails = inter_c > (lam * s * s) >> 1
            intra_c = jnp.where(fails, intra_c, INF)
        else:
            intra_c = jnp.full_like(inter_c, INF)
            mode_map = jnp.zeros_like(inter_c)
        use_intra = intra_c < inter_c
        if satd_mode:
            # leaf costs live in the J (SSE + lam_sse*bits) domain; the
            # intra leaf only has a SATD-stage estimate -> convert
            leaf_cost[s] = jnp.where(
                use_intra,
                jnp.minimum(j_ratio * intra_c.astype(jnp.float32), 3e37),
                inter_j)
        else:
            leaf_cost[s] = jnp.where(use_intra, intra_c, inter_c)
        leaf_inter[s] = ~use_intra
        leaf_mv[s] = mv_sel
        leaf_mode[s] = mode_map.astype(jnp.int32)

    split_charge = lam_sse * 3.0 if satd_mode else lam * 2
    best = {8: leaf_cost[8]}
    split = {}
    for s in sizes[1:]:
        agg = _boxsum(best[s // 2], 2) + split_charge
        split[s] = agg < leaf_cost[s]
        if w is not None:
            # CUs crossing the coded boundary are never leaves (the
            # syntax forces their split, 7.3.8.4)
            gy, gx = leaf_cost[s].shape
            cross = (((jnp.arange(gx) * s + s) > w)[None, :]
                     | ((jnp.arange(gy) * s + s) > h)[:, None])
            split[s] = split[s] | cross
        best[s] = jnp.where(split[s], agg, leaf_cost[s])

    nby, nbx = leaf_cost[8].shape
    cu_log2 = jnp.zeros((nby, nbx), jnp.int32)
    inter8 = jnp.zeros((nby, nbx), bool)
    mv8 = jnp.zeros((nby, nbx, 2), jnp.int32)
    mode8 = jnp.zeros((nby, nbx), jnp.int32)

    def rep(m, k):
        return jnp.repeat(jnp.repeat(m, k, 0), k, 1)

    undecided = jnp.ones((nby, nbx), bool)
    for s in reversed(sizes):
        k = s // 8
        if s == 8:
            leaf_here = undecided
        else:
            leaf_here = undecided & ~rep(split[s], k)
        lg = s.bit_length() - 1
        cu_log2 = jnp.where(leaf_here, lg, cu_log2)
        inter_rep = rep(leaf_inter[s], k)
        inter8 = jnp.where(leaf_here, inter_rep, inter8)
        take_mv = (leaf_here & inter_rep)[..., None]
        mv8 = jnp.where(take_mv, rep(leaf_mv[s], k), mv8)
        mode8 = jnp.where(leaf_here, rep(leaf_mode[s], k), mode8)
        undecided = undecided & ~leaf_here
    return cu_log2, inter8, mv8, mode8


def _subpel_raw8(raw16, mvqx, mvqy, h: int, w: int):
    """14-bit MC gather where every 8x8 block uses its own quarter-pel
    MV (the bi-prediction intermediate form of _subpel_pred8)."""
    ph = (mvqy & 3) * 4 + (mvqx & 3)
    by = jnp.arange(h // 8) * 8
    bx = jnp.arange(w // 8) * 8
    sy = by[:, None] + (mvqy >> 2) + PAD
    sx = bx[None, :] + (mvqx >> 2) + PAD
    return _gather_blocks(raw16, ph, sy, sx, 8, h, w)


def decide_tree_b_dev(md0: dict, md1: dict, ois: dict, ctb_log2: int,
                      src, ref0, ref1,
                      min_intra_log2: int = 4,
                      w: int | None = None, h: int | None = None,
                      qp=None, bit_depth: int = 8):
    """B-picture quadtree DP: per CU size the candidates are uni-L0
    (ME or zero-MV), uni-L1 (ME or zero-MV), bi (L0+L1 ME winners,
    sizes >= 16), and gated intra, all ranked by SATD (see
    decide_tree_dev). Returns (cu_log2_8, ref8_2l (2, nby, nbx),
    mv8_2l (2, nby, nbx, 2), mode8). Reference analogue: the MD
    candidate set of B pictures — uni per list + the bi combination
    (EbModeDecision.c :926) over the ME winners
    (EbMotionEstimation.c EbHevcBiPredictionSearch :2870)."""
    INF = jnp.int32(1 << 30)
    lam = jnp.int32(3) if qp is None else jnp.asarray(LAMBDA_SAD)[qp]
    lam = 2 * lam                       # SATD ~ 2x SAD scale
    lam_sse = P_LAMBDA_SCALE * jnp.float32(0.57) * jnp.exp2(
        (qp.astype(jnp.float32) - 12.0) / 3.0)
    j_ratio = lam_sse / jnp.maximum(lam.astype(jnp.float32), 1.0)
    srcf = src.astype(jnp.int32)
    h_, w_ = srcf.shape
    # per-list direct-MC support planes (see decide_tree_dev)
    ext0 = _ext_y(ref0)
    ext1 = _ext_y(ref1)

    zs0 = {8: _satd8_map(srcf - ref0.astype(jnp.int32))}
    zs1 = {8: _satd8_map(srcf - ref1.astype(jnp.int32))}
    for s in (16, 32, 64):
        zs0[s] = _boxsum(zs0[s // 2], 2)
        zs1[s] = _boxsum(zs1[s // 2], 2)

    s_b = 15 - bit_depth
    maxval = (1 << bit_depth) - 1

    leaf_cost, leaf_mode = {}, {}
    leaf_mv0, leaf_mv1, leaf_u0, leaf_u1 = {}, {}, {}, {}
    sizes = [s for s in (8, 16, 32, 64) if (1 << ctb_log2) >= s]
    for s in sizes:
        rep = s // 8
        mv0 = md0[f"mv{s}"].astype(jnp.int32)
        mv1 = md1[f"mv{s}"].astype(jnp.int32)

        def up(m):
            return jnp.repeat(jnp.repeat(m, rep, 0), rep, 1)

        def upmv(mv_c):
            return jnp.stack([up(mv_c[..., 0]), up(mv_c[..., 1])], -1)

        raw_a = _mc_luma(ext0, upmv(mv0), bit_depth, False)
        raw_b = _mc_luma(ext1, upmv(mv1), bit_depth, False)
        s_u = 14 - bit_depth
        pred0 = jnp.clip((raw_a + (1 << (s_u - 1))) >> s_u, 0, maxval)
        pred1 = jnp.clip((raw_b + (1 << (s_u - 1))) >> s_u, 0, maxval)
        d0 = _boxsum(_satd8_map(srcf - pred0), rep)
        d1 = _boxsum(_satd8_map(srcf - pred1), rep)

        # merge-aware per-list candidates (see decide_tree_dev): left /
        # top neighbor ME winners at merge cost, ME winner at
        # predictor-relative MVD cost, zero-MV merge-priced only when a
        # neighbor is also zero. Each list also reports its cheapest
        # merge-class candidate for the stage-2 true-RD full loop.
        def uni_best(mv_s, d_me, zsat, ext_l, extra):
            mvL = jnp.concatenate([mv_s[:, :1], mv_s[:, :-1]], 1)
            mvT = jnp.concatenate([mv_s[:1], mv_s[:-1]], 0)

            def pred_of(mv_c):
                return _mc_luma(ext_l, upmv(mv_c), bit_depth, True)

            def satd_of(p):
                return _boxsum(_satd8_map(srcf - p), rep)

            b_me = (_mvd_bits_dev(mv_s[..., 0] - mvL[..., 0])
                    + _mvd_bits_dev(mv_s[..., 1] - mvL[..., 1]))
            zerN = (mvL == 0).all(-1) | (mvT == 0).all(-1)
            bits_stack = jnp.stack([b_me + 4 + extra,
                                    jnp.full_like(b_me, 2),
                                    jnp.full_like(b_me, 3),
                                    jnp.where(zerN, 3, 10)])
            c_stack = jnp.stack([d_me, satd_of(pred_of(mvL)),
                                 satd_of(pred_of(mvT)),
                                 zsat]) + lam * bits_stack
            mv_stack = jnp.stack([mv_s, mvL, mvT, jnp.zeros_like(mv_s)])
            k = jnp.argmin(c_stack, 0)
            kc = jnp.argmin(c_stack[1:], 0) + 1

            def take(stack, idx):
                return jnp.take_along_axis(stack, idx[None], axis=0)[0]

            def take_mv(idx):
                return jnp.take_along_axis(mv_stack, idx[None, ..., None],
                                           axis=0)[0]

            # finalist predictions are regenerated from their MVs — no
            # candidate plane held across the stage (see decide_tree_dev)
            return (jnp.min(c_stack, 0), take_mv(k), b_me,
                    pred_of(take_mv(k)), take(bits_stack, k),
                    take(c_stack, kc), take_mv(kc),
                    pred_of(take_mv(kc)), take(bits_stack, kc))

        (c0, mv0_sel, b0, p0_sel, bits0_sel,
         c0_ch, mv0_ch, p0_ch, bits0_ch) = uni_best(
            mv0, d0, zs0[s], ext0, 0)
        (c1, mv1_sel, b1, p1_sel, bits1_sel,
         c1_ch, mv1_ch, p1_ch, bits1_ch) = uni_best(
            mv1, d1, zs1[s], ext1, 1)

        if s >= 16:
            pred_bi = jnp.clip((raw_a + raw_b + (1 << (s_b - 1))) >> s_b,
                               0, maxval)
            d_bi = _boxsum(_satd8_map(srcf - pred_bi), rep)
            cbi = d_bi + lam * (b0 + b1 + 6)
        else:
            cbi = jnp.full_like(c0, INF)

        if s <= 32 and s >= (1 << min_intra_log2):
            mode_map, cost_map = ois[s]
            intra_c = 2 * cost_map + lam * 6
            fails = jnp.minimum(c0, c1) > (lam * s * s) >> 1
            intra_c = jnp.where(fails, intra_c, INF)
        else:
            intra_c = jnp.full_like(c0, INF)
            mode_map = jnp.zeros_like(c0)

        best = jnp.minimum(jnp.minimum(c0, c1), jnp.minimum(cbi, intra_c))
        is_bi = best == cbi
        is_1 = (best == c1) & ~is_bi
        is_0 = (best == c0) & ~is_bi & ~is_1
        is_intra = ~(is_bi | is_1 | is_0)

        # ---- stage 2: true-RD full loop between the SATD winner and
        # the cheapest merge-class candidate across both lists (see
        # decide_tree_dev / reference EbProductCodingLoop.c:907)
        def upx(m):
            return jnp.repeat(jnp.repeat(m, s, 0), s, 1)

        if s >= 16:
            pred_bi_r = jnp.clip((raw_a + raw_b + (1 << (s_b - 1))) >> s_b,
                                 0, maxval)
        else:
            pred_bi_r = pred0
        pred_win = jnp.where(upx(is_bi), pred_bi_r,
                             jnp.where(upx(is_1), p1_sel, p0_sel))
        bits_win = jnp.where(is_bi, b0 + b1 + 6,
                             jnp.where(is_1, bits1_sel, bits0_sel))
        ch_is_1 = c1_ch < c0_ch
        pred_ch = jnp.where(upx(ch_is_1), p1_ch, p0_ch)
        bits_ch = jnp.where(ch_is_1, bits1_ch, bits0_ch)
        j_sel = _rd_leaf_cost(srcf, pred_win, s, qp, lam_sse, bits_win,
                              bit_depth)
        j_ch = _rd_leaf_cost(srcf, pred_ch, s, qp, lam_sse, bits_ch,
                             bit_depth)
        use_ch = (j_ch < j_sel) & ~is_intra
        inter_j = jnp.where(use_ch, j_ch, j_sel)
        mv0_fin = jnp.where(use_ch[..., None],
                            jnp.where(ch_is_1[..., None], 0, mv0_ch),
                            jnp.where(is_bi[..., None], mv0,
                                      jnp.where(is_0[..., None],
                                                mv0_sel, 0)))
        mv1_fin = jnp.where(use_ch[..., None],
                            jnp.where(ch_is_1[..., None], mv1_ch, 0),
                            jnp.where(is_bi[..., None], mv1,
                                      jnp.where(is_1[..., None],
                                                mv1_sel, 0)))
        u0_fin = jnp.where(use_ch, ~ch_is_1, is_0 | is_bi)
        u1_fin = jnp.where(use_ch, ch_is_1, is_1 | is_bi)

        leaf_cost[s] = jnp.where(
            is_intra,
            jnp.minimum(j_ratio * intra_c.astype(jnp.float32), 3e37),
            inter_j)
        leaf_u0[s] = u0_fin
        leaf_u1[s] = u1_fin
        leaf_mv0[s] = mv0_fin
        leaf_mv1[s] = mv1_fin
        leaf_mode[s] = jnp.where(is_intra, mode_map.astype(jnp.int32), 0)
        del is_intra

    best = {sizes[0]: leaf_cost[sizes[0]]}
    split = {}
    for s in sizes[1:]:
        agg = _boxsum(best[s // 2], 2) + lam_sse * 3.0
        split[s] = agg < leaf_cost[s]
        if w is not None:
            gy, gx = leaf_cost[s].shape
            cross = (((jnp.arange(gx) * s + s) > w)[None, :]
                     | ((jnp.arange(gy) * s + s) > h)[:, None])
            split[s] = split[s] | cross
        best[s] = jnp.where(split[s], agg, leaf_cost[s])

    nby, nbx = leaf_cost[8].shape
    cu_log2 = jnp.zeros((nby, nbx), jnp.int32)
    u0 = jnp.zeros((nby, nbx), bool)
    u1 = jnp.zeros((nby, nbx), bool)
    mv8_2 = jnp.zeros((2, nby, nbx, 2), jnp.int32)
    mode8 = jnp.zeros((nby, nbx), jnp.int32)

    def rep(m, k):
        return jnp.repeat(jnp.repeat(m, k, 0), k, 1)

    undecided = jnp.ones((nby, nbx), bool)
    for s in reversed(sizes):
        k = s // 8
        leaf_here = undecided if s == 8 else undecided & ~rep(split[s], k)
        cu_log2 = jnp.where(leaf_here, s.bit_length() - 1, cu_log2)
        u0 = jnp.where(leaf_here, rep(leaf_u0[s], k), u0)
        u1 = jnp.where(leaf_here, rep(leaf_u1[s], k), u1)
        lh = leaf_here[..., None]
        mv8_2 = mv8_2.at[0].set(jnp.where(lh, rep(leaf_mv0[s], k),
                                          mv8_2[0]))
        mv8_2 = mv8_2.at[1].set(jnp.where(lh, rep(leaf_mv1[s], k),
                                          mv8_2[1]))
        mode8 = jnp.where(leaf_here, rep(leaf_mode[s], k), mode8)
        undecided = undecided & ~leaf_here
    ref8_2 = jnp.stack([jnp.where(u0, 0, -1), jnp.where(u1, 0, -1)])
    return cu_log2, ref8_2, mv8_2, mode8


FUSED_EXTRA = ("cu_log2_8", "inter8", "mv8", "intra_mode8")


@functools.partial(jax.jit, static_argnames=("ctb_log2", "bit_depth",
                                             "w", "h"))
def fast_p_fused_packed(src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr,
                        hme_mv, qp, qp_c, ctb_log2: int,
                        w: int, h: int, bit_depth: int = 8):
    """The whole fast-path device pipeline for one P picture in ONE
    compiled graph and ONE packed download: reference phase planes ->
    dense inter MD + open-loop intra costs -> quadtree decision ->
    normative inter encode pass -> closed-loop wavefront pass for the
    intra CUs (tpu/intra_pass.py). The host only walks CTUs for syntax
    legalization afterwards (pipeline/fast_path.py)."""
    from .analysis import intra_search_size
    from .intra_pass import intra_wavefront_pass

    raw_y = luma_phase_planes(ref_y, bit_depth=bit_depth)
    raw_cb = chroma_phase_planes(ref_cb, bit_depth=bit_depth)
    raw_cr = chroma_phase_planes(ref_cr, bit_depth=bit_depth)

    md = dense_md_p(src_y, ref_y, raw_y, hme_mv, bit_depth=bit_depth)

    yf = src_y.astype(jnp.float32)
    ois = {}
    for n in (8, 16, 32):
        mode, cost = intra_search_size(yf, n)
        ois[n] = (mode.astype(jnp.int32),
                  jnp.round(cost).astype(jnp.int32))

    cu_log2_8, inter8, mv8, mode8 = decide_tree_dev(md, ois, ctb_log2,
                                                    w=w, h=h)
    tu_log2 = jnp.minimum(cu_log2_8, 5)
    out = encode_pass_p(src_y, src_cb, src_cr, raw_y, raw_cb, raw_cr,
                        mv8, inter8, tu_log2, qp, qp_c,
                        bit_depth=bit_depth)
    # closed-loop intra for the CUs the decision sent to intra: inter
    # recon is final (MC never reads intra recon), so fixing up intra CUs
    # in wavefront order reproduces exact z-scan decoder state
    rec_y, rec_cb, rec_cr, lv_y, lv_cb, lv_cr, _ = intra_wavefront_pass(
        src_y, src_cb, src_cr,
        out["rec_y"], out["rec_cb"], out["rec_cr"],
        out["lv_y"], out["lv_cb"], out["lv_cr"],
        cu_log2_8, mode8, ~inter8,
        qp, qp_c, w=w, h=h, bit_depth=bit_depth, ctb_log2=ctb_log2)
    fin = {
        "lv_y": lv_y.astype(jnp.int16),
        "lv_cb": lv_cb.astype(jnp.int16),
        "lv_cr": lv_cr.astype(jnp.int16),
        "rec_y": rec_y.astype(jnp.uint16),
        "rec_cb": rec_cb.astype(jnp.uint16),
        "rec_cr": rec_cr.astype(jnp.uint16),
        "nz4_y": _nz_map(lv_y, 4).astype(jnp.uint8),
        "nz4_cb": _nz_map(lv_cb, 4).astype(jnp.uint8),
        "nz4_cr": _nz_map(lv_cr, 4).astype(jnp.uint8),
    }
    arrs = [fin[k] for k in EP_KEYS] + [cu_log2_8, inter8, mv8, mode8]
    return _pack(arrs, jnp.int16)


def fused_specs(h64: int, w64: int):
    nby, nbx = h64 // 8, w64 // 8
    return ep_specs(h64, w64) + [
        ("cu_log2_8", (nby, nbx), np.int32),
        ("inter8", (nby, nbx), bool),
        ("mv8", (nby, nbx, 2), np.int32),
        ("intra_mode8", (nby, nbx), np.int32)]


# ------------------------------------------------------- fused I-picture path

# SAD-domain lambda per QP (HM-style sqrt(0.85 * 2^((qp-12)/3)), rounded
# to int so device and host decisions are bit-identical; the reference
# drives MD with per-QP lambda tables, EbLambdaRateTables.h:55-232)
LAMBDA_SAD = np.maximum(
    np.round(np.sqrt(0.85 * 2.0 ** ((np.arange(64) - 12) / 3.0))),
    1).astype(np.int32)


def decide_tree_i_dev(ois: dict, qp, ctb_log2: int, w: int, h: int,
                      src=None, preds: dict | None = None,
                      bit_depth: int = 8):
    """Intra-only quadtree DP (sizes 8/16/32; a 64 node always splits —
    coded intra TBs are <= 32). Picture-boundary CUs are forced to split
    by an INF leaf cost, matching the syntax's forced split outside the
    coded area. Returns (cu_log2_8, mode8).

    With src + preds (per-size open-loop pred planes from
    intra_search_size_pred) the leaves are costed by TRUE RD —
    transform/quant at the leaf size, post-quant SSE + real coefficient
    bits — instead of SATD. SATD sees no transform compaction, so it
    splits textured areas to 8x8 and throws away the large-TB energy
    compaction that dominates intra texture coding (the reference's
    intra MD full loop makes exactly this tradeoff visible,
    EbProductCodingLoop.c :907)."""
    INF = jnp.float32(3e37) if src is not None else jnp.int32(1 << 28)
    lam = jnp.asarray(LAMBDA_SAD)[qp]
    lam_sse = jnp.float32(0.57) * jnp.exp2(
        (qp.astype(jnp.float32) - 12.0) / 3.0)
    sizes = [s for s in (8, 16, 32) if (1 << ctb_log2) >= s]

    leaf_cost, leaf_mode = {}, {}
    for s in sizes:
        mode_map, cost_map = ois[s]
        gy, gx = cost_map.shape
        ok = (((jnp.arange(gx) * s + s) <= w)[None, :]
              & ((jnp.arange(gy) * s + s) <= h)[:, None])
        if src is not None:
            j = _rd_leaf_cost_intra(src, preds[s], s, qp, lam_sse,
                                    bit_depth)
            leaf_cost[s] = jnp.where(ok, j, INF)
        else:
            # SATD is ~2x SAD scale; ~3 bits mode signalling charge
            leaf_cost[s] = jnp.where(ok, 2 * cost_map + lam * 3, INF)
        leaf_mode[s] = mode_map.astype(jnp.int32)

    charge = lam_sse * 3.0 if src is not None else lam * 2
    best = {sizes[0]: leaf_cost[sizes[0]]}
    split = {}
    for s in sizes[1:]:
        agg = _boxsum(best[s // 2], 2) + charge
        # boundary-crossing CUs must split even when the children are
        # also INF (out-of-picture): never emit a crossing leaf
        split[s] = (agg < leaf_cost[s]) | (leaf_cost[s] >= INF)
        best[s] = jnp.minimum(jnp.where(split[s], agg, leaf_cost[s]), INF)

    nby, nbx = leaf_cost[8].shape
    cu_log2 = jnp.full((nby, nbx), 3, jnp.int32)
    mode8 = jnp.zeros((nby, nbx), jnp.int32)

    def rep(m, k):
        return jnp.repeat(jnp.repeat(m, k, 0), k, 1)

    undecided = jnp.ones((nby, nbx), bool)
    for s in reversed(sizes):
        k = s // 8
        if s == 8:
            leaf_here = undecided
        else:
            leaf_here = undecided & ~rep(split[s], k)
        cu_log2 = jnp.where(leaf_here, s.bit_length() - 1, cu_log2)
        mode8 = jnp.where(leaf_here, rep(leaf_mode[s], k), mode8)
        undecided = undecided & ~leaf_here
    return cu_log2, mode8


@functools.partial(jax.jit, static_argnames=("ctb_log2", "bit_depth",
                                             "w", "h"))
def fast_i_fused_packed(src_y, src_cb, src_cr, qp, qp_c, ctb_log2: int,
                        w: int, h: int, bit_depth: int = 8):
    """The whole I-picture device pipeline in ONE compiled graph and ONE
    packed download: open-loop intra search -> quadtree decision ->
    closed-loop wavefront encode pass (tpu/intra_pass.py). The host walk
    afterwards only emits syntax from the maps (pipeline/fast_path.py).
    Replaces the per-CTU host Python walk of the non-fast path
    (reference hot loop: EbCodingLoop.c EncodePass :2989 under the
    EncDec wavefront, EbEncDecProcess.c :1540)."""
    from .analysis import intra_search_size_pred
    from .intra_pass import intra_wavefront_pass

    yf = src_y.astype(jnp.float32)
    ois, preds = {}, {}
    for n in (8, 16, 32):
        mode, cost, pred = intra_search_size_pred(yf, n, bit_depth)
        ois[n] = (mode.astype(jnp.int32), jnp.round(cost).astype(jnp.int32))
        preds[n] = pred
    cu_log2_8, mode8 = decide_tree_i_dev(ois, qp, ctb_log2, w, h,
                                         src=src_y.astype(jnp.int32),
                                         preds=preds, bit_depth=bit_depth)

    h64, w64 = src_y.shape
    zy = jnp.zeros((h64, w64), jnp.int32)
    zc = jnp.zeros((h64 // 2, w64 // 2), jnp.int32)
    nby, nbx = h64 // 8, w64 // 8
    rec_y, rec_cb, rec_cr, lv_y, lv_cb, lv_cr = intra_wavefront_pass(
        src_y, src_cb, src_cr, zy, zc, zc, zy, zc, zc,
        cu_log2_8, mode8, jnp.ones((nby, nbx), bool),
        qp, qp_c, w=w, h=h, bit_depth=bit_depth, ctb_log2=ctb_log2)

    out = {
        "lv_y": lv_y.astype(jnp.int16),
        "lv_cb": lv_cb.astype(jnp.int16),
        "lv_cr": lv_cr.astype(jnp.int16),
        "rec_y": rec_y.astype(jnp.uint16),
        "rec_cb": rec_cb.astype(jnp.uint16),
        "rec_cr": rec_cr.astype(jnp.uint16),
        "nz4_y": _nz_map(lv_y, 4).astype(jnp.uint8),
        "nz4_cb": _nz_map(lv_cb, 4).astype(jnp.uint8),
        "nz4_cr": _nz_map(lv_cr, 4).astype(jnp.uint8),
    }
    arrs = [out[k] for k in EP_KEYS] + [
        cu_log2_8, jnp.zeros((nby, nbx), bool),
        jnp.zeros((nby, nbx, 2), jnp.int32), mode8]
    return _pack(arrs, jnp.int16)


# --------------------------------------------- device-resident fused encodes
#
# The _dev variants keep the reconstruction ON DEVICE: the packed download
# carries only levels / nz / decision maps / SAO parameters, and the
# returned recon planes (post-DLF, post-SAO, edge-padded) chain directly
# into the next picture's reference without any host round trip — the
# Device-resident form of the reference's in-flight reference objects
# (EbEncHandle.c:1645, PadRefAndSetFlags EbEncDecProcess.c:3107).

SAO_KEYS = ("sao_type", "sao_eo", "sao_bp", "sao_offs")


# sparse-download occupancy cap: nonzero 4x4 groups beyond this fraction
# of the plane trigger the full-plane fallback transfer (rare: typical P
# occupancy is < 10%, I < 60%; the cap trades worst-case double
# transfer for a 4x smaller common-case download)
COMPACT_CAP_FRAC = 4      # cap = n_groups // 4


def _compact4(lv, nz4):
    """(buf (cap, 16) int16, count int32): the nonzero 4x4 coefficient
    groups of `lv` compacted in scan order by an on-device prefix-sum
    scatter. Groups beyond `cap` are dropped (the caller detects
    count > cap and falls back to the full plane)."""
    hh, ww = lv.shape
    ng = (hh // 4) * (ww // 4)
    cap = max(ng // COMPACT_CAP_FRAC, 1)
    g = (lv.reshape(hh // 4, 4, ww // 4, 4).transpose(0, 2, 1, 3)
         .reshape(ng, 16).astype(jnp.int16))
    m = nz4.reshape(ng)
    idx = jnp.cumsum(m.astype(jnp.int32)) - 1
    dest = jnp.where(m & (idx < cap), idx, cap)
    buf = jnp.zeros((cap + 1, 16), jnp.int16).at[dest].set(g)
    return buf[:cap], m.astype(jnp.int32).sum()


def compact_specs(h64: int, w64: int):
    """Download layout of the compacted coefficient section."""
    cap_y = max((h64 // 4) * (w64 // 4) // COMPACT_CAP_FRAC, 1)
    cap_c = max((h64 // 8) * (w64 // 8) // COMPACT_CAP_FRAC, 1)
    return [("lvc_y", (cap_y, 16), np.int16),
            ("lvc_cb", (cap_c, 16), np.int16),
            ("lvc_cr", (cap_c, 16), np.int16),
            ("lv_counts", (3, 2), np.int32)]


def _cbf4_map(lv_y, tu_log2_8):
    """Per-4x4 luma cbf of the covering TU (deblocking bS input)."""
    out = None
    for lg in (3, 4, 5):
        n = 1 << lg
        anyn = _boxsum(jnp.abs(lv_y), n) > 0
        rep = jnp.repeat(jnp.repeat(anyn, n // 4, 0), n // 4, 1)
        m = jnp.repeat(jnp.repeat(tu_log2_8 == lg, 2, 0), 2, 1)
        out = jnp.where(m, rep, out if out is not None else False)
    return out.astype(jnp.int32)


def _edge_pad_to(rec, w: int, h: int):
    """Replicate the coded boundary into the 64-aligned pad region (the
    reference pads reference pictures, EbMcp.c GeneratePadding :1017)."""
    hh, ww = rec.shape
    iy = jnp.clip(jnp.arange(hh), 0, h - 1)
    ix = jnp.clip(jnp.arange(ww), 0, w - 1)
    return rec[iy][:, ix]


def _finish_fused(src3, rec3, lv3, cu_log2_8, inter8, mv8, tu8,
                  qp, qp_c, lam, ctb_log2: int, w: int, h: int,
                  bit_depth: int, dlf: bool, sao: bool,
                  refpoc8=None, mv8_2l=None):
    """Shared fused tail: cbf map -> DLF -> SAO decide + apply ->
    edge-pad, then pack everything the host needs (no recon planes).
    refpoc8/mv8_2l: two-list motion for the B-picture bS rule."""
    from .dlf import deblock_dev, derive_bs_maps
    from .sao import sao_apply_dev, sao_decide_dev

    src_y, src_cb, src_cr = src3
    rec_y, rec_cb, rec_cr = rec3
    lv_y, lv_cb, lv_cr = lv3
    h64, w64 = src_y.shape
    ctb = 1 << ctb_log2
    ny, nx = h64 // ctb, w64 // ctb

    if dlf:
        cbf4 = _cbf4_map(lv_y, tu8)
        bs_v, bs_ht = derive_bs_maps(cu_log2_8, inter8, mv8, cbf4, w, h,
                                     tu_log2_8=tu8, refpoc8=refpoc8,
                                     mv8_2l=mv8_2l)
        rec_y, rec_cb, rec_cr = deblock_dev(rec_y, rec_cb, rec_cr,
                                            bs_v, bs_ht, qp, qp_c,
                                            bit_depth=bit_depth)
    if sao:
        stats = []
        for comp, (rec, src) in enumerate(((rec_y, src_y), (rec_cb, src_cb),
                                           (rec_cr, src_cr))):
            cell = ctb if comp == 0 else ctb // 2
            hv = h if comp == 0 else h // 2
            wv = w if comp == 0 else w // 2
            hh, ww = rec.shape
            valid = ((jnp.arange(hh)[:, None] < hv)
                     & (jnp.arange(ww)[None, :] < wv)).astype(jnp.float32)
            stats.append(sao_stats_plane(rec, src, valid, cell, cell,
                                         bit_depth=bit_depth))
        params = sao_decide_dev(stats, lam, bit_depth=bit_depth)
        rec_y = sao_apply_dev(rec_y, params, 0, ctb, w, h,
                              bit_depth=bit_depth)
        rec_cb = sao_apply_dev(rec_cb, params, 1, ctb, w // 2, h // 2,
                               bit_depth=bit_depth)
        rec_cr = sao_apply_dev(rec_cr, params, 2, ctb, w // 2, h // 2,
                               bit_depth=bit_depth)
    else:
        params = {"type": jnp.zeros((ny, nx, 2), jnp.int32),
                  "eo": jnp.zeros((ny, nx, 2), jnp.int32),
                  "bp": jnp.zeros((ny, nx, 3), jnp.int32),
                  "offs": jnp.zeros((ny, nx, 3, 4), jnp.int32)}

    rec_y = _edge_pad_to(rec_y, w, h)
    rec_cb = _edge_pad_to(rec_cb, w // 2, h // 2)
    rec_cr = _edge_pad_to(rec_cr, w // 2, h // 2)

    # sparse coefficient download: most 4x4 groups are zero in inter
    # pictures — ship only the nonzero groups, compacted by an on-device
    # prefix-sum scatter, capped at COMPACT_CAP_FRAC of the plane (the
    # full planes remain available device-side as the overflow fallback;
    # see fast_path._build_maps)
    nz_y = _nz_map(lv_y, 4)
    nz_cb = _nz_map(lv_cb, 4)
    nz_cr = _nz_map(lv_cr, 4)
    buf_y, cnt_y = _compact4(lv_y, nz_y)
    buf_cb, cnt_cb = _compact4(lv_cb, nz_cb)
    buf_cr, cnt_cr = _compact4(lv_cr, nz_cr)
    cnts = jnp.stack([cnt_y, cnt_cb, cnt_cr])
    cnt_lo = cnts & 0x3FFF
    cnt_hi = cnts >> 14
    arrs = [buf_y, buf_cb, buf_cr,
            jnp.stack([cnt_lo, cnt_hi], -1).astype(jnp.int16),
            nz_y.astype(jnp.int16),
            nz_cb.astype(jnp.int16),
            nz_cr.astype(jnp.int16),
            params["type"], params["eo"], params["bp"], params["offs"]]
    return (_pack(arrs, jnp.int16), rec_y, rec_cb, rec_cr,
            (lv_y.astype(jnp.int16), lv_cb.astype(jnp.int16),
             lv_cr.astype(jnp.int16)))


def dec_specs(h64: int, w64: int):
    nby, nbx = h64 // 8, w64 // 8
    return [("cu_log2_8", (nby, nbx), np.int32),
            ("inter8", (nby, nbx), bool),
            ("mv8", (nby, nbx, 2), np.int32),
            ("intra_mode8", (nby, nbx), np.int32),
            ("tu_log2_8", (nby, nbx), np.int32)]


def finish_specs(h64: int, w64: int, ctb: int):
    ny, nx = h64 // ctb, w64 // ctb
    return compact_specs(h64, w64) + [
            ("nz4_y", (h64 // 4, w64 // 4), bool),
            ("nz4_cb", (h64 // 8, w64 // 8), bool),
            ("nz4_cr", (h64 // 8, w64 // 8), bool),
            ("sao_type", (ny, nx, 2), np.int32),
            ("sao_eo", (ny, nx, 2), np.int32),
            ("sao_bp", (ny, nx, 3), np.int32),
            ("sao_offs", (ny, nx, 3, 4), np.int32)]


def fused_dev_specs(h64: int, w64: int, ctb: int):
    return dec_specs(h64, w64) + finish_specs(h64, w64, ctb)


# the P fast path offers intra only at 16/32 (reference analogue: CU-8x8
# gating at fast presets, EbPictureDecisionProcess.c:425-449); this also
# quarters the intra-fixup wavefront's scan length
P_MIN_INTRA_LOG2 = 4

# extra lambda weight on the INTER residual zero-out: biases P pictures
# toward skip/coasting like the reference's RD (whose CABAC-accurate
# coefficient rate estimates make scattered residual far more expensive
# than a simple proxy suggests); calibrated by BD-rate sweep vs the
# reference encoder at M7
INTER_ZERO_LAMBDA_SCALE = 1.5

# inter-slice MD lambda weight over the I-slice SSE base (see
# decide_tree_dev; calibrated by BD-rate sweep vs the reference at M7)
P_LAMBDA_SCALE = 1.5

# stage-2 bias (in bits, lambda-scaled) toward the merge-class candidate
# when the true-RD costs are close: the reference's MD candidate ordering
# + NFL pruning effectively applies the same preference (measured: its
# CIF IPPP streams carry ~2 MVD CUs per frame). Env-overridable for BD
# calibration sweeps (tools/bd_sweep.py); the default IS the calibration.
import os as _os

MERGE_BIAS_BITS = float(_os.environ.get("SVT_MERGE_BIAS", "8.0"))

# signalling charge of the AMVP-coded (non-merge) candidate on top of
# its MVD bits: merge_flag + pred_idc + ref_idx + mvp_flag bins
AMVP_BASE_BITS = int(_os.environ.get("SVT_AMVP_BITS", "4"))

# merge-index charge of the TMVP (collocated) candidate
TMVP_BITS = int(_os.environ.get("SVT_TMVP_BITS", "5"))

# MV-rate weight inside the dense search (integer units of the SAD
# lambda; calibrated by BD sweep)
ME_LAMBDA_SCALE = int(_os.environ.get("SVT_ME_LAMBDA", "1"))

# merge-snap preference (bits, SATD-lambda-scaled): a decided MV snaps
# to a real merge candidate whose cost is within this margin
SNAP_BIAS_BITS = int(_os.environ.get("SVT_SNAP_BIAS", "4"))
# 3 passes: BD-rate vs reference M7 CIF +35.1% (1 pass +46.4, 5 +31.0,
# converges ~+30 at 8) at ~6%/pass fps cost — the knee of the curve
SNAP_PASSES = int(_os.environ.get("SVT_SNAP_PASSES", "3"))


def merge_snap(src, ref_ext4, mv8, inter8, cu_log2_8, qp,
               col16_mv, col16_valid, tb, td,
               ctb_log2: int, w: int, h: int, bit_depth: int = 8):
    """Post-decision merge alignment pass.

    The decision stage ranks merge-class candidates drawn from the ME
    winner field, but the emit walk (pipeline/fast_path._compute_plan)
    codes a CU as merge ONLY when its decided MV exactly equals a
    candidate of the REAL merge list — which is built from the DECIDED
    field at the spec positions (A1/B1/..., 8.5.3.2.3). A decided MV
    that is merely close therefore falls back to AMVP + MVD: measured
    at CIF M7, ~940 MVD CUs per 24 frames vs the reference's ~55 — MV
    bits were 28% of the stream (the round-4 "merge chain breaks").

    This pass re-reads the DECIDED field, derives each leaf CU's A1
    (left, bottom) / B1 (top, right) / TMVP candidates exactly where the
    merge list will look, and snaps the CU's MV to the best candidate
    when its SATD cost is within SNAP_BIAS_BITS of the decided MV's
    AMVP-priced cost. Snapped CUs then hit the merge (often skip) path
    at emit time. (Reference analogue: merge candidates ranked inside
    MD against real lists, EbModeDecision.c:1608.)"""
    srcf = src.astype(jnp.int32)
    lam = 2 * jnp.asarray(LAMBDA_SAD)[qp]      # SATD-domain lambda
    lim_q = (PAD - 9) * 4
    nby, nbx = inter8.shape
    out = mv8
    col16 = None
    if col16_mv is not None:
        col16 = _scale_mv_dev(col16_mv.astype(jnp.int32), tb, td)
    # the decided field is uniform within each CU, so ONE full-field
    # prediction serves every size's d_dec via boxsum
    satd8_dec = _satd8_map(srcf - _mc_luma(ref_ext4, mv8, bit_depth,
                                           True))
    for s in (8, 16, 32, 64):
        if (1 << ctb_log2) < s:
            continue
        k = s // 8
        lg = s.bit_length() - 1
        gy, gx = nby // k, nbx // k
        leaf = (cu_log2_8[::k, ::k] == lg) & inter8[::k, ::k]
        mv_cu = mv8[::k, ::k]

        def upg(m):
            return jnp.repeat(jnp.repeat(m, k, 0), k, 1)

        def pred_of(mv_c):
            mvf = jnp.stack([upg(mv_c[..., 0]), upg(mv_c[..., 1])], -1)
            return _mc_luma(ref_ext4, mvf, bit_depth, True)

        def satd_of(p):
            return _boxsum(_satd8_map(srcf - p), k)

        # spec merge positions in the decided 8-grid: A1 = block left of
        # the CU's bottom-left corner; B1 = block above the top-right
        rA1 = jnp.arange(gy) * k + (k - 1)
        cA1 = jnp.arange(gx) * k - 1
        rB1 = jnp.arange(gy) * k - 1
        cB1 = jnp.arange(gx) * k + (k - 1)
        vA1 = ((cA1 >= 0)[None, :]
               & inter8[rA1[:, None], jnp.maximum(cA1, 0)[None, :]])
        mvA1 = mv8[rA1[:, None], jnp.maximum(cA1, 0)[None, :]]
        vB1 = ((rB1 >= 0)[:, None]
               & inter8[jnp.maximum(rB1, 0)[:, None], cB1[None, :]])
        mvB1 = mv8[jnp.maximum(rB1, 0)[:, None], cB1[None, :]]
        cands = [(mvA1, vA1, 2), (mvB1, vB1, 3)]
        if col16 is not None:
            mv_t, v_t = _tmvp_candidate(col16, col16_valid, s,
                                        (gy, gx), ctb_log2, w, h)
            cands.append((jnp.clip(mv_t, -lim_q, lim_q), v_t, 5))

        # decided-MV cost at AMVP pricing (MVD vs the A1 predictor, the
        # emit walk's first AMVP candidate in the common case)
        d_dec = _boxsum(satd8_dec, k)
        bits_dec = (_mvd_bits_dev(mv_cu[..., 0] - mvA1[..., 0])
                    + _mvd_bits_dev(mv_cu[..., 1] - mvA1[..., 1])
                    + AMVP_BASE_BITS)
        j_dec = d_dec + lam * bits_dec
        best_j = jnp.full((gy, gx), 1 << 30, jnp.int32)
        best_mv = mv_cu
        already = jnp.zeros((gy, gx), bool)
        for mv_c, v_c, bits_c in cands:
            same = (mv_c == mv_cu).all(-1) & v_c
            already = already | same
            j_c = jnp.where(v_c, satd_of(pred_of(mv_c)) + lam * bits_c,
                            1 << 30)
            take = j_c < best_j
            best_j = jnp.where(take, j_c, best_j)
            best_mv = jnp.where(take[..., None], mv_c, best_mv)
        # snap when a real candidate is within the preference margin and
        # the decided MV is not already one of them (already-matching
        # CUs merge for free at emit time)
        snap = (leaf & ~already
                & (best_j <= j_dec + lam * SNAP_BIAS_BITS))
        new_cu = jnp.where(snap[..., None], best_mv, mv_cu)
        leaf_up = upg(leaf & snap)
        out = jnp.where(leaf_up[..., None], upg_mv(new_cu, k), out)
    return out


def upg_mv(m, k: int):
    return jnp.repeat(jnp.repeat(m, k, 0), k, 1)


def merge_snap_b(src, ext0, ext1, mv8_2l, ref8_2l, cu_log2_8, qp,
                 ctb_log2: int, w: int, h: int, bit_depth: int = 8):
    """Two-list merge alignment for B pictures (see merge_snap): a B
    CU merges only when its ENTIRE motion info — both lists' use flags
    and MVs — equals a real merge candidate's, so the snap adopts the
    neighbor's full Mi (uni-L0 / uni-L1 / bi) at the A1/B1 positions.
    Returns (mv8_2l, ref8_2l) with snapped fields."""
    srcf = src.astype(jnp.int32)
    lam = 2 * jnp.asarray(LAMBDA_SAD)[qp]
    maxval = (1 << bit_depth) - 1
    s_u = 14 - bit_depth
    s_b = 15 - bit_depth
    nby, nbx = cu_log2_8.shape
    inter_any = (ref8_2l >= 0).any(0)

    def field_pred(mv2, use0, use1):
        """Rounded prediction of the full 8-grid field with per-block
        uni/bi selection (luma only — the snap metric)."""
        a = _mc_luma(ext0, mv2[0], bit_depth, False)
        b = _mc_luma(ext1, mv2[1], bit_depth, False)
        m0 = jnp.repeat(jnp.repeat(use0, 8, 0), 8, 1)
        m1 = jnp.repeat(jnp.repeat(use1, 8, 0), 8, 1)
        uni0 = (a + (1 << (s_u - 1))) >> s_u
        uni1 = (b + (1 << (s_u - 1))) >> s_u
        bi = (a + b + (1 << (s_b - 1))) >> s_b
        out = jnp.where(m0 & m1, bi, jnp.where(m1, uni1, uni0))
        return jnp.clip(out, 0, maxval)

    u0_f = ref8_2l[0] >= 0
    u1_f = ref8_2l[1] >= 0
    satd8_dec = _satd8_map(srcf - field_pred(mv8_2l, u0_f, u1_f))

    out_mv = mv8_2l
    out_ref = ref8_2l
    for s in (8, 16, 32, 64):
        if (1 << ctb_log2) < s:
            continue
        k = s // 8
        lg = s.bit_length() - 1
        gy, gx = nby // k, nbx // k
        leaf = (cu_log2_8[::k, ::k] == lg) & inter_any[::k, ::k]
        mv_cu = mv8_2l[:, ::k, ::k]
        u_cu = jnp.stack([u0_f[::k, ::k], u1_f[::k, ::k]])

        rA1 = jnp.arange(gy) * k + (k - 1)
        cA1 = jnp.arange(gx) * k - 1
        rB1 = jnp.arange(gy) * k - 1
        cB1 = jnp.arange(gx) * k + (k - 1)

        def nb(rr, cc, ok):
            rr_ = jnp.maximum(rr, 0)
            cc_ = jnp.maximum(cc, 0)
            mvn = mv8_2l[:, rr_[:, None], cc_[None, :]]
            un = jnp.stack([u0_f[rr_[:, None], cc_[None, :]],
                            u1_f[rr_[:, None], cc_[None, :]]])
            vn = ok & inter_any[rr_[:, None], cc_[None, :]]
            return mvn, un, vn

        candA = nb(rA1, cA1, (cA1 >= 0)[None, :])
        candB = nb(rB1, cB1, (rB1 >= 0)[:, None])

        def upg2(m):
            return jnp.repeat(jnp.repeat(m, k, 0), k, 1)

        d_dec = _boxsum(satd8_dec, k)
        # decided Mi at AMVP pricing: per used list, MVD vs the A1 MV
        mvA = candA[0]
        bits_dec = jnp.zeros((gy, gx), jnp.int32) + AMVP_BASE_BITS
        for li in range(2):
            bl = (_mvd_bits_dev(mv_cu[li, ..., 0] - mvA[li, ..., 0])
                  + _mvd_bits_dev(mv_cu[li, ..., 1] - mvA[li, ..., 1]))
            bits_dec = bits_dec + jnp.where(u_cu[li], bl, 0)
        j_dec = d_dec + lam * bits_dec

        best_j = jnp.full((gy, gx), 1 << 30, jnp.int32)
        best_mv = mv_cu
        best_u = u_cu
        already = jnp.zeros((gy, gx), bool)
        for (mvn, un, vn), bits_c in ((candA, 2), (candB, 3)):
            same = ((mvn == mv_cu).all(0).all(-1)
                    & (un == u_cu).all(0) & vn)
            already = already | same
            pred_c = field_pred(
                jnp.stack([jnp.stack([upg2(mvn[li, ..., 0]),
                                      upg2(mvn[li, ..., 1])], -1)
                           for li in range(2)]),
                upg2(un[0]), upg2(un[1]))
            d_c = _boxsum(_satd8_map(srcf - pred_c), k)
            j_c = jnp.where(vn, d_c + lam * bits_c, 1 << 30)
            take = j_c < best_j
            best_j = jnp.where(take, j_c, best_j)
            best_mv = jnp.where(take[None, ..., None], mvn, best_mv)
            best_u = jnp.where(take[None], un, best_u)
        snap = (leaf & ~already
                & (best_j <= j_dec + lam * SNAP_BIAS_BITS))
        sn_up = upg2(leaf & snap)
        new_mv = jnp.where(snap[None, ..., None], best_mv, mv_cu)
        new_u = jnp.where(snap[None], best_u, u_cu)
        out_mv = jnp.where(sn_up[None, ..., None],
                           jnp.stack([upg_mv(new_mv[0], k),
                                      upg_mv(new_mv[1], k)]), out_mv)
        new_ref = jnp.stack([jnp.where(new_u[0], 0, -1),
                             jnp.where(new_u[1], 0, -1)])
        out_ref = jnp.where(sn_up[None],
                            jnp.stack([upg2(new_ref[0]),
                                       upg2(new_ref[1])]), out_ref)
    return out_mv, out_ref


@functools.partial(jax.jit, static_argnames=("ctb_log2", "bit_depth",
                                             "w", "h", "min_intra_log2",
                                             "subpel_min"))
def _fast_p_front(src_y, ref_y, hme_mv, qp, col16_mv, col16_valid,
                  tb, td, ctb_log2: int, w: int, h: int,
                  bit_depth: int = 8,
                  min_intra_log2: int = P_MIN_INTRA_LOG2,
                  subpel_min: int = 16):
    """P-picture front half: dense MD + OIS + quadtree decision.
    Outputs only the small decision maps; chained on-device into
    _fast_p_finish."""
    from .analysis import intra_search_size

    md = dense_md_p(src_y, ref_y, None, hme_mv, bit_depth=bit_depth,
                    qp=qp, subpel_min=subpel_min)
    yf = src_y.astype(jnp.float32)
    ois = {}
    for n in (16, 32):
        mode, cost = intra_search_size(yf, n)
        ois[n] = (mode.astype(jnp.int32), jnp.round(cost).astype(jnp.int32))
    cu_log2_8, inter8, mv8, mode8 = decide_tree_dev(
        md, ois, ctb_log2, min_intra_log2=min_intra_log2, w=w, h=h,
        qp=qp, src=src_y, ref=ref_y,
        bit_depth=bit_depth,
        col_mv8=col16_mv, col_valid8=col16_valid, tb=tb, td=td)
    # align the decided field with the REAL merge lists the emit walk
    # will build from it (see merge_snap); a second pass re-reads the
    # once-snapped field, letting merges chain through neighbors that
    # themselves just snapped
    ext4 = _ext_y(ref_y)
    for _ in range(SNAP_PASSES):
        mv8 = merge_snap(src_y, ext4, mv8, inter8, cu_log2_8, qp,
                         col16_mv, col16_valid, tb, td,
                         ctb_log2=ctb_log2, w=w, h=h,
                         bit_depth=bit_depth)
    return cu_log2_8, inter8, mv8, mode8


def fast_p_fused_dev(src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr,
                     hme_mv, qp, qp_c, lam, col16_mv, col16_valid, tb, td,
                     ctb_log2: int,
                     w: int, h: int, bit_depth: int = 8,
                     dlf: bool = True, sao: bool = True,
                     min_intra_log2: int = P_MIN_INTRA_LOG2,
                     subpel_min: int = 16):
    """Device-resident P-picture pipeline as two jitted halves chained
    on device (front: dense MD + OIS + decision; finish: inter encode
    pass, intra-fixup wavefront behind a runtime lax.cond, DLF + SAO,
    pack). Split like the B path: one mega-program compiles slower; the
    halves cache and execute independently.
    One packed download (decisions + levels + SAO params); recon stays
    device-resident.

    col16_mv/col16_valid: the collocated (L0 reference) picture's
    16x16-compressed decided motion — device-resident, chained from the
    previous call's outputs — feeding the TMVP merge candidate of the
    dense decision; tb/td: POC distances for its scaling. Returns
    (packed, rec_y, rec_cb, rec_cr, col16_mv_out, col16_valid_out)."""
    cu_log2_8, inter8, mv8, mode8 = _fast_p_front(
        src_y, ref_y, hme_mv, qp, col16_mv, col16_valid, tb, td,
        ctb_log2=ctb_log2, w=w, h=h, bit_depth=bit_depth,
        min_intra_log2=min_intra_log2, subpel_min=subpel_min)
    return _fast_p_finish(
        src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr,
        cu_log2_8, inter8, mv8, mode8, qp, qp_c, lam,
        ctb_log2=ctb_log2, w=w, h=h, bit_depth=bit_depth, dlf=dlf,
        sao=sao, min_intra_log2=min_intra_log2)


@functools.partial(jax.jit, static_argnames=("ctb_log2", "bit_depth",
                                             "w", "h", "dlf", "sao",
                                             "min_intra_log2"))
def _fast_p_finish(src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr,
                   cu_log2_8, inter8, mv8, mode8, qp, qp_c, lam,
                   ctb_log2: int, w: int, h: int, bit_depth: int = 8,
                   dlf: bool = True, sao: bool = True,
                   min_intra_log2: int = P_MIN_INTRA_LOG2):
    """P-picture finish half: encode pass + intra fixup + DLF/SAO +
    pack (see fast_p_fused_dev)."""
    from .intra_pass import intra_wavefront_pass

    tu_log2 = jnp.minimum(cu_log2_8, 5)
    out = encode_pass_p_direct(src_y, src_cb, src_cr,
                               ref_y, ref_cb, ref_cr,
                               mv8, inter8, tu_log2, qp, qp_c,
                               bit_depth=bit_depth,
                               lam=lam * INTER_ZERO_LAMBDA_SCALE,
                               tu_split=True, cu_log2_8=cu_log2_8)
    tu8 = out["tu8"]
    rec3 = (out["rec_y"].astype(jnp.int32), out["rec_cb"].astype(jnp.int32),
            out["rec_cr"].astype(jnp.int32))
    lv3 = (out["lv_y"].astype(jnp.int32), out["lv_cb"].astype(jnp.int32),
           out["lv_cr"].astype(jnp.int32))

    nby, nbx = cu_log2_8.shape
    if min_intra_log2 >= 6:
        # intra disabled in inter pictures at this preset (the DP never
        # offered it): the wavefront branch is not even built — its
        # compile cost is the largest part of the P graph
        pass
    else:
        inpic = ((jnp.arange(nbx) * 8 < w)[None, :]
                 & (jnp.arange(nby) * 8 < h)[:, None])
        any_intra = (~inter8 & inpic).any()

        def run_wavefront(args):
            r3, l3, m8 = args
            out7 = intra_wavefront_pass(
                src_y, src_cb, src_cr, *r3, *l3, cu_log2_8, m8, ~inter8,
                qp, qp_c, w=w, h=h, bit_depth=bit_depth,
                ctb_log2=ctb_log2, min_cu_log2=min_intra_log2, lam=lam,
                refine_modes=True)
            return out7[:3], out7[3:6], out7[6]

        rec3, lv3, mode8 = jax.lax.cond(any_intra, run_wavefront,
                                        lambda a: a, (rec3, lv3, mode8))

    packed_fin, rec_y, rec_cb, rec_cr, lv_full = _finish_fused(
        (src_y, src_cb, src_cr), rec3, lv3,
        cu_log2_8, inter8, mv8, tu8, qp, qp_c, lam,
        ctb_log2, w, h, bit_depth, dlf, sao)
    packed = jnp.concatenate(
        [_pack([cu_log2_8, inter8, mv8, mode8, tu8], jnp.int16),
         packed_fin])
    # this picture's decided motion, 16x16-compressed, stays on device
    # as the next picture's TMVP collocated source; lv_full: the full
    # coefficient planes, device-resident, materialized only on
    # compaction overflow
    return (packed, rec_y, rec_cb, rec_cr,
            mv8[::2, ::2], inter8[::2, ::2], lv_full)


@functools.partial(jax.jit, static_argnames=("ctb_log2", "bit_depth",
                                             "w", "h", "min_intra_log2",
                                             "subpel_min"))
def _fast_b_front(src_y, src_cb, src_cr,
                  ref0_y, ref0_cb, ref0_cr,
                  ref1_y, ref1_cb, ref1_cr,
                  hme_mv0, hme_mv1, qp, qp_c, lam, ctb_log2: int,
                  w: int, h: int, bit_depth: int = 8,
                  min_intra_log2: int = P_MIN_INTRA_LOG2,
                  subpel_min: int = 16):
    """B-picture front half: phase planes for both lists, dense MD per
    list + bi combination, quadtree decision, B encode pass, intra-fixup
    wavefront behind a runtime cond."""
    from .analysis import intra_search_size
    from .intra_pass import intra_wavefront_pass

    md0 = dense_md_p(src_y, ref0_y, None, hme_mv0, bit_depth=bit_depth,
                     qp=qp, subpel_min=subpel_min)
    md1 = dense_md_p(src_y, ref1_y, None, hme_mv1, bit_depth=bit_depth,
                     qp=qp, subpel_min=subpel_min)
    yf = src_y.astype(jnp.float32)
    ois = {}
    for n in (16, 32):
        mode, cost = intra_search_size(yf, n)
        ois[n] = (mode.astype(jnp.int32), jnp.round(cost).astype(jnp.int32))
    cu_log2_8, ref8_2l, mv8_2l, mode8 = decide_tree_b_dev(
        md0, md1, ois, ctb_log2, src_y, ref0_y, ref1_y,
        min_intra_log2=min_intra_log2, w=w, h=h, qp=qp,
        bit_depth=bit_depth)
    # align the decided two-list field with the real merge lists (see
    # merge_snap_b)
    ext0 = _ext_y(ref0_y)
    ext1 = _ext_y(ref1_y)
    for _ in range(SNAP_PASSES):
        mv8_2l, ref8_2l = merge_snap_b(
            src_y, ext0, ext1, mv8_2l, ref8_2l, cu_log2_8, qp,
            ctb_log2=ctb_log2, w=w, h=h, bit_depth=bit_depth)
    inter8 = (ref8_2l >= 0).any(0)
    tu_log2 = jnp.minimum(cu_log2_8, 5)
    out = encode_pass_b_direct(src_y, src_cb, src_cr,
                               (ref0_y, ref0_cb, ref0_cr),
                               (ref1_y, ref1_cb, ref1_cr),
                               mv8_2l, ref8_2l, tu_log2, qp, qp_c,
                               bit_depth=bit_depth,
                               lam=lam * INTER_ZERO_LAMBDA_SCALE,
                               tu_split=True, cu_log2_8=cu_log2_8)
    tu8 = out["tu8"]
    rec3 = (out["rec_y"].astype(jnp.int32), out["rec_cb"].astype(jnp.int32),
            out["rec_cr"].astype(jnp.int32))
    lv3 = (out["lv_y"].astype(jnp.int32), out["lv_cb"].astype(jnp.int32),
           out["lv_cr"].astype(jnp.int32))

    nby, nbx = cu_log2_8.shape
    if min_intra_log2 >= 6:
        pass          # intra disabled at this preset: no wavefront built
    else:
        inpic = ((jnp.arange(nbx) * 8 < w)[None, :]
                 & (jnp.arange(nby) * 8 < h)[:, None])
        any_intra = (~inter8 & inpic).any()

        def run_wavefront(args):
            r3, l3, m8 = args
            out7 = intra_wavefront_pass(
                src_y, src_cb, src_cr, *r3, *l3, cu_log2_8, m8, ~inter8,
                qp, qp_c, w=w, h=h, bit_depth=bit_depth,
                ctb_log2=ctb_log2, min_cu_log2=min_intra_log2, lam=lam,
                refine_modes=True)
            return out7[:3], out7[3:6], out7[6]

        rec3, lv3, mode8 = jax.lax.cond(any_intra, run_wavefront,
                                        lambda a: a, (rec3, lv3, mode8))
    return cu_log2_8, ref8_2l, mv8_2l, mode8, tu8, rec3, lv3


@functools.partial(jax.jit, static_argnames=("ctb_log2", "bit_depth",
                                             "w", "h", "dlf", "sao"))
def _fast_b_finish(src_y, src_cb, src_cr, cu_log2_8, ref8_2l, mv8_2l,
                   mode8, tu8, rec3, lv3, poc_delta0, poc_delta1,
                   qp, qp_c, lam, ctb_log2: int, w: int, h: int,
                   bit_depth: int = 8, dlf: bool = True, sao: bool = True):
    """B-picture finish half: DLF (two-list bS rule) + SAO + pack."""
    inter8 = (ref8_2l >= 0).any(0)
    # per-list reference POCs for the bS rule (sentinel where unused);
    # the absolute scale cancels — only equality/min/max matter, so
    # cur POC = 0 and deltas suffice
    sent = jnp.int32(-(10 ** 6))
    refpoc8 = jnp.stack([
        jnp.where(ref8_2l[0] >= 0, poc_delta0, sent),
        jnp.where(ref8_2l[1] >= 0, poc_delta1, sent)])
    packed_fin, rec_y, rec_cb, rec_cr, lv_full = _finish_fused(
        (src_y, src_cb, src_cr), rec3, lv3,
        cu_log2_8, inter8, mv8_2l[0], tu8, qp, qp_c, lam,
        ctb_log2, w, h, bit_depth, dlf, sao,
        refpoc8=refpoc8, mv8_2l=mv8_2l)
    packed = jnp.concatenate(
        [_pack([cu_log2_8, ref8_2l, mv8_2l, mode8, tu8], jnp.int16),
         packed_fin])
    return packed, rec_y, rec_cb, rec_cr, lv_full


def fast_b_fused_dev(src_y, src_cb, src_cr,
                     ref0_y, ref0_cb, ref0_cr,
                     ref1_y, ref1_cb, ref1_cr,
                     hme_mv0, hme_mv1, poc_delta0, poc_delta1,
                     qp, qp_c, lam, ctb_log2: int,
                     w: int, h: int, bit_depth: int = 8,
                     dlf: bool = True, sao: bool = True,
                     min_intra_log2: int = P_MIN_INTRA_LOG2,
                     subpel_min: int = 16):
    """Device-resident B-picture pipeline: two jitted halves chained on
    device (front: phases/MD/decision/encode/wavefront; finish: DLF with
    the two-list bS rule + SAO + pack). Split into two executables
    because XLA:CPU mis-dispatches repeat invocations of the single
    fused form (constant-hoisting buffer mismatch); the split also lets
    the halves' compilations cache independently. Reference analogue:
    the B-slice MD/encode path (EbModeDecision.c :926,
    EbMotionEstimation.c EbHevcBiPredictionSearch :2870)."""
    cu_log2_8, ref8_2l, mv8_2l, mode8, tu8, rec3, lv3 = _fast_b_front(
        src_y, src_cb, src_cr, ref0_y, ref0_cb, ref0_cr,
        ref1_y, ref1_cb, ref1_cr, hme_mv0, hme_mv1, qp, qp_c, lam,
        ctb_log2=ctb_log2, w=w, h=h, bit_depth=bit_depth,
        min_intra_log2=min_intra_log2, subpel_min=subpel_min)
    packed, rec_y, rec_cb, rec_cr, lv_full = _fast_b_finish(
        src_y, src_cb, src_cr, cu_log2_8, ref8_2l, mv8_2l, mode8, tu8,
        rec3, lv3, poc_delta0, poc_delta1, qp, qp_c, lam,
        ctb_log2=ctb_log2, w=w, h=h, bit_depth=bit_depth, dlf=dlf,
        sao=sao)
    # 16x16-compressed decided motion (L0-preferred, like the TMVP list
    # choice for forward prediction) for future collocated use
    use0 = ref8_2l[0] >= 0
    col_mv = jnp.where(use0[..., None], mv8_2l[0], mv8_2l[1])
    col_valid = use0 | (ref8_2l[1] >= 0)
    return (packed, rec_y, rec_cb, rec_cr,
            col_mv[::2, ::2], col_valid[::2, ::2], lv_full)


def b_dec_specs(h64: int, w64: int):
    nby, nbx = h64 // 8, w64 // 8
    return [("cu_log2_8", (nby, nbx), np.int32),
            ("ref8", (2, nby, nbx), np.int32),
            ("mv8_2l", (2, nby, nbx, 2), np.int32),
            ("intra_mode8", (nby, nbx), np.int32),
            ("tu_log2_8", (nby, nbx), np.int32)]


def fused_b_dev_specs(h64: int, w64: int, ctb: int):
    return b_dec_specs(h64, w64) + finish_specs(h64, w64, ctb)


@functools.partial(jax.jit, static_argnames=("ctb_log2", "bit_depth",
                                             "w", "h", "dlf", "sao",
                                             "refine_modes"))
def fast_i_fused_dev(src_y, src_cb, src_cr, qp, qp_c, lam, ctb_log2: int,
                     w: int, h: int, bit_depth: int = 8,
                     dlf: bool = True, sao: bool = True,
                     refine_modes: bool = True):
    """Device-resident I-picture pipeline: OIS -> decision -> wavefront
    closed-loop encode -> DLF -> SAO, one graph, one small download
    (decision maps + levels + SAO params)."""
    from .analysis import intra_search_size_pred
    from .intra_pass import intra_wavefront_pass

    yf = src_y.astype(jnp.float32)
    ois, preds = {}, {}
    for n in (8, 16, 32):
        mode, cost, pred = intra_search_size_pred(yf, n, bit_depth)
        ois[n] = (mode.astype(jnp.int32), jnp.round(cost).astype(jnp.int32))
        preds[n] = pred
    cu_log2_8, mode8 = decide_tree_i_dev(ois, qp, ctb_log2, w, h,
                                         src=src_y.astype(jnp.int32),
                                         preds=preds, bit_depth=bit_depth)
    h64, w64 = src_y.shape
    zy = jnp.zeros((h64, w64), jnp.int32)
    zc = jnp.zeros((h64 // 2, w64 // 2), jnp.int32)
    nby, nbx = h64 // 8, w64 // 8
    rec_y, rec_cb, rec_cr, lv_y, lv_cb, lv_cr, mode8 = \
        intra_wavefront_pass(
            src_y, src_cb, src_cr, zy, zc, zc, zy, zc, zc,
            cu_log2_8, mode8, jnp.ones((nby, nbx), bool),
            qp, qp_c, w=w, h=h, bit_depth=bit_depth, ctb_log2=ctb_log2,
            lam=lam, refine_modes=refine_modes)
    inter8 = jnp.zeros((nby, nbx), bool)
    mv8 = jnp.zeros((nby, nbx, 2), jnp.int32)
    tu8 = jnp.minimum(cu_log2_8, 5)
    packed_fin, rec_y, rec_cb, rec_cr, lv_full = _finish_fused(
        (src_y, src_cb, src_cr), (rec_y, rec_cb, rec_cr),
        (lv_y, lv_cb, lv_cr), cu_log2_8, inter8, mv8, tu8, qp, qp_c, lam,
        ctb_log2, w, h, bit_depth, dlf, sao)
    packed = jnp.concatenate(
        [_pack([cu_log2_8, inter8, mv8, mode8, tu8], jnp.int16),
         packed_fin])
    # an intra picture contributes no collocated motion
    return (packed, rec_y, rec_cb, rec_cr,
            mv8[::2, ::2], inter8[::2, ::2], lv_full)


# ----------------------------------------------------------------- SAO stats

@functools.partial(jax.jit, static_argnames=("ctb_y", "ctb_x", "bit_depth"))
def sao_stats_plane(pre: jnp.ndarray, src: jnp.ndarray, valid: jnp.ndarray,
                    ctb_y: int, ctb_x: int, bit_depth: int = 8) -> dict:
    """Per-CTB SAO statistics for one plane, fully batched (the
    reference gathers these per LCU in the encode pass,
    EbSampleAdaptiveOffsetGenerationDecision.c:647).

    pre: post-DLF reconstruction padded to CTB multiples; src: source
    (same shape); valid: 1.0 inside the coded picture, 0 in the pad.
    Returns eo_cnt/eo_sum (ny, nx, 4, 5) and bo_cnt/bo_sum (ny, nx, 32).
    Category/band maps match core.sao._eo_category_map/_band_map."""
    h, w = pre.shape
    ny, nx = h // ctb_y, w // ctb_x
    diff = (src - pre).astype(jnp.float32) * valid

    def ctb_sum(m):
        return m.reshape(ny, ctb_y, nx, ctb_x).sum((1, 3))

    p = pre.astype(jnp.int32)
    pad = jnp.pad(p, 1, mode="edge")

    neigh = (((-1, 0), (1, 0)), ((0, -1), (0, 1)),
             ((-1, -1), (1, 1)), ((1, -1), (-1, 1)))
    eo_cnt, eo_sum = [], []
    for ec, ((ax, ay), (bx, by)) in enumerate(neigh):
        na = pad[1 + ay:h + 1 + ay, 1 + ax:w + 1 + ax]
        nb = pad[1 + by:h + 1 + by, 1 + bx:w + 1 + bx]
        edge = 2 + jnp.sign(p - na) + jnp.sign(p - nb)
        cat = jnp.asarray([1, 2, 0, 3, 4])[edge]
        ok = valid
        horiz = ax != 0 or bx != 0
        vert = ay != 0 or by != 0
        border = jnp.zeros((h, w), bool)
        if horiz:
            border = border.at[:, 0].set(True).at[:, w - 1].set(True)
        if vert:
            border = border.at[0, :].set(True).at[h - 1, :].set(True)
        ok = ok * (1.0 - border.astype(jnp.float32))
        cnts, sums = [], []
        for k in range(5):
            m = (cat == k).astype(jnp.float32) * ok
            cnts.append(ctb_sum(m))
            sums.append(ctb_sum(diff * m * (ok > 0)))
        eo_cnt.append(jnp.stack(cnts, -1))
        eo_sum.append(jnp.stack(sums, -1))

    band = p >> (bit_depth - 5)
    bo_cnt, bo_sum = [], []
    for b in range(32):
        m = (band == b).astype(jnp.float32) * valid
        bo_cnt.append(ctb_sum(m))
        bo_sum.append(ctb_sum(diff * m))
    return {
        "eo_cnt": jnp.stack(eo_cnt, -2).astype(jnp.int32),
        "eo_sum": jnp.stack(eo_sum, -2).astype(jnp.int32),
        "bo_cnt": jnp.stack(bo_cnt, -1).astype(jnp.int32),
        "bo_sum": jnp.stack(bo_sum, -1).astype(jnp.int32),
    }
