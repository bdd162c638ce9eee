"""Device SAO: per-CTB statistics -> decision -> picture apply, all on device.

Device mirror of core/sao.py's stats-based decision
(derive_sao_params_from_stats) and vectorized apply (apply_sao), so the
fast path's post-DLF reconstruction never leaves the device: the fused
graph gathers stats (tpu.encode.sao_stats_plane), picks per-CTB
type/class/offsets with the same math (offsets and gains in int32, one
float32 rounding per score, see core.sao.rate_lambda — so every backend
decides alike), applies the offsets, and hands the host only the tiny
parameter grids for syntax emission (encode_sao_ctb). The reference
decides per-LCU in the encode pass and applies once per picture
(EbSampleAdaptiveOffsetGenerationDecision.c :647, ApplySaoOffsetsPicture
via EbEncDecProcess.c :3087).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

SAO_OFF, SAO_BAND, SAO_EDGE = 0, 1, 2

_EO_CAT_LUT = np.array([1, 2, 0, 3, 4], np.int32)
_EO_NEIGHBORS = (((-1, 0), (1, 0)), ((0, -1), (0, 1)),
                 ((-1, -1), (1, 1)), ((1, -1), (-1, 1)))


def _round_div(s, c):
    """Round-half-even of s / c for int32 s and c > 0, in integers (the
    numpy mirror's np.round of the exact quotient)."""
    q = jnp.floor_divide(s, c)
    r2 = 2 * (s - q * c)
    return q + ((r2 > c) | ((r2 == c) & (q % 2 == 1))).astype(jnp.int32)


def _eo_offsets_gains(eo_cnt, eo_sum, mx: int):
    """(offs (ny,nx,4cls,4), gain (ny,nx,4cls) int32) — jax mirror of
    core.sao._eo_offsets_gains."""
    c = eo_cnt[..., 1:5]
    s = eo_sum[..., 1:5]
    o = jnp.where(c > 0, jnp.clip(_round_div(s, jnp.maximum(c, 1)), -mx, mx),
                  0)
    o = o.at[..., 0:2].set(jnp.maximum(o[..., 0:2], 0))
    o = o.at[..., 2:4].set(jnp.minimum(o[..., 2:4], 0))
    g = 2 * o * s - c * o * o
    keep = g > 0
    offs = jnp.where(keep, o, 0)
    gain = jnp.where(keep, g, 0).sum(-1)
    return offs, gain


def _bo_offsets_gains(bo_cnt, bo_sum, lam_q, mx: int):
    """(bp (ny,nx), offs (ny,nx,4), score) — jax mirror of
    core.sao._bo_offsets_gains."""
    c, s = bo_cnt, bo_sum
    ob = jnp.where(c > 0, jnp.clip(_round_div(s, jnp.maximum(c, 1)), -mx, mx),
                   0)
    gains = jnp.maximum(jnp.where(ob != 0, 2 * ob * s - c * ob * ob, 0), 0)
    win = jnp.stack([gains[..., k:k + 4].sum(-1) for k in range(29)], -1)
    bp = win.argmax(-1)
    offs = jnp.stack(
        [jnp.where(jnp.take_along_axis(gains, (bp + i)[..., None], -1)[..., 0]
                   > 0,
                   jnp.take_along_axis(ob, (bp + i)[..., None], -1)[..., 0],
                   0) for i in range(4)], -1)
    from ..core.sao import SAO_RATE_SCALE
    rate = SAO_RATE_SCALE * (9 + (jnp.abs(offs) + 1).sum(-1))
    g = (jnp.take_along_axis(win, bp[..., None], -1)[..., 0]
         .astype(jnp.float32) - lam_q * rate.astype(jnp.float32))
    return bp.astype(jnp.int32), offs, g


def _rate_lambda(lam):
    """Device mirror of core.sao.rate_lambda (exact: frexp/ldexp)."""
    m, e = jnp.frexp(lam.astype(jnp.float32))
    return jnp.ldexp(jnp.round(m * 2.0 ** 15), e - 15).astype(jnp.float32)


def sao_decide_dev(stats, lam, bit_depth: int = 8):
    """Per-CTB SAO decision from device stats.

    stats: per-component dicts of eo_cnt/eo_sum (ny,nx,4,5) and
    bo_cnt/bo_sum (ny,nx,32) int32. Returns dict of int32 grids:
    type (ny,nx,2: luma/chroma), eo (ny,nx,2), bp (ny,nx,3),
    offs (ny,nx,3,4) — identical decisions to
    core.sao.derive_sao_params_from_stats."""
    mx = (1 << (min(bit_depth, 10) - 5)) - 1
    lam_q = _rate_lambda(jnp.asarray(lam))
    out_type, out_eo, out_bp, out_offs = [], [], [], []
    cb_type = cb_eo = None
    for comp in range(3):
        st = stats[comp]
        eo_offs, eo_gain = _eo_offsets_gains(st["eo_cnt"], st["eo_sum"], mx)
        from ..core.sao import SAO_RATE_SCALE
        eo_rate = SAO_RATE_SCALE * (4 + (jnp.abs(eo_offs) + 1).sum(-1))
        eo_score = (eo_gain.astype(jnp.float32)
                    - lam_q * eo_rate.astype(jnp.float32))
        bo_bp, bo_offs, bo_score = _bo_offsets_gains(st["bo_cnt"],
                                                     st["bo_sum"], lam_q, mx)
        bo_valid = (bo_score > 0) & bo_offs.any(-1)

        if comp == 2:
            # cr shares the chroma type/eo chosen for cb; offsets free
            ec = cb_eo
            eo_sel = jnp.take_along_axis(
                eo_offs, ec[..., None, None].repeat(4, -1), -2)[..., 0, :]
            use_edge = cb_type == SAO_EDGE
            use_band = (cb_type == SAO_BAND) & bo_valid
            offs = jnp.where(use_edge[..., None], eo_sel,
                             jnp.where(use_band[..., None], bo_offs, 0))
            out_bp.append(jnp.where(use_band, bo_bp, 0))
            out_offs.append(offs)
            continue

        best_ec = eo_score.argmax(-1)
        best_eo_score = jnp.take_along_axis(eo_score, best_ec[..., None],
                                            -1)[..., 0]
        use_bo = bo_valid & (bo_score > jnp.maximum(best_eo_score, 0.0))
        use_eo = ~use_bo & (best_eo_score > 0.0)
        tmap = jnp.where(use_bo, SAO_BAND,
                         jnp.where(use_eo, SAO_EDGE, SAO_OFF))
        eo_sel = jnp.take_along_axis(
            eo_offs, best_ec[..., None, None].repeat(4, -1), -2)[..., 0, :]
        offs = jnp.where(use_eo[..., None], eo_sel,
                         jnp.where(use_bo[..., None], bo_offs, 0))
        out_type.append(tmap.astype(jnp.int32))
        out_eo.append(jnp.where(use_eo, best_ec, 0).astype(jnp.int32))
        out_bp.append(jnp.where(use_bo, bo_bp, 0))
        out_offs.append(offs)
        if comp == 1:
            cb_type, cb_eo = tmap, jnp.where(use_eo, best_ec, 0)

    return {
        "type": jnp.stack(out_type, -1),
        "eo": jnp.stack(out_eo, -1),
        "bp": jnp.stack(out_bp, -1),
        "offs": jnp.stack(out_offs, -2),
    }


def _eo_cat(plane, ec: int, w: int, h: int):
    """EO category map (0..4) with picture-edge invalidation (8.7.3);
    plane is 64-aligned but only the coded (h, w) region matters."""
    hh, ww = plane.shape
    (ax, ay), (bx, by) = _EO_NEIGHBORS[ec]
    pad = jnp.pad(plane, 1, mode="edge")
    c = pad[1:-1, 1:-1]
    na = pad[1 + ay:hh + 1 + ay, 1 + ax:ww + 1 + ax]
    nb = pad[1 + by:hh + 1 + by, 1 + bx:ww + 1 + bx]
    cat = jnp.asarray(_EO_CAT_LUT)[2 + jnp.sign(c - na) + jnp.sign(c - nb)]
    xs = jnp.arange(ww)[None, :]
    ys = jnp.arange(hh)[:, None]
    valid = jnp.ones((hh, ww), bool)
    if ax != 0 or bx != 0:
        valid = valid & (xs > 0) & (xs < w - 1)
    if ay != 0 or by != 0:
        valid = valid & (ys > 0) & (ys < h - 1)
    return jnp.where(valid, cat, 0)


def sao_apply_dev(rec, params, comp: int, ctb: int, w: int, h: int,
                  bit_depth: int = 8):
    """Apply SAO to one 64-aligned plane from the decision grids
    (classification on the pre-SAO input, 8.7.3). comp: 0/1/2; chroma
    planes use CTB/2 cells; w/h are THIS plane's coded dims. Bit-exact
    with core.sao.apply_sao."""
    maxval = (1 << bit_depth) - 1
    c01 = min(comp, 1)
    cell = ctb if comp == 0 else ctb // 2
    hh, ww = rec.shape
    tmap = params["type"][..., c01]
    emap = params["eo"][..., c01]
    bp = params["bp"][..., comp]
    offs = params["offs"][..., comp, :]
    ny, nx = tmap.shape

    cyi = (jnp.arange(hh) // cell).clip(0, ny - 1)[:, None]
    cxi = (jnp.arange(ww) // cell).clip(0, nx - 1)[None, :]

    # per-CTB offset LUTs with the type/class masking folded in
    is_edge = (tmap == SAO_EDGE)[..., None]
    lut_eo = jnp.zeros((ny, nx, 4, 5), jnp.int32)
    onehot = (emap[..., None] == jnp.arange(4)).astype(jnp.int32)
    lut_eo = lut_eo.at[..., 1:].set(
        onehot[..., None] * offs[:, :, None, :] * is_edge[..., None])

    is_band = (tmap == SAO_BAND)[..., None]
    bandhot = sum(((bp[..., None] + i) % 32 ==
                   jnp.arange(32)).astype(jnp.int32) * offs[..., i:i + 1]
                  for i in range(4))
    lut_bo = jnp.where(is_band, bandhot, 0)

    off = jnp.zeros((hh, ww), jnp.int32)
    for ec in range(4):
        cat = _eo_cat(rec, ec, w, h)
        off = off + lut_eo[cyi, cxi, ec, cat]
    band = rec >> (bit_depth - 5)
    off = off + lut_bo[cyi, cxi, band]
    return jnp.clip(rec + off, 0, maxval)
