"""Device deblocking filter: dense edge-parallel JAX form of core/deblock.py.

The reference filters per-LCU inside the EncDec loop
(EbDeblockingFilter.c edge cores :1027-2221, invoked EbCodingLoop.c
:4600-4637); the host backend (core/deblock.py) already batches all edge
segments of a picture. This module is the device form: every vertical
edge segment of the picture is filtered in one masked dense pass, then
horizontal edges run the same core on the transposed plane (spec
8.7.2 order), so post-filter reconstruction never leaves the device.

Boundary strengths are derived from the fast path's decision maps
(cu_log2_8 / inter8 / mv8 / per-4x4 luma cbf), not from the host walk's
edge flags: in the fast path TU == min(CU, 32) and PU == CU, so a
deblocking-grid column is an edge exactly where it is a multiple of the
right-hand block's TU size. Bit-exact with the host filter (tested in
tests/test_tpu_dlf.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.deblock import BETA_TABLE, TC_TABLE
from ..core.ctu import chroma_qp

_CHROMA_QP = np.array([chroma_qp(q, 0, 1) for q in range(52)], np.int32)


def _clip3(lo, hi, v):
    return jnp.minimum(jnp.maximum(v, lo), hi)


def _filter_luma_dir(plane, bs, qp, bit_depth: int):
    """Filter all vertical luma edges (bs: (H//4, W//8), qp scalar int32).
    Mirror of core.deblock._filter_luma_vertical, dense + masked."""
    hh, ww = plane.shape
    ns, nc = hh // 4, ww // 8
    maxval = (1 << bit_depth) - 1

    seg = bs > 0
    seg = seg.at[:, 0].set(False)
    qb = jnp.clip(qp, 0, 51)
    beta = jnp.asarray(BETA_TABLE)[qb] << (bit_depth - 8)
    qts = jnp.clip(qp + 2 * (bs.astype(jnp.int32) - 1), 0, 53)
    tcs = jnp.asarray(TC_TABLE)[qts] << (bit_depth - 8)       # (ns, nc)

    # gather all candidate edge blocks: (ns, nc, 4, 8)
    rows = (jnp.arange(ns) * 4)[:, None] + jnp.arange(4)[None, :]  # (ns,4)
    cols = ((jnp.arange(nc) * 8)[:, None]
            + jnp.arange(-4, 4)[None, :]).clip(0, ww - 1)          # (nc,8)
    blk = plane[rows[:, None, :, None], cols[None, :, None, :]]
    blk = blk.astype(jnp.int32)                                # (ns,nc,4,8)
    p3, p2, p1, p0 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    q0, q1, q2, q3 = blk[..., 4], blk[..., 5], blk[..., 6], blk[..., 7]

    tc = tcs[:, :, None]
    dp0 = jnp.abs(p2[..., 0] - 2 * p1[..., 0] + p0[..., 0])
    dp3 = jnp.abs(p2[..., 3] - 2 * p1[..., 3] + p0[..., 3])
    dq0 = jnp.abs(q2[..., 0] - 2 * q1[..., 0] + q0[..., 0])
    dq3 = jnp.abs(q2[..., 3] - 2 * q1[..., 3] + q0[..., 3])
    dpq0, dpq3 = dp0 + dq0, dp3 + dq3
    d = dpq0 + dpq3
    do_filter = seg & (d < beta)

    def strong_line(dpq_k, k):
        return ((2 * dpq_k < (beta >> 2))
                & (jnp.abs(p3[..., k] - p0[..., k])
                   + jnp.abs(q0[..., k] - q3[..., k]) < (beta >> 3))
                & (jnp.abs(p0[..., k] - q0[..., k])
                   < ((5 * tcs + 1) >> 1)))

    strong = do_filter & strong_line(dpq0, 0) & strong_line(dpq3, 3)
    weak = do_filter & ~strong
    dEp1 = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
    dEq1 = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)

    s = strong[..., None]
    sp0 = _clip3(p0 - 2 * tc, p0 + 2 * tc,
                 (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = _clip3(p1 - 2 * tc, p1 + 2 * tc, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = _clip3(p2 - 2 * tc, p2 + 2 * tc,
                 (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = _clip3(q0 - 2 * tc, q0 + 2 * tc,
                 (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
    sq1 = _clip3(q1 - 2 * tc, q1 + 2 * tc, (p0 + q0 + q1 + q2 + 2) >> 2)
    sq2 = _clip3(q2 - 2 * tc, q2 + 2 * tc,
                 (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    w_on = jnp.abs(delta) < 10 * tc
    dc = _clip3(-tc, tc, delta)
    wp0 = _clip3(0, maxval, p0 + dc)
    wq0 = _clip3(0, maxval, q0 - dc)
    dcp = _clip3(-(tc >> 1), tc >> 1,
                 (((p2 + p0 + 1) >> 1) - p1 + dc) >> 1)
    wp1 = _clip3(0, maxval, p1 + dcp)
    dcq = _clip3(-(tc >> 1), tc >> 1,
                 (((q2 + q0 + 1) >> 1) - q1 - dc) >> 1)
    wq1 = _clip3(0, maxval, q1 + dcq)

    w = weak[..., None] & w_on
    out = blk
    out = out.at[..., 1].set(jnp.where(s, sp2, p2))
    out = out.at[..., 2].set(jnp.where(s, sp1,
                                       jnp.where(w & dEp1[..., None], wp1,
                                                 p1)))
    out = out.at[..., 3].set(jnp.where(s, sp0, jnp.where(w, wp0, p0)))
    out = out.at[..., 4].set(jnp.where(s, sq0, jnp.where(w, wq0, q0)))
    out = out.at[..., 5].set(jnp.where(s, sq1,
                                       jnp.where(w & dEq1[..., None], wq1,
                                                 q1)))
    out = out.at[..., 6].set(jnp.where(s, sq2, q2))
    out = _clip3(0, maxval, out)
    out = jnp.where(do_filter[:, :, None, None], out, blk)
    # adjacent edge windows are disjoint (8 cols apart, 8-wide windows)
    return plane.at[rows[:, None, :, None],
                    cols[None, :, None, :]].set(out)


def _filter_chroma_dir(plane, bs_luma, qp_c, bit_depth: int):
    """Vertical chroma edges (4:2:0): bS == 2 segments on the chroma 8x8
    grid. bs_luma: the (Hl//4, Wl//8) luma map; every 2nd column applies
    and each luma 4-row segment is 2 chroma rows."""
    hh, ww = plane.shape
    maxval = (1 << bit_depth) - 1
    bsc = bs_luma[:, ::2]                       # (Hl//4, Wc//8)
    seg = (bsc == 2).at[:, 0].set(False)
    ns, nc = seg.shape
    qt = jnp.clip(qp_c + 2, 0, 53)
    tc_s = jnp.asarray(TC_TABLE)[qt] << (bit_depth - 8)

    rows = ((jnp.arange(ns) * 2)[:, None]
            + jnp.arange(2)[None, :]).clip(0, hh - 1)          # (ns,2)
    cols = ((jnp.arange(nc) * 8)[:, None]
            + jnp.arange(-2, 2)[None, :]).clip(0, ww - 1)      # (nc,4)
    blk = plane[rows[:, None, :, None], cols[None, :, None, :]]
    blk = blk.astype(jnp.int32)                                # (ns,nc,2,4)
    p1, p0, q0, q1 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    delta = _clip3(-tc_s, tc_s, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3))
    out = blk
    out = out.at[..., 1].set(_clip3(0, maxval, p0 + delta))
    out = out.at[..., 2].set(_clip3(0, maxval, q0 - delta))
    out = jnp.where(seg[:, :, None, None], out, blk)
    return plane.at[rows[:, None, :, None],
                    cols[None, :, None, :]].set(out)


_POC_NONE = -(10 ** 6)          # plain int: traces as an inline literal


def _bs_motion_rule_dev(rp, rq, mvp, mvq):
    """Device mirror of core.deblock._bs_motion_rule: the bS=1 motion
    conditions (8.7.2.4) for inter/inter edges, two reference lists.
    rp/rq: (..., 2) ref POCs (sentinel = unused); mvp/mvq: (..., 2, 2)."""
    # 2-element sort as min/max (avoids the variadic sort custom-call,
    # which trips an XLA:CPU buffer-accounting bug on repeat dispatch)
    diff_sets = ((jnp.minimum(rp[..., 0], rp[..., 1])
                  != jnp.minimum(rq[..., 0], rq[..., 1]))
                 | (jnp.maximum(rp[..., 0], rp[..., 1])
                    != jnp.maximum(rq[..., 0], rq[..., 1])))

    both_bi = (rp != _POC_NONE).all(-1) & (rq != _POC_NONE).all(-1)
    up = jnp.where((rp[..., 0] != _POC_NONE)[..., None],
                   mvp[..., 0, :], mvp[..., 1, :])
    uq = jnp.where((rq[..., 0] != _POC_NONE)[..., None],
                   mvq[..., 0, :], mvq[..., 1, :])
    uni_diff = (jnp.abs(up - uq) >= 4).any(-1)

    same_order = rp[..., 0] == rq[..., 0]
    d_same = ((jnp.abs(mvp[..., 0, :] - mvq[..., 0, :]) >= 4).any(-1)
              | (jnp.abs(mvp[..., 1, :] - mvq[..., 1, :]) >= 4).any(-1))
    d_cross = ((jnp.abs(mvp[..., 0, :] - mvq[..., 1, :]) >= 4).any(-1)
               | (jnp.abs(mvp[..., 1, :] - mvq[..., 0, :]) >= 4).any(-1))
    bi_distinct_diff = jnp.where(same_order, d_same, d_cross)
    same_pic_twice = both_bi & (rp[..., 0] == rp[..., 1])
    bi_same_diff = d_same & d_cross

    mv_rule = jnp.where(both_bi,
                        jnp.where(same_pic_twice, bi_same_diff,
                                  bi_distinct_diff),
                        uni_diff)
    return diff_sets | mv_rule


def derive_bs_maps(cu_log2_8, inter8, mv8, cbf4, w: int, h: int,
                   tu_log2_8=None, refpoc8=None, mv8_2l=None):
    """Boundary-strength maps from the fast-path decision grids.

    cu_log2_8/inter8: (nby, nbx); mv8: (nby, nbx, 2) L0 quarter-pel MV
    (single reference, the P fast path's shape); cbf4: (H//4, W//4) luma
    cbf of the covering TU. Returns (bs_v (H//4, W//8), bs_h (H//8, W//4))
    with edges outside the coded area zeroed (8.7.2.4: intra side -> 2;
    else cbf or the motion rule -> 1). TU size is min(CU, 32) and
    PU == CU, so a column/row is an edge iff it is a multiple of the
    right/lower block's TU size.

    B form: refpoc8 (2, nby, nbx) per-list reference POC (sentinel
    -10^6 = unused) + mv8_2l (2, nby, nbx, 2) activate the full
    two-list motion rule (core.deblock._bs_motion_rule mirror)."""
    nby, nbx = cu_log2_8.shape
    h64, w64 = nby * 8, nbx * 8
    tu8 = (jnp.minimum(cu_log2_8, 5) if tu_log2_8 is None
           else tu_log2_8)                       # TU log2 per 8-block
    two_list = refpoc8 is not None

    def one_dir(transpose: bool):
        # vertical edges: columns 8c; work on (rows at 4-gran, cols at 8)
        if transpose:
            cu = tu8.T
            it = inter8.T
            cb = cbf4.T
            hh, wwv = w64, h64
            wlim, hlim = h, w
            if two_list:
                rp8 = refpoc8.transpose(0, 2, 1)
                mv2 = mv8_2l.transpose(0, 2, 1, 3)
            else:
                mv = mv8.transpose(1, 0, 2)
        else:
            cu, it, cb = tu8, inter8, cbf4
            hh, wwv = h64, w64
            wlim, hlim = w, h
            if two_list:
                rp8, mv2 = refpoc8, mv8_2l
            else:
                mv = mv8
        ns, nc = hh // 4, wwv // 8
        rows4 = jnp.arange(ns)                    # 4-sample segments
        cols8 = jnp.arange(nc) * 8
        br = rows4 // 2                           # 8-block row of segment
        bq = cols8 // 8                           # right-hand 8-block col
        bp = jnp.maximum(cols8 - 1, 0) // 8       # left-hand block col
        tu_r = cu[br[:, None], bq[None, :]]
        edge = (cols8[None, :] % (1 << tu_r)) == 0
        # coded-area crop: the edge column and its segment rows must be
        # inside the picture
        edge = edge & (cols8[None, :] < wlim) & ((rows4 * 4)[:, None] < hlim)

        intra_p = ~it[br[:, None], bp[None, :]]
        intra_q = ~it[br[:, None], bq[None, :]]
        cbf_p = cb[rows4[:, None], jnp.maximum(cols8 - 1, 0)[None, :] // 4]
        cbf_q = cb[rows4[:, None], cols8[None, :] // 4]
        if two_list:
            rpp = rp8[:, br[:, None], bp[None, :]].transpose(1, 2, 0)
            rpq = rp8[:, br[:, None], bq[None, :]].transpose(1, 2, 0)
            mvp = mv2[:, br[:, None], bp[None, :]].transpose(1, 2, 0, 3)
            mvq = mv2[:, br[:, None], bq[None, :]].transpose(1, 2, 0, 3)
            mv_diff = _bs_motion_rule_dev(rpp, rpq, mvp, mvq)
        else:
            mvp = mv[br[:, None], bp[None, :]]
            mvq = mv[br[:, None], bq[None, :]]
            mv_diff = (jnp.abs(mvp - mvq) >= 4).any(-1)
        bs1 = (cbf_p | cbf_q) > 0
        bs = jnp.where(intra_p | intra_q, 2,
                       jnp.where(bs1 | mv_diff, 1, 0))
        return jnp.where(edge, bs, 0).astype(jnp.int8)

    return one_dir(False), one_dir(True)


@functools.partial(jax.jit, static_argnames=("bit_depth",))
def deblock_dev(rec_y, rec_cb, rec_cr, bs_v, bs_ht, qp, qp_c,
                bit_depth: int = 8):
    """Full in-loop deblock of one picture on device (constant slice QP).
    Spec order: all vertical edges, then all horizontal on the result.
    bs_ht: the horizontal-edge map in transposed-plane layout, as
    returned by derive_bs_maps."""
    y = _filter_luma_dir(rec_y.astype(jnp.int32), bs_v, qp, bit_depth)
    y = _filter_luma_dir(y.T, bs_ht, qp, bit_depth).T
    cb = _filter_chroma_dir(rec_cb.astype(jnp.int32), bs_v, qp_c, bit_depth)
    cb = _filter_chroma_dir(cb.T, bs_ht, qp_c, bit_depth).T
    cr = _filter_chroma_dir(rec_cr.astype(jnp.int32), bs_v, qp_c, bit_depth)
    cr = _filter_chroma_dir(cr.T, bs_ht, qp_c, bit_depth).T
    return y, cb, cr
