"""Device closed-loop intra encode pass: wavefront over CTB anti-diagonals.

This is the data-parallel redesign of the reference's intra encode path
(EbCodingLoop.c EncodePass :2989 with reference-sample generation
EbIntraPrediction.c :212+), whose neighbor dependencies the reference
parallelises with the EncDec segment wavefront + dependency map
(EbEncDecProcess.c AssignEncDecSegments :1540).  Here the same DAG is
honored by a single jitted ``lax.scan``:

  - outer schedule: CTBs on anti-diagonal d = 2*row + col run in parallel
    (the WPP slope: left and top-right CTBs are always on diagonal d-1);
  - inner schedule: the 64 8x8-block z-scan slots of a CTB run
    sequentially, so intra reference samples always see exactly the
    reconstruction state a decoder in z-scan order would see;
  - each micro-step processes, for every CTB lane on the diagonal, the
    (masked) CU whose top-left 8x8 block sits at the current z-slot —
    all three intra CU sizes (8/16/32) are computed with static shapes
    and the real one is selected by the decision map.

Per CU the pass is bit-exact with the host normative path
(core.intra + core.transforms + core.quant, verified in
tests/test_intra_pass.py):

  - reference samples: gather from the carried recon planes, with spec
    6.4.1 availability (z-scan precedence computed from Morton indices),
    substitution per 8.4.4.2.2 (vectorized scan-order forward fill), and
    the mode-dependent [1 2 1] filter (8.4.4.2.3);
  - prediction: every mode is an integer weight matrix over the reference
    vector (planar / angular), with DC and the normative DC/H/V boundary
    columns applied as masked fix-ups — exact integer arithmetic, not the
    float approximation used by the open-loop search (intra_weights.py);
  - residual -> forward DCT -> quant (intra offset) -> dequant -> inverse
    DCT -> clip, identical shift-for-shift to core.transforms/core.quant;
  - chroma (4:2:0) is coded with its luma CU at half size with the DM
    mode, unfiltered references, no boundary filters (8.4.4.2.5/6).

The same kernel serves two callers: I pictures (every CU intra) and the
P/B fused path (intra8 marks only the CUs the dense mode decision sent to
intra; inter blocks' reconstruction is already final and is read as
neighbor state but never written).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.intra import INTRA_PRED_ANGLE, INV_ANGLE, _filter_flag
from ..core.quant import INV_QUANT_SCALES, QUANT_SCALES
from ..core.transforms import DCT


# --------------------------------------------------------------- mode tables

@functools.lru_cache(maxsize=None)
def _mode_tables(n: int):
    """Integer prediction tables for an (n, n) TB.

    Returns (W, shift, offset, filt):
      W:      (35, n*n, 4n+1) int32 — pred = (W[m] @ refs + offset[m])
              >> shift[m] for planar/angular modes (DC is handled apart);
      shift:  (35,) int32; offset: (35,) int32;
      filt:   (35,) bool — mode uses the [1 2 1]-filtered references
              (luma; chroma 4:2:0 never filters).
    Reference vector layout: [left[0..2n-1], corner, top[0..2n-1]]
    (matches intra_weights._ref_index). The V/H/DC boundary fix-ups are
    NOT baked in (they are two-stage-rounded / clipped, hence non-linear)
    — the kernel applies them with masked element ops.
    """
    m = 4 * n + 1
    corner = 2 * n
    log2 = n.bit_length() - 1
    w = np.zeros((35, n * n, m), np.int32)
    shift = np.zeros(35, np.int32)
    offset = np.zeros(35, np.int32)

    # planar (8.4.4.2.4): integer weights, shift log2+1, offset n
    wp = np.zeros((n, n, m), np.int32)
    for y in range(n):
        for x in range(n):
            wp[y, x, y] += n - 1 - x              # left[y]
            wp[y, x, corner + 1 + n] += x + 1     # top[n]
            wp[y, x, corner + 1 + x] += n - 1 - y  # top[x]
            wp[y, x, n] += y + 1                  # left[n]
    w[0] = wp.reshape(n * n, m)
    shift[0], offset[0] = log2 + 1, n

    # angular 2..34 (8.4.4.2.6): two taps (32-f, f), shift 5, offset 16
    for mode in range(2, 35):
        angle = INTRA_PRED_ANGLE[mode]
        vertical = mode >= 18

        def ext(k: int) -> int:
            """Packed-vector index of extended-reference position k."""
            if k == 0:
                return corner
            if k > 0:
                idx = min(k - 1, 2 * n - 1)
                return corner + 1 + idx if vertical else idx
            inv = INV_ANGLE[mode]
            idx = ((k * inv + 128) >> 8) - 1
            assert 0 <= idx < 2 * n, (mode, k, idx)
            return idx if vertical else corner + 1 + idx

        wa = np.zeros((n, n, m), np.int32)
        for q in range(n):                   # main-direction coordinate
            iidx = ((q + 1) * angle) >> 5
            ifact = ((q + 1) * angle) & 31
            for p in range(n):               # cross coordinate
                y, x = (q, p) if vertical else (p, q)
                wa[y, x, ext(p + iidx + 1)] += 32 - ifact
                if ifact:
                    wa[y, x, ext(p + iidx + 2)] += ifact
        w[mode] = wa.reshape(n * n, m)
        shift[mode], offset[mode] = 5, 16

    shift[1], offset[1] = 0, 0               # DC: overridden by the kernel
    filt = np.array([_filter_flag(md, n) for md in range(35)], bool)
    return w, shift, offset, filt


def _morton_spread(v: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 4 bits of v: b3 b2 b1 b0 -> b3 0 b2 0 b1 0 b0."""
    return ((v & 1) | ((v & 2) << 1) | ((v & 4) << 2) | ((v & 8) << 3))


def _zidx(x, y, nctbx: int, ctb_log2: int):
    """z-scan precedence index of luma position (x, y): CTB raster index
    (CTB size from ctb_log2), then the Morton index of the 4x4 unit
    inside the CTB (6.4.1 MinTbAddrZs semantics at 4x4 granularity)."""
    c = ctb_log2
    ctb = (y >> c) * nctbx + (x >> c)
    m = (1 << (c - 2)) - 1
    ix = (x >> 2) & m
    iy = (y >> 2) & m
    return (ctb << (2 * (c - 2))) + (_morton_spread(iy) << 1) \
        + _morton_spread(ix)


def _gather_lt(plane, x0, y0, n2max: int, cur_z, w: int, h: int,
               nctbx: int, ctb_log2: int, scale: int):
    """Shared left/top/corner gather for ALL CU sizes at a batch of
    positions: one gather of the largest extent, sliced per size later.

    plane: (H, W) or stacked (2, H, W) chroma. Returns
    (lv, l_av, cv, c_av, tv, t_av) with value arrays (..., R, n2max) /
    (..., R) and avail arrays (R, n2max) / (R,). scale: 1 luma, 2 chroma
    (availability evaluated at luma scale). w/h: THIS plane's coded
    extent."""
    ph, pw = plane.shape[-2:]
    k = jnp.arange(n2max)
    ly = y0[:, None] + k[None, :]
    lx = x0 - 1
    tx = x0[:, None] + k[None, :]
    ty = y0 - 1

    l_av = ((lx >= 0)[:, None] & (ly < h)
            & (_zidx((lx[:, None] * scale).clip(0), ly * scale, nctbx,
                     ctb_log2) < cur_z[:, None]))
    t_av = ((ty >= 0)[:, None] & (tx < w)
            & (_zidx(tx * scale, (ty[:, None] * scale).clip(0), nctbx,
                     ctb_log2) < cur_z[:, None]))
    c_av = ((lx >= 0) & (ty >= 0)
            & (_zidx((lx * scale).clip(0), (ty * scale).clip(0), nctbx,
                     ctb_log2) < cur_z))

    lyc = ly.clip(0, ph - 1)
    lxc = lx[:, None].clip(0, pw - 1)
    tyc = ty[:, None].clip(0, ph - 1)
    txc = tx.clip(0, pw - 1)
    if plane.ndim == 3:
        lv = plane[:, lyc, lxc]
        tv = plane[:, tyc, txc]
        cv = plane[:, ty.clip(0, ph - 1), lx.clip(0, pw - 1)]
    else:
        lv = plane[lyc, lxc]
        tv = plane[tyc, txc]
        cv = plane[ty.clip(0, ph - 1), lx.clip(0, pw - 1)]
    return lv, l_av, cv, c_av, tv, t_av


def _substitute(lv, l_av, cv, c_av, tv, t_av, n: int, default: int):
    """8.4.4.2.2 substitution for size n from (possibly larger) gathered
    arrays: scan order left[2n-1]..left[0], corner, top[0]..top[2n-1];
    the first unavailable head takes the first available value later in
    the scan, then forward-fill. Returns (R', 4n+1) packed refs."""
    n2 = 2 * n
    lv, tv = lv[..., :n2], tv[..., :n2]
    la, ta = l_av[..., :n2], t_av[..., :n2]
    seq = jnp.concatenate([lv[..., ::-1], cv[..., None], tv], axis=-1)
    av = jnp.concatenate([la[..., ::-1], c_av[..., None], ta], axis=-1)
    ln = seq.shape[-1]
    any_av = av.any(axis=-1)
    first_idx = jnp.argmax(av, axis=-1)
    first_val = jnp.take_along_axis(seq, first_idx[..., None], -1)[..., 0]
    head = jnp.where(av[..., 0], seq[..., 0], first_val)
    seq = seq.at[..., 0].set(head)
    av = av.at[..., 0].set(True)
    pos = jnp.where(av, jnp.arange(ln), -1)
    last = jax.lax.cummax(pos, axis=pos.ndim - 1)
    filled = jnp.take_along_axis(seq, last, -1)
    filled = jnp.where(any_av[..., None], filled, default)
    return jnp.concatenate([filled[..., :n2][..., ::-1],
                            filled[..., n2:n2 + 1],
                            filled[..., n2 + 1:]], axis=-1)


def _filter_refs(refs: jnp.ndarray, n: int) -> jnp.ndarray:
    """[1 2 1]/4 smoothing (8.4.4.2.3) of a packed (R, 4n+1) batch."""
    n2 = 2 * n
    left, corner, top = refs[:, :n2], refs[:, n2:n2 + 1], refs[:, n2 + 1:]
    lprev = jnp.concatenate([corner, left[:, :-1]], axis=1)
    lnext = jnp.concatenate([left[:, 1:], left[:, -1:]], axis=1)
    fl = (lprev + 2 * left + lnext + 2) >> 2
    fl = fl.at[:, -1].set(left[:, -1])
    tprev = jnp.concatenate([corner, top[:, :-1]], axis=1)
    tnext = jnp.concatenate([top[:, 1:], top[:, -1:]], axis=1)
    ft = (tprev + 2 * top + tnext + 2) >> 2
    ft = ft.at[:, -1].set(top[:, -1])
    fc = (left[:, :1] + 2 * corner + top[:, :1] + 2) >> 2
    return jnp.concatenate([fl, fc, ft], axis=1)


def _predict_batch(refs_u, refs_f, mode, n: int, luma: bool,
                   bit_depth: int):
    """Exact intra prediction of a (R, n, n) batch with per-lane mode."""
    wt, sh, off, filt = _mode_tables(n)
    wt = jnp.asarray(wt)
    log2 = n.bit_length() - 1
    maxval = (1 << bit_depth) - 1
    n2 = 2 * n

    if luma and refs_f is not None:
        use_f = jnp.asarray(filt)[mode]
        refs = jnp.where(use_f[:, None], refs_f, refs_u)
    else:
        refs = refs_u

    wm = wt[mode]                                      # (R, n*n, 4n+1)
    lin = jnp.einsum("rk,rpk->rp", refs, wm)
    lin = ((lin + jnp.asarray(off)[mode][:, None])
           >> jnp.asarray(sh)[mode][:, None]).reshape(-1, n, n)

    # DC (8.4.4.2.5) from unfiltered refs
    left_u = refs_u[:, :n2]
    top_u = refs_u[:, n2 + 1:]
    corner_u = refs_u[:, n2]
    dc = ((top_u[:, :n].sum(1) + left_u[:, :n].sum(1) + n) >> (log2 + 1))
    dcp = jnp.broadcast_to(dc[:, None, None], lin.shape)
    if luma and n < 32:
        row0 = (top_u[:, :n] + 3 * dc[:, None] + 2) >> 2
        col0 = (left_u[:, :n] + 3 * dc[:, None] + 2) >> 2
        dcp = dcp.at[:, 0, :].set(row0)
        dcp = dcp.at[:, :, 0].set(col0)
        dcp = dcp.at[:, 0, 0].set(
            (left_u[:, 0] + 2 * dc + top_u[:, 0] + 2) >> 2)
    pred = jnp.where((mode == 1)[:, None, None], dcp, lin)

    # normative V/H boundary columns (8.4.4.2.6), luma n < 32
    if luma and n < 32:
        vcol = jnp.clip(top_u[:, :1]
                        + ((left_u[:, :n] - corner_u[:, None]) >> 1),
                        0, maxval)
        hrow = jnp.clip(left_u[:, :1]
                        + ((top_u[:, :n] - corner_u[:, None]) >> 1),
                        0, maxval)
        pred = jnp.where((mode == 26)[:, None, None],
                         pred.at[:, :, 0].set(vcol), pred)
        pred = jnp.where((mode == 10)[:, None, None],
                         pred.at[:, 0, :].set(hrow), pred)
    return pred


def _tq_batch(resid, n: int, qp, bit_depth: int, lam=None):
    """Forward DCT + intra quant + dequant + inverse DCT of an (R, n, n)
    residual batch; bit-exact with core.transforms/core.quant (same
    formulas as encode.dense_tq_size). Returns (levels, recon_residual).
    lam: optional SSE lambda enabling the per-TU RD zero-out."""
    t = jnp.asarray(DCT[n].astype(np.int32))
    log2n = n.bit_length() - 1
    s1 = log2n + bit_depth - 9
    s2 = log2n + 6
    b = resid.astype(jnp.int32)
    tmp = (jnp.einsum("byx,kx->byk", b, t) + (1 << (s1 - 1))) >> s1
    coef = (jnp.einsum("iy,byj->bij", t, tmp) + (1 << (s2 - 1))) >> s2

    qp = qp + 6 * (bit_depth - 8)
    qbits = 14 + qp // 6 + (15 - bit_depth - log2n)
    f = jnp.asarray(QUANT_SCALES.astype(np.int32))[qp % 6]
    off = 171 << (qbits - 9)                       # intra offset
    lv = jnp.minimum((jnp.abs(coef) * f + off) >> qbits, 32767)
    lv = jnp.sign(coef) * lv

    dq_shift = log2n + bit_depth - 9
    scale = jnp.asarray(INV_QUANT_SCALES.astype(np.int32))[qp % 6] \
        << (qp // 6)
    d = jnp.clip((lv * scale + (1 << (dq_shift - 1))) >> dq_shift,
                 -32768, 32767)
    e = jnp.clip((jnp.einsum("ky,bkx->byx", t, d) + 64) >> 7,
                 -32768, 32767)
    bd_shift = 20 - bit_depth
    r = jnp.clip((jnp.einsum("byk,kx->byx", e, t)
                  + (1 << (bd_shift - 1))) >> bd_shift, -32768, 32767)
    if lam is not None:
        from .encode import _tu_zero_rd
        lv, r = _tu_zero_rd(resid.astype(jnp.int32), lv, r, lam)
    return lv, r


def _scatter(plane, vals, x0, y0, n: int, mask):
    """Masked disjoint block write: rows with mask=False are dropped.
    plane: (H, W), or stacked (2, H, W) with vals (2R, n, n)."""
    ph = plane.shape[-2]
    r = x0.shape[0]
    a = jnp.arange(n)
    yy = jnp.broadcast_to(y0[:, None, None] + a[None, :, None], (r, n, n))
    xx = jnp.broadcast_to(x0[:, None, None] + a[None, None, :], (r, n, n))
    yy = jnp.where(mask[:, None, None], yy, ph)      # OOB -> dropped
    if plane.ndim == 3:
        yy = jnp.concatenate([yy, yy], 0)
        xx = jnp.concatenate([xx, xx], 0)
        cc = jnp.repeat(jnp.arange(2), r)[:, None, None]
        cc = jnp.broadcast_to(cc, (2 * r, n, n))
        return plane.at[cc, yy, xx].set(vals, mode="drop")
    return plane.at[yy, xx].set(vals, mode="drop")


@functools.partial(jax.jit,
                   static_argnames=("w", "h", "bit_depth", "ctb_log2",
                                    "min_cu_log2", "refine_modes"))
def intra_wavefront_pass(src_y, src_cb, src_cr,
                         rec_y, rec_cb, rec_cr,
                         lv_y, lv_cb, lv_cr,
                         cu_log2_8, mode8, intra8,
                         qp, qp_c, w: int, h: int,
                         bit_depth: int = 8, ctb_log2: int = 6,
                         min_cu_log2: int = 3, lam=None,
                         refine_modes: bool = False):
    """Closed-loop intra encode for all CUs flagged in intra8.

    src_*: int32 source planes at 64-aligned dims. rec_*/lv_*: int32
    reconstruction / quantized-levels planes to update in place (I
    pictures pass zeros; the P path passes the inter encode-pass output).
    cu_log2_8/mode8/intra8: per-8x8-block decision maps (intra CU sizes
    min_cu..32; 64 must be pre-split by the decision). w/h: coded picture
    dims. min_cu_log2: smallest intra CU present — larger minimums
    quarter the scan length per step (the P fast path restricts intra to
    >=16, like the reference's CU-8x8 gating at fast presets,
    EbPictureDecisionProcess.c:425). Returns the six updated planes.
    """
    h64, w64 = src_y.shape
    tile = 1 << ctb_log2              # the CTB is the wavefront tile
    unit = 1 << min_cu_log2           # z-scan slot granularity
    R, C = h64 // tile, w64 // tile
    nctbx = C
    nbits = ctb_log2 - min_cu_log2    # z-scan bits per axis
    slots = 1 << (2 * nbits)          # slots per CTB
    D = 2 * (R - 1) + C
    T = D * slots
    maxval = (1 << bit_depth) - 1
    default = 1 << (bit_depth - 1)
    rows = jnp.arange(R)
    sizes = [n for n in (8, 16, 32) if unit <= n <= tile]
    nmax = sizes[-1]
    ncmax = nmax // 2

    def body(carry, t):
        rec_y, rec_c, lv_y, lv_c, mode_map = carry
        d = t // slots
        k = t % slots
        zx = sum((((k >> (2 * b)) & 1) << b) for b in range(nbits)) \
            if nbits else jnp.int32(0)
        zy = sum((((k >> (2 * b + 1)) & 1) << b) for b in range(nbits)) \
            if nbits else jnp.int32(0)
        cols = d - 2 * rows
        x0 = cols * tile + zx * unit
        y0 = rows * tile + zy * unit
        active = (cols >= 0) & (cols < C) & (x0 < w) & (y0 < h)
        x0c = jnp.where(active, x0, 0)
        y0c = jnp.where(active, y0, 0)
        by = (y0c >> 3).astype(jnp.int32)
        bx = (x0c >> 3).astype(jnp.int32)
        cu_lg = cu_log2_8[by, bx]
        mode = mode8[by, bx]
        mode2 = jnp.concatenate([mode, mode])
        is_intra = intra8[by, bx]
        cur_z = _zidx(x0c, y0c, nctbx, ctb_log2)

        # one gather at the largest size, sliced per size below
        glt = _gather_lt(rec_y, x0c, y0c, 2 * nmax, cur_z, w, h,
                         nctbx, ctb_log2, 1)
        xc, yc = x0c >> 1, y0c >> 1
        cglt = _gather_lt(rec_c, xc, yc, 2 * ncmax, cur_z,
                          w // 2, h // 2, nctbx, ctb_log2, 2)
        a = jnp.arange(nmax)
        sy = (y0c[:, None, None] + a[None, :, None]).clip(0, h64 - 1)
        sx = (x0c[:, None, None] + a[None, None, :]).clip(0, w64 - 1)
        src_max = src_y[jnp.broadcast_to(sy, (R, nmax, nmax)),
                        jnp.broadcast_to(sx, (R, nmax, nmax))]
        ac = jnp.arange(ncmax)
        cyi = (yc[:, None, None] + ac[None, :, None]).clip(0, h64 // 2 - 1)
        cxi = (xc[:, None, None] + ac[None, None, :]).clip(0, w64 // 2 - 1)
        csrc_max = src_c[:, jnp.broadcast_to(cyi, (R, ncmax, ncmax)),
                         jnp.broadcast_to(cxi, (R, ncmax, ncmax))]
        csrc_max = csrc_max.reshape(2 * R, ncmax, ncmax)

        for n in sizes:
            lg = n.bit_length() - 1
            sel = (active & is_intra & (cu_lg == lg)
                   & (x0c % n == 0) & (y0c % n == 0))
            # ---- luma TB
            refs_u = _substitute(*glt, n, default)
            refs_f = _filter_refs(refs_u, n)
            if refine_modes:
                # closed-loop mode refinement: re-rank a shortlist
                # against the TRUE reconstruction references (the
                # reference's enhanced-I behavior at M3-9: OIS shortlist
                # + closed-loop refinement, SURVEY §2.4b). The open-loop
                # OIS winner predicts from source neighbors and often
                # misranks on structured content. All candidates fold
                # into the LANE axis of one _predict_batch call — one
                # einsum instance instead of five, which cuts the XLA
                # graph (and its compile time) without changing FLOPs.
                srcn = src_max[:, :n, :n]
                cands = (0, 1, 26, 10)
                nc_ = 1 + len(cands)
                cm_all = jnp.concatenate(
                    [mode] + [jnp.full_like(mode, c) for c in cands])
                p_all = _predict_batch(jnp.tile(refs_u, (nc_, 1)),
                                       jnp.tile(refs_f, (nc_, 1)),
                                       cm_all, n, True, bit_depth)
                p_all = p_all.reshape(nc_, R, n, n)
                sse = jnp.sum((srcn[None] - p_all) * (srcn[None] - p_all),
                              (-2, -1))
                kbest = jnp.argmin(sse, 0)
                md_sel = jnp.take_along_axis(
                    cm_all.reshape(nc_, R), kbest[None], 0)[0]
                pred = jnp.take_along_axis(
                    p_all, kbest[None, :, None, None], 0)[0]
                # write the chosen mode over the CU's 8-blocks
                k = n // 8
                off = jnp.arange(k * k)
                yy = by[:, None] + off[None, :] // k
                xx = bx[:, None] + off[None, :] % k
                upd = jnp.broadcast_to(sel[:, None], (R, k * k))
                yy = jnp.where(upd, yy, mode_map.shape[0])
                mode_map = mode_map.at[yy, xx].set(
                    jnp.broadcast_to(md_sel[:, None], (R, k * k)),
                    mode="drop")
            else:
                pred = _predict_batch(refs_u, refs_f, mode, n, True,
                                      bit_depth)
                md_sel = mode
            lv, rr = _tq_batch(src_max[:, :n, :n] - pred, n, qp, bit_depth,
                               lam=lam)
            rec = jnp.clip(pred + rr, 0, maxval)
            rec_y = _scatter(rec_y, rec, x0c, y0c, n, sel)
            lv_y = _scatter(lv_y, lv, x0c, y0c, n, sel)

            # ---- chroma TBs (4:2:0, DM mode, size n/2, cb+cr stacked)
            nc = n // 2
            clv2, cl_av, ccv2, cc_av, ctv2, ct_av = cglt
            crefs = _substitute(
                clv2.reshape(2 * R, -1), jnp.concatenate([cl_av, cl_av]),
                ccv2.reshape(2 * R), jnp.concatenate([cc_av, cc_av]),
                ctv2.reshape(2 * R, -1), jnp.concatenate([ct_av, ct_av]),
                nc, default)
            cpred = _predict_batch(crefs, None,
                                   jnp.concatenate([md_sel, md_sel]),
                                   nc, False, bit_depth)
            clv, crr = _tq_batch(csrc_max[:, :nc, :nc] - cpred, nc, qp_c,
                                 bit_depth, lam=lam)
            crec = jnp.clip(cpred + crr, 0, maxval)
            rec_c = _scatter(rec_c, crec, xc, yc, nc, sel)
            lv_c = _scatter(lv_c, clv, xc, yc, nc, sel)
        return (rec_y, rec_c, lv_y, lv_c, mode_map), None

    src_c = jnp.stack([src_cb.astype(jnp.int32),
                       src_cr.astype(jnp.int32)])
    carry = (rec_y.astype(jnp.int32),
             jnp.stack([rec_cb.astype(jnp.int32),
                        rec_cr.astype(jnp.int32)]),
             lv_y.astype(jnp.int32),
             jnp.stack([lv_cb.astype(jnp.int32),
                        lv_cr.astype(jnp.int32)]),
             mode8.astype(jnp.int32))
    (rec_y, rec_c, lv_y, lv_c, mode_map), _ = jax.lax.scan(
        body, carry, jnp.arange(T, dtype=jnp.int32))
    return (rec_y, rec_c[0], rec_c[1], lv_y, lv_c[0], lv_c[1], mode_map)
