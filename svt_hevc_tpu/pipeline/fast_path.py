"""Fast P-picture path: device dense mode decision + batched encode pass.

This replaces the per-CTU host hot loop (the reference's EncDec,
EbEncDecProcess.c:2630) for the common P-picture configuration:

  1. ``tpu.encode.dense_md_p``: dense inter search for every CU size
     (the FULL85 densification) + the open-loop intra costs from
     ``tpu.analysis`` -> cost maps per size.
  2. ``decide_tree``: bottom-up quadtree DP over the cost maps (host
     numpy on tiny grids) -> CU size / inter-intra / MV decision maps.
  3. ``tpu.encode.encode_pass_p``: motion compensation, residual,
     T/Q/IQ/IT and reconstruction for the whole picture in one jitted
     graph, at the decided TU sizes.
  4. ``FastCtuEncoder``: a single host walk per CTU doing only the
     sequential work — merge/AMVP legalization from the final MV field,
     intra-CU closed-loop reconstruction (wavefront-ordered by the CTU
     scan itself), and CABAC bin recording. All pixel math for inter CUs
     comes from the device arrays.

The walk records per-CTU op streams; after DLF/SAO the orchestrator
stitches SAO syntax + CTU ops per tile and runs the native arithmetic
coder once per tile (pipeline/encoder.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.ctu import CtuEncoder
from ..core.inter import Mi

LAMBDA_MD = 3.0           # cost scale of the host heuristics (sad + 3*bits)
SPLIT_BITS = 2.0          # split flag + partition overhead charge


def _mvd_bits_arr(v: np.ndarray) -> np.ndarray:
    """Vectorized core.ctu._mvd_bits (approximate MVD rate)."""
    a = np.abs(v)
    big = np.maximum(a - 2, 1)
    blen = np.frexp(big.astype(np.float64))[1]          # bit_length
    out = 4 + 2 * blen
    out = np.where(a == 1, 3, out)
    out = np.where(a == 0, 1, out)
    return out


def _sum4(m: np.ndarray) -> np.ndarray:
    h, w = m.shape
    return m.reshape(h // 2, 2, w // 2, 2).sum((1, 3))


@dataclass
class DecisionMaps:
    """Per-8x8-block decision grids on the 64-aligned padded picture."""
    cu_log2_8: np.ndarray     # chosen CU log2 size (3..6)
    inter8: np.ndarray        # bool: inter vs intra
    mv8: np.ndarray           # (nby, nbx, 2) quarter-pel decided MV (L0)
    intra_mode8: np.ndarray   # intra mode of the covering CU
    tu_log2_8: np.ndarray | None = None   # chosen TU log2 (3..5, RQT)
    # B pictures: per-list ref idx (-1 = unused) + per-list MVs
    ref8: np.ndarray | None = None        # (2, nby, nbx)
    mv8_2l: np.ndarray | None = None      # (2, nby, nbx, 2)
    # filled after encode_pass_p:
    lv_y: np.ndarray | None = None
    lv_cb: np.ndarray | None = None
    lv_cr: np.ndarray | None = None
    nz4_y: np.ndarray | None = None
    nz4_cb: np.ndarray | None = None
    nz4_cr: np.ndarray | None = None

    def list_motion(self, by: int, bx: int):
        """(ref0, ref1, mv0, mv1) of the 8-block (by, bx) — the two-list
        generalization used by the walk's plan derivation."""
        if self.ref8 is not None:
            r0 = int(self.ref8[0, by, bx])
            r1 = int(self.ref8[1, by, bx])
            mv0 = (int(self.mv8_2l[0, by, bx, 0]),
                   int(self.mv8_2l[0, by, bx, 1])) if r0 >= 0 else (0, 0)
            mv1 = (int(self.mv8_2l[1, by, bx, 0]),
                   int(self.mv8_2l[1, by, bx, 1])) if r1 >= 0 else (0, 0)
            return r0, r1, mv0, mv1
        if self.inter8[by, bx]:
            return 0, -1, (int(self.mv8[by, bx, 0]),
                           int(self.mv8[by, bx, 1])), (0, 0)
        return -1, -1, (0, 0), (0, 0)


def decide_tree(md: dict, ois: dict, ctb_log2: int) -> DecisionMaps:
    """Bottom-up quadtree decision from dense cost maps.

    md: numpy dict from dense_md_p. ois: {n: (mode_map, cost_map)}.
    Reference analogue: ModeDecisionLcu's depth-first 85-CU search
    (EbProductCodingLoop.c:4691) densified into map algebra.
    """
    L = LAMBDA_MD
    nby, nbx = md["sad8"].shape

    # zero-MV SAD summed per size (merge/skip candidate)
    zs = {8: md["zsad8"].astype(np.float64)}
    for s in (16, 32, 64):
        zs[s] = _sum4(zs[s // 2])

    leaf_cost, leaf_inter, leaf_mv, leaf_mode = {}, {}, {}, {}
    for s, lg in ((8, 3), (16, 4), (32, 5), (64, 6)):
        if (1 << ctb_log2) < s:
            break
        sad = md[f"sad{s}"].astype(np.float64)
        mv = md[f"mv{s}"].astype(np.int32)
        bits = (_mvd_bits_arr(mv[..., 0]) + _mvd_bits_arr(mv[..., 1]))
        ic = sad + L * (bits + 4.0)
        zc = zs[s] + L * 3.0
        use_zero = zc < ic
        inter_c = np.where(use_zero, zc, ic)
        mv_sel = np.where(use_zero[..., None], 0, mv)

        if s <= 32:
            mode_map, cost_map = ois[s]
            intra_c = 2.0 * cost_map.astype(np.float64) + L * 6.0
            # intra gating in inter pictures (mirror of decide_tree_dev):
            # open-loop intra cost reads ~0 on predictable content, so
            # only offer intra where inter prediction genuinely fails
            fails = inter_c > (int(L) * s * s) // 2
            intra_c = np.where(fails, intra_c, np.inf)
        else:
            intra_c = np.full_like(inter_c, np.inf)
            mode_map = np.zeros_like(inter_c, np.int32)
        use_intra = intra_c < inter_c
        leaf_cost[s] = np.where(use_intra, intra_c, inter_c)
        leaf_inter[s] = ~use_intra
        leaf_mv[s] = mv_sel
        leaf_mode[s] = mode_map.astype(np.int32)

    # DP: best(s) = min(leaf(s), sum of children best + split charge)
    best = {8: leaf_cost[8]}
    split = {}
    for s in (16, 32, 64):
        if s not in leaf_cost:
            break
        agg = _sum4(best[s // 2]) + L * SPLIT_BITS
        split[s] = agg < leaf_cost[s]
        best[s] = np.where(split[s], agg, leaf_cost[s])

    top = 1 << ctb_log2
    cu_log2 = np.zeros((nby, nbx), np.int32)
    inter8 = np.zeros((nby, nbx), bool)
    mv8 = np.zeros((nby, nbx, 2), np.int32)
    mode8 = np.zeros((nby, nbx), np.int32)

    def rep(m, k):
        return np.repeat(np.repeat(m, k, 0), k, 1)

    # walk down: a block is a leaf at size s where no ancestor chose a
    # smaller size and split[s] is False
    undecided = np.ones((nby, nbx), bool)
    s = top
    while s >= 8:
        k = s // 8
        if s == 8:
            leaf_here = undecided
        else:
            leaf_here = undecided & ~rep(split[s], k)
        lg = s.bit_length() - 1
        gsel = rep(np.ones_like(leaf_cost[s], bool), k) & leaf_here
        cu_log2[leaf_here] = lg
        inter8 = np.where(leaf_here, rep(leaf_inter[s], k), inter8)
        for c in range(2):
            mv8[..., c] = np.where(leaf_here & rep(leaf_inter[s], k),
                                   rep(leaf_mv[s][..., c], k), mv8[..., c])
        mode8 = np.where(leaf_here, rep(leaf_mode[s], k), mode8)
        undecided &= ~leaf_here
        del gsel
        s //= 2

    return DecisionMaps(cu_log2_8=cu_log2, inter8=inter8, mv8=mv8,
                        intra_mode8=mode8)


# ---------------------------------------------------------------- the walker

class FastCtuEncoder(CtuEncoder):
    """Single-walk CTU coder driven by precomputed decision maps and
    device-computed inter levels/reconstruction.

    st.planes must be pre-initialised with the device inter reconstruction;
    the walk only (a) legalizes inter signalling (merge/AMVP) against the
    final motion field, (b) reconstructs intra CUs closed-loop, and (c)
    emits bins. No inter pixel math happens on the host."""

    def __init__(self, state, bac, src, maps: DecisionMaps, *, features):
        super().__init__(
            state, bac, src,
            split_policy=lambda x0, y0, log2, depth:
                maps.cu_log2_8[y0 >> 3, x0 >> 3] < log2,
            mode_policy=lambda px, py, n:
                int(maps.intra_mode8[py >> 3, px >> 3]),
            features=features)
        self.m = maps

    # ------------------------------------------------------ decision source
    def _cu_any_nz(self, x0: int, y0: int, n: int) -> bool:
        m = self.m
        if m.nz4_y[y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2].any():
            return True
        ys, xs = slice(y0 >> 3, (y0 + n) >> 3), slice(x0 >> 3, (x0 + n) >> 3)
        return bool(m.nz4_cb[ys, xs].any() or m.nz4_cr[ys, xs].any())

    def _compute_plan(self, x0, y0, log2):
        from ..core.ctu import _InterPlan
        from ..core.inter import amvp_candidates, merge_candidates
        from ..core.ctu import _mvd_bits
        st, m = self.st, self.m
        n = 1 << log2
        plan = _InterPlan()
        r0, r1, mv0, mv1 = m.list_motion(y0 >> 3, x0 >> 3)
        if r0 < 0 and r1 < 0:
            plan.use_inter = False
            return plan
        plan.use_inter = True
        target = Mi(mv0, r0, mv1, r1)
        any_nz = self._cu_any_nz(x0, y0, n)
        plan.root_cbf = int(any_nz)
        merge_list = merge_candidates(st, x0, y0, n, st.max_merge)
        plan.merge_list = merge_list
        for idx, cand in enumerate(merge_list):
            if cand == target:
                plan.merge_flag = True
                plan.merge_idx = idx
                plan.mi = target
                plan.skip = not any_nz
                return plan
        plan.mi = target
        plan.idc = 2 if (r0 >= 0 and r1 >= 0) else (0 if r0 >= 0 else 1)
        for lst, mv in ((0, mv0), (1, mv1)):
            if target.ref(lst) < 0:
                continue
            amvp = amvp_candidates(st, x0, y0, n, lst)
            plan.amvp[lst] = amvp
            b0 = (_mvd_bits(mv[0] - amvp[0][0])
                  + _mvd_bits(mv[1] - amvp[0][1]))
            b1 = (_mvd_bits(mv[0] - amvp[1][0])
                  + _mvd_bits(mv[1] - amvp[1][1]))
            mvp_i = 1 if b1 < b0 else 0
            plan.mvp_idx[lst] = mvp_i
            plan.mvd[lst] = (mv[0] - amvp[mvp_i][0], mv[1] - amvp[mvp_i][1])
        return plan

    # ----------------------------------------------- transform tree (RQT)
    def sx_split_transform(self, cu, x0, y0, log2, depth):
        from ..bitstream.contexts import Ctx
        v = 1 if int(self.m.tu_log2_8[y0 >> 3, x0 >> 3]) < log2 else 0
        self.bac.encode_bin(Ctx.SPLIT_TRANSFORM + 5 - log2, v)
        return v

    # ------------------------------------------- intra pixel work: disabled
    # (the wavefront device pass computed recon + levels; the walk only
    # emits syntax and maintains availability)
    def sx_cbf_luma(self, cu, x0, y0, log2, depth):
        if cu.is_inter:
            return super().sx_cbf_luma(cu, x0, y0, log2, depth)
        from ..bitstream.contexts import Ctx
        st, n = self.st, 1 << log2
        lv = self.m.lv_y[y0:y0 + n, x0:x0 + n]
        cu.luma_levels[(x0, y0)] = lv
        st.mark(0, x0, y0, n)
        cbf = int(lv.any())
        self.bac.encode_bin(Ctx.CBF_LUMA + (1 if depth == 0 else 0), cbf)
        return cbf

    # -------------------------------------------- inter pixel work: disabled
    def _predict_mi(self, x0, y0, n, mi):
        # prediction lives on the device; nothing downstream reads it
        # (all cu.pred consumers are overridden)
        return (None, None, None)

    def _inter_nocbf(self, x0, y0, log2, mi, skip):
        """Skip / root_cbf=0: recon already equals the MC prediction in
        st.planes (zero levels => zero residual on device)."""
        st = self.st
        n = 1 << log2
        self._set_motion(x0, y0, n, mi, skip)
        st.mark(0, x0, y0, n)
        sx, sy = st.ss_x, st.ss_y
        for c in (1, 2):
            st.avail[c][y0 >> sy >> 2:(y0 + n) >> sy >> 2,
                        x0 >> sx >> 2:(x0 + n) >> sx >> 2] = True
        st.cbf4[y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2] = 0

    def _tu_split(self, x0, y0, log2) -> bool:
        """The transform tree's split decision at a node (mirrors
        sx_split_transform without emitting)."""
        if log2 > 5:
            return True
        return (log2 > 3
                and int(self.m.tu_log2_8[y0 >> 3, x0 >> 3]) < log2)

    def _luma_tree_inter(self, cu, x0, y0, log2):
        if self._tu_split(x0, y0, log2):
            h = 1 << (log2 - 1)
            for dx, dy in ((0, 0), (h, 0), (0, h), (h, h)):
                self._luma_tree_inter(cu, x0 + dx, y0 + dy, log2 - 1)
            return
        st, n = self.st, 1 << log2
        cu.luma_levels[(x0, y0)] = self.m.lv_y[y0:y0 + n, x0:x0 + n]
        st.mark(0, x0, y0, n)

    def _chroma_tree(self, cu, x0, y0, log2, depth):
        # both inter and intra CUs take their chroma levels from the
        # device maps (inter: encode_pass_p; intra: the wavefront pass);
        # the recursion mirrors the transform tree incl. RQT splits
        st = self.st
        split = self._tu_split(x0, y0, log2) if cu.is_inter else log2 > 5
        if split:
            half = 1 << (log2 - 1)
            any_cbf = {1: 0, 2: 0}
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                self._chroma_tree(cu, x0 + dx, y0 + dy, log2 - 1, depth + 1)
                for c in (1, 2):
                    child = (c, x0 + dx, y0 + dy, log2 - 1)
                    any_cbf[c] |= cu.chroma_cbf[child + (0,)]
            for c in (1, 2):
                cu.chroma_cbf[(c, x0, y0, log2, 0)] = any_cbf[c]
            return
        planes = {1: self.m.lv_cb, 2: self.m.lv_cr}
        for c_idx in (1, 2):
            for sub, (xc, yc, log2c) in enumerate(
                    self._chroma_leaf_tbs(x0, y0, log2)):
                n = 1 << log2c
                lv = planes[c_idx][yc:yc + n, xc:xc + n]
                cu.chroma_levels[(c_idx, xc, yc)] = lv
                cu.chroma_cbf[(c_idx, x0, y0, log2, sub)] = int(lv.any())
                st.avail[c_idx][yc >> 2:(yc + n) >> 2,
                                xc >> 2:(xc + n) >> 2] = True


# ------------------------------------------------------------- orchestration

def run_fast_p(cfg, feat, st, qp, mv_dev, src_dev, ref_dev, col_dev,
               tb, td):
    """Device stages + host walk preparation for one P picture.

    src_dev / ref_dev: (y, cb, cr) device int32 planes, 64-aligned
    (pipeline-level device context — uploaded once per frame; references
    stay device-resident between frames). mv_dev: device HME field. The
    whole device pipeline (phase planes, dense MD, OIS, quadtree
    decision, encode pass) runs as ONE fused graph whose result comes
    back as ONE packed buffer (one device->host transfer). Recon planes
    are written into st.planes."""
    import jax.numpy as jnp

    from ..tpu import encode as tenc

    cw, ch = st.w, st.h
    w64 = (cw + 63) // 64 * 64
    h64 = (ch + 63) // 64 * 64
    bd = st.bit_depth

    src_y, src_cb, src_cr = src_dev
    ref_y, ref_cb, ref_cr = ref_dev

    from ..core.rdo import lambda_sse

    if col_dev is None:
        col_mv = jnp.zeros((h64 // 16, w64 // 16, 2), jnp.int32)
        col_valid = jnp.zeros((h64 // 16, w64 // 16), bool)
    else:
        col_mv, col_valid = col_dev
    (packed, rec_y, rec_cb, rec_cr, out_mv, out_valid,
     lv_dev) = tenc.fast_p_fused_dev(
            src_y, src_cb, src_cr, ref_y, ref_cb, ref_cr, mv_dev,
            jnp.int32(qp), jnp.int32(st.qp_c), jnp.float32(lambda_sse(qp)),
            col_mv, col_valid, jnp.int32(tb), jnp.int32(td),
            ctb_log2=st.ctb_log2, w=cw, h=ch, bit_depth=bd,
            dlf=cfg.enable_deblocking, sao=cfg.enable_sao,
            min_intra_log2=feat.p_min_intra_log2,
            subpel_min=feat.subpel_min_size)
    return (packed, (rec_y, rec_cb, rec_cr), (out_mv, out_valid),
            lv_dev)


def run_fast_b(cfg, feat, st, qp, mv0_dev, mv1_dev, src_dev,
               ref0_dev, ref1_dev):
    """Device stages for one B picture: phase planes for both lists,
    per-list dense MD + bi combination, quadtree decision, B encode
    pass, DLF/SAO — one fused graph, one packed download (the B analogue
    of run_fast_p; reference: the B-slice MD/encode path,
    EbModeDecision.c :926)."""
    import jax.numpy as jnp

    from ..core.rdo import lambda_sse
    from ..tpu import encode as tenc

    cw, ch = st.w, st.h
    d0 = st.ref_pocs[0][0] - st.poc
    d1 = st.ref_pocs[1][0] - st.poc
    (packed, rec_y, rec_cb, rec_cr, out_mv, out_valid,
     lv_dev) = tenc.fast_b_fused_dev(
            *src_dev, *ref0_dev, *ref1_dev, mv0_dev, mv1_dev,
            jnp.int32(d0), jnp.int32(d1),
            jnp.int32(qp), jnp.int32(st.qp_c), jnp.float32(lambda_sse(qp)),
            ctb_log2=st.ctb_log2, w=cw, h=ch, bit_depth=st.bit_depth,
            dlf=cfg.enable_deblocking, sao=cfg.enable_sao,
            min_intra_log2=feat.p_min_intra_log2,
            subpel_min=feat.subpel_min_size)
    return (packed, (rec_y, rec_cb, rec_cr), (out_mv, out_valid),
            lv_dev)


def complete_fast(cfg, st, packed, b_form: bool = False, lv_dev=None):
    """Blocking half of run_fast_p / run_fast_i / run_fast_b: fetch the
    packed device buffer and build the host-side maps. Kept separate so
    the caller can dispatch the NEXT frame's graph before this
    download+walk (frames-in-flight; reference analogue:
    EbEncHandle.c:1645). lv_dev: the device-resident full coefficient
    planes, materialized only when the sparse download overflowed."""
    from ..tpu import encode as tenc
    cw, ch = st.w, st.h
    w64 = (cw + 63) // 64 * 64
    h64 = (ch + 63) // 64 * 64
    specs = (tenc.fused_b_dev_specs if b_form
             else tenc.fused_dev_specs)(h64, w64, cfg.ctb_size)
    out = tenc.unpack(np.asarray(packed), specs)
    return _build_maps(st, out, lv_dev)


def _expand4(buf, cnt, nz4, hh, ww):
    """Rebuild a coefficient plane from its compacted nonzero 4x4 groups
    (device _compact4 layout). Returns None on overflow."""
    if cnt > buf.shape[0]:
        return None
    groups = np.zeros(((hh // 4) * (ww // 4), 16), np.int32)
    pos = np.flatnonzero(nz4.ravel())
    groups[pos] = buf[:cnt]
    return (groups.reshape(hh // 4, ww // 4, 4, 4)
            .transpose(0, 2, 1, 3).reshape(hh, ww))


def _build_maps(st, out: dict, lv_dev=None):
    """(DecisionMaps, sao param arrays) from unpacked download dicts.
    Reconstruction stays device-resident — nothing writes st.planes."""
    cw, ch = st.w, st.h
    if "ref8" in out:
        ref8 = out["ref8"]
        mv8_2l = out["mv8_2l"]
        maps = DecisionMaps(cu_log2_8=out["cu_log2_8"],
                            inter8=(ref8 >= 0).any(0),
                            mv8=mv8_2l[0], intra_mode8=out["intra_mode8"],
                            tu_log2_8=out["tu_log2_8"],
                            ref8=ref8, mv8_2l=mv8_2l)
    else:
        maps = DecisionMaps(cu_log2_8=out["cu_log2_8"],
                            inter8=out["inter8"],
                            mv8=out["mv8"], intra_mode8=out["intra_mode8"],
                            tu_log2_8=out["tu_log2_8"])
    h64 = (ch + 63) // 64 * 64
    w64 = (cw + 63) // 64 * 64
    cnts = out["lv_counts"]
    counts = (cnts[:, 0] & 0x3FFF) + (cnts[:, 1] << 14)
    lv_y = _expand4(out["lvc_y"], int(counts[0]), out["nz4_y"], h64, w64)
    lv_cb = _expand4(out["lvc_cb"], int(counts[1]), out["nz4_cb"],
                     h64 // 2, w64 // 2)
    lv_cr = _expand4(out["lvc_cr"], int(counts[2]), out["nz4_cr"],
                     h64 // 2, w64 // 2)
    if lv_y is None or lv_cb is None or lv_cr is None:
        # sparse download overflowed its cap: one extra transfer of the
        # device-resident full planes (rare — dense intra pictures)
        fy, fcb, fcr = (np.asarray(p).astype(np.int32) for p in lv_dev)
        lv_y = lv_y if lv_y is not None else fy
        lv_cb = lv_cb if lv_cb is not None else fcb
        lv_cr = lv_cr if lv_cr is not None else fcr
    maps.lv_y = lv_y[:ch, :cw]
    maps.lv_cb = lv_cb[:ch // 2, :cw // 2]
    maps.lv_cr = lv_cr[:ch // 2, :cw // 2]
    maps.nz4_y = out["nz4_y"][:ch // 4, :cw // 4]
    maps.nz4_cb = out["nz4_cb"][:ch // 8, :cw // 8]
    maps.nz4_cr = out["nz4_cr"][:ch // 8, :cw // 8]
    sao_np = {k[4:]: out[k] for k in ("sao_type", "sao_eo", "sao_bp",
                                      "sao_offs")}
    return maps, sao_np


def sao_grid_from_arrays(sao_np: dict, ny: int, nx: int):
    """Build the SaoCtbParams grid (syntax emission input) from the
    device decision arrays, cropped to the coded CTB grid."""
    from ..core.sao import SaoCtbParams
    t, e, b, o = (sao_np["type"], sao_np["eo"], sao_np["bp"],
                  sao_np["offs"])
    return [[SaoCtbParams([int(t[y, x, 0]), int(t[y, x, 1])],
                          [int(e[y, x, 0]), int(e[y, x, 1])],
                          [int(b[y, x, c]) for c in range(3)],
                          [[int(v) for v in o[y, x, c]] for c in range(3)])
             for x in range(nx)] for y in range(ny)]


def run_fast_i(cfg, feat, st, qp, src_dev):
    """Device stages + host walk preparation for one I picture: OIS ->
    intra quadtree decision -> closed-loop wavefront encode pass -> DLF
    -> SAO, one fused graph, one packed download (the I analogue of
    run_fast_p)."""
    import jax.numpy as jnp

    from ..core.rdo import lambda_sse
    from ..tpu import encode as tenc

    cw, ch = st.w, st.h
    w64 = (cw + 63) // 64 * 64
    h64 = (ch + 63) // 64 * 64
    src_y, src_cb, src_cr = src_dev
    (packed, rec_y, rec_cb, rec_cr, out_mv, out_valid,
     lv_dev) = tenc.fast_i_fused_dev(
            src_y, src_cb, src_cr, jnp.int32(qp), jnp.int32(st.qp_c),
            jnp.float32(lambda_sse(qp)),
            ctb_log2=st.ctb_log2, w=cw, h=ch, bit_depth=st.bit_depth,
            dlf=cfg.enable_deblocking, sao=cfg.enable_sao,
            refine_modes=feat.i_refine_modes)
    return (packed, (rec_y, rec_cb, rec_cr), (out_mv, out_valid),
            lv_dev)
