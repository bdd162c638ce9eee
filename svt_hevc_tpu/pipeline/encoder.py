"""Encoder pipeline: frames -> Annex-B HEVC byte stream (+ recon frames).

All-intra CQP path. Per picture: pad to coded dims, CABAC-encode the CTU
raster scan through the shared CTU coder, wrap slice into an IDR NAL.

Analogue of the reference steady-state path (SURVEY.md section 3.2):
ResourceCoordination ... EncDec -> EntropyCoding -> Packetization
(reference: Source/Lib/Codec/EbEncHandle.c:3603, EbPacketizationProcess.c:121)
collapsed into a staged per-frame loop; pixel-stage batching moves to the
device graphs in svt_hevc_tpu.tpu.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitstream.cabac import CabacEncoder
from ..bitstream.contexts import init_contexts
from ..bitstream.estimator import CabacEstimator
from ..bitstream.recorder import CabacRecorder, NullCoder
from ..native import cabac_encode_ops
from ..bitstream.headers import (tile_grid, write_pps, write_slice_header,
                                 write_sps, write_vps)
from ..bitstream.nal import NalUnitType, wrap_nal
from ..bitstream import sei
from ..config import EncoderConfig
from ..core.ctu import CtuEncoder, PictureState
from ..preset import derive_preset
from ..core.deblock import deblock_picture
from ..core.rdo import RdSearch, lambda_sse
from ..core.sao import apply_sao, derive_sao_params, encode_sao_ctb
from ..io.yuv import Frame


def _apply_segment_ov(base: np.ndarray, sov: np.ndarray,
                      lo: int, hi: int) -> np.ndarray:
    """Merge per-CTB segment overrides into a QP map (reference semantics:
    EbEncDecProcess.c:2854-2870 — direct QP wins over delta QP over
    deblock-density delta, all clipped to [min,max]QpAllowed)."""
    from ..config import (SEG_DENSITY_DEBLOCK_OV, SEG_DENSITY_QP_OV,
                          SEG_QP_OV_DELTA, SEG_QP_OV_DIRECT)
    sov = np.asarray(sov)
    if sov.shape[:2] != base.shape:
        raise ValueError(f"segment_ov grid {sov.shape[:2]} != CTB grid "
                         f"{base.shape}")
    flags = sov[..., 0].astype(np.int32)
    qp_ov = sov[..., 1].astype(np.int32)
    db_ov = sov[..., 2].astype(np.int32)
    out = base.astype(np.int32).copy()
    direct = ((flags & SEG_DENSITY_QP_OV) != 0) & \
             ((flags & SEG_QP_OV_DIRECT) != 0)
    delta = ((flags & SEG_DENSITY_QP_OV) != 0) & \
            ((flags & SEG_QP_OV_DELTA) != 0) & ~direct
    dbl = ((flags & SEG_DENSITY_DEBLOCK_OV) != 0) & ~direct & ~delta
    out = np.where(direct, qp_ov, out)
    out = np.where(delta, out + np.clip(qp_ov, -25, 25), out)
    out = np.where(dbl, out + np.clip(db_ov, -25, 25), out)
    return np.clip(out, lo, hi)


def pad_plane(plane: np.ndarray, w: int, h: int) -> np.ndarray:
    """Edge-replicate a plane to coded dimensions (reference analogue:
    EbPictureAnalysisProcess.c PadPictureToMultipleOfLcuDimensions)."""
    out = np.empty((h, w), np.int32)
    ph, pw = plane.shape
    out[:ph, :pw] = plane
    if pw < w:
        out[:ph, pw:] = plane[:, -1:]
    if ph < h:
        out[ph:, :] = out[ph - 1:ph, :]
    return out


def finalize_cabac(rec: CabacRecorder, init_ctx: list[int]) -> bytes:
    """Arithmetic-code a recorded op stream: native C core when available,
    else replay through the Python reference backend (bit-identical)."""
    data = cabac_encode_ops(rec.op_array(), init_ctx)
    if data is not None:
        return data
    enc = CabacEncoder(list(init_ctx))
    for kind, a, v in rec.iter_ops():
        if kind == 0:
            enc.encode_bin(a, v)
        elif kind == 1:
            enc.encode_bypass(v)
        elif kind == 2:
            enc.encode_bypass_bins(v, a)
        else:
            enc.encode_terminate(v)
    enc.finish()
    return enc.data


def device_me_field(src_y: np.ndarray, ref_y: np.ndarray) -> np.ndarray:
    """Per-16x16-block quarter-pel MV field from the device HME search
    (svt_hevc_tpu.tpu.me.hme_search), padded to the 64-aligned grid."""
    import jax.numpy as jnp

    from ..tpu.me import hme_search
    h, w = src_y.shape
    hh = (h + 63) // 64 * 64
    ww = (w + 63) // 64 * 64
    sp = pad_plane(src_y, ww, hh)
    rp = pad_plane(ref_y, ww, hh)
    mv, _ = hme_search(jnp.asarray(sp), jnp.asarray(rp))
    return np.asarray(mv)


class _LazyPlanes:
    """List-like [y, cb, cr] post-filter recon planes (coded dims, int32)
    materialized from device-resident arrays on first access — fast-path
    pictures never download their reconstruction unless something
    actually reads it (recon output, a host-path reference, RA DPB)."""

    def __init__(self, rec_dev, cw: int, ch: int):
        self._dev = rec_dev
        self._cw, self._ch = cw, ch
        self._v = None

    def _get(self):
        if self._v is None:
            y, cb, cr = self._dev
            cw, ch = self._cw, self._ch
            self._v = [np.asarray(y)[:ch, :cw].astype(np.int32),
                       np.asarray(cb)[:ch // 2, :cw // 2].astype(np.int32),
                       np.asarray(cr)[:ch // 2, :cw // 2].astype(np.int32)]
        return self._v

    def __getitem__(self, i):
        return self._get()[i]

    def __iter__(self):
        return iter(self._get())

    def __len__(self):
        return 3


class _LazyFrame:
    """Frame-like recon view over _LazyPlanes: materializes a real Frame
    (display crop + dtype) on first attribute access, so fast-path
    pictures whose recon nobody reads never download it."""

    def __init__(self, planes: _LazyPlanes, w: int, h: int, wc: int,
                 hc: int, dt):
        object.__setattr__(self, "_spec", (planes, w, h, wc, hc, dt))
        object.__setattr__(self, "_frame", None)

    def _materialize(self) -> Frame:
        if self._frame is None:
            planes, w, h, wc, hc, dt = self._spec
            object.__setattr__(self, "_frame", Frame(
                y=planes[0][:h, :w].astype(dt),
                cb=planes[1][:hc, :wc].astype(dt),
                cr=planes[2][:hc, :wc].astype(dt)))
        return self._frame

    def __getattr__(self, name):
        return getattr(self._materialize(), name)


@dataclass
class EncodedPicture:
    nal_bytes: bytes          # slice NAL (Annex-B)
    recon: Frame              # cropped reconstruction (possibly lazy)
    poc: int = 0
    ref_planes: list | None = None   # full-plane post-filter recon (DPB)


@dataclass
class PendingPicture:
    """A dispatched-but-not-finalized fast-path picture: the device graph
    is running; recon/DPB handles already exist so the NEXT frame can be
    dispatched against it, and finish() downloads + walks + assembles the
    bitstream (the one-frame-deep analogue of the reference's
    frames-in-flight pipeline, EbEncHandle.c:1645)."""
    poc: int
    recon: object
    ref_planes: object
    _finish: object
    _pic: EncodedPicture | None = None

    def finish(self) -> EncodedPicture:
        if self._pic is None:
            self._pic = self._finish()
        return self._pic


@dataclass
class EncodedAu:
    """One coded access unit from the streaming API (the analogue of the
    reference's EB_BUFFERHEADERTYPE output, EbApi.h)."""

    data: bytes               # slice NAL(s) + per-AU SEI (Annex-B)
    recon: Frame
    poc: int
    slice_type: int           # 2 I, 1 P, 0 B
    is_idr: bool
    display_idx: int
    decode_idx: int


class Encoder:
    """HEVC encoder (CQP): all-intra or low-delay P per cfg.intra_period."""

    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg.validate()
        self._sent_headers = False
        self._frame_idx = 0
        self._ref_planes = None      # previous picture planes (post-filter)
        self._ref_poc = 0
        # (poc, w64, h64) -> device (y, cb, cr) padded int32 reference
        # planes, so fast-path P pictures never re-upload references
        self._dev_dpb: dict = {}
        # poc -> motion field of coded reference pictures (TMVP
        # collocated data; reference: the TMVP map, EbCodingLoop.c:4500)
        self._ref_motion: dict = {}
        # (poc, w64, h64) -> (col16_mv, col16_valid, ref_poc_l0) DEVICE
        # arrays: each fast picture's decided motion, 16x16-compressed,
        # chained into the next picture's dense MD as the TMVP merge
        # candidate without any host round trip
        self._dev_motion: dict = {}
        self._dev_motion_cap = 6
        # the not-yet-finalized pipelined picture (PendingPicture):
        # synchronous (host-path) encodes force-finish it first so the
        # collocated motion field exists
        self._inflight = None
        # dynamic preset (reference analogue: SpeedBufferControl,
        # EbResourceCoordinationProcess.c :68): adjusted in encode() when
        # speed control is enabled
        self._dyn_enc_mode: int | None = None
        self._speed_target_fps: float | None = None
        # checkpoint/resume state (SURVEY §5: the encoder's resumable
        # state is the DPB + RC state, a plain pytree — unlike the
        # reference, which has no checkpoint surface at all)
        self._ckpt_prev_y = None
        self._prev_src_y = None      # previous padded source luma (QPM
        #                              stationary-edge temporal axis)
        self._ckpt_ll_last: dict = {}
        self._ckpt_rc_state: dict | None = None
        self._resuming = False
        self.last_rc = None

    # ------------------------------------------------------ checkpoint/resume
    def checkpoint(self) -> dict:
        """Snapshot the streaming-encode state after a completed
        encode_pictures() segment: frame counter, POC base, reference
        planes per temporal layer (the DPB), SCD context, and rate-control
        state. The snapshot is plain numpy/python data — picklable,
        device-free — and a fresh Encoder restored from it continues the
        stream bit-exactly (tests/test_checkpoint.py)."""
        rc_state = None
        if self.last_rc is not None:
            rc_state = {k: v for k, v in self.last_rc.__dict__.items()
                        if k != "cfg"}
        return {
            "frame_idx": self._frame_idx,
            "poc_base": getattr(self, "_poc_base", 0),
            "ll_last": {
                layer: (idx, tuple(np.asarray(p) for p in planes), poc)
                for layer, (idx, planes, poc) in self._ckpt_ll_last.items()},
            "prev_y": (None if self._ckpt_prev_y is None
                       else np.asarray(self._ckpt_prev_y)),
            "rc": rc_state,
            "ref_planes": (None if self._ref_planes is None
                           else tuple(np.asarray(p)
                                      for p in self._ref_planes)),
            "ref_poc": self._ref_poc,
            # TMVP collocated state: host 16x16-compressed motion (the
            # emit walk's merge lists) and its device mirror (the dense
            # MD's TMVP candidate) — both required for bit-exact resume
            "ref_motion": {k: {kk: (np.asarray(vv) if isinstance(
                                        vv, np.ndarray) else vv)
                               for kk, vv in v.items()}
                           for k, v in self._ref_motion.items()},
            "dev_motion": {k: (np.asarray(v[0]), np.asarray(v[1]), v[2])
                           for k, v in self._dev_motion.items()},
        }

    def restore(self, ckpt: dict) -> None:
        """Restore a checkpoint() snapshot into this (fresh) encoder; the
        next encode_pictures() call continues the stream."""
        self._frame_idx = int(ckpt["frame_idx"])
        self._poc_base = int(ckpt["poc_base"])
        self._ckpt_ll_last = {
            layer: (idx, tuple(planes), poc)
            for layer, (idx, planes, poc) in ckpt["ll_last"].items()}
        self._ckpt_prev_y = ckpt["prev_y"]
        self._ckpt_rc_state = (dict(ckpt["rc"])
                               if ckpt.get("rc") is not None else None)
        self._ref_planes = (None if ckpt["ref_planes"] is None
                            else tuple(ckpt["ref_planes"]))
        self._ref_poc = ckpt["ref_poc"]
        self._ref_motion = {k: dict(v)
                            for k, v in ckpt["ref_motion"].items()}
        self._dev_motion = dict(ckpt["dev_motion"])
        self._resuming = True

    def set_speed_control(self, target_fps: float) -> None:
        """Enable dynamic-preset speed control toward a target encode
        rate; enc_mode then floats in [cfg.enc_mode, 11]."""
        self._speed_target_fps = target_fps
        self._dyn_enc_mode = self.cfg.enc_mode

    def _leaf_batchable(self, frame, rd) -> bool:
        """True when this leaf picture would take the single-ref fused
        fast path in encode_frame (the mesh-batched dispatch runs exactly
        that graph; any condition that would fall to the host path or a
        different graph disqualifies the picture from batching)."""
        from ..preset import derive_preset
        cfg = self.cfg
        feat = derive_preset(cfg.enc_mode)
        if rd is None:
            rd = feat.rd_mode_decision
        return (cfg.chroma_format == 1 and cfg.bit_depth == 8
                and cfg.tile_columns == 1 and cfg.tile_rows == 1
                and not cfg.constrained_motion_tiles
                and not cfg.constrained_intra
                and not cfg.improve_sharpness
                and not cfg.bit_rate_reduction
                and getattr(frame, "segment_ov", None) is None
                and feat.ois_intra and not rd)

    def _flush_inflight(self) -> None:
        """Force-finish the pipelined picture in flight (host-path
        encodes and TMVP lookups need its final motion field)."""
        if self._inflight is not None:
            self._inflight.finish()
            self._inflight = None

    def _col_for(self, col_poc):
        """Collocated motion dict for TMVP, or None. A missing entry for
        a requested collocated POC is an encoder ordering bug (the slice
        header will still signal slice_temporal_mvp_enabled_flag=1, so
        silently dropping the temporal candidate would desync the
        decoder's merge/AMVP lists) — fail loudly like decoder.py does."""
        if col_poc is None:
            return None
        ent = self._ref_motion.get(col_poc)
        if ent is None:
            raise RuntimeError(
                f"TMVP collocated motion for POC {col_poc} not registered "
                "(motion-registration/flush ordering bug)")
        return dict(ent, from_l0=True)

    def _frame_is_idr(self, idx: int) -> bool:
        ip = self.cfg.intra_period
        if idx == 0 or ip == 0:
            return True
        if ip < 0:
            return False
        return idx % (ip + 1) == 0

    @staticmethod
    def _scene_cut(prev_y: np.ndarray, cur_y: np.ndarray) -> bool:
        """Region-histogram scene-change detector (reference analogue:
        EbPictureDecisionProcess.c SceneTransitionDetector :73 — per-region
        accumulated histogram difference vs threshold)."""
        h, w = cur_y.shape
        rh, rw = max(h // 4, 1), max(w // 4, 1)
        votes = 0
        regions = 0
        shift = 3 if cur_y.dtype == np.uint8 else 5   # 32 histogram bins
        for ry in range(0, h - rh + 1, rh):
            for rx in range(0, w - rw + 1, rw):
                a = np.bincount(prev_y[ry:ry + rh, rx:rx + rw].ravel() >> shift,
                                minlength=32)
                b = np.bincount(cur_y[ry:ry + rh, rx:rx + rw].ravel() >> shift,
                                minlength=32)
                ahd = np.abs(a - b).sum()
                regions += 1
                if ahd > 0.6 * rh * rw:
                    votes += 1
        return regions > 0 and votes > regions // 2

    def headers(self) -> bytes:
        cfg = self.cfg
        out = (wrap_nal(NalUnitType.VPS_NUT, write_vps(cfg))
               + wrap_nal(NalUnitType.SPS_NUT, write_sps(cfg))
               + wrap_nal(NalUnitType.PPS_NUT, write_pps(cfg)))
        msgs = [sei.write_active_parameter_sets()]
        if cfg.max_cll or cfg.max_fall:
            msgs.append(sei.write_content_light_level(cfg.max_cll, cfg.max_fall))
        if cfg.mastering_display is not None:
            md = cfg.mastering_display
            msgs.append(sei.write_mastering_display(
                [(md[0], md[1]), (md[2], md[3]), (md[4], md[5])],
                (md[6], md[7]), md[8], md[9]))
        if cfg.use_recovery_point_sei:
            msgs.append(sei.write_recovery_point(0))
        if cfg.constrained_motion_tiles:
            msgs.append(sei.write_temporal_mcts())
        out += wrap_nal(NalUnitType.PREFIX_SEI_NUT, sei.sei_rbsp(msgs))
        return out

    def _hrd_sei(self, is_idr: bool, dpb_output_delay: int = 0) -> bytes:
        """Per-AU HRD timing SEIs (reference: EbPacketizationProcess.c
        buffering period / pic timing emission): buffering_period at each
        IDR, pic_timing on every picture."""
        from ..bitstream.headers import hrd_rate_size
        msgs = []
        if is_idr or not hasattr(self, "_au_since_bp"):
            rate, size = hrd_rate_size(self.cfg)
            delay = int(90000 * 0.9 * size / rate)
            offset = int(90000 * size / rate) - delay
            msgs.append(sei.write_buffering_period(delay, offset))
            self._au_since_bp = 0
        msgs.append(sei.write_pic_timing(max(self._au_since_bp - 1, 0),
                                         dpb_output_delay))
        self._au_since_bp += 1
        return wrap_nal(NalUnitType.PREFIX_SEI_NUT, sei.sei_rbsp(msgs))

    def _derive_qp_map(self, y_plane: np.ndarray, base_qp: int,
                       frame=None) -> np.ndarray:
        """Per-CTB desired QP from device spatial activity (reference QPM,
        EbEncDecProcess.c QpmDeriveWeightsMinAndMax :1919): textured CTBs
        (high masking) take a higher QP, smooth ones a lower QP when
        improve_sharpness; bit_rate_reduction biases the map upward.
        With the full frame available, the content classes (grass/skin/
        dark/stationary-edge, pipeline/content_class.py — the reference's
        SourceBasedOperations classification,
        EbSourceBasedOperationsProcess.c:1159-1369) refine the map."""
        import jax.numpy as jnp

        from ..tpu.analysis import ctb_activity
        cfg = self.cfg
        ctb = cfg.ctb_size
        hh = (y_plane.shape[0] + ctb - 1) // ctb * ctb
        ww = (y_plane.shape[1] + ctb - 1) // ctb * ctb
        yp = pad_plane(y_plane.astype(np.int32), ww, hh)
        act = np.asarray(ctb_activity(jnp.asarray(yp, jnp.float32), ctb))
        act = np.maximum(act, 1.0)
        gmean = float(np.exp(np.log(act).mean()))
        delta = np.round(1.5 * np.log2(act / gmean))
        lo = -3 if cfg.improve_sharpness else 0
        delta = np.clip(delta, lo, 3)
        if cfg.improve_sharpness and frame is not None:
            from .content_class import classify_ctbs, qp_class_delta
            cwc = ww * frame.cb.shape[1] // y_plane.shape[1]
            chc = hh * frame.cb.shape[0] // y_plane.shape[0]
            classes = classify_ctbs(
                yp,
                pad_plane(np.asarray(frame.cb, np.int32), cwc, chc),
                pad_plane(np.asarray(frame.cr, np.int32), cwc, chc),
                ctb, activity=act, prev_y=self._prev_src_y,
                bit_depth=cfg.bit_depth)
            self._prev_src_y = yp
            self.last_classes = classes
            delta = delta + qp_class_delta(classes)
        elif cfg.improve_sharpness:
            # dark-area protection (reference SourceBasedOperations dark
            # LCU classification, EbSourceBasedOperationsProcess.c:1159+):
            # banding in dark regions is highly visible — spend more bits
            means = yp.reshape(hh // ctb, ctb, ww // ctb, ctb).mean((1, 3))
            delta = np.where(means < 0.2 * (1 << cfg.bit_depth),
                             delta - 1, delta)
        if cfg.bit_rate_reduction:
            delta += 1
        return np.clip(base_qp + delta, 1, 51).astype(np.int32)

    def encode_frame(self, frame: Frame, *, split_policy=None,
                     part_nxn_policy=None, rd: bool | None = None,
                     is_idr: bool | None = None, poc: int = 0,
                     qp: int | None = None, slice_type: int | None = None,
                     refs_l0=None, refs_l1=None,
                     qp_map: np.ndarray | None = None,
                     non_ref: bool = False,
                     retain_pocs=None,
                     pipelined: bool = False,
                     nal_type_override=None,
                     precomputed=None) -> EncodedPicture:
        """Encode one picture. refs_lX: list of (planes, poc) per list
        (None => derived from the single-ref low-delay DPB). qp_map:
        explicit per-CTB QP grid (overrides the derived QPM map).
        retain_pocs: POCs that FUTURE pictures still reference — signalled
        in the RPS with used_by_curr_pic=0 so the decoder's DPB keeps them
        (7.4.8; the reference's dependent-count RPS machinery,
        EbPredictionStructure.c:857)."""
        cfg = self.cfg
        if cfg.enable_denoise:
            frame = self._denoise(frame)
        feat = derive_preset(self._dyn_enc_mode if self._dyn_enc_mode
                             is not None else cfg.enc_mode)
        if rd is None:
            rd = feat.rd_mode_decision
        if is_idr is None:
            is_idr = self._ref_planes is None and refs_l0 is None
        if qp is None:
            qp = cfg.qp
        if slice_type is None:
            slice_type = 2 if is_idr else 1
        if not is_idr and refs_l0 is None and slice_type != 2:
            refs_l0 = [(self._ref_planes, self._ref_poc)]
        if slice_type == 0 and not refs_l1:
            refs_l1 = list(refs_l0)          # low-delay B: L1 = L0
        init_type = {2: 0, 1: 1, 0: 2}[slice_type]
        # TMVP collocated picture: list-0 ref 0 (collocated_from_l0
        # signalled 1 for B slices)
        col_poc = (refs_l0[0][1]
                   if cfg.tmvp and not is_idr and refs_l0
                   and slice_type != 2 else None)
        cw, ch = cfg.coded_width, cfg.coded_height
        cw_c, ch_c = cw // cfg.sub_width_c, ch // cfg.sub_height_c
        src = [
            pad_plane(frame.y.astype(np.int32), cw, ch),
            pad_plane(frame.cb.astype(np.int32), cw_c, ch_c),
            pad_plane(frame.cr.astype(np.int32), cw_c, ch_c),
        ]
        ctb = cfg.ctb_size
        n_ctb_x = (cw + ctb - 1) // ctb
        n_ctb_y = (ch + ctb - 1) // ctb
        # tile partitioning (tile-scan CTU order; reference analogue:
        # per-tile-group EncDec tasks, EbModeDecisionConfigurationProcess.c
        # :2086, per-tile entropy EbEntropyCodingProcess.c :313)
        col_bd, row_bd = tile_grid(n_ctb_x, n_ctb_y,
                                   cfg.tile_columns, cfg.tile_rows)
        tiles = []       # [(ctb_order, left_col, top_row, pixel_rect)]
        for tr in range(cfg.tile_rows):
            for tc in range(cfg.tile_columns):
                order = [(cx * ctb, cy * ctb)
                         for cy in range(row_bd[tr], row_bd[tr + 1])
                         for cx in range(col_bd[tc], col_bd[tc + 1])]
                rect = (col_bd[tc] * ctb, row_bd[tr] * ctb,
                        min(col_bd[tc + 1] * ctb, cw),
                        min(row_bd[tr + 1] * ctb, ch))
                tiles.append((order, col_bd[tc], row_bd[tr], rect))
        last_xy = tiles[-1][0][-1]
        mcts = cfg.constrained_motion_tiles
        tile_edges_x = [min(col_bd[i] * ctb, cw)
                        for i in range(1, cfg.tile_columns)]
        tile_edges_y = [min(row_bd[i] * ctb, ch)
                        for i in range(1, cfg.tile_rows)]

        # QPM activity map only when a QPM tool asks for it (reference
        # gates derivation on improveSharpness||bitRateReduction,
        # EbEncDecProcess.c:2838); segment_ov_enabled alone applies the
        # per-LCU overrides over a flat base map (:2854)
        if qp_map is None and (cfg.improve_sharpness or cfg.bit_rate_reduction):
            qp_map = self._derive_qp_map(np.asarray(frame.y), qp,
                                         frame=frame)
        if frame.segment_ov is not None:
            # per-CTB segment overrides (reference: SegmentOverride_t
            # applied per LCU, EbEncDecProcess.c:2854-2870)
            if not cfg.segment_ov_enabled:
                raise ValueError("Frame.segment_ov requires "
                                 "segment_ov_enabled=True in the config")
            base = (qp_map if qp_map is not None
                    else np.full((n_ctb_y, n_ctb_x), qp, np.int32))
            qp_map = _apply_segment_ov(base, frame.segment_ov,
                                       cfg.min_qp_allowed,
                                       cfg.max_qp_allowed)
        if qp_map is None and cfg.adaptive_qp:
            # cu_qp_delta is signalled in the PPS for the whole stream:
            # pictures with no QPM/override input still code (zero) deltas
            # against a flat map, keeping parser and encoder in sync
            qp_map = np.full((n_ctb_y, n_ctb_x), qp, np.int32)

        def new_state():
            s = PictureState(cw, ch, qp, cfg.ctb_log2, cfg.bit_depth,
                             chroma_format=cfg.chroma_format)
            s.constrained_intra = cfg.constrained_intra
            s.max_tt_depth_inter = 2     # matches the SPS (write_sps)
            if mcts:
                s.filter_across_tiles = False
                s.tile_edges_x = tile_edges_x
                s.tile_edges_y = tile_edges_y
            if qp_map is not None:
                s.enable_cu_qp_delta(qp_map)
            if not is_idr and refs_l0:      # CRA: intra, no ref lists
                s.slice_type = slice_type
                s.ref_planes = [[r[0] for r in refs_l0],
                                [r[0] for r in (refs_l1 or [])]]
                s.ref_pocs = [[r[1] for r in refs_l0],
                              [r[1] for r in (refs_l1 or [])]]
                s.poc = poc
            return s

        # ---- device context: ship the source once (narrow dtype), keep
        # reference planes device-resident between frames, and let every
        # device stage (HME, OIS, dense MD, encode pass) consume the
        # device arrays without host round trips.
        # 8-bit AND 10-bit run the device path: every kernel is int32
        # with bit_depth a static knob (the reference's 10-bit runs the
        # same full-speed path via its 16-bit kernel variants,
        # EbPictureOperators.c:428-544)
        fast_capable = (cfg.chroma_format == 1
                        and cfg.bit_depth in (8, 10)
                        and len(tiles) == 1 and not mcts
                        and split_policy is None
                        and part_nxn_policy is None)
        w64, h64 = (cw + 63) // 64 * 64, (ch + 63) // 64 * 64
        src_dev = ref_dev = ref1_dev = None
        single_ref = (not is_idr and refs_l0 is not None
                      and len(refs_l0) == 1 and not refs_l1)
        b_pair = (not is_idr and slice_type == 0
                  and refs_l0 is not None and len(refs_l0) == 1
                  and refs_l1 is not None and len(refs_l1) == 1)
        if fast_capable and precomputed is None:
            from ..tpu import encode as tenc

            def dev_ref(entry):
                got = self._dev_dpb.get((entry[1], w64, h64))
                if got is None:
                    dt = np.uint8 if cfg.bit_depth == 8 else np.uint16
                    rp = entry[0]
                    got = tenc.prep_planes(rp[0].astype(dt),
                                           rp[1].astype(dt),
                                           rp[2].astype(dt), w64, h64)
                return got

            src_dev = tenc.prep_planes(np.ascontiguousarray(frame.y),
                                       np.ascontiguousarray(frame.cb),
                                       np.ascontiguousarray(frame.cr),
                                       w64, h64)
            if single_ref:
                ref_dev = dev_ref(refs_l0[0])
            elif b_pair:
                ref_dev = dev_ref(refs_l0[0])
                ref1_dev = (ref_dev if refs_l1[0][1] == refs_l0[0][1]
                            else dev_ref(refs_l1[0]))

        # ---- fast paths: ONE fused device graph (P: phases + dense MD +
        # OIS + quadtree decision + encode pass + intra wavefront;
        # B: both lists + bi; I: OIS + decision + intra wavefront) +
        # native syntax emission from the maps (pipeline/native_emit.py)
        use_fast = (fast_capable and slice_type == 1 and not rd
                    and single_ref and qp_map is None and feat.ois_intra
                    and not cfg.constrained_intra)
        use_fast_b = (fast_capable and b_pair and not rd
                      and qp_map is None and feat.ois_intra
                      and not cfg.constrained_intra)
        use_fast_i = (fast_capable and slice_type == 2 and not rd
                      and qp_map is None and feat.ois_intra)

        me_seed = mv_dev = mv1_dev = None
        if not is_idr and slice_type != 2 and precomputed is None:
            if ref_dev is not None:
                from ..tpu.me import hme_search
                mv_dev = hme_search(src_dev[0], ref_dev[0])[0]
                if ref1_dev is not None:
                    mv1_dev = (mv_dev if ref1_dev is ref_dev
                               else hme_search(src_dev[0], ref1_dev[0])[0])
                if not (use_fast or use_fast_b):
                    me_seed = np.asarray(mv_dev)
            else:
                me_seed = device_me_field(src[0], refs_l0[0][0][0])

        # device open-loop intra search once per picture; its mode/cost maps
        # drive the MD shortlist at OIS presets (reference: OIS feeding MD
        # candidate pruning, EbModeDecisionConfigurationProcess.c:289).
        # Fast-path pictures run OIS inside the fused graph instead.
        if feat.ois_intra and not (use_fast or use_fast_i or use_fast_b):
            ois = self._ois_maps(src[0] if src_dev is None else src_dev[0])
        else:
            ois = None

        rec_dev = packed = None
        if use_fast or use_fast_i or use_fast_b:
            # dispatch the fused device graph; the download + host walk
            # happen in _complete() so a pipelined caller can dispatch
            # the NEXT frame first (frames-in-flight)
            from .fast_path import run_fast_b, run_fast_i, run_fast_p
            st = new_state()
            if precomputed is not None:
                # mesh-batched leaf picture: the fused graph already ran
                # (vmapped over the device mesh, parallel/pictures.py) —
                # bind its per-lane outputs and fall through to the same
                # host walk as the per-picture path
                packed, rec_dev, mot_dev, lv_dev = precomputed
            elif use_fast_i:
                packed, rec_dev, mot_dev, lv_dev = run_fast_i(
                    cfg, feat, st, qp, src_dev)
            elif use_fast_b:
                packed, rec_dev, mot_dev, lv_dev = run_fast_b(
                    cfg, feat, st, qp, mv_dev, mv1_dev, src_dev,
                    ref_dev, ref1_dev)
            else:
                # device-resident TMVP collocated motion of the L0
                # reference + its POC distances (8.5.3.2.8 tb/td)
                col_ent = (self._dev_motion.get((col_poc, w64, h64))
                           if col_poc is not None else None)
                col_dev = None
                tb = td = 1
                if col_ent is not None:
                    col_dev = (col_ent[0], col_ent[1])
                    tb = poc - refs_l0[0][1]
                    td = (col_poc - col_ent[2]
                          if col_ent[2] is not None else tb)
                packed, rec_dev, mot_dev, lv_dev = run_fast_p(
                    cfg, feat, st, qp, mv_dev, src_dev, ref_dev,
                    col_dev, tb, td)
            if not non_ref:
                if is_idr:
                    self._dev_motion.clear()
                self._dev_motion[(poc, w64, h64)] = (
                    mot_dev[0], mot_dev[1],
                    refs_l0[0][1] if (refs_l0 and not is_idr
                                      and slice_type != 2) else None)
                while len(self._dev_motion) > self._dev_motion_cap:
                    del self._dev_motion[next(iter(self._dev_motion))]
            substreams = None
        else:
            substreams = None

        slice_per_tile = bool(cfg.tile_slice_mode) and len(tiles) > 1
        if substreams is None and packed is None:
            # synchronous host-path encode: the previous pipelined frame
            # must be final (its motion field is this frame's TMVP source)
            self._flush_inflight()
            # ---- pass 1: decide + reconstruct (no bitstream output) ----
            st = new_state()
            st.col = self._col_for(col_poc)
            decisions_all: dict = {}
            # decide-once cache shared with pass 2 (identical recon state
            # => identical plans/modes; pass 2 only replays)
            dcache = {"plans": {}, "modes": {}}
            for order, _, _, rect in tiles:
                st.begin_tile()
                est_ctx = init_contexts(qp, init_type=init_type)
                mrect = rect if mcts else None
                if rd:
                    for x0, y0 in order:
                        rds = RdSearch(st, src, me_seed=me_seed,
                                       try_nxn=feat.try_nxn, features=feat,
                                       ois=ois, mcts_rect=mrect)
                        decisions, est_ctx = rds.compress_ctu(x0, y0, est_ctx)
                        decisions_all[(x0, y0)] = decisions
                else:
                    # decide-only walk: bins never read in non-RD pass 1
                    sink = NullCoder(est_ctx)
                    enc1 = CtuEncoder(st, sink, src,
                                      split_policy=split_policy,
                                      part_nxn_policy=part_nxn_policy,
                                      me_seed=me_seed, features=feat,
                                      ois=ois, decision_cache=dcache,
                                      mcts_rect=mrect)
                    for x0, y0 in order:
                        enc1.code_ctu(x0, y0)

            if cfg.enable_deblocking:
                deblock_picture(st)

            sao_grid = None
            if cfg.enable_sao:
                sao_grid = derive_sao_params(st, src, lambda_sse(qp))
                apply_sao(st, sao_grid, True, True)

            # ---- pass 2: emit the real CABAC stream (replays
            # identically). Syntax is recorded per tile as a bin-op
            # stream; each tile's sequential arithmetic runs independently
            # in the native C core (svt_hevc_tpu/native/cabac.c) ----
            st2 = new_state()
            st2.col = st.col
            substreams = []
            for t_idx, (order, left_col, top_row, rect) in enumerate(tiles):
                st2.begin_tile()
                mrect = rect if mcts else None
                bac = CabacRecorder(init_contexts(qp, init_type=init_type))
                if not rd:
                    enc = CtuEncoder(st2, bac, src,
                                     split_policy=split_policy,
                                     part_nxn_policy=part_nxn_policy,
                                     me_seed=me_seed, features=feat, ois=ois,
                                     decision_cache=dcache, mcts_rect=mrect)
                for x0, y0 in order:
                    if rd:
                        d = decisions_all[(x0, y0)]
                        enc = CtuEncoder(st2, bac, src,
                                         split_policy=d.split_policy,
                                         part_nxn_policy=d.part_nxn_policy,
                                         mode_policy=d.mode_policy,
                                         me_seed=me_seed, features=feat,
                                         ois=ois, mcts_rect=mrect)
                    if sao_grid is not None:
                        encode_sao_ctb(bac, sao_grid, x0 // ctb, y0 // ctb,
                                       True, True, bit_depth=cfg.bit_depth,
                                       left_ok=x0 // ctb > left_col,
                                       up_ok=y0 // ctb > top_row)
                    enc.code_ctu(x0, y0)
                    # end_of_slice_segment_flag: last CTB of the slice
                    # (the tile in tile-slice mode, else the picture)
                    last = (x0, y0) == (order[-1] if slice_per_tile
                                        else last_xy)
                    bac.encode_terminate(1 if last else 0)
                if not slice_per_tile and t_idx != len(tiles) - 1:
                    bac.encode_terminate(1)      # end_of_subset_one_bit
                substreams.append(
                    finalize_cabac(bac,
                                   init_contexts(qp, init_type=init_type)))

        all_ref_pocs = {r[1] for r in (refs_l0 or [])} | \
                       {r[1] for r in (refs_l1 or [])}
        keep = set(retain_pocs or ()) | all_ref_pocs
        keep.discard(poc)
        negs = [(poc - rp, int(rp in all_ref_pocs))
                for rp in sorted((p for p in keep if p < poc),
                                 reverse=True)]
        poss = [(rp - poc, int(rp in all_ref_pocs))
                for rp in sorted(p for p in keep if p > poc)]
        nal_type = (nal_type_override if nal_type_override is not None
                    else NalUnitType.IDR_W_RADL if is_idr
                    else NalUnitType.TRAIL_N if non_ref
                    else NalUnitType.TRAIL_R)
        irap = is_idr or nal_type == NalUnitType.CRA_NUT

        # ---- DPB updates happen at dispatch time: the device recon
        # handle (fast) / host planes (slow) already exist, so the next
        # frame can reference this one before its bitstream is final
        dt = np.uint8 if cfg.bit_depth == 8 else np.uint16
        hc, wc = frame.cb.shape
        if rec_dev is not None:
            # fast path: the post-filter recon lives on the device; it
            # becomes the next reference directly (device-resident DPB —
            # no download, no upload), and the host-side recon / DPB
            # views materialize lazily only if something reads them
            if is_idr:
                self._dev_dpb.clear()
            if not non_ref:
                self._dev_dpb[(poc, w64, h64)] = rec_dev
                while len(self._dev_dpb) > 6:
                    del self._dev_dpb[next(iter(self._dev_dpb))]
            lazy = _LazyPlanes(rec_dev, cw, ch)
            self._ref_planes = lazy
            self._ref_poc = poc
            recon = _LazyFrame(lazy, frame.width, frame.height, wc, hc, dt)
        else:
            # host-path picture: planes are the post-filter recon
            self._ref_planes = [p.copy() for p in st.planes]
            self._ref_poc = poc
            # keep the device DPB coherent so a following fast P picture
            # can still motion-compensate without re-uploading later
            if fast_capable and not non_ref:
                from ..tpu import encode as tenc
                if is_idr:
                    self._dev_dpb.clear()
                self._dev_dpb[(poc, w64, h64)] = tenc.prep_planes(
                    st.planes[0].astype(dt), st.planes[1].astype(dt),
                    st.planes[2].astype(dt), w64, h64)
                while len(self._dev_dpb) > 6:
                    del self._dev_dpb[next(iter(self._dev_dpb))]
            recon = Frame(
                y=st.planes[0][:frame.height, :frame.width].astype(dt),
                cb=st.planes[1][:hc, :wc].astype(dt),
                cr=st.planes[2][:hc, :wc].astype(dt),
            )
        ref_planes = self._ref_planes

        def _complete() -> EncodedPicture:
            substr = substreams
            if substr is None:
                # fast path: fetch the packed device buffer, walk, CABAC.
                # The collocated motion binds HERE (not at dispatch): the
                # previous frame's walk has finished by completion order.
                st.col = self._col_for(col_poc)
                from .fast_path import complete_fast
                maps, sao_np = complete_fast(cfg, st, packed,
                                             b_form=use_fast_b,
                                             lv_dev=lv_dev)
                substr = self._encode_fast(
                    st, src, maps, sao_np, qp, feat, tiles[0][0], last_xy,
                    init_type)
            if cfg.tmvp and not non_ref:
                # this picture's final motion field is a future TMVP
                # collocated source (reference: TMVP map fill,
                # EbCodingLoop.c:4500)
                self._ref_motion[poc] = {
                    "mv": st.mv[::4, ::4].copy(),     # 16x16 compression
                    "ref_idx": st.ref_idx[::4, ::4].copy(),
                    "ref_pocs": [list(st.ref_pocs[0]),
                                 list(st.ref_pocs[1])],
                    "poc": poc}
                # lifetime mirrors the decoder DPB: anything a future
                # picture could still collocate against stays
                for k in [k for k in self._ref_motion
                          if abs(k - poc) > 64]:
                    del self._ref_motion[k]
            if slice_per_tile:
                # one independent slice NAL per tile (reference
                # tileSliceMode, EbApi.h:360; MCTS packaging tested by
                # the reference's FunctionalTests MCTS check)
                nals = []
                for t_idx, (order, _, _, _) in enumerate(tiles):
                    ax, ay = order[0]
                    addr = ((ay >> cfg.ctb_log2) * n_ctb_x
                            + (ax >> cfg.ctb_log2))
                    w = write_slice_header(cfg, slice_qp=qp, is_idr=is_idr,
                                           poc=poc, slice_type=slice_type,
                                           entry_points=[], neg_deltas=negs,
                                           pos_deltas=poss,
                                           first_slice=t_idx == 0,
                                           slice_address=addr, irap=irap)
                    w.write_bytes(substr[t_idx])
                    nals.append(wrap_nal(nal_type, w.get_bytes()))
                nal = b"".join(nals)
            else:
                payload = b"".join(substr)
                entry_points = [len(s) for s in substr[:-1]]
                w = write_slice_header(cfg, slice_qp=qp, is_idr=is_idr,
                                       poc=poc, slice_type=slice_type,
                                       entry_points=entry_points,
                                       neg_deltas=negs, pos_deltas=poss,
                                       irap=irap)
                w.write_bytes(payload)
                nal = wrap_nal(nal_type, w.get_bytes())

            # per-picture metadata: prefix user-data SEIs before the
            # slice, Dolby Vision RPU as NAL 62 after it (reference:
            # per-buffer SEI attachments + RPU passthrough,
            # EbPacketizationProcess.c:733-752)
            pre_msgs = []
            if frame.sei_t35 is not None:
                pre_msgs.append(sei.write_user_data_registered(
                    frame.sei_t35))
            if frame.sei_unreg is not None:
                pre_msgs.append(sei.write_user_data_unregistered(
                    frame.sei_unreg[0], frame.sei_unreg[1]))
            out = nal
            if pre_msgs:
                out = wrap_nal(NalUnitType.PREFIX_SEI_NUT,
                               sei.sei_rbsp(pre_msgs)) + out
            if cfg.dolby_vision_profile == 81 and frame.dv_rpu:
                out += wrap_nal(NalUnitType.UNSPEC62, frame.dv_rpu)
            pic = EncodedPicture(nal_bytes=out, recon=recon, poc=poc)
            pic.ref_planes = ref_planes
            return pic

        if pipelined and packed is not None:
            return PendingPicture(poc=poc, recon=recon,
                                  ref_planes=ref_planes, _finish=_complete)
        return _complete()

    def encode(self, frames, *, rd: bool | None = None,
               frame_qps=None) -> tuple[bytes, list[Frame]]:
        """Encode an iterable of frames; returns (annex_b_stream, recons in
        display order). frame_qps: optional per-frame QP list (the
        reference's qp-on-the-fly / -qp-file path, EbRateControlProcess.c
        :2439)."""
        if self.cfg.pred_structure == 2:
            stream, recons = self._encode_random_access(list(frames), rd=rd)
            if self.cfg.code_eos_nal:
                stream += wrap_nal(NalUnitType.EOS_NUT, b"")
            return stream, recons
        chunks = [self.headers()]
        recons = []
        for au in self.encode_pictures(frames, rd=rd, frame_qps=frame_qps):
            chunks.append(au.data)
            recons.append(au.recon)
        if self.cfg.code_eos_nal:
            chunks.append(wrap_nal(NalUnitType.EOS_NUT, b""))
        return b"".join(chunks), recons

    def encode_pictures(self, frames, *, rd: bool | None = None,
                        frame_qps=None):
        """Streaming form of encode(): yields one EncodedAu per picture in
        decode order, without the parameter-set headers (the reference's
        EbH265GetPacket surface; headers come from headers() like
        EbH265EncStreamHeader)."""
        import time as _time
        # a new stream must never motion-compensate against a previous
        # stream's device-resident references (advisor r2: stale _dev_dpb
        # entries on POC reuse without an intervening IDR) — unless this
        # call RESUMES a checkpointed stream, whose restored TMVP/DPB
        # state is exactly what the next picture must see
        self._dev_dpb.clear()
        if not self._resuming:
            self._ref_motion.clear()
        self._resuming = False
        if self.cfg.pred_structure == 2:
            yield from self._ra_pictures(list(frames), rd=rd)
            return
        from .rate_control import RateControl
        rc = RateControl(self.cfg)
        self.last_rc = rc        # introspection: VBV conformance, tests
        la = (self.cfg.lookahead
              if rc.mode == 1 and rc.target_bits and frame_qps is None else 0)
        stream = (self._la_frames(frames, la) if la > 0
                  else ((fr, None) for fr in frames))
        prev_y = self._ckpt_prev_y
        b_slices = self.cfg.pred_structure == 1     # low-delay B
        # hierarchical low-delay: temporal layers within 2^hl mini-GOPs.
        # Layer-L pictures reference the most recent lower-layer picture,
        # top-layer pictures are non-referenced (droppable TRAIL_N), and
        # CQP adds per-layer QP offsets (reference analogue:
        # MOD_QP_OFFSET_LAYER_ARRAY, EbRateControlProcess.h:46; LD
        # prediction structures EbPredictionStructure.c:72-236)
        hl = self.cfg.hierarchical_levels
        # ---- mesh picture parallelism (cfg.mesh_pictures): batch the
        # non-reference leaf pictures of the hierarchy into one vmapped
        # graph sharded over the device mesh (parallel/pictures.py; the
        # analogue of the reference's pictures-in-flight scaling,
        # EbEncHandle.c:1645). Output order is preserved by an ordered
        # slot queue; streams are byte-identical to single-device.
        mesh_ndev = 0
        if (self.cfg.mesh_pictures and self.cfg.rate_control_mode == 0
                and frame_qps is None and hl > 0
                and self.cfg.pred_structure == 0
                and not self.cfg.enable_hrd
                and self._speed_target_fps is None):
            import jax as _jax
            if len(_jax.devices()) > 1:
                mesh_ndev = len(_jax.devices())
                # leaf references must survive in the device motion cache
                # until the batch flushes
                self._dev_motion_cap = 2 * mesh_ndev + 2
        leaf_q: list[dict] = []
        out_q: list[list] = []
        ll_last: dict[int, tuple] = dict(self._ckpt_ll_last)
        if self._ckpt_rc_state is not None:
            rc.__dict__.update(self._ckpt_rc_state)
            self._ckpt_rc_state = None
        pending = None

        def _emit(res, meta):
            pic = res.finish() if isinstance(res, PendingPicture) \
                else res
            m_idx, m_idr, m_stype, m_qp, m_window, m_t0, m_layer = meta
            if self._speed_target_fps is not None:
                fps = 1.0 / max(_time.perf_counter() - m_t0, 1e-9)
                if fps < self._speed_target_fps:
                    self._dyn_enc_mode = min(self._dyn_enc_mode + 1, 11)
                elif fps > 2.0 * self._speed_target_fps:
                    self._dyn_enc_mode = max(self._dyn_enc_mode - 1,
                                             self.cfg.enc_mode)
            data = pic.nal_bytes
            # strict-CBR filler: pad the AU so the VBV cannot overflow
            # (reference: EbPacketizationProcess.c:708-723); filler
            # bits count toward the RC totals like the reference's
            # fillerBitsSent
            fill = rc.filler_bits(8 * len(data))
            if fill >= 16 * 8:
                nbytes = fill // 8 - 7   # NAL overhead
                data += wrap_nal(NalUnitType.FD_NUT,
                                 b"\xff" * nbytes + b"\x80")
            total_bits = 8 * len(data)
            if m_window is not None:
                rc.update_lookahead(total_bits, m_qp, m_window[0],
                                    is_idr=m_idr, layer=m_layer)
            else:
                rc.update(total_bits, m_qp)
            if self.cfg.enable_hrd:
                data = self._hrd_sei(m_idr) + data
            return EncodedAu(data=data, recon=pic.recon, poc=pic.poc,
                             slice_type=m_stype, is_idr=m_idr,
                             display_idx=m_idx, decode_idx=m_idx)

        def _flush_leaves():
            """Encode the queued independent leaf pictures as ONE
            mesh-sharded vmapped dispatch, then finish each lane's host
            walk in display order (parallel/pictures.py)."""
            if not leaf_q:
                return
            from ..preset import derive_preset
            from ..parallel.pictures import dispatch_leaf_batch
            feat_b = derive_preset(self.cfg.enc_mode)
            pre = dispatch_leaf_batch(
                self, feat_b, [e["item"] for e in leaf_q])
            for e, p in zip(leaf_q, pre):
                r = self.encode_frame(
                    e["frame"], rd=rd, is_idr=False, poc=e["poc"],
                    qp=e["qp"], slice_type=1, refs_l0=e["refs"],
                    non_ref=True, retain_pocs=e["retain"],
                    precomputed=p)
                e["slot"][0] = _emit(r, e["meta"])
            leaf_q.clear()

        for fr, window in stream:
            idx = self._frame_idx
            self._frame_idx += 1
            is_idr = self._frame_is_idr(idx)
            if (not is_idr and self.cfg.scene_change_detection
                    and prev_y is not None
                    and self._scene_cut(prev_y, np.asarray(fr.y))):
                is_idr = True
            prev_y = np.asarray(fr.y)
            if is_idr:
                self._ref_planes = None
                self._poc_base = idx
                ll_last.clear()
            rel = idx - getattr(self, "_poc_base", 0)
            pos = rel % (1 << hl) if hl else 0
            layer = 0 if pos == 0 else hl - ((pos & -pos).bit_length() - 1)
            non_ref = hl > 0 and layer == hl
            refs_l0 = None
            if hl > 0 and not is_idr:
                lower = [e for l, e in ll_last.items() if l < max(layer, 1)]
                ref = max(lower, key=lambda e: e[0])
                refs_l0 = [(ref[1], ref[2])]
            if frame_qps is not None and idx < len(frame_qps):
                qp = int(frame_qps[idx])
            else:
                qp = rc.pick_qp(is_idr, window=window, layer=layer)
                if rc.mode == 0 and layer > 0:
                    qp = min(qp + layer + 1, 51)
            qp = min(max(qp, self.cfg.min_qp_allowed),
                     self.cfg.max_qp_allowed)
            t0 = _time.perf_counter()
            # every layer's most recent picture can still be referenced by
            # later pictures — keep them alive in the decoder's DPB
            retain = {e[2] for e in ll_last.values()}
            stype = 2 if is_idr else (0 if b_slices else 1)
            meta = (idx, is_idr, stype, qp, window, t0, layer)

            if (mesh_ndev and not is_idr and layer == hl and stype == 1
                    and refs_l0 is not None and len(refs_l0) == 1
                    and self._leaf_batchable(fr, rd)):
                slot = [None]
                leaf_q.append({
                    "frame": fr, "poc": rel, "qp": qp, "refs": refs_l0,
                    "retain": retain, "meta": meta, "slot": slot,
                    "item": {"frame": fr, "poc": rel, "qp": qp,
                             "ref": refs_l0[0],
                             "col_poc": (refs_l0[0][1]
                                         if self.cfg.tmvp else None)}})
                out_q.append(slot)
                if len(leaf_q) >= mesh_ndev:
                    _flush_leaves()
                while out_q and out_q[0][0] is not None:
                    yield out_q.pop(0)[0]
                continue
            if mesh_ndev and is_idr:
                # the queued leaves' collocated motion would be cleared by
                # the IDR — encode them first (they precede it in order)
                _flush_leaves()

            # one-frame-deep pipelining: dispatch this frame's device
            # graph before finalizing the previous frame, so the host
            # walk overlaps the device compute + download (safe under
            # CQP — the RC feedback path needs same-frame bits)
            can_pipe = (rc.mode == 0 and self._speed_target_fps is None
                        and not mesh_ndev)
            res = self.encode_frame(
                fr, rd=rd, is_idr=is_idr, poc=rel, qp=qp,
                slice_type=stype, refs_l0=refs_l0, non_ref=non_ref,
                retain_pocs=retain, pipelined=can_pipe)
            if hl > 0 and (layer < hl or is_idr):
                ll_last[0 if is_idr else layer] = (idx, res.ref_planes, rel)
            if mesh_ndev:
                out_q.append([_emit(res, meta)])
                while out_q and out_q[0][0] is not None:
                    yield out_q.pop(0)[0]
                continue
            if pending is not None:
                yield _emit(*pending)
                pending = None
                self._inflight = None
            if isinstance(res, PendingPicture):
                pending = (res, meta)
                self._inflight = res
            else:
                yield _emit(res, meta)
        if mesh_ndev:
            _flush_leaves()
            for slot in out_q:
                yield slot[0]
            out_q.clear()
        if pending is not None:
            yield _emit(*pending)
            self._inflight = None
        # segment finished: expose the resumable state to checkpoint()
        self._ckpt_prev_y = prev_y
        self._ckpt_ll_last = ll_last

    def _encode_fast(self, st, src, maps, sao_np, qp, feat, order, last_xy,
                     init_type) -> list[bytes]:
        """Fast-path host half, shared by I and P pictures: ONE host walk
        per CTU recording bin ops from the device maps (decide + emit
        fused — op streams carry context indices, not state, so SAO
        syntax is stitched in afterwards from the device-decided
        parameters), and one native CABAC run. DLF and SAO already ran on
        device (tpu.encode.fast_finish_dev). Returns the slice substream
        list."""
        from .fast_path import FastCtuEncoder, sao_grid_from_arrays
        cfg = self.cfg
        # native emitter: ONE C call derives merge/AMVP/MPM legality from
        # the maps, emits every bin and runs the arithmetic coder —
        # byte-identical to the Python walk below (test-enforced)
        from .native_emit import emit_tile_native
        data = emit_tile_native(
            cfg, st, maps, sao_np if cfg.enable_sao else None, qp,
            init_type, last_ctb=(last_xy[0] >> cfg.ctb_log2,
                                 last_xy[1] >> cfg.ctb_log2))
        if data is not None:
            return [data]
        walker = FastCtuEncoder(st, None, src, maps, features=feat)
        ctu_ops = []
        st.begin_tile()
        for x0, y0 in order:
            rec = CabacRecorder()
            walker.bac = rec
            walker.code_ctu(x0, y0)
            ctu_ops.append(rec)

        sao_grid = None
        if cfg.enable_sao:
            ny = (st.h + cfg.ctb_size - 1) // cfg.ctb_size
            nx = (st.w + cfg.ctb_size - 1) // cfg.ctb_size
            sao_grid = sao_grid_from_arrays(sao_np, ny, nx)

        ctb = cfg.ctb_size
        bac = CabacRecorder(init_contexts(qp, init_type=init_type))
        for i, (x0, y0) in enumerate(order):
            if sao_grid is not None:
                encode_sao_ctb(bac, sao_grid, x0 // ctb, y0 // ctb,
                               True, True, bit_depth=cfg.bit_depth)
            bac.extend_from(ctu_ops[i])
            bac.encode_terminate(1 if (x0, y0) == last_xy else 0)
        return [finalize_cabac(bac, init_contexts(qp, init_type=init_type))]

    def _ois_maps(self, y_plane) -> dict:
        """Per-picture device open-loop intra search: {n: (mode_map, cost_map)}
        numpy maps for n in 4/8/16/32, fetched in one device round trip.
        y_plane: host plane (padded+uploaded here) or an already 64-aligned
        device array (reused from the frame's device context)."""
        import jax
        import jax.numpy as jnp

        from ..tpu.analysis import ois_packed
        if isinstance(y_plane, np.ndarray):
            h, w = y_plane.shape
            hh, ww = (h + 63) // 64 * 64, (w + 63) // 64 * 64
            dev = jnp.asarray(pad_plane(y_plane, ww, hh), jnp.float32)
        else:
            hh, ww = y_plane.shape
            dev = y_plane
        # one packed int32 fetch: one device->host transfer
        flat = ois_packed(dev)
        from ..tpu.encode import unpack
        specs = []
        for n in (4, 8, 16, 32):
            specs.append((f"mode{n}", (hh // n, ww // n), np.int32))
            specs.append((f"cost{n}", (hh // n, ww // n), np.int32))
        got = unpack(np.asarray(flat), specs)
        return {n: (got[f"mode{n}"], got[f"cost{n}"])
                for n in (4, 8, 16, 32)}

    def _denoise(self, frame: Frame) -> Frame:
        """Source denoising (reference PictureAnalysis denoise stage,
        EbPictureAnalysisProcess.c:1020-1320): noise-class-gated device
        filtering of all three planes; chroma follows the luma decision
        only when the luma is noisy."""
        import jax.numpy as jnp

        from ..tpu.analysis import denoise_plane
        maxval = (1 << self.cfg.bit_depth) - 1
        y, sigma = denoise_plane(jnp.asarray(np.asarray(frame.y), jnp.float32),
                                 maxval=maxval)
        dt = frame.y.dtype
        if float(sigma) < 0.004 * maxval:
            return frame
        cb, _ = denoise_plane(jnp.asarray(np.asarray(frame.cb), jnp.float32),
                              maxval=maxval)
        cr, _ = denoise_plane(jnp.asarray(np.asarray(frame.cr), jnp.float32),
                              maxval=maxval)
        return Frame(y=np.asarray(y).astype(dt), cb=np.asarray(cb).astype(dt),
                     cr=np.asarray(cr).astype(dt))

    # ------------------------------------------------------------ lookahead
    @staticmethod
    def _la_complexities(lumas: list[np.ndarray], prev_y) -> list[float]:
        """Per-picture complexities for the lookahead RC: one batched device
        graph (tpu.analysis.lookahead_stats) over [prev] + lumas. The
        zero-MV decimated SAD vs the predecessor is the complexity; the
        stream's very first picture (no predecessor) falls back to a
        variance-derived intra proxy."""
        import jax.numpy as jnp

        from ..tpu.analysis import lookahead_stats
        h, w = lumas[0].shape
        h4, w4 = (h + 3) // 4 * 4, (w + 3) // 4 * 4
        first = prev_y if prev_y is not None else lumas[0]
        stack = np.stack([pad_plane(p.astype(np.int32), w4, h4)
                          for p in [first] + lumas])
        st = lookahead_stats(jnp.asarray(stack))
        # global-motion-compensated SAD: under a pan the zero-MV SAD
        # overstates complexity; the gm search (EbHevcDetectGlobalMotion
        # analogue) removes the translation component
        zz = np.asarray(st["gm_sad"], np.float64)
        if prev_y is None:
            var = float(np.asarray(st["variance"])[0])
            zz[0] = max(float(np.sqrt(var)) / 4.0, 1e-3)
        return [max(float(c), 1e-3) for c in zz]

    def _la_frames(self, frames, la: int):
        """Sliding lookahead queue (reference analogue: the lookahead
        window between PictureDecision and RateControl,
        EbInitialRateControlProcess.c:849). Yields (frame, window) where
        window = [this frame's complexity, next <= la complexities];
        refills in (la+1)-frame batches so the device stats stay batched."""
        import itertools

        from collections import deque
        it = iter(frames)
        buf: deque = deque()            # (frame, complexity)
        prev_y = None
        done = False
        while True:
            if not done and len(buf) < la + 1:
                batch = []
                while len(batch) < 2 * (la + 1) - len(buf):
                    try:
                        batch.append(next(it))
                    except StopIteration:
                        done = True
                        break
                if batch:
                    ys = [np.asarray(f.y) for f in batch]
                    cxs = self._la_complexities(ys, prev_y)
                    prev_y = ys[-1]
                    buf.extend(zip(batch, cxs))
            if not buf:
                return
            fr, c0 = buf.popleft()
            yield fr, [c0] + [c for _, c in itertools.islice(buf, la)]

    def _encode_random_access(self, frames, *, rd=None):
        self._dev_dpb.clear()
        self._ref_motion.clear()
        frames = list(frames)
        chunks = [self.headers()]
        recons: list = [None] * len(frames)
        for au in self._ra_pictures(frames, rd=rd):
            chunks.append(au.data)
            recons[au.display_idx] = au.recon
        return b"".join(chunks), recons

    def _ra_pictures(self, frames, *, rd=None):
        """Random access with periodic IDR refresh (reference analogue:
        intraRefreshType=2 closed GOP, EbApi.h): the stream is cut into
        independent segments of intra_period+1 pictures, each encoded as a
        closed hierarchical-B GOP with its own IDR and POC base. With
        intra_refresh_type=1 the stream is instead one continuous open
        GOP with CRA refresh points and RASL leading pictures
        (_ra_pictures_open)."""
        cfg = self.cfg
        frames = list(frames)
        if cfg.intra_refresh_type == 1 and cfg.intra_period > 0:
            yield from self._ra_pictures_open(frames, rd=rd)
            return
        seg_len = (cfg.intra_period + 1 if cfg.intra_period > 0
                   else len(frames))
        dec_base = 0
        for seg_start in range(0, len(frames), max(seg_len, 1)):
            seg = frames[seg_start:seg_start + seg_len]
            for au in self._ra_segment(seg, rd=rd):
                yield EncodedAu(
                    data=au.data, recon=au.recon, poc=au.poc,
                    slice_type=au.slice_type, is_idr=au.is_idr,
                    display_idx=seg_start + au.display_idx,
                    decode_idx=dec_base + au.decode_idx)
            dec_base += len(seg)

    def _ra_segment(self, frames, *, rd=None):
        """Hierarchical-B mini-GOPs (reference analogue: random-access
        prediction structures, EbPredictionStructure.c :72-637): anchors
        form a P chain, interior pictures are bi-predicted from the two
        enclosing pictures, recursively. AUs are yielded in decode order;
        display_idx gives the presentation order."""
        cfg = self.cfg
        gop = 1 << max(cfg.hierarchical_levels, 1)
        n = len(frames)

        schedule = [(0, 2, None, None, 0)]      # (idx, type, l0, l1, layer)
        pos = 0
        while pos + 1 < n:
            end = min(pos + gop, n - 1)
            schedule.append((end, 1, pos, None, 0))

            def rec(a, b, layer):
                if b - a < 2:
                    return
                m = (a + b) // 2
                schedule.append((m, 0, a, b, layer))
                rec(a, m, layer + 1)
                rec(m, b, layer + 1)

            rec(pos, end, 1)
            pos = end

        dpb: dict[int, list] = {}               # poc -> planes
        # DPB output delays: display index minus decode index, shifted so
        # the minimum is zero (output times stay causal under reordering)
        raw = [i - d for d, (i, *_rest) in enumerate(schedule)]
        base_delay = -min(raw) if raw else 0
        # suffix reference needs: POCs referenced by pictures later in
        # decode order must stay in the DPB (used=0 RPS entries)
        future_refs: list[set] = [set() for _ in schedule]
        acc: set = set()
        for i in range(len(schedule) - 1, -1, -1):
            future_refs[i] = acc.copy()
            _, _, l0i, l1i, _ = schedule[i]
            acc |= {r for r in (l0i, l1i) if r is not None}
        for dec_idx, (idx, stype, l0, l1, layer) in enumerate(schedule):
            qp = min(cfg.qp + (layer + 1 if stype == 0 else 0), 51)
            refs_l0 = [(dpb[l0], l0)] if l0 is not None else None
            refs_l1 = [(dpb[l1], l1)] if l1 is not None else None
            retain = {r for r in future_refs[dec_idx]
                      if r != idx and r in dpb}
            pic = self.encode_frame(frames[idx], rd=rd, qp=qp, poc=idx,
                                    is_idr=stype == 2, slice_type=stype,
                                    refs_l0=refs_l0, refs_l1=refs_l1,
                                    retain_pocs=retain)
            dpb[idx] = pic.ref_planes
            data = pic.nal_bytes
            if cfg.enable_hrd:
                data = self._hrd_sei(stype == 2,
                                     idx - dec_idx + base_delay) + data
            yield EncodedAu(data=data, recon=pic.recon, poc=idx,
                            slice_type=stype, is_idr=stype == 2,
                            display_idx=idx, decode_idx=dec_idx)
            # prune pictures older than the current mini-GOP window
            for k in [k for k in dpb if k < idx - 2 * gop]:
                del dpb[k]

    def _ra_pictures_open(self, frames, *, rd=None):
        """CRA open-GOP random access (reference analogue:
        intraRefreshType=1, EbPictureDecisionProcess.c:554+): one
        continuous coded video sequence — intra refresh points are
        CRA_NUT pictures (POC continues, DPB survives), and the
        hierarchical-B pictures BETWEEN the previous anchor and a CRA
        reference across it; they decode after the CRA but display
        before it, so they go out as RASL_R / RASL_N leading pictures.
        A decoder tuning in at the CRA drops them (that is the point of
        an open GOP: the refresh costs no prediction break for
        continuous decoders)."""
        cfg = self.cfg
        gop = 1 << max(cfg.hierarchical_levels, 1)
        n = len(frames)
        ip1 = cfg.intra_period + 1
        intra_pos = set(range(0, n, ip1))

        # (idx, slice_type, l0, l1, layer, rasl)
        schedule = [(0, 2, None, None, 0, False)]
        pos = 0
        while pos + 1 < n:
            nxt_i = min((p for p in intra_pos if p > pos), default=n - 1)
            end = min(pos + gop, nxt_i, n - 1)
            is_intra = end in intra_pos
            schedule.append((end, 2 if is_intra else 1,
                             None if is_intra else pos, None, 0, False))

            def rec(a, b, layer, rasl):
                if b - a < 2:
                    return
                m = (a + b) // 2
                schedule.append((m, 0, a, b, layer, rasl))
                rec(a, m, layer + 1, rasl)
                rec(m, b, layer + 1, rasl)

            # interior pictures of a CRA-terminated mini-GOP are leading
            # pictures of that CRA (display < CRA <= decode) -> RASL
            rec(pos, end, 1, is_intra)
            pos = end

        dpb: dict[int, list] = {}
        raw = [i - d for d, (i, *_r) in enumerate(schedule)]
        base_delay = -min(raw) if raw else 0
        future_refs: list[set] = [set() for _ in schedule]
        acc: set = set()
        for i in range(len(schedule) - 1, -1, -1):
            future_refs[i] = acc.copy()
            _, _, l0i, l1i, _, _ = schedule[i]
            acc |= {r for r in (l0i, l1i) if r is not None}
        for dec_idx, (idx, stype, l0, l1, layer, rasl) in \
                enumerate(schedule):
            qp = min(cfg.qp + (layer + 1 if stype == 0 else 0), 51)
            refs_l0 = [(dpb[l0], l0)] if l0 is not None else None
            refs_l1 = [(dpb[l1], l1)] if l1 is not None else None
            retain = {r for r in future_refs[dec_idx]
                      if r != idx and r in dpb}
            is_idr = stype == 2 and idx == 0
            non_ref = stype == 0 and layer >= cfg.hierarchical_levels \
                and not future_refs[dec_idx] & {idx}
            nal = None
            if stype == 2 and not is_idr:
                nal = NalUnitType.CRA_NUT
            elif rasl:
                nal = (NalUnitType.RASL_N if non_ref
                       else NalUnitType.RASL_R)
            pic = self.encode_frame(frames[idx], rd=rd, qp=qp, poc=idx,
                                    is_idr=is_idr, slice_type=stype,
                                    refs_l0=refs_l0, refs_l1=refs_l1,
                                    retain_pocs=retain,
                                    nal_type_override=nal)
            dpb[idx] = pic.ref_planes
            data = pic.nal_bytes
            if cfg.enable_hrd:
                data = self._hrd_sei(is_idr,
                                     idx - dec_idx + base_delay) + data
            yield EncodedAu(data=data, recon=pic.recon, poc=idx,
                            slice_type=stype, is_idr=is_idr,
                            display_idx=idx, decode_idx=dec_idx)
            for k in [k for k in dpb if k < idx - 2 * gop]:
                del dpb[k]
