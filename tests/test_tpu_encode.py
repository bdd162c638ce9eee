"""Device encode-pass stages vs the host normative implementations.

The analogue of the reference's asm_test (C_DEFAULT vs auto-ASM
bit-exactness, Tests/SVT-HEVC_FunctionalTests.py:830): every device
kernel that feeds the normative path must match the numpy reference
bit-for-bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from svt_hevc_tpu.core.inter import (interp_chroma, interp_chroma_raw,
                                     interp_luma, interp_luma_raw)
from svt_hevc_tpu.core.quant import dequantize, quantize
from svt_hevc_tpu.core.transforms import forward_transform, inverse_transform
from svt_hevc_tpu.tpu.encode import (PAD, _ext_c, _ext_y, _mc_chroma,
                                     _mc_luma, chroma_phase_planes,
                                     dense_tq_size, encode_pass_p,
                                     luma_phase_planes, mc_pred_chroma,
                                     mc_pred_luma)

RNG = np.random.default_rng(3)


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_luma_mcp_bit_exact(bit_depth):
    h, w = 64, 128
    maxval = (1 << bit_depth) - 1
    ref = RNG.integers(0, maxval + 1, (h, w)).astype(np.int32)
    raw = luma_phase_planes(jnp.asarray(ref), bit_depth=bit_depth)

    mv8 = RNG.integers(-200, 200, (h // 8, w // 8, 2)).astype(np.int32)
    pred = np.asarray(mc_pred_luma(raw, jnp.asarray(mv8), bit_depth))

    for by, bx in [(0, 0), (3, 7), (7, 15), (2, 9)]:
        mvx, mvy = int(mv8[by, bx, 0]), int(mv8[by, bx, 1])
        want = interp_luma(ref, bx * 8, by * 8, 8, 8, mvx, mvy, bit_depth)
        got = pred[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8]
        assert np.array_equal(got, want), (by, bx, mvx, mvy)


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_chroma_mcp_bit_exact(bit_depth):
    h, w = 64, 128                       # luma dims; chroma 32x64
    maxval = (1 << bit_depth) - 1
    ref = RNG.integers(0, maxval + 1, (h // 2, w // 2)).astype(np.int32)
    raw = chroma_phase_planes(jnp.asarray(ref), bit_depth=bit_depth)

    mv8 = RNG.integers(-200, 200, (h // 8, w // 8, 2)).astype(np.int32)
    pred = np.asarray(mc_pred_chroma(raw, jnp.asarray(mv8), bit_depth))

    for by, bx in [(0, 0), (3, 7), (7, 15), (5, 2)]:
        mvx, mvy = int(mv8[by, bx, 0]), int(mv8[by, bx, 1])
        want = interp_chroma(ref, bx * 4, by * 4, 4, 4, mvx, mvy,
                             bit_depth, 1, 1)
        got = pred[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
        assert np.array_equal(got, want), (by, bx, mvx, mvy)


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("rounded", [True, False])
def test_direct_mc_matches_spec_filters(bit_depth, rounded):
    """Per-block luma (8x8) and chroma (4x4) MC, the only MC of the fused
    graphs, against the spec interpolation of core/inter.py on every block:
    rounded and clipped samples, or the 14-bit bi-prediction intermediates.
    MVs span the whole clamped reach, so windows run off every edge."""
    rng = np.random.default_rng(bit_depth * 2 + rounded)
    h, w = 64, 128
    maxval = (1 << bit_depth) - 1
    ref = rng.integers(0, maxval + 1, (h, w)).astype(np.int32)
    refc = rng.integers(0, maxval + 1, (h // 2, w // 2)).astype(np.int32)
    lim = (PAD - 9) * 4
    mv8 = rng.integers(-lim, lim + 1, (h // 8, w // 8, 2)).astype(np.int32)
    py = np.asarray(_mc_luma(_ext_y(jnp.asarray(ref)), jnp.asarray(mv8),
                             bit_depth, rounded))
    pc = np.asarray(_mc_chroma(_ext_c(jnp.asarray(refc)), jnp.asarray(mv8),
                               bit_depth, rounded))
    fl = interp_luma if rounded else interp_luma_raw
    fc = interp_chroma if rounded else interp_chroma_raw
    for by in range(h // 8):
        for bx in range(w // 8):
            mvx, mvy = int(mv8[by, bx, 0]), int(mv8[by, bx, 1])
            np.testing.assert_array_equal(
                py[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8],
                fl(ref, bx * 8, by * 8, 8, 8, mvx, mvy, bit_depth))
            np.testing.assert_array_equal(
                pc[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4],
                fc(refc, bx * 4, by * 4, 4, 4, mvx, mvy, bit_depth))


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_dense_tq_bit_exact(n, bit_depth):
    h, w = 64, 64
    maxv = (1 << bit_depth) - 1
    resid = RNG.integers(-maxv, maxv + 1, (h, w)).astype(np.int32)
    for qp in (4, 27, 45, 51):
        lv, rr = dense_tq_size(jnp.asarray(resid), n, jnp.int32(qp),
                               bit_depth=bit_depth)
        lv, rr = np.asarray(lv), np.asarray(rr)
        for by in range(h // n):
            for bx in range(w // n):
                blk = resid[by * n:(by + 1) * n, bx * n:(bx + 1) * n]
                coef = forward_transform(blk, bit_depth, dst=False)
                want_lv = quantize(coef, qp, is_intra=False,
                                   bit_depth=bit_depth)
                got_lv = lv[by * n:(by + 1) * n, bx * n:(bx + 1) * n]
                assert np.array_equal(got_lv, want_lv), (n, qp, by, bx)
                want_rr = inverse_transform(
                    dequantize(want_lv, qp, bit_depth=bit_depth),
                    bit_depth, dst=False)
                got_rr = rr[by * n:(by + 1) * n, bx * n:(bx + 1) * n]
                assert np.array_equal(got_rr, want_rr), (n, qp, by, bx)


def test_encode_pass_p_recon_consistency():
    """encode_pass_p recon == pred + IT(IQ(levels)) with the host math,
    per decided TU size, and intra-masked blocks carry zero levels."""
    h, w = 64, 128
    src_y = RNG.integers(0, 256, (h, w)).astype(np.int32)
    src_cb = RNG.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    src_cr = RNG.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    ref_y = RNG.integers(0, 256, (h, w)).astype(np.int32)
    ref_cb = RNG.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    ref_cr = RNG.integers(0, 256, (h // 2, w // 2)).astype(np.int32)

    raw_y = luma_phase_planes(jnp.asarray(ref_y))
    raw_cb = chroma_phase_planes(jnp.asarray(ref_cb))
    raw_cr = chroma_phase_planes(jnp.asarray(ref_cr))

    nby, nbx = h // 8, w // 8
    # one 64-CU (tu 32), one 32-region, 16s and 8s; MV constant per CU
    tu_log2 = np.full((nby, nbx), 3, np.int32)
    tu_log2[:8, :8] = 5
    tu_log2[:4, 8:12] = 5
    tu_log2[4:6, 8:10] = 4
    mv8 = np.zeros((nby, nbx, 2), np.int32)
    mv8[:8, :8] = (5, -9)
    mv8[:4, 8:12] = (-13, 2)
    mv8[4:6, 8:10] = (7, 7)
    inter8 = np.ones((nby, nbx), bool)
    inter8[6, 14] = False                     # an intra 8x8 CU

    out = encode_pass_p(jnp.asarray(src_y), jnp.asarray(src_cb),
                        jnp.asarray(src_cr), raw_y, raw_cb, raw_cr,
                        jnp.asarray(mv8), jnp.asarray(inter8),
                        jnp.asarray(tu_log2), jnp.int32(30), jnp.int32(29))
    out = {k: np.asarray(v) for k, v in out.items()}

    # the 64-CU: pred from host MCP, levels from host T/Q at TU32
    pred = interp_luma(ref_y, 0, 0, 64, 64, 5, -9)
    for ty in range(2):
        for tx in range(2):
            blk = (src_y[ty * 32:(ty + 1) * 32, tx * 32:(tx + 1) * 32]
                   - pred[ty * 32:(ty + 1) * 32, tx * 32:(tx + 1) * 32])
            want = quantize(forward_transform(blk, 8), 30, is_intra=False)
            got = out["lv_y"][ty * 32:(ty + 1) * 32, tx * 32:(tx + 1) * 32]
            assert np.array_equal(got, want)
            rec_want = np.clip(
                pred[ty * 32:(ty + 1) * 32, tx * 32:(tx + 1) * 32]
                + inverse_transform(dequantize(want, 30), 8), 0, 255)
            rec_got = out["rec_y"][ty * 32:(ty + 1) * 32,
                                   tx * 32:(tx + 1) * 32]
            assert np.array_equal(rec_got, rec_want)

    # intra-masked block: zero levels, recon == pred
    assert not out["lv_y"][48:56, 112:120].any()
    assert out["nz4_y"][12:14, 28:30].sum() == 0

    # chroma of the 16-CU at luma (32, 64): chroma TB 8x8 at (16, 32)
    pcb = interp_chroma(ref_cb, 32, 16, 8, 8, 7, 7, 8, 1, 1)
    blk = src_cb[16:24, 32:40] - pcb
    want = quantize(forward_transform(blk, 8), 29, is_intra=False)
    assert np.array_equal(out["lv_cb"][16:24, 32:40], want)


def test_decide_tree_dev_matches_host():
    """decide_tree_dev (fused device graph) must reproduce the numpy
    decide_tree bit-for-bit: costs are integer-valued on both sides."""
    import jax.numpy as jnp

    from svt_hevc_tpu.pipeline.fast_path import decide_tree
    from svt_hevc_tpu.tpu.encode import decide_tree_dev

    rng = np.random.default_rng(11)
    h64, w64 = 128, 192
    md = {}
    for n in (8, 16, 32, 64):
        g = (h64 // n, w64 // n)
        md[f"sad{n}"] = rng.integers(0, n * n * 40, g).astype(np.int32)
        md[f"mv{n}"] = rng.integers(-60, 61, (*g, 2)).astype(np.int32)
    md["zsad8"] = rng.integers(0, 8 * 8 * 60, (h64 // 8, w64 // 8)).astype(
        np.int32)
    ois = {n: (rng.integers(0, 35, (h64 // n, w64 // n)).astype(np.int32),
               rng.integers(0, n * n * 30, (h64 // n, w64 // n)).astype(
                   np.int32))
           for n in (4, 8, 16, 32)}

    for ctb_log2 in (5, 6):
        want = decide_tree(md, ois, ctb_log2)
        ois_dev = {n: (jnp.asarray(m), jnp.asarray(c))
                   for n, (m, c) in ois.items() if n in (8, 16, 32)}
        md_dev = {k: jnp.asarray(v) for k, v in md.items()}
        cu, inter, mv, mode = decide_tree_dev(md_dev, ois_dev, ctb_log2)
        assert np.array_equal(np.asarray(cu), want.cu_log2_8), ctb_log2
        assert np.array_equal(np.asarray(inter), want.inter8)
        assert np.array_equal(np.asarray(mv), want.mv8)
        # modes only matter where the CU is intra
        m_dev = np.asarray(mode)
        sel = ~want.inter8
        assert np.array_equal(m_dev[sel], want.intra_mode8[sel])
