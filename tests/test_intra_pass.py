"""Equivalence tests for the device wavefront intra encode pass.

The device kernel (tpu.intra_pass.intra_wavefront_pass) must be bit-exact
with the normative scalar path (core.intra + core.transforms + core.quant
— the same functions the conformance decoder runs): same levels, same
reconstruction, for random valid quadtrees and modes, including picture
boundaries that force partial CTBs (the analogue of the reference's
asm_test bit-exactness gate, Tests/SVT-HEVC_FunctionalTests.py:830).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_hevc_tpu.core.ctu import PictureState, chroma_qp  # noqa: E402
from svt_hevc_tpu.core.ctu import predict_block, reconstruct_tb  # noqa: E402
from svt_hevc_tpu.core.quant import quantize  # noqa: E402
from svt_hevc_tpu.core.transforms import forward_transform  # noqa: E402
from svt_hevc_tpu.tpu.intra_pass import intra_wavefront_pass  # noqa: E402


def random_quadtree(nby, nbx, w, h, rng, max_lg=5):
    """Random valid intra CU map at 8x8 granularity (sizes 8..2^max_lg),
    respecting the picture boundary (a CU must lie fully inside)."""
    cu_log2 = np.full((nby, nbx), 3, np.int32)

    def fill(bx, by, lg):
        s = 1 << lg
        if bx * 8 >= w or by * 8 >= h:
            return
        inside = (bx * 8 + s <= w) and (by * 8 + s <= h)
        if lg > max_lg or not inside or (lg > 3 and rng.random() < 0.55):
            if lg == 3:
                cu_log2[by, bx] = 3
                return
            half = s // 16 * 8
            for dy, dx in ((0, 0), (0, half // 8), (half // 8, 0),
                           (half // 8, half // 8)):
                fill(bx + dx, by + dy, lg - 1)
        else:
            k = s // 8
            cu_log2[by:by + k, bx:bx + k] = lg

    for by in range(0, nby, 8):
        for bx in range(0, nbx, 8):
            fill(bx, by, 6)
    return cu_log2


def host_mirror(src, cu_log2, mode8, w, h, qp, bit_depth=8, ctb_log2=6):
    """Normative scalar encode of the same decisions, in z-scan order."""
    st = PictureState(src[0].shape[1], src[0].shape[0], qp, ctb_log2,
                      bit_depth)
    lv = [np.zeros_like(p) for p in st.planes]
    qpc = chroma_qp(qp)

    def code_cu(x0, y0, n):
        mode = int(mode8[y0 >> 3, x0 >> 3])
        # chroma first (like the host encoder's prepare_cu; order across
        # components is immaterial)
        for c in (1, 2):
            nc = n >> 1
            xc, yc = x0 >> 1, y0 >> 1
            pred = predict_block(st, c, xc, yc, nc, mode)
            resid = src[c][yc:yc + nc, xc:xc + nc].astype(np.int64) - pred
            levels = quantize(forward_transform(resid, bit_depth),
                              qpc, is_intra=True, bit_depth=bit_depth)
            lv[c][yc:yc + nc, xc:xc + nc] = levels
            reconstruct_tb(st, c, xc, yc, nc, pred, levels)
        pred = predict_block(st, 0, x0, y0, n, mode)
        resid = src[0][y0:y0 + n, x0:x0 + n].astype(np.int64) - pred
        levels = quantize(forward_transform(resid, bit_depth),
                          qp, is_intra=True, bit_depth=bit_depth)
        lv[0][y0:y0 + n, x0:x0 + n] = levels
        reconstruct_tb(st, 0, x0, y0, n, pred, levels)

    def walk(x0, y0, lg):
        if x0 >= w or y0 >= h:
            return
        s = 1 << lg
        inside = (x0 + s <= w) and (y0 + s <= h)
        if inside and int(cu_log2[y0 >> 3, x0 >> 3]) == lg:
            code_cu(x0, y0, s)
            return
        half = s >> 1
        for dy, dx in ((0, 0), (0, half), (half, 0), (half, half)):
            walk(x0 + dx, y0 + dy, lg - 1)

    ctb = 1 << ctb_log2
    for cy in range(0, h, ctb):
        for cx in range(0, w, ctb):
            walk(cx, cy, ctb_log2)
    return st.planes, lv


@pytest.mark.parametrize("w,h,seed,qp,ctb_log2", [
    (128, 64, 0, 32, 6),
    (96, 80, 1, 27, 6),      # partial CTBs on both axes
    (64, 64, 2, 45, 6),
    (192, 136, 3, 22, 6),    # partial bottom row
    (128, 64, 0, 32, 5),     # CTB 32: raster z-order differs from 64-tiles
    (96, 80, 4, 30, 5),
    (128, 96, 5, 34, 4),     # CTB 16
])
def test_wavefront_matches_host(w, h, seed, qp, ctb_log2):
    rng = np.random.default_rng(seed)
    w64, h64 = (w + 63) // 64 * 64, (h + 63) // 64 * 64
    nby, nbx = h64 // 8, w64 // 8

    src = [rng.integers(0, 256, (h64, w64)).astype(np.int32),
           rng.integers(0, 256, (h64 // 2, w64 // 2)).astype(np.int32),
           rng.integers(0, 256, (h64 // 2, w64 // 2)).astype(np.int32)]
    # smooth a bit so angular modes matter
    src = [((p + np.roll(p, 1, 0) + np.roll(p, 1, 1)) // 3) for p in src]
    cu_log2 = random_quadtree(nby, nbx, w, h, rng,
                              max_lg=min(ctb_log2, 5))
    mode8 = rng.integers(0, 35, (nby, nbx)).astype(np.int32)
    # mode is per-CU: broadcast the top-left block's mode over each CU
    for by in range(nby):
        for bx in range(nbx):
            lg = cu_log2[by, bx]
            k = (1 << lg) // 8
            mode8[by, bx] = mode8[by // k * k, bx // k * k]

    src_host = [src[0][:h, :w], src[1][:h // 2, :w // 2],
                src[2][:h // 2, :w // 2]]
    planes, lv = host_mirror(src_host, cu_log2, mode8, w, h, qp,
                             ctb_log2=ctb_log2)

    z = [jnp.zeros((h64, w64), jnp.int32),
         jnp.zeros((h64 // 2, w64 // 2), jnp.int32)]
    out = intra_wavefront_pass(
        jnp.asarray(src[0]), jnp.asarray(src[1]), jnp.asarray(src[2]),
        z[0], z[1], z[1], z[0], z[1], z[1],
        jnp.asarray(cu_log2), jnp.asarray(mode8),
        jnp.ones((nby, nbx), bool),
        jnp.int32(qp), jnp.int32(chroma_qp(qp)), w=w, h=h,
        ctb_log2=ctb_log2)
    rec = [np.asarray(out[0]), np.asarray(out[1]), np.asarray(out[2])]
    lvd = [np.asarray(out[3]), np.asarray(out[4]), np.asarray(out[5])]
    np.testing.assert_array_equal(np.asarray(out[6]), mode8,
                                  err_msg="mode passthrough")

    np.testing.assert_array_equal(rec[0][:h, :w], planes[0], err_msg="rec Y")
    np.testing.assert_array_equal(rec[1][:h // 2, :w // 2], planes[1],
                                  err_msg="rec Cb")
    np.testing.assert_array_equal(rec[2][:h // 2, :w // 2], planes[2],
                                  err_msg="rec Cr")
    np.testing.assert_array_equal(lvd[0][:h, :w], lv[0], err_msg="lv Y")
    np.testing.assert_array_equal(lvd[1][:h // 2, :w // 2], lv[1],
                                  err_msg="lv Cb")
    np.testing.assert_array_equal(lvd[2][:h // 2, :w // 2], lv[2],
                                  err_msg="lv Cr")


def test_wavefront_p_fixup_touches_only_intra():
    """With intra8 partially set, inter blocks' recon/levels are
    untouched and intra CUs see the inter recon as neighbor state."""
    rng = np.random.default_rng(9)
    w = h = 64
    src = [rng.integers(0, 256, (64, 64)).astype(np.int32),
           rng.integers(0, 256, (32, 32)).astype(np.int32),
           rng.integers(0, 256, (32, 32)).astype(np.int32)]
    base = [rng.integers(0, 256, (64, 64)).astype(np.int32),
            rng.integers(0, 256, (32, 32)).astype(np.int32),
            rng.integers(0, 256, (32, 32)).astype(np.int32)]
    cu_log2 = np.full((8, 8), 4, np.int32)
    mode8 = np.full((8, 8), 26, np.int32)
    intra8 = np.zeros((8, 8), bool)
    intra8[2:4, 2:4] = True      # one 16x16 intra CU at (16, 16)

    out = intra_wavefront_pass(
        *(jnp.asarray(p) for p in src),
        *(jnp.asarray(p) for p in base),
        jnp.zeros((64, 64), jnp.int32), jnp.zeros((32, 32), jnp.int32),
        jnp.zeros((32, 32), jnp.int32),
        jnp.asarray(cu_log2), jnp.asarray(mode8), jnp.asarray(intra8),
        jnp.int32(30), jnp.int32(chroma_qp(30)), w=w, h=h)
    rec_y = np.asarray(out[0])
    # outside the intra CU: untouched
    mask = np.zeros((64, 64), bool)
    mask[16:32, 16:32] = True
    np.testing.assert_array_equal(rec_y[~mask], base[0][~mask])
    assert (rec_y[16:32, 16:32] != base[0][16:32, 16:32]).any()
