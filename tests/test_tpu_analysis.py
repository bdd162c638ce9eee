"""Device analysis stage tests (on the virtual CPU mesh).

Validates the linear-algebra intra weight matrices against the normative
scalar backend (the project's analogue of the reference asm_test: C kernels
vs SIMD kernels bit-compare, Tests/SVT-HEVC_FunctionalTests.py:830 — here
float-linear vs integer-normative with a rounding tolerance), and checks
the batched search picks sane modes.
"""

import numpy as np
import pytest

from svt_hevc_tpu.core import intra
from svt_hevc_tpu.tpu.intra_weights import mode_weight_matrix


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("mode", [0, 1, 2, 7, 10, 14, 18, 22, 26, 30, 34])
def test_weight_matrix_matches_normative(n, mode):
    rng = np.random.default_rng(n * 100 + mode)
    left = rng.integers(0, 256, 2 * n).astype(np.int32)
    top = rng.integers(0, 256, 2 * n).astype(np.int32)
    corner = int(rng.integers(0, 256))

    fl, fc, ft = intra.filter_ref_samples(left, corner, top, n, mode, 0)
    want = intra.predict_intra(fl, fc, ft, n, mode, 0)

    refs = np.concatenate([left, [corner], top]).astype(np.float32)
    w = mode_weight_matrix(n, luma=True)[mode]
    # the H/V boundary filter saturates in the normative path; the linear
    # map cannot express the clip, so apply it outside (predictions of all
    # other modes are convex combinations and stay in range anyway)
    got = np.clip((w @ refs).reshape(n, n), 0.0, 255.0)

    err = np.abs(got - want.astype(np.float32))
    # integer rounding in the normative path: the two [1 2 1] + predict
    # roundings bound the drift well under 2 levels
    assert err.max() < 2.0, (n, mode, err.max())


def test_weight_matrix_chroma_no_filter():
    n = 8
    rng = np.random.default_rng(0)
    left = rng.integers(0, 256, 2 * n).astype(np.int32)
    top = rng.integers(0, 256, 2 * n).astype(np.int32)
    corner = int(rng.integers(0, 256))
    want = intra.predict_intra(left, corner, top, n, 22, c_idx=1)
    refs = np.concatenate([left, [corner], top]).astype(np.float32)
    got = (mode_weight_matrix(n, luma=False)[22] @ refs).reshape(n, n)
    assert np.abs(got - want).max() < 2.0


def test_extract_block_refs():
    import jax.numpy as jnp
    from svt_hevc_tpu.tpu.analysis import extract_block_refs
    rng = np.random.default_rng(1)
    y = rng.integers(0, 256, (16, 24)).astype(np.float32)
    refs = np.asarray(extract_block_refs(jnp.asarray(y), 8))
    gh, gw = 2, 3
    assert refs.shape == (gh * gw, 33)
    # block (1, 1): left col = y[8..23 clamped, 7], corner y[7,7], top y[7, 8..23]
    b = refs[1 * gw + 1]
    left = y[np.minimum(np.arange(8, 24), 15), 7]
    top = y[7, np.minimum(np.arange(8, 24), 23)]
    np.testing.assert_array_equal(b[:16], left)
    assert b[16] == y[7, 7]
    np.testing.assert_array_equal(b[17:], top)
    # block (0, 0): replicated edges
    b0 = refs[0]
    np.testing.assert_array_equal(b0[:16], y[np.minimum(np.arange(16), 15), 0])
    np.testing.assert_array_equal(b0[17:], y[0, np.minimum(np.arange(16), 23)])


def test_search_finds_directional_structure():
    import jax.numpy as jnp
    from svt_hevc_tpu.tpu.analysis import intra_search_size
    # pure vertical stripes -> vertical mode (26) should win nearly everywhere
    y = np.tile((np.arange(64) * 9 % 251).astype(np.float32), (64, 1))
    mode, cost = intra_search_size(jnp.asarray(y), 8)
    mode = np.asarray(mode)
    inner = mode[1:, :]   # first row has replicated top refs (degenerate)
    assert (inner == 26).mean() > 0.8, inner
    # pure horizontal stripes -> horizontal mode (10)
    yh = np.asarray(y).T.copy()
    mode_h = np.asarray(intra_search_size(jnp.asarray(yh), 8)[0])
    assert (mode_h[:, 1:] == 10).mean() > 0.8


def test_analyze_frame_shapes():
    import jax.numpy as jnp
    from svt_hevc_tpu.tpu.analysis import analyze_frame
    y = jnp.zeros((128, 192), jnp.float32)
    out = analyze_frame(y)
    assert out["decim2"].shape == (64, 96)
    assert out["var16"].shape == (8, 12)
    assert out["mode8"].shape == (16, 24)
    assert out["cost32"].shape == (4, 6)


def test_flat_block_prefers_dc_or_planar():
    import jax.numpy as jnp
    from svt_hevc_tpu.tpu.analysis import intra_search_size
    y = np.full((64, 64), 100.0, np.float32)
    mode, cost = intra_search_size(jnp.asarray(y), 16)
    assert np.asarray(cost).max() < 1.0


def test_lookahead_global_motion():
    """A pure pan: zero-MV SAD is large, gm-compensated SAD ~ 0 and the
    detected global MV equals the pan (EbHevcDetectGlobalMotion
    analogue)."""
    import jax.numpy as jnp
    from svt_hevc_tpu.tpu.analysis import lookahead_stats
    rng = np.random.default_rng(7)
    base = rng.integers(0, 255, (64, 128)).astype(np.float32)
    ys = np.stack([np.roll(base, (0, 8 * i), (0, 1)) for i in range(3)])
    st = lookahead_stats(jnp.asarray(ys))
    zz = np.asarray(st["zz_sad"])
    gm = np.asarray(st["gm_sad"])
    mv = np.asarray(st["gm_mv"])
    assert (gm < 0.2 * zz).all(), (gm, zz)
    # pan of +8 luma pels per frame = 2 decimated pels
    assert abs(int(mv[0, 0])) == 8 and int(mv[0, 1]) == 0
    assert abs(int(mv[1, 0])) == 8 and int(mv[1, 1]) == 0


def test_lookahead_static_gm_matches_zz():
    import jax.numpy as jnp
    from svt_hevc_tpu.tpu.analysis import lookahead_stats
    rng = np.random.default_rng(8)
    ys = rng.integers(0, 255, (3, 64, 64)).astype(np.float32)
    ys[1] = ys[0]                      # identical pair: both SADs zero
    st = lookahead_stats(jnp.asarray(ys))
    assert float(np.asarray(st["gm_sad"])[0]) == 0.0
    assert tuple(np.asarray(st["gm_mv"])[0]) == (0, 0)
    assert np.asarray(st["gm_sad"])[1] <= np.asarray(st["zz_sad"])[1]


def _dots(jaxpr):
    """(operand dtype, precision) of every dot_general in a jaxpr, nested
    jaxprs included."""
    import jax
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append((eqn.invars[0].aval.dtype, eqn.params["precision"]))
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out += _dots(sub)
    return out


@pytest.mark.parametrize("fn", ["intra_search_size",
                                "intra_search_size_pred"])
def test_ois_contractions_are_exact_on_any_backend(fn):
    """The 35-mode prediction is a float32 matmul and must run at HIGHEST
    precision (TF32 on a GPU would round its 1/256 fractions away); the
    Hadamard SATD runs on scaled integers, whose sums no summation order
    can change."""
    import jax
    import jax.numpy as jnp
    from svt_hevc_tpu.tpu import analysis
    y = jnp.zeros((32, 32), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda p: getattr(analysis, fn)(p, 8))(y)
    dots = _dots(jaxpr.jaxpr)
    high = jax.lax.Precision.HIGHEST
    floats = [p for dt, p in dots if dt == jnp.float32]
    assert floats == [(high, high)]
    assert sorted(str(dt) for dt, _ in dots) == ["float32", "int32", "int32"]


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_ois_costs_exact_vs_float64(n):
    """On natural-range content the float32 search is exact: modes and
    costs equal a float64 numpy evaluation of the same definition, so no
    summation order (another backend's) can change them."""
    import jax.numpy as jnp
    from svt_hevc_tpu.tpu.analysis import (_hadamard, extract_block_refs,
                                           intra_search_size)
    rng = np.random.default_rng(n)
    yy, xx = np.mgrid[0:64, 0:128]
    y = (60 + xx + yy // 2 + rng.integers(-6, 7, (64, 128))).astype(
        np.float32)
    mode, cost = (np.asarray(a) for a in
                  intra_search_size(jnp.asarray(y), n))

    refs = np.asarray(extract_block_refs(jnp.asarray(y), n), np.float64)
    preds = refs @ mode_weight_matrix(n).reshape(35 * n * n, -1).T
    gh, gw = 64 // n, 128 // n
    src = y.reshape(gh, n, gw, n).transpose(0, 2, 1, 3).reshape(-1, 1, n, n)
    diff = preds.reshape(-1, 35, n, n) - src
    t = 4 if n == 4 else 8
    hm = _hadamard(t).astype(np.float64)
    tiles = diff.reshape(-1, 35, n // t, t, n // t, t).transpose(
        0, 1, 2, 4, 3, 5)
    tr = hm @ tiles @ hm.T
    want = np.abs(tr).sum(axis=(-4, -3, -2, -1)) / t
    np.testing.assert_array_equal(cost.ravel().astype(np.float64),
                                  want.min(axis=1))
    np.testing.assert_array_equal(mode.ravel(), want.argmin(axis=1))
