"""Device SAO decision + apply == host decision + apply.

Stats come from the existing device stats kernel (already equivalence-
tested in test_sao_stats); here we check that (a) sao_decide_dev picks
the same per-CTB parameters as core.sao.derive_sao_params_from_stats and
(b) sao_apply_dev reproduces core.sao.apply_sao bit-exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_hevc_tpu.core.ctu import PictureState  # noqa: E402
from svt_hevc_tpu.core.rdo import lambda_sse  # noqa: E402
from svt_hevc_tpu.core.sao import (SaoCtbParams, apply_sao,  # noqa: E402
                                   derive_sao_params_from_stats)
from svt_hevc_tpu.tpu.encode import sao_stats_plane  # noqa: E402
from svt_hevc_tpu.tpu.sao import (_round_div, sao_apply_dev,  # noqa: E402
                                  sao_decide_dev)


def make_case(w, h, seed, ctb_log2=6):
    rng = np.random.default_rng(seed)
    ctb = 1 << ctb_log2
    w64, h64 = (w + 63) // 64 * 64, (h + 63) // 64 * 64
    rec, src = [], []
    for c in range(3):
        sh = (h64, w64) if c == 0 else (h64 // 2, w64 // 2)
        base = rng.integers(0, 256, sh).astype(np.int32)
        rec.append(base)
        # correlated source so offsets have signal
        noise = rng.integers(-6, 7, sh)
        src.append(np.clip(base + noise, 0, 255).astype(np.int32))
    stats = []
    for c in range(3):
        cell = ctb if c == 0 else ctb // 2
        hv = h if c == 0 else h // 2
        wv = w if c == 0 else w // 2
        hh, ww = rec[c].shape
        valid = ((np.arange(hh)[:, None] < hv)
                 & (np.arange(ww)[None, :] < wv)).astype(np.float32)
        out = sao_stats_plane(jnp.asarray(rec[c]), jnp.asarray(src[c]),
                              jnp.asarray(valid), cell, cell)
        stats.append({k: np.asarray(v) for k, v in out.items()})
    return rec, src, stats, ctb


def _assert_same_params(grid, dev, cny, cnx):
    for cy in range(cny):
        for cx in range(cnx):
            p = grid[cy][cx]
            assert p.type_idx == [int(dev["type"][cy, cx, 0]),
                                  int(dev["type"][cy, cx, 1])], (cy, cx)
            for c01 in range(2):
                if p.type_idx[c01] == 2:
                    assert p.eo_class[c01] == int(dev["eo"][cy, cx, c01])
            for comp in range(3):
                if p.type_idx[min(comp, 1)] == 0:
                    continue
                assert p.offsets[comp] == [int(v) for v in
                                           dev["offs"][cy, cx, comp]], \
                    (cy, cx, comp)
                if p.type_idx[min(comp, 1)] == 1:
                    assert p.band_pos[comp] == int(dev["bp"][cy, cx, comp])


@pytest.mark.parametrize("w,h,seed,qp", [
    (128, 128, 0, 32), (192, 128, 1, 27), (128, 64, 2, 40)])
def test_sao_decide_and_apply_match_host(w, h, seed, qp):
    rec, src, stats, ctb = make_case(w, h, seed)
    lam = lambda_sse(qp)
    ny, nx = stats[0]["bo_cnt"].shape[:2]

    st = PictureState(w, h, qp, 6)
    for c in range(3):
        sh = st.planes[c].shape
        st.planes[c][:] = rec[c][:sh[0], :sh[1]]
    # crop stats to the coded CTB grid (device grids cover aligned dims)
    cny = (h + ctb - 1) // ctb
    cnx = (w + ctb - 1) // ctb
    host_stats = [{k: v[:cny, :cnx] for k, v in s.items()} for s in stats]
    grid = derive_sao_params_from_stats(st, host_stats, lam)

    dev = {k: np.asarray(v) for k, v in sao_decide_dev(
        [{k2: jnp.asarray(v2) for k2, v2 in s.items()} for s in stats],
        jnp.float32(lam)).items()}
    _assert_same_params(grid, dev, cny, cnx)

    # ---- apply: host grid -> both applications must agree bit-exactly
    apply_sao(st, grid, True, True)
    params = {k: jnp.asarray(v) for k, v in dev.items()}
    for comp in range(3):
        hv = h if comp == 0 else h // 2
        wv = w if comp == 0 else w // 2
        got = np.asarray(sao_apply_dev(jnp.asarray(rec[comp]), params,
                                       comp, ctb, wv, hv))
        np.testing.assert_array_equal(got[:hv, :wv], st.planes[comp],
                                      err_msg=f"comp {comp}")


def test_round_div_matches_numpy_round():
    """Integer round-half-even of s / c, as np.round of the quotient."""
    s = np.arange(-300, 301)[:, None]
    c = np.arange(1, 40)[None, :]
    got = np.asarray(_round_div(jnp.asarray(np.broadcast_to(s, (601, 39)),
                                            jnp.int32),
                                jnp.asarray(np.broadcast_to(c, (601, 39)),
                                            jnp.int32)))
    np.testing.assert_array_equal(got, np.round(s / c))


@pytest.mark.parametrize("seed", [0, 1])
def test_sao_decision_matches_host_with_10bit_gains(seed):
    """10-bit CTB64 statistics: offsets up to 31 over ~4000 samples put
    the gains above 2^24, where float32 sums and products round. The
    device decision must still equal the host's exact one."""
    rng = np.random.default_rng(seed)
    ny, nx = 3, 4
    stats = []
    for _ in range(3):
        eo_cnt = rng.integers(0, 4000, (ny, nx, 4, 5))
        bo_cnt = rng.integers(0, 600, (ny, nx, 32))
        stats.append({
            "eo_cnt": eo_cnt.astype(np.int32),
            "eo_sum": (eo_cnt * rng.integers(-31, 32, eo_cnt.shape)
                       + rng.integers(-99, 100, eo_cnt.shape)
                       ).astype(np.int32),
            "bo_cnt": bo_cnt.astype(np.int32),
            "bo_sum": (bo_cnt * rng.integers(-31, 32, bo_cnt.shape)
                       ).astype(np.int32)})
    lam = lambda_sse(37)
    st = PictureState(64 * nx, 64 * ny, 37, 6, 10)
    grid = derive_sao_params_from_stats(st, stats, lam)
    dev = {k: np.asarray(v) for k, v in sao_decide_dev(
        [{k2: jnp.asarray(v2) for k2, v2 in s.items()} for s in stats],
        jnp.float32(lam), bit_depth=10).items()}
    _assert_same_params(grid, dev, ny, nx)
