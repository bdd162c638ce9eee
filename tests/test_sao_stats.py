"""Device SAO statistics vs the host derive_sao_params decision sweep."""

import numpy as np
import jax
import jax.numpy as jnp

from svt_hevc_tpu.core.ctu import PictureState
from svt_hevc_tpu.core.sao import (derive_sao_params,
                                   derive_sao_params_from_stats)
from svt_hevc_tpu.tpu.encode import sao_stats_plane


def test_sao_stats_decisions_match_host():
    rng = np.random.default_rng(9)
    h, w = 96, 160                     # ragged vs the 64 CTB grid
    st = PictureState(w, h, 32, 6, 8)
    src = [rng.integers(0, 256, (h, w)).astype(np.int32),
           rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32),
           rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)]
    # recon = noisy source so SAO has real work
    for c in range(3):
        n = rng.integers(-6, 7, src[c].shape)
        st.planes[c][:, :] = np.clip(src[c] + n, 0, 255)

    lam = 12.0
    want = derive_sao_params(st, src, lam)

    ctb = 64
    stats = []
    for comp in range(3):
        plane = st.planes[comp]
        ph, pw = plane.shape
        cs = ctb if comp == 0 else ctb // 2
        hh, ww = (ph + cs - 1) // cs * cs, (pw + cs - 1) // cs * cs
        pre = np.zeros((hh, ww), np.int32); pre[:ph, :pw] = plane
        pre[ph:, :pw] = plane[-1:, :]; pre[:, pw:] = pre[:, pw - 1:pw]
        s = np.zeros((hh, ww), np.int32); s[:ph, :pw] = src[comp]
        valid = np.zeros((hh, ww), np.float32); valid[:ph, :pw] = 1.0
        out = sao_stats_plane(jnp.asarray(pre), jnp.asarray(s),
                              jnp.asarray(valid), cs, cs, bit_depth=8)
        stats.append({k: np.asarray(v) for k, v in
                      jax.device_get(out).items()})
    got = derive_sao_params_from_stats(st, stats, lam)

    for cy in range(len(want)):
        for cx in range(len(want[0])):
            assert got[cy][cx] == want[cy][cx], (cy, cx,
                                                 vars(got[cy][cx]),
                                                 vars(want[cy][cx]))
