"""Device motion estimation: batched hierarchical full-pel search.

The reference's hottest loop is per-LCU SAD over search areas
(EbMotionEstimation.c FullPelSearch_LCU :584, HME levels :2012-2315,
GetEightHorizontalSearchPointResultsAll85PUs :156). Data-parallel design:
instead of per-block search loops, every displacement is evaluated for ALL
blocks of the picture at once — one shifted-plane absolute-difference plus
a blockwise box-sum reduction per displacement, vmapped over the (2R+1)^2
displacement grid. XLA fuses the shift+abs+reduce into one pass per
displacement.

Three-level hierarchy like the reference (1/16-area, 1/4-area, full res):
coarse search on decimated planes centers the fine search, so the effective
range is ~±38 full-pel with tiny windows per level. Output is a per-16x16
block integer MV field (quarter-pel units) + SAD map, which seeds the host
encoder's per-CU subpel refinement (CtuEncoder._motion_search's fractional
stage).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _block_sad_all_disp(src: jnp.ndarray, ref: jnp.ndarray, n: int,
                        r: int) -> jnp.ndarray:
    """SAD of every aligned (n, n) block of src vs ref displaced by every
    (dy, dx) in [-r, r]^2. Returns (2r+1, 2r+1, H//n, W//n) float32."""
    h, w = src.shape
    pad = jnp.pad(ref, r, mode="edge")

    dys, dxs = jnp.meshgrid(jnp.arange(2 * r + 1), jnp.arange(2 * r + 1),
                            indexing="ij")
    disp = jnp.stack([dys.ravel(), dxs.ravel()], axis=1)      # (S, 2)

    def one(d):
        shifted = jax.lax.dynamic_slice(pad, (d[0], d[1]), (h, w))
        diff = jnp.abs(src - shifted)
        return diff.reshape(h // n, n, w // n, n).sum(axis=(1, 3))

    sads = jax.vmap(one)(disp)                                # (S, bh, bw)
    return sads.reshape(2 * r + 1, 2 * r + 1, h // n, w // n)


def _pick_best(sads: jnp.ndarray, r: int):
    """argmin over the displacement grid -> (mvy, mvx) integer-pel maps."""
    s2, _, bh, bw = sads.shape
    flat = sads.reshape(s2 * s2, bh, bw)
    k = jnp.argmin(flat, axis=0)
    return k // s2 - r, k % s2 - r, jnp.min(flat, axis=0)


def _search_level(src: jnp.ndarray, ref: jnp.ndarray, n: int, r: int,
                  center_y: jnp.ndarray | None, center_x: jnp.ndarray | None):
    """Search +/-r around per-block centers (integer-pel maps at this
    level's block grid). Centering is applied by pre-translating the
    reference per block via a gather."""
    h, w = src.shape
    if center_y is None:
        sads = _block_sad_all_disp(src, ref, n, r)
        return _pick_best(sads, r)
    # per-block recentred reference: gather block windows displaced by the
    # center MV, rebuild a "recentred" reference plane, then search +/-r
    bh, bw = h // n, w // n
    by = jnp.arange(bh) * n
    bx = jnp.arange(bw) * n
    ys = (by[:, None, None, None] + center_y[:, :, None, None]
          + jnp.arange(n)[None, None, :, None])              # (bh,bw,n,1)
    xs = (bx[None, :, None, None] + center_x[:, :, None, None]
          + jnp.arange(n)[None, None, None, :])              # (bh,bw,1,n)
    ys = jnp.clip(ys, 0, h - 1)
    xs = jnp.clip(xs, 0, w - 1)
    rec = ref[ys, xs]                                        # (bh,bw,n,n)
    rec_plane = rec.transpose(0, 2, 1, 3).reshape(h, w)
    sads = _block_sad_all_disp(src, rec_plane, n, r)
    my, mx, sad = _pick_best(sads, r)
    return my + center_y, mx + center_x, sad


def _decimate2(p: jnp.ndarray) -> jnp.ndarray:
    """2x2 mean pooling (anti-aliased decimation; reference analogue
    EbPictureAnalysisProcess.c Decimation2D :173)."""
    h, w = p.shape
    return p.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))


def _up2(m: jnp.ndarray) -> jnp.ndarray:
    return jnp.repeat(jnp.repeat(m, 2, axis=0), 2, axis=1)


@functools.partial(jax.jit, static_argnums=(2, 3))
def hme_search(src: jnp.ndarray, ref: jnp.ndarray, n: int = 16,
               r: int = 4) -> tuple[jnp.ndarray, jnp.ndarray]:
    """3-level hierarchical full-pel ME for every (n, n) block.

    Same (n, n) block size at every level — at quarter resolution one block
    covers 4n x 4n source pixels, like the reference's LCU-level HME — with
    the coarse MV field upsampled (x2 grid repeat) to seed the next level.
    src/ref: (H, W) planes, H and W multiples of 4n. Returns (mv_q, sad):
    mv_q is (H//n, W//n, 2) int32 [mvx, mvy] in quarter-pel units, sad the
    full-res SAD map. Effective range ~ +/-(8r + 3r) full-pel.
    """
    src = src.astype(jnp.float32)
    ref = ref.astype(jnp.float32)
    s2, r2 = _decimate2(src), _decimate2(ref)
    s4, r4 = _decimate2(s2), _decimate2(r2)
    # level 2 (1/16 area): wide search around zero
    my4, mx4, _ = _search_level(s4, r4, n, 2 * r, None, None)
    # level 1 (1/4 area): refine around upscaled level-2 field
    my2, mx2, _ = _search_level(s2, r2, n, r, _up2(my4) * 2, _up2(mx4) * 2)
    # level 0 (full res): final integer MV per n x n block
    my0, mx0, sad = _search_level(src, ref, n, r, _up2(my2) * 2, _up2(mx2) * 2)
    mv_q = jnp.stack([mx0 * 4, my0 * 4], axis=-1).astype(jnp.int32)
    return mv_q, sad
