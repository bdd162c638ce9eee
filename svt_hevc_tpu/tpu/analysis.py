"""Device picture analysis + open-loop intra search (JAX, batched).

Per frame, in one jit-compiled graph:
  - decimation pyramid (1/2, 1/4 subsampled lumas) and block variance maps
    (analogue of reference EbPictureAnalysisProcess.c DecimateInputPicture
    :4139 / ComputePictureSpatialStatistics :3879), and
  - open-loop intra mode search for every block of every CU size
    {4, 8, 16, 32}: all 35 modes evaluated as ONE batched contraction
    refs[B, 4N+1] x W[35, N^2, 4N+1] (see intra_weights.py), scored by
    Hadamard SATD (analogue of EbMotionEstimation.c OpenLoopIntraSearchLcu
    :5053 with EbHmCode.c Compute4x4Satd/8x8).

Outputs drive the host mode decision (mode_policy / split_policy), exactly
as the reference's OIS results drive its MD candidate pruning and early
partitioning (EbModeDecisionConfigurationProcess.c :289).

All shapes static; everything fuses under jit.

The costs must not depend on the backend, because they decide modes and
partitions of the coded stream. The prediction contraction runs at
Precision.HIGHEST: predictions carry up to 8 fraction bits, so
``pred - src`` needs more significant bits than a reduced-precision matmul
keeps (TF32 keeps 11). At full precision every product and partial sum of
it is exact (below 2^24 units of the finest fraction). The SATD then runs
on those differences scaled to integers, in int32: its sums of up to 1024
terms exceed 2^24 units, where float32 sums round differently in every
summation order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .intra_weights import mode_weight_matrix


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


_H4 = _hadamard(4)
_H8 = _hadamard(8)


@functools.cache
def _frac_bits(n: int) -> int:
    """Fraction bits of the n x n mode weights: every open-loop prediction
    of integer samples is a multiple of 2^-_frac_bits(n)."""
    w = mode_weight_matrix(n).astype(np.float64)
    b = 0
    while not np.array_equal(w * 2.0 ** b, np.round(w * 2.0 ** b)):
        b += 1
    return b


@functools.partial(jax.jit, static_argnums=1)
def extract_block_refs(y: jnp.ndarray, n: int) -> jnp.ndarray:
    """Open-loop reference vectors for every aligned NxN block.

    y: (H, W) float32 plane, H and W multiples of N.
    Returns (gh*gw, 4N+1): [left[0..2N-1], corner, top[0..2N-1]] per block,
    taken from the *source* picture with edge replication (open-loop, like
    the reference's OIS at speed presets; substitution beyond the picture
    edge replicates, matching the unavailable->propagate rule closely
    enough for search).
    """
    h, w = y.shape
    gh, gw = h // n, w // n
    by = jnp.arange(gh) * n
    bx = jnp.arange(gw) * n

    # top row (y0-1) and left col (x0-1), clamped to the plane
    top_y = jnp.maximum(by - 1, 0)                       # (gh,)
    left_x = jnp.maximum(bx - 1, 0)                      # (gw,)

    k = jnp.arange(2 * n)
    # top refs: y[top_y, bx + k] with x clamped
    tx = jnp.minimum(bx[None, :, None] + k[None, None, :], w - 1)  # (1,gw,2n)
    top = y[top_y[:, None, None], tx]                    # (gh, gw, 2n)
    # left refs: y[by + k (clamped), left_x]
    ly = jnp.minimum(by[:, None, None] + k[None, None, :], h - 1)  # (gh,1,2n)
    left = y[ly, left_x[None, :, None]]                  # (gh, gw, 2n)
    corner = y[top_y[:, None], left_x[None, :]]          # (gh, gw)

    refs = jnp.concatenate(
        [left, corner[..., None], top], axis=-1)         # (gh, gw, 4n+1)
    return refs.reshape(gh * gw, 4 * n + 1)


def _satd(diff: jnp.ndarray, n: int) -> jnp.ndarray:
    """Hadamard SATD over (..., N, N) blocks using 8x8 (or 4x4) tiles:
    H @ D @ H^T per tile, then an L1 reduction. diff holds multiples of
    2^-_frac_bits(n) (exact float32), so the transform and the sum run on
    the scaled integers: integer sums are exact in any order."""
    t = 4 if n == 4 else 8
    hmat = jnp.asarray(_H4 if n == 4 else _H8)
    scale = 1 << _frac_bits(n)
    lead = diff.shape[:-2]
    nd = len(lead)
    d = jnp.round(diff * scale).astype(jnp.int32).reshape(
        *lead, n // t, t, n // t, t)
    tiles = d.transpose(*range(nd), nd, nd + 2, nd + 1, nd + 3)  # (..., nb, nb, t, t)
    tr = jnp.einsum("ij,...jk,lk->...il", hmat, tiles, hmat)
    # HM normalisation: satd_t = sum|tr| / (2 * t)  per tile, x2 overall
    total = jnp.sum(jnp.abs(tr), axis=(-4, -3, -2, -1))
    return total.astype(jnp.float32) / (t * scale)


@functools.partial(jax.jit, static_argnums=1)
def intra_search_size(y: jnp.ndarray, n: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Best intra mode per NxN block: returns (best_mode, best_cost) maps
    of shape (H//N, W//N)."""
    h, w = y.shape
    gh, gw = h // n, w // n
    refs = extract_block_refs(y, n)                      # (B, 4n+1)
    wmat = jnp.asarray(mode_weight_matrix(n))            # (35, n*n, 4n+1)
    preds = jnp.einsum("br,mpr->bmp", refs, wmat,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)  # (B, 35, n*n)
    src = (y.reshape(gh, n, gw, n).transpose(0, 2, 1, 3)
           .reshape(gh * gw, 1, n, n))
    diff = preds.reshape(-1, 35, n, n) - src
    cost = _satd(diff, n)                                # (B, 35)
    best = jnp.argmin(cost, axis=1)
    return (best.reshape(gh, gw).astype(jnp.int32),
            jnp.min(cost, axis=1).reshape(gh, gw))


@functools.partial(jax.jit, static_argnums=(1, 2))
def intra_search_size_pred(y: jnp.ndarray, n: int, bit_depth: int = 8):
    """intra_search_size + the winning mode's open-loop prediction PLANE
    (rounded int32, same shape as y) — the input the true-RD intra size
    decision needs (decide_tree_i_dev): transform compaction is invisible
    to a SATD cost, so size choices must see post-quant D and real
    coefficient bits."""
    h, w = y.shape
    gh, gw = h // n, w // n
    refs = extract_block_refs(y, n)
    wmat = jnp.asarray(mode_weight_matrix(n))
    preds = jnp.einsum("br,mpr->bmp", refs, wmat,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)
    src = (y.reshape(gh, n, gw, n).transpose(0, 2, 1, 3)
           .reshape(gh * gw, 1, n, n))
    diff = preds.reshape(-1, 35, n, n) - src
    cost = _satd(diff, n)
    best = jnp.argmin(cost, axis=1)
    bp = jnp.take_along_axis(preds, best[:, None, None], 1)[:, 0]
    plane = (bp.reshape(gh, gw, n, n).transpose(0, 2, 1, 3)
             .reshape(h, w))
    plane = jnp.clip(jnp.round(plane), 0,
                     (1 << bit_depth) - 1).astype(jnp.int32)
    return (best.reshape(gh, gw).astype(jnp.int32),
            jnp.min(cost, axis=1).reshape(gh, gw), plane)


def block_variance(y: jnp.ndarray, n: int) -> jnp.ndarray:
    """(H//N, W//N) map of per-NxN-block pixel variance."""
    h, w = y.shape
    b = y.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3)
    m = jnp.mean(b, axis=(-2, -1), keepdims=True)
    return jnp.mean((b - m) ** 2, axis=(-2, -1))


def _binomial5(p: jnp.ndarray) -> jnp.ndarray:
    """Separable 5-tap binomial ([1,4,6,4,1]/16) blur, edge-replicated.
    Written as shift-adds: XLA fuses the whole stencil into one pass."""
    k = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    e = jnp.pad(p, ((2, 2), (0, 0)), mode="edge")
    p = sum(k[i] * e[i:i + p.shape[0], :] for i in range(5))
    e = jnp.pad(p, ((0, 0), (2, 2)), mode="edge")
    return sum(k[i] * e[:, i:i + p.shape[1]] for i in range(5))


@functools.partial(jax.jit, static_argnames=("maxval",))
def denoise_plane(p: jnp.ndarray, maxval: int = 255):
    """Noise-class-gated denoise of one plane (data-parallel re-design of the
    reference's noise extraction + strong/weak denoisers,
    EbPictureAnalysisProcess.c noiseExtract* :1020-1320): estimate the
    noise level from the flat-region residual of a binomial blur, then
    apply no / weak / strong filtering with an edge-preserving clamp of
    the correction to +-3 sigma. Returns (filtered plane, sigma)."""
    yf = p.astype(jnp.float32)
    weak = _binomial5(yf)
    strong = _binomial5(weak)
    resid = jnp.abs(yf - weak)
    gx = jnp.abs(jnp.diff(yf, axis=1, prepend=yf[:, :1]))
    gy = jnp.abs(jnp.diff(yf, axis=0, prepend=yf[:1, :]))
    flat = ((gx + gy) < 0.06 * maxval).astype(jnp.float32)
    sigma = jnp.sum(resid * flat) / (jnp.sum(flat) + 1.0)

    def clamped(f):
        return yf + jnp.clip(f - yf, -(3.0 * sigma + 1.0), 3.0 * sigma + 1.0)

    lo, hi = 0.004 * maxval, 0.012 * maxval      # noise-class thresholds
    out = jnp.where(sigma < lo, yf,
                    jnp.where(sigma < hi, clamped(weak), clamped(strong)))
    return jnp.clip(jnp.round(out), 0, maxval), sigma


@functools.partial(jax.jit, static_argnames=("ctb",))
def ctb_activity(y: jnp.ndarray, ctb: int) -> jnp.ndarray:
    """Per-CTB spatial activity: mean of the 8x8 sample variances inside
    each CTB (reference ComputePictureSpatialStatistics,
    EbPictureAnalysisProcess.c:3879 — the QPM complexity feed). y must be
    padded to CTB multiples."""
    v8 = block_variance(y.astype(jnp.float32), 8)
    k = ctb // 8
    h8, w8 = v8.shape
    return v8.reshape(h8 // k, k, w8 // k, k).mean(axis=(1, 3))


_GM_R = 8       # global-motion search radius in 1/16-decimated pixels


@jax.jit
def lookahead_stats(ys: jnp.ndarray) -> dict:
    """Batched lookahead statistics for a run of consecutive lumas.

    ys: (T, H, W) — frame 0 is the predecessor of the window (the last
    already-analyzed frame); stats are returned for frames 1..T-1.

    One jit graph over the whole batch (the data-parallel shape of the
    reference's per-picture lookahead kernels): 1/16-area decimation by
    4x4 mean pooling (reference DecimateInputPicture,
    EbPictureAnalysisProcess.c:4139), zero-MV decimated SAD vs the
    previous frame (ComputeDecimatedZzSad,
    EbMotionEstimationProcess.c:828), global motion detection over a
    +-8-decimated-pel displacement grid (EbHevcDetectGlobalMotion,
    EbInitialRateControlProcess.c:218 — gm_sad is the motion-compensated
    complexity, gm_mv the [dx, dy] full-pel pan), per-frame variance, and
    32-bin luma histograms (the scene-change / RC histogram queue feed,
    EbInitialRateControlProcess.c:766).
    """
    yf = ys.astype(jnp.float32)
    t, h, w = yf.shape
    dec = yf.reshape(t, h // 4, 4, w // 4, 4).mean(axis=(2, 4))
    zz = jnp.abs(dec[1:] - dec[:-1]).mean(axis=(1, 2))       # (T-1,)

    # global translation search: SAD of every +-R decimated displacement,
    # all frame pairs at once (vmapped shifts over the padded predecessor)
    r = _GM_R
    hd, wd = h // 4, w // 4
    pad = jnp.pad(dec[:-1], ((0, 0), (r, r), (r, r)), mode="edge")
    disp = jnp.stack(jnp.meshgrid(jnp.arange(2 * r + 1),
                                  jnp.arange(2 * r + 1),
                                  indexing="ij"), -1).reshape(-1, 2)

    def one(d):
        sh = jax.lax.dynamic_slice(pad, (0, d[0], d[1]), (t - 1, hd, wd))
        return jnp.abs(dec[1:] - sh).mean(axis=(1, 2))
    sads = jax.vmap(one)(disp)                               # (S, T-1)
    k = jnp.argmin(sads, axis=0)                             # (T-1,)
    gm_sad = jnp.min(sads, axis=0)
    s2 = 2 * r + 1
    gm_mv = jnp.stack([(k % s2 - r) * 4, (k // s2 - r) * 4], -1)  # full-pel

    mean = yf.mean(axis=(1, 2))
    var = ((yf - mean[:, None, None]) ** 2).mean(axis=(1, 2))
    bins = jnp.clip(yf // 8.0, 0, 31).astype(jnp.int32)
    hist = jax.vmap(lambda b: jnp.zeros(32, jnp.int32).at[b.ravel()].add(1))(
        bins)                                                # (T, 32)
    return {"zz_sad": zz, "gm_sad": gm_sad, "gm_mv": gm_mv,
            "variance": var[1:], "hist": hist[1:]}


@jax.jit
def analyze_frame(y: jnp.ndarray) -> dict:
    """Full analysis graph for one luma plane (uint8/float32 (H, W), dims
    multiple of 64). Returns a pytree of analysis products."""
    yf = y.astype(jnp.float32)
    out = {
        "decim2": yf[::2, ::2],
        "decim4": yf[::4, ::4],
        "var8": block_variance(yf, 8),
        "var16": block_variance(yf, 16),
        "var32": block_variance(yf, 32),
    }
    for n in (4, 8, 16, 32):
        mode, cost = intra_search_size(yf, n)
        out[f"mode{n}"] = mode
        out[f"cost{n}"] = cost
    return out



@jax.jit
def ois_packed(y: jnp.ndarray) -> jnp.ndarray:
    """Open-loop intra search maps for n in 4/8/16/32, packed into ONE
    int32 buffer (mode then rounded cost per size) — a single device->host
    transfer."""
    out = analyze_frame(y.astype(jnp.float32))
    flats = []
    for n in (4, 8, 16, 32):
        flats.append(out[f"mode{n}"].ravel().astype(jnp.int32))
        flats.append(jnp.round(out[f"cost{n}"]).ravel().astype(jnp.int32))
    return jnp.concatenate(flats)
