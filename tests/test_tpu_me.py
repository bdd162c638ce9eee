"""Hierarchical motion estimation tests (virtual CPU mesh)."""

import jax.numpy as jnp
import numpy as np
import pytest

from svt_hevc_tpu.tpu.me import _block_sad_all_disp, hme_search


def _textured(h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w)).astype(np.float32)
    # low-pass for gradient structure
    k = np.ones((3, 3)) / 9.0
    out = base.copy()
    out[1:-1, 1:-1] = sum(base[1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx] * k[dy + 1, dx + 1]
                          for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return out


def test_global_translation_found():
    h, w = 128, 128
    big = _textured(h + 64, w + 64, seed=1)
    ref = big[32:32 + h, 32:32 + w]
    for dx, dy in ((3, 2), (-5, 7), (10, -4), (0, 0)):
        src = big[32 + dy:32 + dy + h, 32 + dx:32 + dx + w]
        mv, sad = hme_search(src, ref)
        mv = np.asarray(mv)
        # interior blocks should find exactly (dx, dy) in quarter-pel units
        inner = mv[2:-2, 2:-2]
        frac_correct = ((inner[..., 0] == 4 * dx) & (inner[..., 1] == 4 * dy)).mean()
        assert frac_correct > 0.9, (dx, dy, frac_correct)


def test_zero_motion_zero_sad():
    src = _textured(64, 64, seed=2)
    mv, sad = hme_search(src, src.copy())
    assert np.asarray(sad).max() == 0
    assert np.abs(np.asarray(mv)).max() == 0


def test_large_motion_within_range():
    """Hierarchy must reach displacements far beyond the +/-4 fine window."""
    h, w = 192, 192
    big = _textured(h + 100, w + 100, seed=3)
    ref = big[50:50 + h, 50:50 + w]
    dx, dy = 30, -22
    src = big[50 + dy:50 + dy + h, 50 + dx:50 + dx + w]
    mv, _ = hme_search(src, ref)
    inner = np.asarray(mv)[3:-3, 3:-3]
    frac = ((inner[..., 0] == 4 * dx) & (inner[..., 1] == 4 * dy)).mean()
    assert frac > 0.8, frac


def test_p_encode_with_me_seed_bitmatch():
    """Pipeline wiring: device-seeded P encode still decodes bit-exact."""
    from test_inter import _roundtrip_seq, moving_sequence
    frames = moving_sequence(64, 64, 3, dx=6, dy=0, seed=4)
    _, recons, decoded = _roundtrip_seq(frames, qp=34)
    for r, d in zip(recons, decoded):
        np.testing.assert_array_equal(r.y, d.y)


@pytest.mark.parametrize("shape", [(64, 128), (32, 256)])
@pytest.mark.parametrize("r", [2, 4])
def test_block_sad_field_matches_brute_force(shape, r):
    """The vmapped shift/abs/box-sum SAD field equals a numpy brute force
    over every displacement, with edge-replicated reference samples."""
    h, w = shape
    n = 16
    rng = np.random.default_rng(h + r)
    src = rng.integers(0, 256, shape).astype(np.float32)
    ref = rng.integers(0, 256, shape).astype(np.float32)
    got = np.asarray(_block_sad_all_disp(jnp.asarray(src), jnp.asarray(ref),
                                         n, r))
    assert got.shape == (2 * r + 1, 2 * r + 1, h // n, w // n)
    pad = np.pad(ref, r, mode="edge")
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            diff = np.abs(src - pad[dy:dy + h, dx:dx + w])
            want = diff.reshape(h // n, n, w // n, n).sum(axis=(1, 3))
            np.testing.assert_array_equal(got[dy, dx], want)
