"""BD-rate / speed comparison against the reference SVT-HEVC encoder.

Encodes the same clip with this framework and with the reference binary
(built by tools/build_reference.sh) at matched QPs and preset, decodes
BOTH streams with the independent libde265 oracle, and reports per-QP
rate/PSNR plus the Bjontegaard delta rate (the reference project's own
quality tracking methodology, SURVEY.md §4 implication (5)).

Usage: python tools/compare_reference.py [--width W --height H --frames N]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# BD-rate is platform-independent (GPU and CPU backends are bit-exact,
# bench.py --device-cpu-check); pin CPU so the tool runs anywhere and never
# contends with a bench on the real chip. Speed numbers come from
# bench.py, not this tool.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

def _pin_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")


def make_clip_scene(w, h, n, path):
    """Structured synthetic content: smooth sky gradient, textured ground,
    high-contrast structures, and three moving objects at mixed (incl.
    fractional-effective) velocities — closer to camera video than the
    pure-noise pan of make_clip."""
    rng = np.random.default_rng(9)
    H, W = h + 96, w + 96
    yy, xx = np.mgrid[0:H, 0:W]
    sky = 60 + 90 * (yy / H)
    tex = rng.integers(0, 256, (H, W)).astype(np.float32)
    for _ in range(3):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)
               + np.roll(tex, -1, 0) + np.roll(tex, -1, 1)) / 5
    ground = 80 + 0.5 * (tex - tex.mean())
    base = np.where(yy > 0.6 * H, ground, sky)
    # static structures: bars and blocks
    for k in range(6):
        x0 = (97 * k) % (W - 80)
        base[H // 3:H // 3 + 40 + 8 * k, x0:x0 + 24] = 30 + 30 * (k % 3)
    frames = []
    with open(path, "wb") as f:
        for i in range(n):
            ox, oy = (3 * i) % 64, (1 * i) % 48
            y = base[oy:oy + h, ox:ox + w].astype(np.float32).copy()
            # moving objects: slow smooth disc, fast small block, drifter
            cx, cy = (40 + 5 * i) % (w - 80), int(h * 0.3)
            ygrid, xgrid = np.mgrid[0:h, 0:w]
            disc = ((xgrid - cx - 40) ** 2 + (ygrid - cy - 40) ** 2) < 35 ** 2
            y[disc] = 200 - (i % 7)
            bx, by = (11 * i) % (w - 32), (h // 2 + 3 * i) % (h - 32)
            y[by:by + 24, bx:bx + 24] = 16
            y = np.clip(y, 0, 255).astype(np.uint8)
            cb = np.full((h // 2, w // 2), 118, np.uint8)
            cb[by // 2:by // 2 + 12, bx // 2:bx // 2 + 12] = 90
            cr = np.full((h // 2, w // 2), 130, np.uint8)
            f.write(y.tobytes()); f.write(cb.tobytes()); f.write(cr.tobytes())
            frames.append((y.astype(np.int64), cb, cr))
    return frames


def make_clip(w, h, n, path):
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (h + 64, w + 64)).astype(np.float32)
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    frames = []
    with open(path, "wb") as f:
        for i in range(n):
            y = base[i % 32:i % 32 + h, (2 * i) % 32:(2 * i) % 32 + w]
            y = y.astype(np.uint8).copy()
            sx, sy = (7 * i) % (w - 64), (5 * i) % (h - 64)
            y[sy:sy + 48, sx:sx + 48] = (
                base[sy:sy + 48, sx:sx + 48] * 0.5 + 90).astype(np.uint8)
            cb = np.full((h // 2, w // 2), 120, np.uint8)
            cr = np.full((h // 2, w // 2), 130, np.uint8)
            f.write(y.tobytes())
            f.write(cb.tobytes())
            f.write(cr.tobytes())
            frames.append((y, cb, cr))
    return frames


def psnr_stream(stream, frames):
    from svt_hevc_tpu.io.de265_decoder import decode_annexb
    dec = decode_annexb(stream)
    assert len(dec) == len(frames), (len(dec), len(frames))
    num = den = 0.0
    for (dy, _, _), (sy, _, _) in zip(dec, frames):
        num += float(((dy - sy.astype(np.int64)) ** 2).sum())
        den += dy.size
    mse = num / den
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def bd_rate(r1, p1, r2, p2):
    """Bjontegaard delta rate of (r2, p2) vs anchor (r1, p1): % bitrate
    change at equal quality (negative = anchor beaten)."""
    lr1, lr2 = np.log10(r1), np.log10(r2)
    c1 = np.polyfit(p1, lr1, 3)
    c2 = np.polyfit(p2, lr2, 3)
    lo = max(min(p1), min(p2))
    hi = min(max(p1), max(p2))
    i1 = np.polyint(c1)
    i2 = np.polyint(c2)
    avg1 = (np.polyval(i1, hi) - np.polyval(i1, lo)) / (hi - lo)
    avg2 = (np.polyval(i2, hi) - np.polyval(i2, lo)) / (hi - lo)
    return (10 ** (avg2 - avg1) - 1) * 100.0


def run_ours(clip, w, h, n, qp, preset, intra_period=-1,
             pred_struct=0, hierarchical_levels=None):
    _pin_cpu()
    from svt_hevc_tpu.config import EncoderConfig
    from svt_hevc_tpu.io.yuv import read_yuv420
    from svt_hevc_tpu.pipeline.encoder import Encoder
    kw = {}
    if pred_struct == 2:
        kw = dict(pred_structure=2,
                  hierarchical_levels=(hierarchical_levels
                                       if hierarchical_levels is not None
                                       else 3))
    elif hierarchical_levels:
        # hierarchical low-delay: temporal layers + per-layer QP offsets
        # (the reference's -pred-struct 0 ALSO defaults to hierarchical
        # levels with layered QP — a flat-QP IPPP on our side would
        # compare different structures again)
        kw = dict(pred_structure=0, hierarchical_levels=hierarchical_levels)
    # CTB 64 anchors the comparison at the reference's LCU size (it has
    # no other): without 64x64 merge/skip CUs every committed BD number
    # carried a structural bits handicap at low rates (r4 verdict)
    cfg = EncoderConfig(width=w, height=h, qp=qp, enc_mode=preset,
                        intra_period=intra_period, ctb_size=64,
                        scene_change_detection=False, **kw)
    enc = Encoder(cfg)
    frames = list(read_yuv420(clip, w, h, max_frames=n))
    t0 = time.perf_counter()
    stream, _ = enc.encode(frames)
    dt = time.perf_counter() - t0
    return bytes(stream), dt


def run_ref(app, clip, w, h, n, qp, preset, intra_period=-1,
            pred_struct=0, hierarchical_levels=None):
    """pred_struct: 0 = low-delay P (matches our IPPP), 1 = low-delay B,
    2 = random access. Matching structures is what makes the BD number
    meaningful (round-3 verdict: the tool previously compared our IPPP
    against the reference's default hierarchical-B RA)."""
    out = tempfile.mktemp(suffix=".265")
    cmd = [app, "-i", clip, "-w", str(w), "-h", str(h), "-q", str(qp),
           "-encMode", str(preset), "-intra-period", str(intra_period),
           "-rc", "0", "-pred-struct", str(pred_struct),
           "-n", str(n), "-scd", "0", "-b", out]
    # ALWAYS pin the reference's hierarchy: its -pred-struct 0 default is
    # hierarchical-levels 3 (layered QP), which silently mismatches a
    # flat IPPP on our side (round-3 verdict's complaint, round-4 redux)
    cmd += ["-hierarchical-levels", str(hierarchical_levels or 0)]
    if pred_struct == 2:
        cmd += ["-irefresh-type", "2"]   # closed GOP (IDR), matching ours
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, capture_output=True)
    dt = time.perf_counter() - t0
    data = open(out, "rb").read()
    os.unlink(out)
    return data, dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--preset", type=int, default=7)
    ap.add_argument("--qps", type=int, nargs="+", default=[22, 27, 32, 37])
    # realistic streaming refresh: with no refresh (-1) the comparison
    # degenerates into a quality-drift contest on synthetic content (the
    # reference coasts with falling per-frame PSNR)
    ap.add_argument("--intra-period", type=int, default=31)
    ap.add_argument("--content", choices=["scene", "noise"],
                    default="scene")
    ap.add_argument("--json", default=None,
                    help="write the per-QP table + BD-rate to this file")
    ap.add_argument("--pred-struct", type=int, default=0, choices=[0, 2],
                    help="0 = IPPP (low-delay P), 2 = random access "
                         "hierarchical-B; applied to BOTH encoders")
    ap.add_argument("--hierarchical-levels", type=int, default=None,
                    help="temporal layers on BOTH sides; default: flat "
                         "(0) for IPPP, 2 for random access")
    args = ap.parse_args()
    if args.hierarchical_levels is None:
        args.hierarchical_levels = 2 if args.pred_struct == 2 else 0

    here = os.path.dirname(os.path.abspath(__file__))
    app = subprocess.run(["sh", os.path.join(here, "build_reference.sh")],
                         capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    clip = tempfile.mktemp(suffix=".yuv")
    gen = make_clip_scene if args.content == "scene" else make_clip
    frames = gen(args.width, args.height, args.frames, clip)

    ours_r, ours_p, ref_r, ref_p = [], [], [], []
    rows = []
    print(f"{'qp':>4} {'ours kb':>9} {'ours dB':>8} {'ours fps':>9} "
          f"{'ref kb':>9} {'ref dB':>8} {'ref fps':>9}")
    hl = args.hierarchical_levels
    for qp in args.qps:
        so, to = run_ours(clip, args.width, args.height, args.frames, qp,
                          args.preset, args.intra_period,
                          pred_struct=args.pred_struct,
                          hierarchical_levels=hl)
        sr, tr = run_ref(app, clip, args.width, args.height, args.frames,
                         qp, args.preset, args.intra_period,
                         pred_struct=args.pred_struct,
                         hierarchical_levels=hl)
        po = psnr_stream(so, frames)
        pr = psnr_stream(sr, frames)
        ours_r.append(len(so))
        ours_p.append(po)
        ref_r.append(len(sr))
        ref_p.append(pr)
        rows.append({"qp": qp, "ours_bytes": len(so),
                     "ours_psnr": round(po, 3),
                     "ours_fps": round(args.frames / to, 3),
                     "ref_bytes": len(sr), "ref_psnr": round(pr, 3),
                     "ref_fps": round(args.frames / tr, 3)})
        print(f"{qp:>4} {len(so)/1000:>9.1f} {po:>8.2f} "
              f"{args.frames/to:>9.2f} {len(sr)/1000:>9.1f} {pr:>8.2f} "
              f"{args.frames/tr:>9.2f}")
    bd = bd_rate(np.array(ref_r, float), np.array(ref_p),
                 np.array(ours_r, float), np.array(ours_p))
    sname = "IPPP" if args.pred_struct == 0 else f"RA-hierB(hl={hl})"
    print(f"\nBD-rate vs reference M{args.preset} (luma, matched {sname}, "
          f"{args.width}x{args.height}, {args.frames}f, "
          f"ip={args.intra_period}, {args.content}): {bd:+.1f}% "
          f"({'worse' if bd > 0 else 'better'} = more bits at equal PSNR)")
    if args.json:
        import json
        with open(args.json, "w") as f:
            json.dump({"preset": args.preset,
                       "dims": [args.width, args.height],
                       "frames": args.frames,
                       "intra_period": args.intra_period,
                       "pred_struct": sname + "-matched",
                       "content": args.content,
                       "rows": rows,
                       "bd_rate_pct": round(bd, 2)}, f, indent=1)
    os.unlink(clip)


if __name__ == "__main__":
    main()
