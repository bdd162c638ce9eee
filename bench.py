"""Benchmark: FULL encode throughput at 1080p, M7, IPPP, one GPU.

Times Encoder.encode_pictures() end-to-end — device frontend (analysis/
OIS/HME), mode decision, encode pass, DLF/SAO, CABAC, packetization — the
analogue of the reference's speed test (Tests/SVT-HEVC_FunctionalTests.py
run_speed_test :1409), NOT just the device frontend.

The produced stream is then DECODED with libde265 (independent
third-party decoder) and compared byte-for-byte against the encoder's own
reconstruction, with PSNR vs the source reported — a corrupt stream can
NOT produce a green bench. (Reference analogue: the functional tests'
decoded.yuv == recon.yuv check, Tests/SVT-HEVC_FunctionalTests.py:641.)

Runs on a GPU only: without one it exits non-zero. Prints ONE JSON line,
naming the device (platform, device_kind, count) and the card's power
limit; a SIGTERM/SIGINT/SIGALRM or the internal deadline emits the
partial result instead of dying silently. The headline
metric is the steady-state IPPP fps; idr_seconds / compile_seconds are
reported separately so warmup cost is visible, not hidden in the average.
vs_baseline normalises against 1080p50 real-time (the reference's design
point, Docs/svt-hevc_encoder_user_guide.md:398).

`python bench.py --device-cpu-check` instead encodes a short 512x256 clip
on the GPU and, in a child process pinned to the CPU backend, on the CPU,
and asserts the streams are byte-identical.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

W, H = 1920, 1080
WARMUP_FRAMES = 3          # IDR + first P (graph compile) + 1 settled P
MAX_FRAMES = 64
TIME_BUDGET_S = 90.0       # steady-state measurement window
DEADLINE_S = 540.0         # absolute wall-clock backstop (SIGALRM)

_state = {
    "idr_seconds": None,        # first (IDR) frame wall time
    "compile_seconds": None,    # first P frame (includes graph compile)
    "steady_frames": 0,
    "steady_seconds": 0.0,
    "decode_ok": None,          # libde265 decode == encoder recon
    "psnr_y": None,             # decoded-vs-source luma PSNR
    "phase": "startup",
}
_device: dict = {}
_emitted = False


def card() -> str:
    """'name, power limit' of the card(s) as nvidia-smi reports them, read
    in a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def require_gpu() -> list:
    """JAX's devices; exits non-zero unless they are GPUs."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"{os.path.basename(sys.argv[0])}: no GPU (JAX "
                         f"reports {devs[0].platform}); this runs on the "
                         "card only")
    return devs


def _emit(rc: int = 0) -> None:
    global _emitted
    if _emitted:
        return
    _emitted = True
    s = _state
    fps = (s["steady_frames"] / s["steady_seconds"]
           if s["steady_seconds"] > 0 and s["steady_frames"] > 0 else 0.0)
    print(json.dumps({
        "metric": "full_encode_1080p_m7_ipp_fps",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / 50.0, 4),
        "idr_seconds": (round(s["idr_seconds"], 3)
                        if s["idr_seconds"] is not None else None),
        "compile_seconds": (round(s["compile_seconds"], 3)
                            if s["compile_seconds"] is not None else None),
        "steady_frames": s["steady_frames"],
        "decode_ok": s["decode_ok"],
        "psnr_y": s["psnr_y"],
        "phase": s["phase"],
        **_device,
    }), flush=True)
    if rc:
        os._exit(rc)


def _on_signal(signum, frame):
    _state["phase"] += f"/sig{signum}"
    _emit(rc=0)
    os._exit(0)


def make_frames(n, w=W, h=H, seed=7):
    """Synthetic content: textured luma AND chroma with global pan +
    moving objects, so both inter luma and chroma coding do real work."""
    from svt_hevc_tpu.io.yuv import Frame
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 128, w + 128)).astype(np.float32)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, -1, 0) + np.roll(big, -1, 1)) / 5.0
    big = big * 0.7 + 64
    cbig = rng.integers(0, 256, (h // 2 + 64, w // 2 + 64)).astype(np.float32)
    for _ in range(2):
        cbig = (cbig + np.roll(cbig, 1, 0) + np.roll(cbig, 1, 1)
                + np.roll(cbig, -1, 0) + np.roll(cbig, -1, 1)) / 5.0
    cbig = cbig * 0.25 + 96
    frames = []
    for i in range(n):
        ox, oy = (2 * i) % 64, i % 64
        y = big[oy:oy + h, ox:ox + w].astype(np.uint8).copy()
        sx, sy = (100 + 7 * i) % (w - 200), (80 + 5 * i) % (h - 200)
        y[sy:sy + 96, sx:sx + 96] = 200
        cb = cbig[oy // 2:oy // 2 + h // 2,
                  ox // 2:ox // 2 + w // 2].astype(np.uint8).copy()
        cr = (255 - cbig[oy // 2:oy // 2 + h // 2,
                         ox // 2:ox // 2 + w // 2]).astype(np.uint8).copy()
        cb[sy // 2:sy // 2 + 48, sx // 2:sx // 2 + 48] = 80
        frames.append(Frame(y=y, cb=cb, cr=cr))
    return frames


def _decode_check(stream, recons, frames):
    """Decode with libde265 and compare against the encoder recon;
    compute decoded-vs-source luma PSNR."""
    from svt_hevc_tpu.io import de265_decoder as d
    if not d.available():
        _state["decode_ok"] = "libde265-missing"
        return
    pics = d.decode_annexb(stream)
    if len(pics) != len(recons):
        _state["decode_ok"] = False
        return
    ok = True
    se = 0.0
    npx = 0
    for i, ((dy, dcb, dcr), rec) in enumerate(zip(pics, recons)):
        ry = np.asarray(rec.y)
        ok = ok and (np.array_equal(dy, ry)
                     and np.array_equal(dcb, np.asarray(rec.cb))
                     and np.array_equal(dcr, np.asarray(rec.cr)))
        src = frames[i].y.astype(np.float64)
        se += float(((dy.astype(np.float64) - src) ** 2).sum())
        npx += src.size
    _state["decode_ok"] = bool(ok)
    _state["psnr_y"] = round(10 * np.log10(255.0 ** 2 * npx / max(se, 1e-9)),
                             2)


def _check_clip():
    w, h, n = 512, 256, 10
    from svt_hevc_tpu.config import EncoderConfig
    from svt_hevc_tpu.pipeline.encoder import Encoder
    cfg = EncoderConfig(width=w, height=h, qp=32, enc_mode=7,
                        intra_period=-1)
    return Encoder(cfg).encode(make_frames(n, w, h, seed=11))[0]


def device_cpu_check() -> None:
    """Encode the same clip on the GPU and, in a child process pinned to
    the CPU backend, on the CPU; exit non-zero unless the streams are
    byte-identical."""
    devs = require_gpu()
    s_dev = _check_clip()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cpu_stream.pkl")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--cpu-clip", out], check=True,
                       env=dict(os.environ, JAX_PLATFORMS="cpu",
                                CUDA_VISIBLE_DEVICES=""))
        with open(out, "rb") as f:
            s_cpu = pickle.load(f)
    res = {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
           "device_count": len(devs), "card": card(),
           "bytes_device": len(s_dev), "bytes_cpu": len(s_cpu),
           "identical": s_dev == s_cpu}
    print(json.dumps(res), flush=True)
    sys.exit(0 if res["identical"] else 1)


def main() -> None:
    if sys.argv[1:2] == ["--cpu-clip"]:
        with open(sys.argv[2], "wb") as f:
            pickle.dump(_check_clip(), f)
        return
    if "--device-cpu-check" in sys.argv:
        device_cpu_check()
        return
    devs = require_gpu()
    _device.update(platform=devs[0].platform,
                   device_kind=devs[0].device_kind, device_count=len(devs),
                   card=card())
    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGALRM):
        signal.signal(sig, _on_signal)
    signal.alarm(int(DEADLINE_S))

    from svt_hevc_tpu.config import EncoderConfig
    from svt_hevc_tpu.pipeline.encoder import Encoder

    cfg = EncoderConfig(width=W, height=H, qp=32, fps_num=50,
                        enc_mode=7, intra_period=-1)
    enc = Encoder(cfg)
    frames = make_frames(MAX_FRAMES)

    _state["phase"] = "warmup"
    t_prev = time.perf_counter()
    t0 = None
    chunks = [enc.headers()]
    recons = []
    n_aus = 0
    for au in enc.encode_pictures(iter(frames)):
        now = time.perf_counter()
        chunks.append(au.data)
        recons.append(au.recon)
        n_aus += 1
        if au.display_idx == 0:
            _state["idr_seconds"] = now - t_prev
        elif au.display_idx == 1:
            _state["compile_seconds"] = now - t_prev
        t_prev = now
        if au.display_idx == WARMUP_FRAMES - 1:
            _state["phase"] = "steady"
            t0 = now                  # start clock after warmup frames
            continue
        if t0 is not None:
            _state["steady_frames"] += 1
            _state["steady_seconds"] = now - t0
            if now - t0 > TIME_BUDGET_S:
                break
    _state["phase"] = "decode-check"
    signal.alarm(int(DEADLINE_S))     # fresh budget for the oracle decode
    _decode_check(b"".join(chunks), recons, frames[:n_aus])
    _state["phase"] = "done"
    _emit()


if __name__ == "__main__":
    main()
