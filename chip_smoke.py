#!/usr/bin/env python3
"""Smoke run of the encoder's device path on NVIDIA GPUs.

    python3 chip_smoke.py               # one card: phases below
    python3 chip_smoke.py --four-cards  # cfg.mesh_pictures on four cards
                                        # vs the same encode on one card

One card, in one process on the card:

  device   JAX must report a GPU; there is no fallback. Prints the platform,
           device kind and count, the JAX version, XLA_FLAGS and the card's
           name and power limit (read by nvidia-smi in a child process).
  stages   the device stages of the main path, compiled for the card at
           1080p, each against the repo's plain reference: the HME SAD
           field vs a numpy brute force, per-block MC vs the spec filters
           of core/inter.py, the int32 transforms + quant vs core/, and the
           open-loop intra search vs the same graph on the CPU backend.
  a, b, c  Encoder.encode_pictures at 1080p: (a) 8-bit M7 IPPP CQP 32,
           CTB 32, twice (determinism); (b) 8-bit random access,
           hierarchical_levels=2, one full mini-GOP; (c) 10-bit IPPP.
           Every picture must take the device path (the host CTU fallback
           raises inside this process) and the native emitter. Each stream
           must equal, byte for byte, the CPU backend's encode of the same
           frames (computed by a child process pinned to the CPU backend),
           and libde265, where installed, must decode it to the recon.

Timings are printed on earlier lines, labelled with the card, as findings.
The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}, printed
only when every phase passed; any failure exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080

# key -> (description, EncoderConfig overrides, frames, bit depth, seed)
PHASES = {
    "a": ("1080p 8-bit M7 IPPP CQP32", dict(intra_period=-1), 5, 8, 7),
    "b": ("1080p 8-bit random access hl=2",
          dict(intra_period=-1, pred_structure=2, hierarchical_levels=2),
          5, 8, 8),
    "c": ("1080p 10-bit IPPP CQP32", dict(intra_period=-1), 3, 10, 9),
}
MC_REPS = 16           # MC calls per graph when timing MC inside a graph
MESH_PHASE = ("1080p 8-bit low-delay P hl=2",
              dict(intra_period=-1, hierarchical_levels=2,
                   scene_change_detection=False), 9, 8, 10)


def phase_frames(n: int, w: int, h: int, bit_depth: int, seed: int):
    """bench.make_frames content; 10-bit adds two seeded low bits."""
    from bench import make_frames
    from svt_hevc_tpu.io.yuv import Frame
    frames = make_frames(n, w, h, seed=seed)
    if bit_depth == 8:
        return frames
    rng = np.random.default_rng(seed)

    def up(p):
        return ((p.astype(np.uint16) << 2)
                | rng.integers(0, 4, p.shape).astype(np.uint16))
    return [Frame(y=up(f.y), cb=up(f.cb), cr=up(f.cr)) for f in frames]


def phase_config(overrides: dict, w: int, h: int, bit_depth: int):
    from svt_hevc_tpu.config import EncoderConfig
    return EncoderConfig(width=w, height=h, qp=32, fps_num=50, enc_mode=7,
                         bit_depth=bit_depth, **overrides)


class HostFallback(RuntimeError):
    """A picture left the device path."""


@contextlib.contextmanager
def device_path_only(counts: dict):
    """Make every host-side fallback raise, count device-path pictures in
    counts["device"] and require the native emitter for every tile."""
    from svt_hevc_tpu.parallel import pictures
    from svt_hevc_tpu.pipeline import encoder as penc
    from svt_hevc_tpu.pipeline import fast_path, native_emit

    def refuse(name):
        def stub(*_a, **_k):
            raise HostFallback(f"picture took the host path ({name})")
        return stub

    def counted(fn, pictures=lambda *_a: 1):
        def run(*a, **k):
            counts["device"] = counts.get("device", 0) + pictures(*a)
            return fn(*a, **k)
        return run

    def native_only(*a, **k):
        data = real_emit(*a, **k)
        if data is None:
            raise HostFallback("native emitter unavailable")
        return data

    real_emit = native_emit.emit_tile_native
    patches = [(penc, "CtuEncoder", refuse("CtuEncoder")),
               (penc, "RdSearch", refuse("RdSearch")),
               (penc, "device_me_field", refuse("device_me_field")),
               (fast_path, "FastCtuEncoder", refuse("FastCtuEncoder")),
               (native_emit, "emit_tile_native", native_only)]
    patches += [(fast_path, f, counted(getattr(fast_path, f)))
                for f in ("run_fast_p", "run_fast_b", "run_fast_i")]
    # mesh-batched leaf pictures run one vmapped graph per batch
    patches.append((pictures, "dispatch_leaf_batch",
                    counted(pictures.dispatch_leaf_batch,
                            lambda _enc, _feat, items: len(items))))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, new in patches:
        setattr(mod, name, new)
    try:
        yield
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)


def encode(cfg, frames):
    """Encode through Encoder.encode_pictures on the device path. Returns
    (AU bytes in decode order, the full stream, recons in display order,
    slice types in decode order, seconds per AU)."""
    from svt_hevc_tpu.pipeline.encoder import Encoder
    counts: dict = {}
    enc = Encoder(cfg)
    aus, recons, types, secs = [], [None] * len(frames), [], []
    with device_path_only(counts):
        t = time.perf_counter()
        for au in enc.encode_pictures(iter(frames)):
            now = time.perf_counter()
            secs.append(now - t)
            t = now
            aus.append(au.data)
            recons[au.display_idx] = au.recon
            types.append("BPI"[au.slice_type])
    if counts.get("device", 0) != len(frames):
        raise HostFallback(f"{counts.get('device', 0)} of {len(frames)} "
                           "pictures ran a device graph")
    return aus, enc.headers() + b"".join(aus), recons, types, secs


def cpu_reference(out_path: str, w: int, h: int) -> None:
    """Child-process entry: encode every phase on the CPU backend and
    pickle {key: [AU bytes]} to out_path. The parent keeps two cores."""
    ncpu = os.cpu_count() or 1
    if ncpu > 4:
        os.sched_setaffinity(0, range(2, ncpu))
    import jax
    if jax.devices()[0].platform != "cpu":
        raise SystemExit("the CPU reference must run on the CPU backend")
    out = {}
    for key, (_, over, n, bd, seed) in PHASES.items():
        t = time.perf_counter()
        out[key] = encode(phase_config(over, w, h, bd),
                          phase_frames(n, w, h, bd, seed))[0]
        print(f"CPU-backend reference {key} (child process): "
              f"{time.perf_counter() - t:.1f} s", flush=True)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def start_cpu_reference(tmp: str):
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    log = open(os.path.join(tmp, "cpu_reference.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference",
         os.path.join(tmp, "cpu_reference.pkl"), str(W), str(H)],
        env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def finish_cpu_reference(proc, log, tmp: str, timeout: float) -> dict:
    rc = proc.wait(timeout=timeout)
    log.close()
    with open(os.path.join(tmp, "cpu_reference.log")) as f:
        text = f.read()
    if rc != 0:
        raise RuntimeError(f"CPU reference failed (rc={rc}):\n"
                           + text[-4000:])
    print(text.strip(), flush=True)
    with open(os.path.join(tmp, "cpu_reference.pkl"), "rb") as f:
        return pickle.load(f)


def first_difference(a: list, b: list):
    """Decode index of the first AU that differs, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def decode_check(stream: bytes, recons, frames) -> str:
    """libde265 decode == recon; returns a one-line verdict."""
    from svt_hevc_tpu.io import de265_decoder
    if not de265_decoder.available():
        return "libde265 absent: decode not checked"
    pics = de265_decoder.decode_annexb(stream)
    if len(pics) != len(recons):
        raise AssertionError(f"libde265 decoded {len(pics)} of "
                             f"{len(recons)} pictures")
    se, npx = 0.0, 0
    maxval = 255.0 if frames[0].y.dtype == np.uint8 else 1023.0
    for i, ((dy, dcb, dcr), rec) in enumerate(zip(pics, recons)):
        for got, want in ((dy, rec.y), (dcb, rec.cb), (dcr, rec.cr)):
            if not np.array_equal(got, np.asarray(want)):
                raise AssertionError(f"libde265 decode != recon, picture {i}")
        d = dy.astype(np.float64) - frames[i].y.astype(np.float64)
        se += float((d * d).sum())
        npx += d.size
    psnr = 10 * np.log10(maxval ** 2 * npx / max(se, 1e-9))
    return (f"libde265 decode == recon ({len(pics)} pictures, "
            f"PSNR-Y {psnr:.2f} dB)")


def peak_bytes(dev):
    """Peak device memory in use so far (None where not reported)."""
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


def timed(fn, *args, reps: int = 10) -> float:
    """Median seconds of fn(*args) after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def check_stages(w: int, h: int, seed: int = 5) -> dict:
    """Compile the main path's device stages for the default device at
    (w, h) rounded up to 64 and compare each with its plain reference.
    Returns their timings in seconds."""
    import jax
    import jax.numpy as jnp

    from svt_hevc_tpu.core.inter import (interp_chroma, interp_chroma_raw,
                                         interp_luma, interp_luma_raw)
    from svt_hevc_tpu.core.quant import dequantize, quantize
    from svt_hevc_tpu.core.transforms import (forward_transform,
                                              inverse_transform)
    from svt_hevc_tpu.tpu import analysis, me
    from svt_hevc_tpu.tpu import encode as tenc

    rng = np.random.default_rng(seed)
    h64, w64 = (h + 63) // 64 * 64, (w + 63) // 64 * 64
    ref = rng.integers(0, 256, (h64, w64)).astype(np.int32)
    src = np.roll(ref, (3, -5), (0, 1))
    times = {}

    # HME SAD field vs numpy brute force
    n, r = 16, 4
    got = np.asarray(jax.jit(me._block_sad_all_disp, static_argnums=(2, 3))(
        jnp.asarray(src, jnp.float32), jnp.asarray(ref, jnp.float32), n, r))
    pad = np.pad(ref, r, mode="edge")
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            d = np.abs(src - pad[dy:dy + h64, dx:dx + w64])
            want = d.reshape(h64 // n, n, w64 // n, n).sum((1, 3))
            if not np.array_equal(got[dy, dx], want):
                raise AssertionError(f"SAD field differs at ({dy}, {dx})")

    # per-block MC vs the spec filters, on sampled blocks of the full plane
    lim = (tenc.PAD - 9) * 4
    mv8 = rng.integers(-lim, lim + 1, (h64 // 8, w64 // 8, 2)).astype(np.int32)
    refc = ref[::2, ::2]
    ext_y = tenc._ext_y(jnp.asarray(ref))
    ext_c = tenc._ext_c(jnp.asarray(refc))
    mcl = jax.jit(tenc._mc_luma, static_argnums=(2, 3))
    mcc = jax.jit(tenc._mc_chroma, static_argnums=(2, 3))
    picks = rng.integers(0, [h64 // 8, w64 // 8], (512, 2))
    for rounded in (True, False):
        py = np.asarray(mcl(ext_y, jnp.asarray(mv8), 8, rounded))
        pc = np.asarray(mcc(ext_c, jnp.asarray(mv8), 8, rounded))
        fl = interp_luma if rounded else interp_luma_raw
        fc = interp_chroma if rounded else interp_chroma_raw
        for by, bx in picks:
            mvx, mvy = int(mv8[by, bx, 0]), int(mv8[by, bx, 1])
            if not np.array_equal(py[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8],
                                  fl(ref, bx * 8, by * 8, 8, 8, mvx, mvy)):
                raise AssertionError(f"luma MC differs, block ({by}, {bx})")
            if not np.array_equal(pc[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4],
                                  fc(refc, bx * 4, by * 4, 4, 4, mvx, mvy)):
                raise AssertionError(f"chroma MC differs, block ({by}, {bx})")
    times["mc_luma"] = timed(mcl, ext_y, jnp.asarray(mv8), 8, True)
    times["mc_chroma"] = timed(mcc, ext_c, jnp.asarray(mv8), 8, True)
    # per-call cost inside one graph, without a dispatch per call
    for name, fn, ext in (("mc_luma", tenc._mc_luma, ext_y),
                          ("mc_chroma", tenc._mc_chroma, ext_c)):
        times[name + "_in_graph"] = timed(
            jax.jit(lambda e, mv, fn=fn: sum(
                fn(e, mv + i, 8, True).sum() for i in range(MC_REPS))),
            ext, jnp.asarray(mv8)) / MC_REPS
    times["hme_search"] = timed(me.hme_search, jnp.asarray(src),
                                jnp.asarray(ref))

    # int32 transform + quant at every TU size vs core/
    resid = (src - ref).astype(np.int32)
    tq = jax.jit(tenc.dense_tq_size, static_argnums=1)
    for n in (4, 8, 16, 32):
        lv, rr = (np.asarray(a) for a in tq(jnp.asarray(resid), n,
                                             jnp.int32(32)))
        for by, bx in rng.integers(0, [h64 // n, w64 // n], (64, 2)):
            sl = np.s_[by * n:(by + 1) * n, bx * n:(bx + 1) * n]
            want_lv = quantize(forward_transform(resid[sl], 8, dst=False),
                               32, is_intra=False, bit_depth=8)
            want_rr = inverse_transform(dequantize(want_lv, 32, bit_depth=8),
                                        8, dst=False)
            if not (np.array_equal(lv[sl], want_lv)
                    and np.array_equal(rr[sl], want_rr)):
                raise AssertionError(f"{n}x{n} transform differs ({by}, {bx})")

    # open-loop intra search: identical modes and costs on the CPU backend
    cpu = jax.devices("cpu")[0]
    y = jnp.asarray(src, jnp.float32)
    y_cpu = jax.device_put(np.asarray(src, np.float32), cpu)
    for n in (4, 8, 16, 32):
        dev = [np.asarray(a) for a in analysis.intra_search_size(y, n)]
        host = [np.asarray(a) for a in analysis.intra_search_size(y_cpu, n)]
        if not (np.array_equal(dev[0], host[0])
                and np.array_equal(dev[1], host[1])):
            raise AssertionError(f"intra search {n}x{n} differs from CPU")
    return times


@contextlib.contextmanager
def count_calls(module, names, calls: dict):
    """Count calls of module.<name> in calls[name]. Inside a jitted graph a
    call runs once per trace, so a fresh trace counts calls per graph."""
    saved = {name: getattr(module, name) for name in names}

    def counting(name, real):
        def run(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        return run

    for name, real in saved.items():
        setattr(module, name, counting(name, real))
    try:
        yield
    finally:
        for name, real in saved.items():
            setattr(module, name, real)


def p_graph_seconds(cfg, frames) -> float:
    """Median seconds of one P picture's fused device graph, from dispatch
    to a ready packed buffer (the encode runs unpipelined)."""
    import jax

    from svt_hevc_tpu.pipeline import fast_path

    real_p = fast_path.run_fast_p
    secs = []

    def timed_p(*a, **k):
        t = time.perf_counter()
        out = real_p(*a, **k)
        jax.block_until_ready(out[0])
        secs.append(time.perf_counter() - t)
        return out

    fast_path.run_fast_p = timed_p
    try:
        encode(cfg, frames)
    finally:
        fast_path.run_fast_p = real_p
    return float(np.median(secs))


class CompileClock:
    """Sums JAX's lowering and backend-compile durations (tracing is left
    out: nested jits report it inside their callers' traces)."""

    EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, secs, **_kw):
        if event in self.EVENTS:
            self.total += secs

    def lap(self) -> float:
        t, self.total = self.total, 0.0
        return t


def device_line(devs) -> dict:
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def run_one_card() -> dict:
    import jax

    from bench import card, require_gpu
    from svt_hevc_tpu.tpu import encode as tenc

    devs = require_gpu()
    label = card()
    print(f"device: {device_line(devs)}, jax {jax.__version__}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    from svt_hevc_tpu import native
    so = os.path.join(os.path.dirname(native.__file__),
                      "_libsvthevc_native.so")
    prebuilt = os.path.exists(so)
    if native.native_cabac_lib() is None:
        raise RuntimeError("native CABAC/emitter library did not build")
    print(f"native emitter: {'found' if prebuilt else 'built'} {so}",
          flush=True)
    clock = CompileClock()

    with tempfile.TemporaryDirectory() as tmp:
        proc, log = start_cpu_reference(tmp)
        try:
            t = time.perf_counter()
            times = check_stages(W, H)
            print(f"[{label}] stages: SAD field, MC luma/chroma (rounded "
                  f"and 14-bit), int32 T/Q 4..32, intra search == "
                  f"references at 1080p ({time.perf_counter() - t:.1f} s)",
                  flush=True)
            print(f"[{label}] 1080p jitted alone: hme_search "
                  f"{times['hme_search'] * 1e3:.3f} ms, _mc_luma "
                  f"{times['mc_luma'] * 1e3:.3f} ms, _mc_chroma "
                  f"{times['mc_chroma'] * 1e3:.3f} ms", flush=True)
            clock.lap()

            gpu = {}
            for key, (desc, over, n, bd, seed) in PHASES.items():
                cfg = phase_config(over, W, H, bd)
                frames = phase_frames(n, W, H, bd, seed)
                mc_calls: dict = {}
                t = time.perf_counter()
                with count_calls(tenc, ("_mc_luma", "_mc_chroma"), mc_calls):
                    aus, stream, recons, types, secs = encode(cfg, frames)
                wall = time.perf_counter() - t
                gpu[key] = aus
                line = (f"[{label}] phase {key} ({desc}): {n} pictures "
                        f"{''.join(types)} all on the device path with the "
                        f"native emitter, {len(stream)} bytes, wall "
                        f"{wall:.1f} s, lowering + compile "
                        f"{clock.lap():.1f} s, peak "
                        f"device memory "
                        f"{peak_bytes(devs[0])} B")
                print(line, flush=True)
                print(f"[{label}] phase {key}: "
                      f"{decode_check(stream, recons, frames)}", flush=True)
                if key == "a":
                    aus2, _, _, _, secs2 = encode(cfg, frames)
                    if aus2 != aus:
                        raise AssertionError(
                            "phase a: two encodes on the card differ at AU "
                            f"{first_difference(aus, aus2)}")
                    print(f"[{label}] phase a warm: deterministic, IDR "
                          f"{secs2[0]:.3f} s, steady P "
                          f"{(len(secs2) - 2) / sum(secs2[2:]):.3f} frames/s",
                          flush=True)
                    p_sec = p_graph_seconds(cfg, frames[:4])
                    nl, nc = mc_calls["_mc_luma"], mc_calls["_mc_chroma"]
                    share = (nl * times["mc_luma_in_graph"]
                             + nc * times["mc_chroma_in_graph"]) / p_sec
                    print(f"[{label}] P graph {p_sec * 1e3:.3f} ms; it "
                          f"holds {nl} _mc_luma and {nc} _mc_chroma calls; "
                          f"at their cost inside one graph "
                          f"({times['mc_luma_in_graph'] * 1e3:.3f} / "
                          f"{times['mc_chroma_in_graph'] * 1e3:.3f} ms) "
                          f"they take {share:.1%} of it", flush=True)
                    clock.lap()

            t = time.perf_counter()
            ref = finish_cpu_reference(proc, log, tmp, timeout=900)
            print(f"[{label}] waited {time.perf_counter() - t:.1f} s for "
                  "the CPU reference", flush=True)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for key in PHASES:
        i = first_difference(gpu[key], ref[key])
        if i is not None:
            raise AssertionError(f"phase {key}: GPU stream != CPU stream "
                                 f"from AU {i} (decode order)")
        print(f"[{label}] phase {key}: GPU stream == CPU stream "
              f"({sum(map(len, gpu[key]))} slice bytes)", flush=True)
    print(f"card: {label}", flush=True)
    return device_line(devs)


def run_four_cards() -> dict:
    from bench import card, require_gpu

    devs = require_gpu()
    if len(devs) != 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX sees {len(devs)}")
    label = card()
    from svt_hevc_tpu.parallel import pictures
    desc, over, n, bd, seed = MESH_PHASE
    frames = phase_frames(n, W, H, bd, seed)
    batches = []
    real = pictures.dispatch_leaf_batch

    def counted(enc, feat, items):
        batches.append(len(items))
        return real(enc, feat, items)

    result = {}
    pictures.dispatch_leaf_batch = counted
    try:
        for mesh in (False, True, False, True):
            cfg = phase_config(dict(over, mesh_pictures=mesh), W, H, bd)
            t = time.perf_counter()
            aus = encode(cfg, frames)[0]
            result.setdefault(mesh, []).append(
                (aus, n / (time.perf_counter() - t)))
    finally:
        pictures.dispatch_leaf_batch = real
    if not batches or max(batches) != 4:
        raise AssertionError(f"leaf batches {batches}: the mesh path did "
                             "not run four pictures at once")
    one, four = result[False], result[True]
    for aus, _ in one[1:] + four:
        i = first_difference(one[0][0], aus)
        if i is not None:
            raise AssertionError(f"mesh_pictures stream differs at AU {i}")
    print(f"[{label}] {desc}, {n} pictures: mesh_pictures on 4 cards == one "
          f"card, byte for byte ({sum(map(len, one[0][0]))} slice bytes); "
          f"warm frames/s: one card {one[1][1]:.3f}, four cards "
          f"{four[1][1]:.3f} (cold {one[0][1]:.3f} / {four[0][1]:.3f}); "
          f"leaf batches {batches}", flush=True)
    print(f"card: {label}", flush=True)
    return device_line(devs)


def main(argv) -> int:
    sys.path.insert(0, REPO)
    if argv[:1] == ["--cpu-reference"]:
        cpu_reference(argv[1], int(argv[2]), int(argv[3]))
        return 0
    if argv not in ([], ["--four-cards"]):
        raise SystemExit(__doc__)
    device = run_four_cards() if argv else run_one_card()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
