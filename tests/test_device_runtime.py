"""The device runtime around the encoder: the compile-cache location, the
GPU-only smoke script (chip_smoke.py) and its device-path guard."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _python(code_or_args, env_update, cwd=REPO, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_update)
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    return subprocess.run([sys.executable, *args], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(env_set, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    fixed <checkout>/.jax_cache, whatever the working directory."""
    code = ("import jax, svt_hevc_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    res = _python(code, env, cwd=str(tmp_path),
                  drop=() if env_set else ("JAX_COMPILATION_CACHE_DIR",))
    assert res.returncode == 0, res.stderr
    want = (str(tmp_path / "cache") if env_set
            else os.path.join(REPO, ".jax_cache"))
    assert res.stdout.strip().splitlines()[-1] == want


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """Without a GPU, or without the rest of the repo, the smoke exits
    non-zero and never prints a result."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    res = _python([str(script)], {"JAX_PLATFORMS": "cpu"},
                  cwd=str(tmp_path))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _tiny(**over):
    cfg = chip_smoke.phase_config(dict(intra_period=-1, **over), 256, 256, 8)
    return cfg, chip_smoke.phase_frames(3, 256, 256, 8, seed=1)


def test_device_path_guard_passes_fast_path():
    cfg, frames = _tiny()
    aus, stream, recons, types, _ = chip_smoke.encode(cfg, frames)
    assert types == ["I", "P", "P"] and len(aus) == 3
    assert len(stream) > sum(map(len, aus))       # parameter sets first
    assert all(r is not None for r in recons)


def test_device_path_guard_refuses_host_fallback():
    """Two tile columns are not on the device path yet: the guard must
    turn the silent host fallback into an error."""
    cfg, frames = _tiny(tile_columns=2)
    with pytest.raises(chip_smoke.HostFallback):
        chip_smoke.encode(cfg, frames[:1])


def test_smoke_stage_checks_on_cpu():
    """The smoke's stage-vs-reference checks, at a small width on the CPU
    backend (on the card they run at 1080p)."""
    times = chip_smoke.check_stages(256, 128)
    assert set(times) == {"mc_luma", "mc_chroma", "mc_luma_in_graph",
                          "mc_chroma_in_graph", "hme_search"}
    assert all(np.isfinite(t) and t > 0 for t in times.values())


def test_first_difference():
    assert chip_smoke.first_difference([b"a", b"b"], [b"a", b"b"]) is None
    assert chip_smoke.first_difference([b"a", b"b"], [b"a", b"c"]) == 1
    assert chip_smoke.first_difference([b"a"], [b"a", b"c"]) == 1


@pytest.mark.gpu
def test_gpu_stages_match_references_at_1080p(gpu):
    chip_smoke.check_stages(chip_smoke.W, chip_smoke.H)
