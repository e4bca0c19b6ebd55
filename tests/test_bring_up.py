"""What keeps the program honest about its device: the smoke script's
backend guard, the benchmark's peak table, the compile-cache location, and
imports that need no IO packages."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_the_cpu():
    import chip_smoke

    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu()


def test_bench_peaks_know_the_h100():
    import bench

    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_gbps"] == 3350.0
    assert peaks["f32_tflops"] == 67.0 and peaks["tf32_tflops"] == 495.0
    assert peaks["bf16_tflops"] == 989.0


def test_bench_peaks_refuse_unknown_devices():
    import bench

    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("cpu")


def test_compile_cache_honours_the_env_var(monkeypatch, tmp_path):
    import jax

    from oisat.utils.compile_cache import enable_compile_cache

    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_default_is_fixed_in_repo(monkeypatch):
    import jax

    from oisat.utils.compile_cache import DEFAULT_CACHE_DIR, enable_compile_cache

    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = enable_compile_cache()
        assert path == str(DEFAULT_CACHE_DIR) == os.path.join(REPO, ".jax_cache")
        assert enable_compile_cache() == path  # not pid- or time-derived
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_analysis_imports_without_io_packages():
    """driver, regridder, ops and parallel (and the job runner) import with
    numpy, scipy and JAX alone: h5py, yaml and matplotlib are blocked."""
    code = (
        "import sys, importlib.util\n"
        "sys.modules.update(h5py=None, yaml=None, matplotlib=None)\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import oisat.driver, oisat.regridder, oisat.parallel\n"
        "import oisat.ops.oi, oisat.ops.oi_full, oisat.readers, oisat.report\n"
        f"spec = importlib.util.spec_from_file_location('job', {os.path.join(REPO, 'run', 'job.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('ok')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
