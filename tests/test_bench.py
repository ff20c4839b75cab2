"""Benchmark harness, timer, compile-cache helper and workload helpers.

SURVEY.md §4: the complexity-fit assertion (BVH log-log slope << brute
slope, results/main.py:68-87) as an automated check of the fit code; the
sweep itself runs end to end on the CPU at toy sizes (its numbers there are
not device numbers).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tracer.bench.harness import complexity_fit, run_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_complexity_fit_math():
    n = [1e3, 1e4, 1e5, 1e6]
    brute = [1e-3 * x / 1e3 for x in n]          # O(n)
    bvh = [1e-4 * np.log(x) for x in n]          # O(log n)
    fits = complexity_fit(n, brute, bvh)
    assert abs(fits["brute_loglog_slope"] - 1.0) < 1e-6
    assert fits["bvh_loglog_slope"] < 0.2


def test_run_sweep_smoke_cpu(tmp_path):
    # The harness runs end to end on CPU: the first size takes the dense
    # sweep, the second the hierarchical path with phase B in plain XLA.
    res = run_sweep(sizes=(256, 1024), num_rays=2048, world_size=60.0,
                    dense_limit=512, log=lambda *a: None)
    assert res.row_paths == ["dense", "leafcull_xla"]
    assert len(res.bvh_s) == 2 and all(v > 0 for v in res.bvh_s)
    j = res.to_json()
    assert "complexity" in j and len(j["speedup"]) == 2
    path = tmp_path / "benchmark_data.txt"
    res.save_data_txt(str(path))
    rows = path.read_text().split("\n")
    assert rows[0].split()[0] == "256" and len(rows[0].split()) == 3


# ------------------------------------------------------------- the timer

def test_time_calls_counts_warmup_and_samples():
    from tracer.bench.timing import time_calls
    calls = []

    def fn(x):
        calls.append(x)
        return x + 1

    timing, out = time_calls(fn, np.float32(1.0), n=5, warmup=2)
    assert len(calls) == 7 and out == 2.0
    assert timing.n == 5
    assert 0.0 <= timing.min_s <= timing.median_s <= timing.max_s
    assert timing.first_call_s >= 0.0
    j = timing.to_json()
    assert set(j) == {"median_ms", "min_ms", "max_ms", "n", "first_call_s"}


def test_time_calls_without_warmup_times_the_first_call():
    import time
    from tracer.bench.timing import time_calls

    def slow_once(state=[]):
        state.append(1)
        if len(state) == 1:
            time.sleep(0.05)
        return np.zeros(1)

    timing, _ = time_calls(slow_once, n=1, warmup=0)
    assert timing.median_s >= 0.05
    assert timing.first_call_s == timing.median_s


# ----------------------------------------------------- compile cache helper

@pytest.mark.parametrize("env", [None, "/some/where/cache"])
def test_enable_compile_cache(env, tmp_path):
    """Run in a fresh interpreter: the helper sets JAX configuration."""
    code = ("import jax; from tracer.compile_cache import "
            "enable_compile_cache, DEFAULT_DIR; d = enable_compile_cache(); "
            "print(d); print(jax.config.jax_compilation_cache_dir); "
            "print(DEFAULT_DIR)")
    e = {k: v for k, v in os.environ.items()
         if k != "JAX_COMPILATION_CACHE_DIR"}
    e["JAX_PLATFORMS"] = "cpu"
    e["PYTHONPATH"] = ROOT
    if env:
        e["JAX_COMPILATION_CACHE_DIR"] = env
    out = subprocess.run([sys.executable, "-c", code], env=e, cwd=tmp_path,
                         capture_output=True, text=True, check=True)
    used, config, default = out.stdout.split("\n")[:3]
    assert default == os.path.join(ROOT, ".jax_cache")
    if env:
        assert used == env and config == env      # JAX read the variable
    else:
        assert used == default and config == default


# ------------------------------------------------------- workload helpers

def test_origin_rays_are_unit_and_seeded():
    from tracer.bench.workload import origin_rays
    o, d = origin_rays(1000, seed=3)
    o2, d2 = origin_rays(1000, seed=3)
    assert (np.asarray(o) == 0).all()
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0,
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(d), np.asarray(d2))


def test_gpu_card_without_nvidia_smi(monkeypatch):
    from tracer.bench import workload

    def missing(*a, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(workload.subprocess, "run", missing)
    assert workload.gpu_card() == "not available"


def test_device_info_names_the_platform():
    from tracer.bench.workload import device_info
    info = device_info()
    assert info["platform"] == "cpu" and info["count"] == 8
    assert isinstance(info["kind"], str)


def test_bench_py_refuses_non_gpu_platform():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")],
                         env={**os.environ, "JAX_PLATFORMS": "cpu",
                              "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "GPU" in out.stderr
