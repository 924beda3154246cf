"""utils/profiling.py: the device peak table and the compile-cache helper."""

import os

import jax
import pytest

from nx_signal_tpu.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_known_kind_gives_its_entry():
    p = profiling.device_peaks("NVIDIA H100 80GB HBM3")
    assert (p.hbm_bytes_per_s, p.bf16_flops, p.tf32_flops, p.f32_flops) == (
        3.35e12, 989e12, 495e12, 67e12)
    assert "data sheet" in p.source
    assert profiling.device_hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("device", ["some other card", None])
def test_unknown_kind_raises(device):
    # None: the first JAX device, which is the CPU here
    with pytest.raises(ValueError, match="no published peaks"):
        profiling.device_peaks(device)


def test_hbm_fraction_needs_a_known_device():
    with pytest.raises(ValueError, match="no published peaks"):
        profiling.benchmark(lambda x: x * 2.0, jax.numpy.ones(8), iters=1,
                            samples_per_call=8, min_bytes_per_sample=8.0)


@pytest.fixture
def config_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_env_set(monkeypatch, config_updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.configure_compile_cache() is None
    assert config_updates == []


def test_compile_cache_env_unset(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = profiling.configure_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert config_updates == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_timed_median_and_benchmark():
    f = jax.jit(lambda x: x * 2.0)
    assert profiling.timed_median(f, jax.numpy.ones(64), reps=3) > 0.0
    r = profiling.benchmark(f, jax.numpy.ones(64), iters=2,
                            samples_per_call=64)
    assert r.samples_per_second > 0.0 and r.hbm_fraction == 0.0
