"""Device peaks, timing and compile-cache set-up for `bench.py`,
`chip_smoke.py` and the measurement scripts (SURVEY.md §5: the reference
has no tracing/profiling subsystem).

The peak table is keyed by `jax.Device.device_kind`. A device that is not
in it is an error, never a default: a roofline share computed against
another card's peaks is not a measurement of this one."""

import os
import time
from dataclasses import dataclass

import jax

__all__ = ["benchmark", "BenchResult", "DevicePeaks", "device_peaks",
           "device_hbm_bandwidth", "configure_compile_cache", "trace",
           "timed_median"]


@dataclass(frozen=True)
class DevicePeaks:
    """Published peak rates of one accelerator (dense, no sparsity): HBM
    bytes/s, tensor-core bf16 and TF32 FLOP/s, float32 FLOP/s outside the
    tensor cores, and where the figures come from. Not in the reference.

    Examples:

    >>> from nx_signal_tpu.utils.profiling import device_peaks
    >>> p = device_peaks("NVIDIA H100 80GB HBM3")
    >>> p.hbm_bytes_per_s, p.tf32_flops
    (3350000000000.0, 495000000000000.0)
    """

    hbm_bytes_per_s: float
    bf16_flops: float
    tf32_flops: float
    f32_flops: float
    source: str


_H100_SXM_SOURCE = ("NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, "
                    "dense rates at the 700 W power limit")

#: published peaks keyed by `jax.Device.device_kind`
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        hbm_bytes_per_s=3.35e12, bf16_flops=989e12, tf32_flops=495e12,
        f32_flops=67e12, source=_H100_SXM_SOURCE),
}


def device_peaks(device=None) -> DevicePeaks:
    """Peak table entry for a device, a `device_kind` string, or (default)
    the first JAX device. Raises ValueError for a kind the table does not
    hold. Not in the reference.

    Examples:

    >>> from nx_signal_tpu.utils.profiling import device_peaks
    >>> device_peaks("NVIDIA H100 80GB HBM3").bf16_flops
    989000000000000.0
    >>> device_peaks("some other card")
    Traceback (most recent call last):
        ...
    ValueError: no published peaks for device kind 'some other card'; add it to DEVICE_PEAKS with its source
    """
    if device is None:
        device = jax.devices()[0]
    kind = device if isinstance(device, str) else device.device_kind
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add it to "
            "DEVICE_PEAKS with its source") from None


def device_hbm_bandwidth(device=None) -> float:
    """Peak HBM bandwidth in bytes/s of a device or `device_kind` (default:
    the first device); raises for a kind the peak table does not hold. Not
    in the reference.

    Examples:

    >>> from nx_signal_tpu.utils.profiling import device_hbm_bandwidth
    >>> device_hbm_bandwidth("NVIDIA H100 80GB HBM3")
    3350000000000.0
    """
    return device_peaks(device).hbm_bytes_per_s


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def configure_compile_cache():
    """Point JAX's persistent compilation cache at `<checkout>/.jax_cache`
    (the checkout being the directory that holds this package) unless
    `JAX_COMPILATION_CACHE_DIR` is set, in which case JAX reads that
    variable itself and nothing is set here. Returns the directory it set,
    or None. Not in the reference.

    Examples:

    >>> import os, tempfile
    >>> from nx_signal_tpu.utils.profiling import configure_compile_cache
    >>> saved = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    >>> os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp()
    >>> configure_compile_cache() is None
    True
    >>> if saved is None:
    ...     del os.environ["JAX_COMPILATION_CACHE_DIR"]
    ... else:
    ...     os.environ["JAX_COMPILATION_CACHE_DIR"] = saved
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


@dataclass(frozen=True)
class BenchResult:
    """Result of `benchmark`: wall time per call plus the derived
    throughput / HBM-speed-of-light fraction (0 when the caller gave no
    samples/bytes model). Not in the reference (it has no profiling
    subsystem — SURVEY.md §5).

    Examples:

    >>> from nx_signal_tpu.utils.profiling import BenchResult
    >>> str(BenchResult(0.002, 5e8, 0.25))
    '2.000 ms/call, 500 Msamples/s, 25.0% of HBM SoL'
    """

    seconds_per_call: float
    samples_per_second: float  # 0 when samples_per_call not given
    hbm_fraction: float        # fraction of speed-of-light, 0 when unknown

    def __str__(self):
        parts = [f"{self.seconds_per_call * 1e3:.3f} ms/call"]
        if self.samples_per_second:
            parts.append(f"{self.samples_per_second / 1e6:.0f} Msamples/s")
        if self.hbm_fraction:
            parts.append(f"{self.hbm_fraction * 100:.1f}% of HBM SoL")
        return ", ".join(parts)


def benchmark(fn, *args, iters: int = 10, samples_per_call: int = 0,
              min_bytes_per_sample: float = 0.0) -> BenchResult:
    """Time a jitted callable: compile and warm up, then `iters` timed calls
    ending in one `jax.block_until_ready`. When `samples_per_call` and
    `min_bytes_per_sample` are given, also reports throughput as a fraction
    of the device's HBM speed-of-light bound (the device must be in the
    peak table). Not in the reference.

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.utils.profiling import benchmark
    >>> r = benchmark(lambda x: x * 2.0, jnp.ones(1024), iters=2,
    ...               samples_per_call=1024)
    >>> r.seconds_per_call > 0.0, r.samples_per_second > 0.0
    (True, True)
    """
    jf = jax.jit(fn)
    jax.block_until_ready(jf(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = jf(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    sps = samples_per_call / dt if samples_per_call else 0.0
    frac = 0.0
    if samples_per_call and min_bytes_per_sample:
        sol = device_hbm_bandwidth() / min_bytes_per_sample
        frac = sps / sol
    return BenchResult(dt, sps, frac)


def timed_median(fn, *args, reps: int = 5) -> float:
    """Median wall seconds of `reps` calls of `fn(*args)`, each ended by
    `jax.block_until_ready`, after one untimed warm-up call (which compiles
    a jitted `fn`). Not in the reference.

    Examples:

    >>> import jax
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.utils.profiling import timed_median
    >>> timed_median(jax.jit(lambda x: x * 2.0), jnp.ones(256), reps=3) > 0.0
    True
    """
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def trace(path: str):
    """Context manager writing a jax.profiler trace (view with XProf /
    Perfetto): `with trace('/tmp/trace'): step(x)`. Not in the reference.

    Examples:

    >>> import tempfile
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.utils.profiling import trace
    >>> with trace(tempfile.mkdtemp()):
    ...     _ = (jnp.ones(16) * 2.0).block_until_ready()
    """
    return jax.profiler.trace(path)
