"""Run the docstring examples of every module that carries them — NOT
collected by pytest (tests/test_doctests.py spawns this in a subprocess
with the user-default JAX config: CPU, x64 OFF, so the printed dtypes are
exactly what a library user sees).

Prints 'DOCTESTS_OK <attempted>' on success; exits nonzero on any failure
or if a listed module has no examples (stale list guard).
"""

import doctest
import importlib
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# 8 virtual devices: the parallel/ examples build a (2, 4) DSP mesh
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

#: every module with >>> examples; the runner fails if one has none
DOCTEST_MODULES = [
    "nx_signal_tpu.ops.windows",
    "nx_signal_tpu.ops.convolution",
    "nx_signal_tpu.ops.filters",
    "nx_signal_tpu.ops.waveforms",
    "nx_signal_tpu.ops.peak_finding",
    "nx_signal_tpu.ops.find_peaks",
    "nx_signal_tpu.ops.lambert_w",
    "nx_signal_tpu.ops.iir",
    "nx_signal_tpu.ops.iir_design",
    "nx_signal_tpu.ops.fir_design",
    "nx_signal_tpu.ops.ltisys",
    "nx_signal_tpu.ops.resample",
    "nx_signal_tpu.ops.czt",
    "nx_signal_tpu.ops.transforms",
    "nx_signal_tpu.ops.mixing",
    "nx_signal_tpu.ops.splines",
    "nx_signal_tpu.ops.wavelets",
    "nx_signal_tpu.spectral.framing",
    "nx_signal_tpu.spectral.stft",
    "nx_signal_tpu.spectral.short_time_fft",
    "nx_signal_tpu.spectral.mel",
    "nx_signal_tpu.spectral.estimation",
    "nx_signal_tpu.spectral.spectrogram",
    "nx_signal_tpu.kernels.dft",
    "nx_signal_tpu.parallel.mesh",
    "nx_signal_tpu.parallel.sharded",
    "nx_signal_tpu.parallel.estimation",
    "nx_signal_tpu.parallel.multihost",
    "nx_signal_tpu.parallel.failure",
    "nx_signal_tpu.parallel.streaming",
    "nx_signal_tpu.models.pipeline",
    "nx_signal_tpu.io.wav",
    "nx_signal_tpu.io.raw",
    "nx_signal_tpu.io.checkpoint",
    "nx_signal_tpu.utils.checks",
    "nx_signal_tpu.utils.metrics",
    "nx_signal_tpu.utils.profiling",
]


def main():
    # --fast is accepted for compatibility but skips nothing: the round-5
    # gate executes 100% of examples in every tier
    total_attempted = total_failed = 0
    for name in DOCTEST_MODULES:
        module = importlib.import_module(name)
        res = doctest.testmod(
            module, optionflags=doctest.NORMALIZE_WHITESPACE, verbose=False
        )
        if res.attempted == 0:
            print(f"FAIL: {name} is listed but has no doctest examples")
            sys.exit(2)
        total_attempted += res.attempted
        total_failed += res.failed
    if total_failed:
        print(f"DOCTESTS_FAILED {total_failed}/{total_attempted}")
        sys.exit(1)
    print(f"DOCTESTS_OK {total_attempted}")


if __name__ == "__main__":
    main()
