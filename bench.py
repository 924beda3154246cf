"""Benchmark: STFT+FIR chain throughput on one GPU (the BASELINE.json
north-star metric).

Workload: 255-tap FIR low-pass, then a 512-point Hann STFT with hop 128,
then the one-sided power spectrogram, on 768 channels x 10 s at 48 kHz of
float32 — `stft_fir_chain` with `return_filtered=False` at its default
precision, as a user calls it.

Prints ONE JSON line: {"metric", "value" (Msamples/s), "unit",
"vs_baseline", "device", ...}. The reference publishes no performance
numbers (BASELINE.md), so vs_baseline is the fraction of the chain's speed
of light on this device: the larger of its arithmetic time at the rate
the chosen precision runs at and its memory time, against the published
peaks in utils/profiling.DEVICE_PEAKS. Exits non-zero without a GPU.

    python bench.py
"""

import functools
import json

import jax

import chip_smoke
from nx_signal_tpu.kernels.dft import good_matmul_fft_length
from nx_signal_tpu.models.pipeline import CHAIN_PRECISION, stft_fir_chain
from nx_signal_tpu.ops.convolution import _fir_block_size
from nx_signal_tpu.utils.profiling import (
    configure_compile_cache, device_peaks, timed_median)

FRAME, HOP, NFFT = chip_smoke.FRAME, chip_smoke.HOP, chip_smoke.NFFT
NUM_TAPS = chip_smoke.NUM_TAPS
BINS = NFFT // 2 + 1


def matmul_rate(peaks, precision):
    """FLOP/s a float32 dot or convolution runs at under `precision` on an
    H100: 'highest' keeps float32 on the CUDA cores; 'high' and 'default'
    run TF32 on the tensor cores (measured: PERF.md, bring-up findings)."""
    if precision == "highest":
        return peaks.f32_flops
    if precision in ("high", "default"):
        return peaks.tf32_flops
    raise ValueError(f"no rate model for precision {precision!r}")


def chain_speed_of_light(peaks, precision):
    """Samples/s the chain cannot exceed, and which bound sets it. Memory:
    read x (4 B) and write the one-sided power (BINS * 4 / HOP B) per
    sample. Arithmetic: the FIR-folded matmul DFT costs 2 * (FRAME +
    NUM_TAPS - 1) * 2 * BINS / HOP FLOP per sample where `method='auto'`
    prefers it; otherwise the Toeplitz-matmul FIR, 2 * (B + NUM_TAPS - 1)
    FLOP per sample for its output block B, dominates (the FFT's FLOPs are
    negligible beside it)."""
    bytes_per_sample = 4.0 + BINS * 4.0 / HOP
    if good_matmul_fft_length(NFFT):
        flops_per_sample = 2.0 * (FRAME + NUM_TAPS - 1) * 2 * BINS / HOP
    else:
        flops_per_sample = 2.0 * (_fir_block_size(NUM_TAPS) + NUM_TAPS - 1)
        precision = "highest"   # the FIR's matmul always runs at 'highest'
    compute = matmul_rate(peaks, precision) / flops_per_sample
    memory = peaks.hbm_bytes_per_s / bytes_per_sample
    return (compute, "compute") if compute < memory else (memory, "memory")


def main():
    device = chip_smoke.device_info()
    configure_compile_cache()
    peaks = device_peaks()
    taps, window = chip_smoke.chain_filters()
    x = chip_smoke.make_signal(chip_smoke.CHANNELS,
                               chip_smoke.SECONDS * chip_smoke.RATE, 0)
    step = jax.jit(functools.partial(
        stft_fir_chain, taps=taps, window=window, fft_length=NFFT,
        overlap_length=FRAME - HOP, sampling_rate=float(chip_smoke.RATE),
        return_filtered=False, frame_chunks="auto"))
    dt = timed_median(step, x, reps=5)
    samples_per_s = x.size / dt
    sol, bound = chain_speed_of_light(peaks, CHAIN_PRECISION)
    print(json.dumps({
        "metric": "stft_fir_chain_throughput",
        "value": samples_per_s / 1e6,
        "unit": "Msamples/s",
        "vs_baseline": samples_per_s / sol,
        "ms_per_step": dt * 1e3,
        "precision": CHAIN_PRECISION,
        "dft": "matmul" if good_matmul_fft_length(NFFT) else "fft",
        "speed_of_light_msamples_per_s": sol / 1e6,
        "bound": bound,
        "device": device,
    }))


if __name__ == "__main__":
    main()
