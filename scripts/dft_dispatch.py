"""Measure, on the GPU, what decides the framed-DFT dispatch and the chain's
precision:

* the STFT+FIR chain as `stft_fir_chain` runs it with the matmul DFT (FIR
  folded into the DFT weights) at several precisions, against the plain
  chain (FIR, framing, `jnp.fft.rfft`, |.|^2) — error against the float32
  reference of chip_smoke.py and median time of 5 alternating runs;
* `stft` with method='matmul' against method='fft' over fft lengths;
* the 'auto' frame-chunking plan at 1024 channels.

Writes chiprun_out/dft_dispatch.json and prints one line per result.

    python scripts/dft_dispatch.py
"""

import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nx_signal_tpu.kernels import dft  # noqa: E402
from nx_signal_tpu.models.pipeline import (  # noqa: E402
    CHAIN_PRECISION, stft_fir_chain)
from nx_signal_tpu.ops.convolution import convolve, oaconvolve  # noqa: E402
from nx_signal_tpu.ops.windows import hann  # noqa: E402
from nx_signal_tpu.spectral import as_windowed, stft  # noqa: E402
from nx_signal_tpu.utils.profiling import configure_compile_cache  # noqa: E402

PRECISIONS = ["highest", "high", "default", "BF16_BF16_F32_X3",
              "BF16_BF16_F32_X6", "TF32_TF32_F32_X3"]
STFT_LENGTHS = [128, 256, 512, 1024, 2048]
REPS = 5


def alternate(fns, x, reps=REPS):
    """Median seconds of each callable, timed in turns `reps` times after
    one warm-up call each."""
    for f in fns.values():
        jax.block_until_ready(f(x))
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, f in fns.items():
            t0 = time.perf_counter()
            jax.block_until_ready(f(x))
            times[name].append(time.perf_counter() - t0)
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def plain_chain(fir):
    def step(x, taps, window):
        y = fir(x, taps[None, :], mode="same")
        frames = as_windowed(y, window_length=cs.FRAME, stride=cs.HOP)
        z = jnp.fft.rfft(frames * window, n=cs.NFFT, axis=-1)
        return jnp.real(z) ** 2 + jnp.imag(z) ** 2
    return step


def main():
    out = {"device": cs.device_info()}
    configure_compile_cache()
    taps, window = cs.chain_filters()
    x = cs.make_signal(cs.CHANNELS, cs.SECONDS * cs.RATE, 0)
    chain_kw = dict(taps=taps, window=window, fft_length=cs.NFFT,
                    overlap_length=cs.FRAME - cs.HOP,
                    sampling_rate=float(cs.RATE), return_filtered=False,
                    frame_chunks="auto")

    fns, errors, refused = {}, {}, {}
    for p in PRECISIONS:
        step = jax.jit(functools.partial(stft_fir_chain, precision=p,
                                         **chain_kw))
        try:
            compiled = step.lower(x).compile()
            power = compiled(x)
        except Exception as e:  # a preset the GPU compiler refuses
            refused[p] = f"{type(e).__name__}: {str(e)[:300]}"
            print(f"matmul chain [{p}]: refused: {refused[p]}", flush=True)
            continue
        fns[f"matmul[{p}]"] = compiled
        errors[f"matmul[{p}]"] = cs.compare_to_reference(
            {"p": (power, "power")}, x, taps, window, hop=cs.HOP,
            n_fft=cs.NFFT)["p"]
        del power
    for name, fir in [("plain[direct FIR]", convolve),
                      ("plain[oaconvolve FIR]", oaconvolve)]:
        step = jax.jit(functools.partial(plain_chain(fir), taps=taps,
                                         window=window))
        power = step(x)
        fns[name] = step
        errors[name] = cs.compare_to_reference(
            {"p": (power, "power")}, x, taps, window, hop=cs.HOP,
            n_fft=cs.NFFT)["p"]
        del power
    chain_times = alternate(fns, x)
    for name in fns:
        print(f"chain {name}: {chain_times[name] * 1e3:.3f} ms, "
              f"error {errors[name]:.3e}", flush=True)
    out["chain"] = {"ms": {k: v * 1e3 for k, v in chain_times.items()},
                    "error": errors, "refused": refused}

    stft_ms = {}
    for n in STFT_LENGTHS:
        w = hann(n)
        kw = dict(sampling_rate=float(cs.RATE), fft_length=n,
                  overlap_length=n - n // 4, onesided=True)
        pair = {m: jax.jit(lambda x, m=m: stft(x, w, method=m, **kw).z)
                for m in ("matmul", "fft")}
        t = alternate(pair, x)
        stft_ms[n] = {m: v * 1e3 for m, v in t.items()}
        print(f"stft n_fft={n} hop={n // 4}: matmul {stft_ms[n]['matmul']:.3f}"
              f" ms, fft {stft_ms[n]['fft']:.3f} ms", flush=True)
    out["stft_ms"] = stft_ms
    del x

    dev = jax.devices()[0]
    limit = dev.memory_stats()["bytes_limit"]
    x1024 = cs.make_signal(1024, cs.SECONDS * cs.RATE, 1)
    frames = (x1024.shape[-1] - cs.FRAME) // cs.HOP + 1
    chunks = dft._auto_frame_chunks(1024, frames, 2 * (cs.NFFT // 2 + 1),
                                    x1024.size)
    step = jax.jit(functools.partial(stft_fir_chain,
                                     precision=CHAIN_PRECISION, **chain_kw))
    compiled = step.lower(x1024).compile()
    power = compiled(x1024)
    finite = bool(jnp.all(jnp.isfinite(power)))
    peak = dev.memory_stats()["peak_bytes_in_use"]
    print(f"planner: bytes_limit {limit}, budget {dft._hbm_budget():.0f}, "
          f"1024 channels -> {chunks} chunk(s), finite {finite}, peak bytes "
          f"in use {peak}; {compiled.memory_analysis()}", flush=True)
    out["planner_1024"] = {"bytes_limit": limit, "chunks": chunks,
                           "finite": finite, "peak_bytes_in_use": peak}

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "dft_dispatch.json"),
              "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
