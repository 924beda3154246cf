"""Throughput for the non-chain BASELINE.json configs on one card:

  config 2 — STFT -> ISTFT round trip (60 s stereo 44.1 kHz)
  config 3 — polyphase resample 48 kHz -> 16 kHz + DDC mixdown, 64 ch
  config 4/5 — 64-channel polyphase filterbank analysis on a wideband
               stream

One JSON line per config, each the median of 5 timed calls. Usage, from
the root of a checkout:

    python scripts/configs_bench.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nx_signal_tpu.utils.profiling import (  # noqa: E402
    configure_compile_cache, timed_median as timed)


def emit(name, n_samples, dt, **extra):
    print(json.dumps({
        "metric": name,
        "ms_per_step": round(dt * 1e3, 2),
        "msamples_per_s": round(n_samples / dt / 1e6, 1),
        **extra,
    }), flush=True)


def main():
    from nx_signal_tpu.ops.windows import hann
    from nx_signal_tpu.spectral.stft import istft, stft
    from nx_signal_tpu.ops.resample import pfb_analyze, resample_poly
    from nx_signal_tpu.ops.mixing import mix_down

    configure_compile_cache()
    rng = np.random.default_rng(0)

    # config 2: 60 s stereo 44.1 kHz round trip (batched to fill the card)
    ch, n = 64, 60 * 44100
    x = jnp.asarray(rng.normal(size=(ch, n)), jnp.float32)
    w = np.asarray(hann(512))

    @jax.jit
    def roundtrip(x):
        z, _, _ = stft(x, w, sampling_rate=44100.0, fft_length=512,
                       overlap_length=384, onesided=True, precision="high")
        return istft(z, w, overlap_length=384, onesided=True,
                     precision="high")

    emit("stft_istft_roundtrip", ch * n, timed(roundtrip, x),
         channels=ch, seconds=60, rate=44100)
    del x

    # config 3: 48 kHz -> 16 kHz polyphase + DDC mixdown, 64 ch x 60 s
    n3 = 60 * 48000
    x3 = jnp.asarray(rng.normal(size=(64, n3)), jnp.float32)

    @jax.jit
    def resample_chain(x):
        y = mix_down(x, 8000.0, 48000.0)        # complex baseband shift
        return resample_poly(y.real, 1, 3)       # 48k -> 16k

    emit("resample_mixdown_64ch", 64 * n3, timed(resample_chain, x3),
         channels=64, up=1, down=3)
    del x3

    # config 4/5 single-card point: 64-band PFB on a wideband stream
    n4 = 4_194_304
    x4 = jnp.asarray(rng.normal(size=(8, n4)), jnp.float32)

    @jax.jit
    def pfb(x):
        return pfb_analyze(x, 64, taps_per_channel=8)

    emit("pfb_analyze_64band", 8 * n4, timed(pfb, x4),
         streams=8, bands=64)


if __name__ == "__main__":
    main()
