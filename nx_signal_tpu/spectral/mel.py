"""Mel filterbanks and log-mel spectrograms (Whisper-style).

Reference semantics: lib/nx_signal.ex `mel_filters/4` (:397-445) and
`stft_to_mel/3` (:486-513). The mel projection is a plain matmul over the
frequency axis — matmul work that XLA tiles directly.
"""

import math

import jax.numpy as jnp

from nx_signal_tpu.spectral.stft import fft_frequencies
from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT

__all__ = ["mel_filters", "stft_to_mel"]


def mel_filters(fft_length: int, mel_bins: int, sampling_rate, *,
                max_mel: float = 3016.0, mel_frequency_spacing: float = 200.0 / 3.0,
                dtype=DEFAULT_FLOAT):
    """Slaney/librosa-style mel filterbank matrix [mels, frequencies]:
    linear spacing below the 1 kHz breakpoint, log spacing (step log(6.4)/27)
    above, triangular weights with Slaney 2/(bandwidth) normalization
    (reference: nx_signal.ex:412-445).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.spectral.mel import mel_filters
    >>> fb = mel_filters(16, 3, 8000.0)
    >>> fb.shape
    (3, 16)
    >>> np.round(np.asarray(fb)[:, :6], 4)
    array([[0.    , 0.0008, 0.0009, 0.0002, 0.    , 0.    ],
           [0.    , 0.    , 0.0002, 0.0005, 0.0006, 0.0004],
           [0.    , 0.    , 0.    , 0.    , 0.    , 0.0001]], dtype=float32)
    """
    f_sp = mel_frequency_spacing
    fftfreqs = fft_frequencies(sampling_rate, fft_length=fft_length, dtype=dtype)

    mels = jnp.linspace(0.0, max_mel / f_sp, mel_bins + 2, dtype=dtype)
    freqs = f_sp * mels

    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0

    mel_f = jnp.where(
        mels >= min_log_mel,
        min_log_hz * jnp.exp(logstep * (mels - min_log_mel)),
        freqs,
    )

    fdiff = (mel_f[1:] - mel_f[:-1])[:, None]
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:mel_bins] / fdiff[:mel_bins]
    upper = ramps[2 : mel_bins + 2] / fdiff[1 : mel_bins + 1]
    weights = jnp.maximum(0.0, jnp.minimum(lower, upper))

    enorm = 2.0 / (mel_f[2 : mel_bins + 2] - mel_f[:mel_bins])
    return (weights * enorm[:, None]).astype(dtype)


def stft_to_mel(z, sampling_rate, *, fft_length: int, mel_bins: int = 128,
                max_mel: float = 3016.0, mel_frequency_spacing: float = 200.0 / 3.0,
                dtype=DEFAULT_FLOAT):
    """STFT spectrum -> log-mel spectrogram with Whisper's normalization:
    |z|^2 power on the first fft_length//2 bins, mel projection, log10 with
    1e-10 clip, dynamic-range floor max(log, max(log) - 8), then (x + 4)/4
    (reference: nx_signal.ex:486-513).

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.windows import hann
    >>> from nx_signal_tpu.spectral.mel import stft_to_mel
    >>> from nx_signal_tpu.spectral.stft import stft
    >>> x = jnp.asarray(np.sin(0.3 * np.arange(4000)), jnp.float32)
    >>> z, t, f = stft(x, hann(256), sampling_rate=8000.0, fft_length=256,
    ...                overlap_length=128, onesided=True)
    >>> m = stft_to_mel(z, 8000.0, fft_length=256, mel_bins=40)
    >>> m.shape, bool(jnp.all(jnp.isfinite(m)))
    ((30, 40), True)
    """
    magnitudes = jnp.abs(z).astype(dtype) ** 2

    filters = mel_filters(
        fft_length, mel_bins, sampling_rate,
        max_mel=max_mel, mel_frequency_spacing=mel_frequency_spacing, dtype=dtype,
    )

    freq_size = fft_length // 2
    mel_spec = jnp.matmul(magnitudes[..., :freq_size], filters[:, :freq_size].T,
                          precision="highest")

    log_spec = jnp.log10(jnp.clip(mel_spec, 1e-10, None))
    log_spec = jnp.maximum(log_spec, jnp.max(log_spec) - 8.0)
    return (log_spec + 4.0) / 4.0
