"""scipy.signal.spectrogram-style convenience wrapper over the STFT engine.

The reference exposes spectrograms only through its Livebook guide
(spectrogram.livemd); this functional form matches scipy's (f, t, Sxx)
contract so scipy.signal users can switch directly. Rides the fused
framed-DFT path (kernels/dft.py) via `stft`.
"""

import jax.numpy as jnp

from nx_signal_tpu.ops.windows import get_window
from nx_signal_tpu.spectral.stft import stft
from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT

__all__ = ["spectrogram"]


def spectrogram(x, sampling_rate, *, window="hann", window_length: int = 256,
                overlap_length: int = None, fft_length=None, mode: str = "psd",
                onesided: bool = True):
    """Compute a spectrogram: returns (frequencies, times, Sxx) with Sxx of
    shape (..., frequencies, frames) — scipy.signal.spectrogram layout.

    `window` is a get_window spec (periodic/DFT-even, as spectral analysis
    wants); `overlap_length` defaults to window_length//8 (scipy's default);
    `mode`: 'psd' (density: |z|^2 / (Fs * sum(w^2)), one-sided bins doubled
    except DC/Nyquist), 'magnitude' (|z|), or 'complex' (raw STFT).

    Examples:

    A 1 kHz tone sampled at 8 kHz peaks in the 1 kHz bin:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.spectral.spectrogram import spectrogram
    >>> x = jnp.sin(2 * jnp.pi * 1000.0 * jnp.arange(2048) / 8000.0)
    >>> f, t, S = spectrogram(x, 8000.0, window_length=256)
    >>> S.shape
    (129, 9)
    >>> float(np.asarray(f)[np.asarray(S).mean(axis=-1).argmax()])
    1000.0
    """
    if mode not in ("psd", "magnitude", "complex"):
        raise ValueError(
            f"mode must be one of 'psd', 'magnitude', 'complex', got: {mode}"
        )
    if overlap_length is None:
        overlap_length = window_length // 8
    w = get_window(window, window_length, periodic=True, dtype=DEFAULT_FLOAT)
    n_fft = fft_length if fft_length is not None else window_length
    z, times, freqs = stft(
        x, w,
        sampling_rate=sampling_rate,
        fft_length=n_fft,
        overlap_length=overlap_length,
        onesided=onesided,
    )
    if mode == "complex":
        out = z
    elif mode == "magnitude":
        out = jnp.abs(z)
    else:
        scale = 1.0 / (sampling_rate * jnp.sum(w.astype(DEFAULT_FLOAT) ** 2))
        out = (jnp.abs(z) ** 2) * scale
        if onesided:
            # fold the redundant conjugate half's power into the kept bins
            bins = out.shape[-1]
            doubling = jnp.ones((bins,), DEFAULT_FLOAT).at[1:].set(2.0)
            if n_fft % 2 == 0:
                doubling = doubling.at[-1].set(1.0)
            out = out * doubling
    return freqs, times, jnp.swapaxes(out, -1, -2)
