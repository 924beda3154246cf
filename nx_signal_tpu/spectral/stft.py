"""Short-Time Fourier Transform pipeline: stft / istft / fft_frequencies.

Reference semantics: lib/nx_signal.ex `stft/3` (:68-130), `istft/3`
(:582-638), `fft_frequencies/2` (:154-166).

Design notes: framing is the gather-free slice/reshape decomposition
(see spectral/framing.py), the window multiply fuses into it, and the batched
FFT runs as one XLA FFT op over all frames. Extra leading batch axes
(channels) are supported everywhere — they become the data-parallel sharding
axis in nx_signal_tpu.parallel.
"""

from typing import NamedTuple

import jax.numpy as jnp

from nx_signal_tpu.kernels.dft import framed_dft, framed_idft, good_matmul_fft_length
from nx_signal_tpu.spectral.framing import _ola_fold, as_windowed, pad_for_windowing
from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT
from nx_signal_tpu.utils.shapes import next_power_of_two

__all__ = ["stft", "istft", "fft_frequencies", "STFTResult", "check_cola", "check_nola"]


class STFTResult(NamedTuple):
    """STFT output: complex spectrum [..., frames, frequencies], frame times
    in seconds, and FFT bin frequencies in Hz."""

    z: jnp.ndarray
    times: jnp.ndarray
    frequencies: jnp.ndarray


def fft_frequencies(sampling_rate, *, fft_length: int, dtype=DEFAULT_FLOAT,
                    endpoint: bool = False):
    """FFT bin frequencies in Hz: linspace(0, Fs, fft_length, endpoint=False)
    — full bin range, not the rfft half (reference: nx_signal.ex:154-166).

    Examples:

    >>> from nx_signal_tpu.spectral.stft import fft_frequencies
    >>> fft_frequencies(sampling_rate=10.0, fft_length=5)
    Array([0., 2., 4., 6., 8.], dtype=float32)
    """
    return jnp.linspace(0.0, sampling_rate, fft_length, endpoint=endpoint, dtype=dtype)


def _resolve_fft_length(frame_length: int, fft_length) -> int:
    if fft_length is None or fft_length == "power_of_two":
        return next_power_of_two(frame_length)
    return int(fft_length)


def _apply_scaling(z, window, scaling, sampling_rate, inverse: bool):
    """:spectrum divides by sum(w); :psd by sqrt(Fs * sum(w^2)) (reference:
    nx_signal.ex:114-127; istft multiplies back, :611-625)."""
    if scaling is None:
        return z
    window = window.astype(DEFAULT_FLOAT) if jnp.issubdtype(window.dtype, jnp.integer) else window
    if scaling == "spectrum":
        factor = jnp.sum(window)
    elif scaling == "psd":
        if sampling_rate is None:
            raise ValueError("sampling_rate is mandatory if scaling is 'psd'")
        factor = jnp.sqrt(sampling_rate * jnp.sum(window**2))
    else:
        raise ValueError(
            f"invalid scaling, expected one of 'spectrum', 'psd' or None, got: {scaling}"
        )
    return z * factor if inverse else z / factor


def stft(data, window, *, sampling_rate=100, fft_length="power_of_two",
         overlap_length=None, window_padding="valid", scaling=None,
         onesided=False, method="auto", precision="highest"):
    """Short-Time Fourier Transform.

    Frames the (..., L) signal with hop = frame_length - overlap_length,
    multiplies by `window`, and FFTs each frame (reference pipeline:
    nx_signal.ex:94-102). Returns `STFTResult(z, times, frequencies)` with
    z complex of shape (..., frames, fft_length); frame times are window
    midpoints time_step*(1..M) with time_step = frame_length/(2 Fs)
    (reference: nx_signal.ex:108-111).

    Options mirror the reference defaults (nx_signal.ex:71-83): sampling_rate
    100, fft_length 'power_of_two' (next power of two >= frame_length),
    overlap_length frame_length//2, window_padding 'valid',
    scaling in {None, 'spectrum', 'psd'}.

    `onesided=True` (an extension, not in the reference) computes
    the rfft half-spectrum (fft_length//2 + 1 bins) for real input — half
    the FFT work and output bandwidth; z[k] for k > N/2 is redundant
    (conj-symmetric) for real signals.

    `method`: 'auto' (default) uses the fused framing+window+DFT matmul
    (kernels/dft.py) for real input where `good_matmul_fft_length`
    prefers it — on the H100 at no length, XLA's FFT won at every length
    timed — and XLA's FFT otherwise; 'fft' / 'matmul' force a path.

    `precision` sets the matmul path's precision ('highest' = full f32;
    on the H100 'high' and 'default' run TF32, ~3e-4 of the spectrum's
    peak); ignored on the FFT path.

    Examples:

    A 100 Hz tone sampled at 400 Hz lands in bin 16 of a 64-point frame
    (bin spacing 400/64 = 6.25 Hz):

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import hann
    >>> from nx_signal_tpu.spectral.stft import stft
    >>> x = jnp.sin(2 * jnp.pi * 100.0 * jnp.arange(400) / 400.0)
    >>> z, times, freqs = stft(x, hann(64), sampling_rate=400.0, overlap_length=32)
    >>> z.shape
    (11, 64)
    >>> times[:3]
    Array([0.08      , 0.16      , 0.24000001], dtype=float32)
    >>> freqs[16]
    Array(100., dtype=float32)
    >>> int(np.argmax(np.abs(np.asarray(z)[0])))
    16
    """
    data = jnp.asarray(data)
    window = jnp.asarray(window)
    (frame_length,) = window.shape
    if overlap_length is None:
        overlap_length = frame_length // 2
    if sampling_rate is None:
        raise ValueError("missing sampling_rate option")
    n_fft = _resolve_fft_length(frame_length, fft_length)
    if not 0 <= overlap_length < frame_length:
        raise ValueError(
            "overlap_length must satisfy 0 <= overlap_length < frame_length "
            f"(got overlap {overlap_length} for frame {frame_length})"
        )
    stride = frame_length - overlap_length

    if method not in ("auto", "fft", "matmul"):
        raise ValueError(
            f"invalid method, expected one of 'auto', 'fft', 'matmul', got: {method}"
        )
    real_input = not jnp.issubdtype(data.dtype, jnp.complexfloating)
    use_matmul = method == "matmul" or (
        method == "auto"
        and real_input
        and good_matmul_fft_length(n_fft)
        and n_fft >= frame_length  # the DFT-matmul zero-pads; it cannot
        # truncate frames like fft(n=...) (that would time-alias)
    )
    if use_matmul and not real_input:
        raise ValueError("method='matmul' requires real input")
    if use_matmul and n_fft < frame_length:
        raise ValueError(
            "method='matmul' requires fft_length >= frame_length "
            f"(got {n_fft} < {frame_length}); use method='fft'"
        )

    if use_matmul:
        padded = pad_for_windowing(data, frame_length, window_padding)
        if padded.shape[-1] < frame_length:
            raise ValueError(
                f"window length {frame_length} exceeds padded signal length "
                f"{padded.shape[-1]}"
            )
        spectrum = framed_dft(
            padded, window, stride=stride, n_fft=n_fft, onesided=onesided,
            precision=precision,
        )
    else:
        frames = as_windowed(
            data, window_length=frame_length, stride=stride, padding=window_padding
        )
        if onesided:
            spectrum = jnp.fft.rfft(frames * window, n=n_fft, axis=-1)
        else:
            spectrum = jnp.fft.fft(frames * window, n=n_fft, axis=-1)
    num_frames = spectrum.shape[-2]

    frequencies = fft_frequencies(sampling_rate, fft_length=n_fft)
    if onesided:
        frequencies = frequencies[: n_fft // 2 + 1]
    time_step = frame_length / (2.0 * sampling_rate)
    times = jnp.linspace(time_step, time_step * num_frames, num_frames,
                         dtype=DEFAULT_FLOAT)
    spectrum = _apply_scaling(spectrum, window, scaling, sampling_rate, inverse=False)
    return STFTResult(spectrum, times, frequencies)


def istft(z, window, *, fft_length=None, overlap_length=None, scaling=None,
          sampling_rate=1000, onesided=False, method="auto", precision="highest"):
    """Inverse STFT: per-frame IFFT, inverse scaling, window multiply,
    deterministic overlap-add, and NOLA window-envelope normalization with a
    1e-10 guard (reference: nx_signal.ex:582-638).

    Returns the complex reconstruction (take `.real` for real signals, as the
    reference's doctests do via as_type). Perfect reconstruction holds in the
    overlapping interior for NOLA windows.

    Extensions (not in the reference): `onesided=True` accepts a
    half-spectrum (fft_length//2 + 1 bins, e.g. from
    `stft(..., onesided=True)`) and returns a REAL reconstruction; `method`
    picks the per-frame inverse — 'auto' uses the fused iDFT+window
    matmul (kernels/dft.py) where `good_matmul_fft_length` prefers it,
    XLA's IFFT otherwise; `precision` sets that matmul's precision (see
    `stft`).

    Examples:

    Round-trip reconstruction is exact (to f32) in the overlapping
    interior:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import hann
    >>> from nx_signal_tpu.spectral.stft import istft, stft
    >>> x = jnp.asarray(np.sin(np.arange(256) / 5.0), jnp.float32)
    >>> z, _, _ = stft(x, hann(32), overlap_length=16)
    >>> y = istft(z, hann(32), overlap_length=16)
    >>> bool(np.allclose(np.asarray(y)[16:-16], np.asarray(x)[16 : y.shape[-1] - 16], atol=1e-6))
    True
    """
    z = jnp.asarray(z)
    window = jnp.asarray(window)
    if onesided and fft_length is None:
        n_fft = 2 * (z.shape[-1] - 1)
    else:
        n_fft = _resolve_fft_length(z.shape[-1], fft_length)
    if overlap_length is None:
        overlap_length = window.shape[-1] // 2
    if method not in ("auto", "fft", "matmul"):
        raise ValueError(
            f"invalid method, expected one of 'auto', 'fft', 'matmul', got: {method}"
        )
    use_matmul = method == "matmul" or (
        method == "auto"
        and good_matmul_fft_length(n_fft)
        and window.shape[-1] == n_fft  # fft path broadcasts window over ifft frames
    )

    if use_matmul:
        # fused inverse-DFT + synthesis-window multiply as a matmul; scaling
        # is a scalar multiply and commutes with the linear transform
        windowed = framed_idft(z, window, n_fft=n_fft, onesided=onesided,
                               precision=precision)
        windowed = _apply_scaling(windowed, window, scaling, sampling_rate,
                                  inverse=True)
        frame_length = windowed.shape[-1]
    else:
        if onesided:
            frames = jnp.fft.irfft(z, n=n_fft, axis=-1)
        else:
            frames = jnp.fft.ifft(z, n=n_fft, axis=-1)
        frames = _apply_scaling(frames, window, scaling, sampling_rate, inverse=True)
        windowed = frames * window
        frame_length = frames.shape[-1]

    num_frames = windowed.shape[-2]
    if overlap_length >= frame_length:
        raise ValueError(
            f"overlap_length must be a number less than the window size {frame_length}, "
            f"got: {overlap_length}"
        )
    stride = frame_length - overlap_length
    out_length = num_frames * stride + overlap_length

    result = _ola_fold(windowed, stride, out_length)

    envelope_frames = jnp.broadcast_to(
        jnp.abs(window).astype(DEFAULT_FLOAT) ** 2, (num_frames, frame_length)
    )
    norm = _ola_fold(envelope_frames, stride, out_length)
    norm = jnp.where(norm > 1e-10, norm, jnp.ones((), dtype=norm.dtype))
    return result / norm


def check_cola(window, nperseg: int, noverlap: int, tol: float = 1e-10):
    """Whether the window/hop pair satisfies the Constant OverLap-Add
    constraint (perfect reconstruction for the unnormalized inverse) —
    scipy.signal.check_COLA semantics: the strided sums
    sum_j w[k + j*step] must be equal (within tol) for all k in one hop
    period. Host-side f64; `window` may be an array or a window name known
    to ops.windows.get_window. Not in the reference (its istft always
    NOLA-normalizes, nx_signal.ex:630-637).

    Examples:

    A Hann window at half overlap satisfies COLA:

    >>> from nx_signal_tpu.spectral.stft import check_cola
    >>> check_cola("hann", 8, 4)
    True
    """
    import numpy as np

    w = _check_window_arg(window, nperseg)
    if not 0 <= noverlap < nperseg:
        raise ValueError("noverlap must be less than nperseg.")
    step = nperseg - noverlap
    binsums = np.sum(
        [w[i * step : (i + 1) * step] for i in range(nperseg // step)], axis=0
    )
    if nperseg % step != 0:
        binsums[: nperseg % step] += w[-(nperseg % step):]
    deviation = binsums - np.median(binsums)
    return bool(np.max(np.abs(deviation)) < tol)


def check_nola(window, nperseg: int, noverlap: int, tol: float = 1e-10):
    """Whether the window/hop pair satisfies the NOnzero OverLap-Add
    constraint (invertibility of the normalized inverse STFT) —
    scipy.signal.check_NOLA semantics: min_k sum_j |w[k + j*step]|^2 > tol.
    This is exactly the 1e-10 guard `istft` applies per sample
    (reference: nx_signal.ex:635-637) evaluated as a predicate.

    Examples:

    >>> from nx_signal_tpu.spectral.stft import check_nola
    >>> check_nola("hann", 8, 4)
    True
    """
    import numpy as np

    w = _check_window_arg(window, nperseg)
    if not 0 <= noverlap < nperseg:
        raise ValueError("noverlap must be less than nperseg")
    if tol <= 0:
        raise ValueError("tol must be positive")
    step = nperseg - noverlap
    binsums = np.sum(
        [w[i * step : (i + 1) * step] ** 2 for i in range(nperseg // step)],
        axis=0,
    )
    if nperseg % step != 0:
        binsums[: nperseg % step] += w[-(nperseg % step):] ** 2
    return bool(np.min(binsums) > tol)


# scipy.signal spells these with upper-case acronyms; keep both names so
# `from nx_signal_tpu import check_COLA` works for scipy users.
check_COLA = check_cola
check_NOLA = check_nola


def _check_window_arg(window, nperseg: int):
    import numpy as np

    if isinstance(window, str) or (isinstance(window, tuple)):
        from nx_signal_tpu.ops.windows import get_window

        # scipy's check_COLA/check_NOLA resolve window names through
        # get_window's fftbins=True default — i.e. PERIODIC (DFT-even) —
        # in f64 (the 1e-10 default tol assumes it: a hann window's COLA
        # deviation is ~6e-8 in f32, which would wrongly fail). These are
        # host-side design predicates, so force x64 locally regardless of
        # the runtime flag.
        import jax

        with jax.enable_x64():
            w = np.asarray(get_window(window, nperseg, periodic=True,
                                      dtype=np.float64), dtype=np.float64)
    else:
        w = np.asarray(window, dtype=np.float64)
    if w.ndim != 1:
        raise ValueError("window must be 1-D")
    if w.shape[0] != nperseg:
        raise ValueError("window must have length of nperseg")
    return w
