"""Spectral estimation: periodogram / Welch PSD / cross-spectral density /
coherence.

The reference library stops at the raw STFT (lib/nx_signal.ex:68-130); these
averaged estimators are the standard scipy.signal layer users expect on top
of it (scipy.signal.periodogram/welch/csd/coherence semantics, including
segment detrending, density/spectrum scaling, and mean/median averaging).

Design notes: segmentation + window + DFT rides the fused framed-DFT
kernel (kernels/dft.py) via spectral.stft for real input; the per-segment
'constant' and 'linear' detrends are applied in the frequency domain by
linearity — the removed trend is a linear functional of the segment, so
F((s - trend) * w) = F(s * w) - coefs @ [F(w); F(tc * w)] — where the
per-segment (mean, slope) coefficients are one extra blocked mat-vec, so
the segment matrix is never materialized. Callable detrends take the
materialized time-domain path (scipy's callable contract).
"""

import numpy as np

import jax
import jax.numpy as jnp

from nx_signal_tpu.kernels.dft import blocked_frame_matmul
from nx_signal_tpu.ops.windows import get_window
from nx_signal_tpu.spectral.framing import as_windowed
from nx_signal_tpu.spectral.stft import stft
from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT

__all__ = ["periodogram", "welch", "csd", "coherence", "lombscargle",
           "vectorstrength"]


def lombscargle(x, y, freqs, *, precenter: bool = False,
                normalize: bool = False):
    """Lomb-Scargle periodogram of unevenly sampled data —
    scipy.signal.lombscargle semantics (classic Townsend recurrence-free
    form with the per-frequency time offset tau that makes the sinusoid
    basis orthogonal).

    Mapping: the (n_freqs, n_samples) phase matrix w x^T is built once
    and every sum is a row reduction / matvec — the whole periodogram is a
    handful of matmul-shaped products, not scipy's per-frequency loop. Not in
    the reference (no unevenly-sampled support there).

    Examples:

    A 2 rad/s sine shows its power at w = 2:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.spectral.estimation import lombscargle
    >>> t = jnp.asarray(np.linspace(0, 10, 50))
    >>> p = lombscargle(t, jnp.sin(2.0 * t), jnp.asarray([1.0, 2.0, 3.0]))
    >>> np.round(np.asarray(p), 4)
    array([ 0.4509, 12.243 ,  0.4375], dtype=float32)
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    freqs = jnp.asarray(freqs)
    if x.ndim != 1 or y.ndim != 1 or x.shape != y.shape:
        raise ValueError("x and y must be 1-D arrays of the same length")
    if freqs.ndim != 1:
        raise ValueError("freqs must be 1-D")
    dtype = jnp.result_type(x.dtype, y.dtype, freqs.dtype, DEFAULT_FLOAT)
    x, y, freqs = x.astype(dtype), y.astype(dtype), freqs.astype(dtype)
    if precenter:
        y = y - jnp.mean(y)

    phase = freqs[:, None] * x[None, :]  # (M, N)
    c2, s2 = jnp.cos(2.0 * phase), jnp.sin(2.0 * phase)
    # tan(2 w tau) = sum sin(2wx) / sum cos(2wx)
    tau = jnp.arctan2(jnp.sum(s2, axis=1), jnp.sum(c2, axis=1)) / (
        2.0 * freqs)
    arg = phase - (freqs * tau)[:, None]
    c, s = jnp.cos(arg), jnp.sin(arg)
    yc = c @ y
    ys = s @ y
    cc = jnp.sum(c * c, axis=1)
    ss = jnp.sum(s * s, axis=1)
    pgram = 0.5 * (yc * yc / cc + ys * ys / ss)
    if normalize:
        pgram = pgram * (2.0 / jnp.sum(y * y))
    return pgram


def vectorstrength(events, period):
    """Vector strength (and phase) of events relative to one or more
    periods — scipy.signal.vectorstrength semantics: each event is a unit
    phasor exp(i 2 pi t / T); strength is the mean phasor magnitude, phase
    its angle. Not in the reference.

    Examples:

    Three events evenly spread across the period partially cancel:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.spectral.estimation import vectorstrength
    >>> s, phase = vectorstrength(jnp.asarray([0.0, 0.5, 1.0]), 1.0)
    >>> round(float(s), 4), round(float(phase), 4)
    (0.3333, 0.0)
    """
    events = jnp.asarray(events)
    period = jnp.asarray(period)
    if events.ndim != 1:
        raise ValueError("events must be 1-D")
    scalar = period.ndim == 0
    period_v = jnp.atleast_1d(period)
    if period_v.ndim != 1:
        raise ValueError("period must be a scalar or 1-D")
    dtype = jnp.result_type(events.dtype, period_v.dtype, DEFAULT_FLOAT)
    ang = 2.0 * jnp.pi * events.astype(dtype)[None, :] / \
        period_v.astype(dtype)[:, None]
    vectors = jnp.mean(jnp.exp(1j * ang), axis=1)
    strength = jnp.abs(vectors)
    phase = jnp.angle(vectors)
    if scalar:
        return strength[0], phase[0]
    return strength, phase


def _median_bias(n: int) -> float:
    """Bias of the median of n exponentially-distributed periodogram
    estimates relative to the mean (scipy.signal._spectral_py._median_bias)."""
    ii_2 = 2.0 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1.0 + np.sum(1.0 / (ii_2 + 1.0) - 1.0 / ii_2))


def _resolve_window(window, segment_length):
    is_spec = isinstance(window, str) or (
        isinstance(window, (tuple, list))
        and len(window) > 0
        and isinstance(window[0], str)
    )
    if is_spec:
        # DFT-even window, matching scipy's get_window(..., sym=False) default
        w = get_window(window, segment_length, periodic=True,
                       dtype=DEFAULT_FLOAT)
    else:
        w = jnp.asarray(window)
        if w.ndim != 1:
            raise ValueError(f"window must be 1-D, got shape {w.shape}")
    return w


def _validate_detrend(detrend, *, allow_callable=True):
    if detrend in ("constant", "linear", False, None) or (
        allow_callable and callable(detrend)
    ):
        return
    expected = "'constant', 'linear', False, None" + (
        " or a callable" if allow_callable else ""
    )
    raise ValueError(f"invalid detrend, expected {expected}, got: {detrend}")


def _detrend_columns(frame_length, detrend):
    """(frame_length, k) host matrix whose product with a segment yields
    its detrend coefficients: k=1 (mean) for 'constant', k=2 (mean, slope
    on the centered ramp) for 'linear'. The ramp is centered so the two
    least-squares basis vectors are orthogonal — the fit decouples and
    there is no large-term cancellation in f32."""
    cols = [np.full((frame_length,), 1.0 / frame_length)]
    if detrend == "linear":
        tc = np.arange(frame_length) - (frame_length - 1) / 2.0
        cols.append(tc / np.sum(tc * tc))
    return np.stack(cols, axis=1)


def _detrend_basis_spectra(window, n_fft, one_sided_fft, detrend):
    """(k, bins) spectra of the windowed detrend basis functions: F(w) and,
    for 'linear', F(tc * w) — what frequency-domain detrending subtracts,
    scaled by the per-segment coefficients."""
    frame_length = window.shape[-1]
    if isinstance(window, jax.core.Tracer):
        # window built inside an enclosing jit: stage the (constant-folded)
        # spectra instead of computing them host-side
        basis = [window]
        if detrend == "linear":
            tc = jnp.arange(frame_length) - (frame_length - 1) / 2.0
            basis.append(tc * window)
        b = jnp.stack(basis)
        return jnp.fft.rfft(b, n_fft) if one_sided_fft else jnp.fft.fft(b, n_fft)
    w64 = np.asarray(window, np.float64)
    basis = [w64]
    if detrend == "linear":
        tc = np.arange(frame_length) - (frame_length - 1) / 2.0
        basis.append(tc * w64)
    b = np.stack(basis)
    wk = np.fft.rfft(b, n_fft) if one_sided_fft else np.fft.fft(b, n_fft)
    return jnp.asarray(wk.astype(np.complex64))


def _segment_spectra(x, window, *, stride, n_fft, onesided, detrend,
                     precision):
    """(..., segments, bins) complex spectra of detrended, windowed
    segments of the (..., L) signal."""
    x = jnp.asarray(x)
    frame_length = window.shape[-1]
    if x.shape[-1] < frame_length:
        raise ValueError(
            f"segment_length {frame_length} exceeds signal length {x.shape[-1]}"
        )
    _validate_detrend(detrend)
    real_input = not jnp.issubdtype(x.dtype, jnp.complexfloating)
    one_sided_fft = onesided and real_input

    if callable(detrend):
        # general time-domain path (scipy's callable contract: the
        # detrender sees the segmented array, segments along the last
        # axis); the fused no-materialize kernel can't apply here
        frames = as_windowed(x, window_length=frame_length, stride=stride)
        dw = detrend(frames) * window
        return jnp.fft.rfft(dw, n_fft) if one_sided_fft \
            else jnp.fft.fft(dw, n_fft)

    z, _, _ = stft(
        x, window, sampling_rate=1.0, fft_length=n_fft,
        overlap_length=frame_length - stride, window_padding="valid",
        onesided=one_sided_fft, precision=precision,
    )
    if detrend in ("constant", "linear"):
        # frequency-domain detrend by linearity: the removed trend
        # (mean, and for 'linear' the least-squares line) is a linear
        # functional of the segment, so F((s - trend) * w) =
        # F(s*w) - coefs @ [F(w); F(tc*w)] — the coefficients are one
        # extra blocked mat-vec and the segment matrix is never built
        num_frames = z.shape[-2]
        cols = _detrend_columns(frame_length, detrend)
        if real_input:
            coefs = blocked_frame_matmul(
                x.astype(DEFAULT_FLOAT), jnp.asarray(cols, DEFAULT_FLOAT),
                window_length=frame_length, stride=stride,
                num_frames=num_frames, precision=precision,
            )  # (..., segments, k)
        else:
            frames = as_windowed(x, window_length=frame_length, stride=stride)
            coefs = jnp.matmul(frames, jnp.asarray(cols, frames.real.dtype),
                               precision=precision)
        wk = _detrend_basis_spectra(window, n_fft, one_sided_fft, detrend)
        z = z - jnp.matmul(coefs, wk, precision=precision)
    return z


def _spectral_params(window, segment_length, overlap_length, fft_length,
                     scaling, average, sampling_rate):
    """Validate and resolve the shared Welch-family options; returns
    (window array, stride, n_fft, scalar power scale)."""
    w = _resolve_window(window, segment_length)
    segment_length = w.shape[-1]
    if overlap_length is None:
        overlap_length = segment_length // 2
    if not 0 <= overlap_length < segment_length:
        raise ValueError(
            f"overlap_length must be in [0, {segment_length}), got: {overlap_length}"
        )
    stride = segment_length - overlap_length
    n_fft = segment_length if fft_length is None else int(fft_length)
    if n_fft < segment_length:
        raise ValueError(
            f"fft_length ({n_fft}) must be >= segment_length ({segment_length})"
        )
    if scaling == "density":
        scale = 1.0 / (sampling_rate * jnp.sum(w.astype(DEFAULT_FLOAT) ** 2))
    elif scaling == "spectrum":
        scale = 1.0 / jnp.sum(w.astype(DEFAULT_FLOAT)) ** 2
    else:
        raise ValueError(
            f"invalid scaling, expected 'density' or 'spectrum', got: {scaling}"
        )
    if average not in ("mean", "median"):
        raise ValueError(
            f"invalid average, expected 'mean' or 'median', got: {average}"
        )
    return w, stride, n_fft, scale


def _finalize_csd(pxy, *, n_fft, onesided, average, sampling_rate):
    """Shared tail of the Welch family: one-sided conjugate-symmetry
    doubling, segment averaging (mean, or bias-corrected median), and the
    frequency vector. `pxy` is (..., segments, bins)."""
    if onesided:
        # every bin except DC (and Nyquist for even n_fft) carries the
        # energy of its mirrored negative frequency
        bins = n_fft // 2 + 1
        factor = np.full((bins,), 2.0, np.float32)
        factor[0] = 1.0
        if n_fft % 2 == 0:
            factor[-1] = 1.0
        pxy = pxy * jnp.asarray(factor)
        freqs = np.fft.rfftfreq(n_fft, 1.0 / sampling_rate)
    else:
        freqs = np.fft.fftfreq(n_fft, 1.0 / sampling_rate)

    n_seg = pxy.shape[-2]
    if average == "median" and n_seg > 1:
        bias = _median_bias(n_seg)
        if jnp.issubdtype(pxy.dtype, jnp.complexfloating):
            pxy = (jnp.median(jnp.real(pxy), axis=-2)
                   + 1j * jnp.median(jnp.imag(pxy), axis=-2)) / bias
        else:
            pxy = jnp.median(pxy, axis=-2) / bias
    else:
        pxy = jnp.mean(pxy, axis=-2)
    return jnp.asarray(freqs, DEFAULT_FLOAT), pxy


def csd(x, y, *, sampling_rate=1.0, window="hann", segment_length=256,
        overlap_length=None, fft_length=None, detrend="constant",
        onesided=True, scaling="density", average="mean",
        precision="highest"):
    """Cross power spectral density P_xy by Welch's method
    (scipy.signal.csd semantics): segment both signals, detrend, window,
    DFT, form conj(X)*Y per segment, and average.

    Returns (frequencies, P_xy) with P_xy complex of shape (..., bins);
    leading batch axes broadcast like every op in this framework. Two-sided
    output uses scipy's fftfreq bin ordering (negative frequencies in the
    upper half). `average` is 'mean' or 'median' (median is bias-corrected,
    robust to interference spikes). `scaling='density'` gives V**2/Hz
    (divide by Fs*sum(w**2)); 'spectrum' gives V**2 (divide by sum(w)**2).
    `detrend` is 'constant' (remove each segment's mean), 'linear' (remove
    its least-squares line), False/None, or a callable applied to the
    segmented array along the last axis.

    Examples:

    A tone's cross-spectral density with itself peaks at the tone:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.spectral.estimation import csd
    >>> x = jnp.sin(2 * jnp.pi * 0.25 * jnp.arange(512))
    >>> f, p = csd(x, x, segment_length=128)
    >>> float(np.asarray(f)[np.abs(np.asarray(p)).argmax()])
    0.25
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    w, stride, n_fft, scale = _spectral_params(
        window, segment_length, overlap_length, fft_length, scaling, average,
        sampling_rate,
    )
    complex_input = jnp.issubdtype(x.dtype, jnp.complexfloating) or \
        jnp.issubdtype(y.dtype, jnp.complexfloating)
    if onesided and complex_input:
        raise ValueError("onesided=True requires real input; "
                         "use onesided=False for complex signals")

    zx = _segment_spectra(x, w, stride=stride, n_fft=n_fft, onesided=onesided,
                          detrend=detrend, precision=precision)
    zy = zx if y is x else _segment_spectra(
        y, w, stride=stride, n_fft=n_fft, onesided=onesided, detrend=detrend,
        precision=precision)
    pxy = jnp.conj(zx) * zy * scale
    return _finalize_csd(pxy, n_fft=n_fft, onesided=onesided, average=average,
                         sampling_rate=sampling_rate)


def welch(x, *, sampling_rate=1.0, window="hann", segment_length=256,
          overlap_length=None, fft_length=None, detrend="constant",
          onesided=True, scaling="density", average="mean",
          precision="highest"):
    """Welch power spectral density estimate (scipy.signal.welch
    semantics): average of detrended, windowed periodograms over
    overlapping segments. Returns (frequencies, P_xx) with P_xx real.

    See `csd` for the option surface; welch is csd(x, x) with the
    imaginary part (identically zero) dropped.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.spectral.estimation import welch
    >>> t = jnp.arange(2048) / 1000.0
    >>> x = jnp.sin(2 * jnp.pi * 125.0 * t)
    >>> freqs, pxx = welch(x, sampling_rate=1000.0, segment_length=256)
    >>> float(freqs[int(np.argmax(np.asarray(pxx)))])
    125.0
    """
    x = jnp.asarray(x)
    freqs, pxx = csd(
        x, x, sampling_rate=sampling_rate, window=window,
        segment_length=segment_length, overlap_length=overlap_length,
        fft_length=fft_length, detrend=detrend, onesided=onesided,
        scaling=scaling, average=average, precision=precision,
    )
    return freqs, jnp.real(pxx)


def periodogram(x, *, sampling_rate=1.0, window="rectangular",
                fft_length=None, detrend="constant", onesided=True,
                scaling="density", precision="highest"):
    """Single-segment power spectral density (scipy.signal.periodogram
    semantics): the whole signal is one detrended, windowed segment.
    Returns (frequencies, P_xx).

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.spectral.estimation import periodogram
    >>> x = jnp.sin(2 * jnp.pi * 50.0 * jnp.arange(512) / 512.0)
    >>> freqs, pxx = periodogram(x, sampling_rate=512.0)
    >>> float(freqs[int(np.argmax(np.asarray(pxx)))])
    50.0
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    return welch(
        x, sampling_rate=sampling_rate, window=window, segment_length=n,
        overlap_length=0, fft_length=fft_length, detrend=detrend,
        onesided=onesided, scaling=scaling, average="mean",
        precision=precision,
    )


def coherence(x, y, *, sampling_rate=1.0, window="hann", segment_length=256,
              overlap_length=None, fft_length=None, detrend="constant",
              precision="highest"):
    """Magnitude-squared coherence C_xy = |P_xy|**2 / (P_xx * P_yy)
    (scipy.signal.coherence semantics). Returns (frequencies, C_xy) with
    C_xy real in [0, 1]; needs overlapping segments (>= 2) to be
    meaningful — with one segment it is identically 1.

    Examples:

    A signal is perfectly coherent with itself at every frequency:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.spectral.estimation import coherence
    >>> x = jnp.sin(2 * jnp.pi * 0.1 * jnp.arange(512))
    >>> f, c = coherence(x, x, segment_length=128)
    >>> float(np.asarray(c).min()), float(np.asarray(c).max())
    (1.0, 1.0)
    """
    common = dict(
        sampling_rate=sampling_rate, window=window,
        segment_length=segment_length, overlap_length=overlap_length,
        fft_length=fft_length, detrend=detrend, precision=precision,
    )
    freqs, pxx = welch(x, **common)
    _, pyy = welch(y, **common)
    _, pxy = csd(x, y, **common)
    return freqs, jnp.abs(pxy) ** 2 / (pxx * pyy)
