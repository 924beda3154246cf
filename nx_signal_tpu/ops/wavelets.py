"""Wavelet generators and the continuous wavelet transform.

Not in the reference (nx_signal has no wavelet surface); the contract is
scipy.signal's legacy wavelet API (ricker/morlet/morlet2/qmf/cwt, removed
from scipy 1.15 but still the de-facto semantics, and still used
internally by scipy.signal.find_peaks_cwt — the oracle for these tests).

Design of `cwt`: scipy loops scales calling convolve per
width. Here the data is FFT'd ONCE at a shared power-of-two length
(utils/shapes.py fft_fast_length), the whole wavelet bank is transformed as one
batched FFT, and all scales multiply/inverse-transform together: one
(n_scales, L) elementwise pass over HBM instead of n_scales separate
convolutions. Per-scale 'same' alignment is restored by static slices
(kernel lengths are Python-level shape math, the deftransform idiom)."""

import math

import numpy as np

import jax.numpy as jnp

from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT
from nx_signal_tpu.utils.shapes import fft_fast_length

__all__ = ["ricker", "morlet", "morlet2", "qmf", "cwt"]

_CDTYPE = jnp.complex64 if DEFAULT_FLOAT == jnp.float32 else jnp.complex128


def _ricker_np(points, a):
    """f64 numpy ricker table (shared by the public op and the
    find_peaks_cwt default wavelet, which needs full precision)."""
    a = float(a)
    num = int(np.ceil(points))  # arange semantics: fractional points round up
    x = np.arange(num, dtype=np.float64) - (num - 1.0) / 2.0
    amp = 2.0 / (math.sqrt(3.0 * a) * (math.pi ** 0.25))
    xsq = (x / a) ** 2
    return amp * (1.0 - xsq) * np.exp(-xsq / 2.0)


def ricker(points: int, a, *, dtype=DEFAULT_FLOAT):
    """Ricker ("Mexican hat") wavelet: the negative normalized second
    derivative of a Gaussian, A (1 - (x/a)^2) e^{-x^2/(2a^2)} with
    A = 2 / (sqrt(3a) pi^{1/4}), sampled at x = arange(points) -
    (points-1)/2 — scipy.signal.ricker (legacy) semantics. Host-side f64
    table, cast to `dtype`.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.wavelets import ricker
    >>> np.round(np.asarray(ricker(5, 1.0)), 4)
    array([-0.3521,  0.    ,  0.8673,  0.    , -0.3521], dtype=float32)
    """
    return jnp.asarray(_ricker_np(points, a), dtype=dtype)


def morlet(points: int, w: float = 5.0, s: float = 1.0,
           complete: bool = True):
    """Legacy Morlet wavelet over x = linspace(-s*2*pi, s*2*pi, points):
    pi^{-1/4} e^{i w x} e^{-x^2/2}, with the zero-mean correction term
    e^{-w^2/2} subtracted when `complete` — scipy.signal.morlet (legacy)
    semantics. Complex output.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.wavelets import morlet
    >>> np.round(np.asarray(morlet(5, w=5.0, s=0.5)), 4)
    array([-0.0054-0.j    , -0.    -0.2187j,  0.7511+0.j    , -0.    +0.2187j,
           -0.0054+0.j    ], dtype=complex64)
    """
    x = np.linspace(-s * 2.0 * math.pi, s * 2.0 * math.pi, points)
    out = np.exp(1j * w * x)
    if complete:
        out = out - math.exp(-0.5 * w * w)
    out = out * np.exp(-0.5 * x * x) * (math.pi ** -0.25)
    return jnp.asarray(out, dtype=_CDTYPE)


def morlet2(points: int, s, w: float = 5.0):
    """Morlet wavelet in the cwt-compatible parameterization:
    sqrt(1/s) pi^{-1/4} e^{i w x} e^{-x^2/2} with x = (arange(points) -
    (points-1)/2) / s — scipy.signal.morlet2 (legacy) semantics. Its
    scale s relates to a signal frequency f as s = w * fs / (2 pi f).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.wavelets import morlet2
    >>> np.round(np.asarray(morlet2(4, 1.0)), 4)
    array([ 0.0845-0.2287j, -0.5311-0.3967j, -0.5311+0.3967j,  0.0845+0.2287j],
          dtype=complex64)
    """
    s = float(s)
    x = (np.arange(points, dtype=np.float64) - (points - 1.0) / 2.0) / s
    out = (math.pi ** -0.25) * math.sqrt(1.0 / s) \
        * np.exp(1j * w * x) * np.exp(-0.5 * x * x)
    return jnp.asarray(out, dtype=_CDTYPE)


def qmf(hk):
    """Quadrature mirror filter of a FIR filter: reverse the taps and
    negate every second one, g[n] = (-1)^n h[N-1-n] —
    scipy.signal.qmf (legacy) semantics.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.wavelets import qmf
    >>> np.asarray(qmf(jnp.asarray([1.0, 2.0, 3.0, 4.0])))
    array([ 4., -3.,  2., -1.], dtype=float32)
    """
    hk = jnp.atleast_1d(jnp.asarray(hk))
    if hk.ndim != 1:
        raise ValueError("qmf expects a rank-1 tap vector")
    signs = 1 - 2 * (jnp.arange(hk.shape[0]) % 2)
    return hk[::-1] * signs.astype(hk.dtype)


def _wavelet_bank(wavelet, widths, n, xp):
    """Per-scale kernels conj(wavelet(min(10*width, n), width))[::-1],
    built with array module `xp` (np for the f64 host path)."""
    kernels = []
    for width in widths:
        length = int(math.ceil(min(10 * float(width), float(n))))
        if length < 1:
            raise ValueError(f"width {width} yields an empty wavelet")
        kern = xp.conj(xp.asarray(wavelet(length, width))[::-1])
        kernels.append(kern)
    return kernels


def cwt(data, wavelet, widths, *, dtype=None):
    """Continuous wavelet transform: row i is the 'same'-mode convolution
    of `data` with conj(reversed wavelet(min(10*widths[i], N), widths[i]))
    — scipy.signal.cwt (legacy) semantics, default output dtype f32
    (c64 for complex wavelets).

    One shared-length FFT of the data + one batched FFT of the whole
    wavelet bank replaces scipy's per-scale convolution loop (see module
    docstring); per-scale 'same' windows are static slices.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.wavelets import cwt, ricker
    >>> sig = jnp.cos(2 * jnp.pi * 0.1 * jnp.arange(32))
    >>> m = cwt(sig, ricker, jnp.asarray([1.0, 2.0]))
    >>> m.shape
    (2, 32)
    >>> round(float(np.asarray(m)[0, 0]), 4)
    0.2346
    """
    data = jnp.atleast_1d(jnp.asarray(data))
    if data.ndim != 1:
        raise ValueError("cwt expects rank-1 data")
    n = data.shape[0]
    widths = np.atleast_1d(np.asarray(widths))
    kernels = _wavelet_bank(wavelet, widths, n, jnp)
    is_complex = any(jnp.iscomplexobj(k) for k in kernels) \
        or jnp.iscomplexobj(data)
    if dtype is None:
        dtype = _CDTYPE if is_complex else DEFAULT_FLOAT

    k_max = max(k.shape[0] for k in kernels)
    length = fft_fast_length(n + k_max - 1)
    bank = jnp.zeros((len(kernels), length), dtype=_CDTYPE)
    for i, k in enumerate(kernels):
        bank = bank.at[i, : k.shape[0]].set(k.astype(_CDTYPE))
    conv = jnp.fft.ifft(
        jnp.fft.fft(data.astype(_CDTYPE), n=length)[None, :]
        * jnp.fft.fft(bank, axis=-1),
        axis=-1,
    )
    rows = []
    for i, k in enumerate(kernels):
        start = (k.shape[0] - 1) // 2
        rows.append(conv[i, start : start + n])
    out = jnp.stack(rows, axis=0)
    return out.astype(dtype) if is_complex else jnp.real(out).astype(dtype)


def _cwt_f64(data, wavelet, widths):
    """f64 host-side cwt (numpy FFT) — find_peaks_cwt's ridge decisions
    (argmax/relextrema comparisons) must not flip on f32 rounding, the
    same reason the repo keeps all design math in f64 pockets."""
    data = np.atleast_1d(np.asarray(data, dtype=np.float64))
    n = data.shape[0]
    kernels = _wavelet_bank(wavelet, np.atleast_1d(widths), n, np)
    k_max = max(k.shape[0] for k in kernels)
    length = fft_fast_length(n + k_max - 1)
    data_f = np.fft.fft(data, n=length)
    out = np.empty((len(kernels), n), dtype=np.float64)
    for i, k in enumerate(kernels):
        full = np.fft.ifft(data_f * np.fft.fft(np.asarray(k, np.complex128),
                                               n=length))
        start = (k.shape[0] - 1) // 2
        out[i] = np.real(full[start : start + n])
    return out
