"""Filters and FIR filter design.

Reference semantics: lib/nx_signal/filters.ex — `median/2` (:17-55),
`wiener/2` (:81-110, :281-303), `firwin/3` (:147-279).

`firwin` is design-time math on tiny tensors (scipy.signal.firwin parity is
what matters; reference tests pin scipy values at atol 1e-5). `median` and
`wiener` are sliding-window ops; `wiener` runs as direct
correlation with a ones kernel.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

from nx_signal_tpu.ops.convolution import correlate, fir_convolve_1d
from nx_signal_tpu.ops.waveforms import sinc
from nx_signal_tpu.ops.windows import get_window
from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT

__all__ = ["median", "medfilt", "medfilt2d", "order_filter", "wiener",
           "firwin", "freqz", "sosfreqz", "freqz_sos", "group_delay",
           "gammatone", "max_len_seq", "detrend", "savgol_coeffs",
           "savgol_filter", "freqz_zpk", "freqs", "freqs_zpk"]


def median(t, *, kernel_shape):
    """N-D sliding median filter, float32 output.

    Window semantics follow the reference exactly (filters.ex:17-55): the
    window is ANCHORED at each element and extends forward, with the start
    clamped so the window fits (Nx.slice clamping) — windows near the
    trailing edge shift back. This differs from scipy.ndimage's centered
    median; it is the reference's pinned behavior (filters_test.exs:6-12).

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.filters import median
    >>> median(jnp.asarray([1.0, 9.0, 2.0, 8.0, 3.0]), kernel_shape=(3,))
    Array([2., 8., 3., 3., 3.], dtype=float32)
    """
    t = jnp.asarray(t)
    if isinstance(kernel_shape, int):
        kernel_shape = (kernel_shape,)
    if t.ndim != len(kernel_shape):
        raise ValueError("kernel shape must be of the same rank as the tensor")
    rank = t.ndim
    win = t
    for d in range(rank):
        dim, k = t.shape[d], kernel_shape[d]
        starts = jnp.clip(jnp.arange(dim), 0, dim - k)
        idx = starts[:, None] + jnp.arange(k)[None, :]
        win = jnp.take(win, idx, axis=d)  # axis d -> (dim, k); k lands at d+1
        win = jnp.moveaxis(win, d + 1, -1)
    return jnp.median(
        win.astype(DEFAULT_FLOAT), axis=tuple(range(rank, 2 * rank))
    ).astype(DEFAULT_FLOAT)


def wiener(t, *, kernel_size=3, noise=None):
    """N-D adaptive Wiener filter, scipy.signal.wiener semantics (reference:
    filters.ex:81-110, :281-303): local mean/variance from correlation with a
    ones kernel in 'same' mode; noise defaults to the mean local variance;
    output select(l_var < noise, l_mean, l_mean + (t - l_mean)(1 - noise/l_var)).

    Accumulates in float64 when x64 is enabled (the reference computes in f64,
    filters.ex:107-109); without x64 it runs in float32 — document'd
    precision difference, wiener is not in the hot chain.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import wiener
    >>> out = wiener(jnp.asarray([1.0, 2.0, 8.0, 2.0, 1.0]), kernel_size=3)
    >>> np.round(np.asarray(out), 4)
    array([1.    , 2.9922, 5.1556, 2.9922, 1.    ], dtype=float32)
    """
    t = jnp.asarray(t)
    rank = t.ndim
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,) * rank
    if len(kernel_size) != rank:
        raise ValueError("kernel_size must be an integer or a tuple matching the tensor rank")
    acc_dtype = jnp.float64 if jax.config.jax_enable_x64 else DEFAULT_FLOAT
    size = math.prod(kernel_size)
    kernel = jnp.ones(kernel_size, dtype=acc_dtype)

    x = t.astype(acc_dtype)
    l_mean = correlate(x, kernel, mode="same") / size
    l_var = correlate(x**2, kernel, mode="same") / size - l_mean**2

    noise_t = jnp.mean(l_var) if noise is None else jnp.asarray(noise, dtype=acc_dtype)

    res = (x - l_mean) * (1.0 - noise_t / l_var)
    out = jnp.where(l_var < noise_t, l_mean, res + l_mean)
    return out.astype(t.dtype)


def firwin(num_taps: int, cutoff, *, window="hamming", pass_zero: bool = True,
           scale: bool = True, sampling_rate: float = 2.0, dtype=DEFAULT_FLOAT):
    """FIR filter design by the window method (scipy.signal.firwin semantics;
    reference: filters.ex:147-279).

    Linear-phase: Type I for odd `num_taps`, Type II for even — Type II has a
    forced zero at Nyquist, so filters with gain there require odd taps.
    Cutoffs are in the units of `sampling_rate` (default 2.0 => already
    normalized to [0, 1] with 1 = Nyquist), strictly inside (0, Nyquist).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import firwin
    >>> np.round(np.asarray(firwin(5, [0.5])), 4)
    array([-0.    ,  0.2037,  0.5926,  0.2037, -0.    ], dtype=float32)
    """
    if isinstance(cutoff, (int, float)):
        cutoff = [cutoff]
    cutoff = list(cutoff)
    if not cutoff:
        raise ValueError(f"cutoff must be a non-empty list of frequencies, got: {cutoff}")
    nyq = sampling_rate / 2.0
    cutoffs = sorted(c / nyq for c in cutoff)

    if cutoffs[0] <= 0.0:
        raise ValueError(
            "cutoff must be strictly between 0 and Nyquist (exclusive), got: "
            f"{cutoffs[0] * nyq}"
        )
    if cutoffs[-1] >= 1.0:
        raise ValueError(
            "cutoff must be strictly between 0 and Nyquist (exclusive), got: "
            f"{cutoffs[-1] * nyq}"
        )

    even_n_cuts = len(cutoffs) % 2 == 0
    nyquist_gain = (pass_zero and even_n_cuts) or (not pass_zero and not even_n_cuts)
    if nyquist_gain and num_taps % 2 == 0:
        raise ValueError(
            "a filter with non-zero gain at Nyquist (e.g. highpass) requires "
            f"an odd number of taps, got: {num_taps}"
        )

    m = (num_taps - 1) / 2.0
    alpha = jnp.arange(num_taps, dtype=dtype) - m

    # Ideal response: sum over selected passband pairs from [0 | cutoffs | 1]
    # of b*sinc(b*alpha) - a*sinc(a*alpha) (reference: filters.ex:195-227).
    bands = [0.0] + cutoffs + [1.0]
    pairs = list(zip(bands[:-1], bands[1:]))
    selected = [p for i, p in enumerate(pairs) if (i % 2 == 0) == pass_zero]

    h = jnp.zeros((num_taps,), dtype=dtype)
    for a, b in selected:
        h = h + b * sinc(b * alpha) - a * sinc(a * alpha)

    w = get_window(window, num_taps, periodic=False, dtype=dtype)
    h = h * w

    if scale:
        # Normalize the response to exactly 1 at DC (pass_zero), Nyquist
        # (single-cutoff highpass), or the first passband center (reference:
        # filters.ex:229-252).
        if pass_zero:
            scale_freq = 0.0
        elif len(cutoffs) == 1:
            scale_freq = 1.0
        else:
            scale_freq = (cutoffs[0] + cutoffs[1]) / 2.0
        factor = jnp.abs(jnp.dot(h, jnp.cos(alpha * (math.pi * scale_freq)),
                                 precision="highest"))
        h = h / factor
    return h


_PASS_ZERO_STRINGS = {"lowpass": True, "bandstop": True,
                      "highpass": False, "bandpass": False}


def firwin_2d(hsize, window, *, fc=None, sampling_rate: float = 2.0,
              circular: bool = False, pass_zero=True, scale: bool = True,
              dtype=DEFAULT_FLOAT):
    """2-D FIR filter design by the window method — scipy.signal.firwin_2d
    semantics (Not in the reference). Separable mode (`circular=False`)
    designs two 1-D `firwin` filters (`window` is a 2-list of window specs)
    and returns their outer product; `circular=True` designs one 8x
    oversampled 1-D prototype and samples it radially over the normalized
    frequency grid, giving an approximately circularly symmetric filter.

    Deviation from scipy 1.17: `pass_zero`/`scale` ARE forwarded to the 1-D
    designs as documented (scipy's docstring promises this but its
    implementation currently drops both; with the defaults the outputs
    match scipy exactly).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import firwin_2d
    >>> h = firwin_2d((3, 3), ("hamming", "hamming"), fc=0.5)
    >>> np.round(np.asarray(h), 4)
    array([[0.0021, 0.0419, 0.0021],
           [0.0419, 0.8237, 0.0419],
           [0.0021, 0.0419, 0.0021]], dtype=float32)
    """
    if len(hsize) != 2:
        raise ValueError("hsize must be a 2-element tuple or list")
    if isinstance(pass_zero, str):
        try:
            pass_zero = _PASS_ZERO_STRINGS[pass_zero]
        except KeyError:
            raise ValueError(
                f"pass_zero must be a bool or one of "
                f"{sorted(_PASS_ZERO_STRINGS)}, got: {pass_zero!r}") from None
    if circular:
        if fc is None:
            raise ValueError("cutoff frequency `fc` must be provided when "
                             "`circular` is True")
        n_r = max(hsize[0], hsize[1]) * 8  # oversampled radial prototype
        win_r = firwin(n_r, fc, window=window, pass_zero=pass_zero,
                       scale=scale, sampling_rate=sampling_rate, dtype=dtype)
        f1 = jnp.linspace(-1.0, 1.0, hsize[0], dtype=dtype)
        f2 = jnp.linspace(-1.0, 1.0, hsize[1], dtype=dtype)
        r = jnp.sqrt(f1[None, :] ** 2 + f2[:, None] ** 2)
        return jnp.interp(r, jnp.linspace(0.0, 1.0, n_r, dtype=dtype), win_r)
    if len(window) != 2 or isinstance(window, str):
        raise ValueError("window must be a 2-element tuple or list of "
                         "window specs (or a single spec with circular=True)")
    row = firwin(hsize[0], fc, window=window[0], pass_zero=pass_zero,
                 scale=scale, sampling_rate=sampling_rate, dtype=dtype)
    col = firwin(hsize[1], fc, window=window[1], pass_zero=pass_zero,
                 scale=scale, sampling_rate=sampling_rate, dtype=dtype)
    return jnp.outer(row, col)


def _analysis_float():
    """f64 when x64 is on (design-time analysis wants full precision —
    responses span 100+ dB), DEFAULT_FLOAT otherwise (the device runtime)."""
    return jnp.float64 if jax.config.jax_enable_x64 else DEFAULT_FLOAT


def _freq_grid(n_freqs, sampling_rate, whole):
    span = sampling_rate if whole else sampling_rate / 2.0
    freqs = jnp.linspace(0.0, span, n_freqs, endpoint=False,
                         dtype=_analysis_float())
    return freqs, 2.0 * math.pi * freqs / sampling_rate


def _polyval_exp(coefs, w):
    """sum_n c[n] e^{-iwn} as one matmul: (n_freqs, n_taps) basis."""
    coefs = jnp.asarray(coefs)
    n = jnp.arange(coefs.shape[-1], dtype=w.dtype)
    basis = jnp.exp(-1j * w[:, None].astype(w.dtype) * n[None, :])
    return basis @ coefs.astype(basis.dtype)


def freqz(taps, a=None, *, n_freqs: int = 512, sampling_rate: float = 2.0,
          whole: bool = False):
    """Frequency response H(w) = B(e^{iw}) / A(e^{iw}) evaluated at
    `n_freqs` points over [0, Nyquist) (or [0, Fs) with `whole=True`).
    Returns (frequencies_hz, complex_response) — scipy.signal.freqz
    semantics; `a=None` is the FIR case. Not in the reference; provided
    for filter-design verification (used with firwin and the IIR designs).
    Evaluation is a basis matmul rather than per-point Horner.

    Examples:

    The 2-tap moving average: |H| falls from 1 at DC toward the Nyquist
    null (frequencies in units of ``sampling_rate=2.0``, i.e. Nyquist=1):

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import freqz
    >>> w, h = freqz(jnp.asarray([0.5, 0.5]), n_freqs=4)
    >>> np.round(np.asarray(w), 4)
    array([0.  , 0.25, 0.5 , 0.75], dtype=float32)
    >>> np.round(np.abs(np.asarray(h)), 4)
    array([1.    , 0.9239, 0.7071, 0.3827], dtype=float32)
    """
    freqs, w = _freq_grid(n_freqs, sampling_rate, whole)
    resp = _polyval_exp(jnp.asarray(taps), w)
    if a is not None:
        resp = resp / _polyval_exp(jnp.asarray(a), w)
    return freqs, resp


def sosfreqz(sos, *, n_freqs: int = 512, sampling_rate: float = 2.0,
             whole: bool = False):
    """Frequency response of cascaded second-order sections —
    scipy.signal.sosfreqz semantics. Returns (frequencies_hz, response).
    Not in the reference (no IIR there).

    Examples:

    One FIR section holding the 2-tap moving average:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import sosfreqz
    >>> sos = jnp.asarray([[0.5, 0.5, 0.0, 1.0, 0.0, 0.0]])
    >>> w, h = sosfreqz(sos, n_freqs=4)
    >>> np.round(np.abs(np.asarray(h)), 4)
    array([1.    , 0.9239, 0.7071, 0.3827], dtype=float32)
    """
    sos = jnp.asarray(sos)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos array must be shape (n_sections, 6)")
    freqs, w = _freq_grid(n_freqs, sampling_rate, whole)
    resp = jnp.ones(w.shape, dtype=jnp.complex64 if DEFAULT_FLOAT == jnp.float32
                    else jnp.complex128)
    for s in range(sos.shape[0]):
        resp = resp * (_polyval_exp(sos[s, :3], w) / _polyval_exp(sos[s, 3:], w))
    return freqs, resp


def freqz_sos(sos, *, n_freqs: int = 512, sampling_rate: float = 2.0,
              whole: bool = False):
    """Alias of `sosfreqz` under scipy >= 1.15's preferred name. Not in
    the reference (no IIR there).

    Examples:

    >>> from nx_signal_tpu.ops.filters import freqz_sos
    >>> from nx_signal_tpu.ops.iir_design import butter
    >>> w, h = freqz_sos(butter(4, 0.3, output='sos'), n_freqs=8)
    >>> w.shape, round(float(abs(h[0])), 4)   # unity DC gain
    ((8,), 1.0)
    """
    return sosfreqz(sos, n_freqs=n_freqs, sampling_rate=sampling_rate,
                    whole=whole)


def freqz_zpk(z, p, k, *, n_freqs: int = 512, sampling_rate: float = 2.0,
              whole: bool = False):
    """Frequency response of a digital filter in zpk form, evaluated as a
    product over roots H(w) = k * prod(e^{iw} - z_i) / prod(e^{iw} - p_i)
    — scipy.signal.freqz_zpk semantics (root-product evaluation keeps
    accuracy for high-order filters where the expanded polynomial of freqz
    loses digits). Returns (frequencies_hz, complex_response). Not in the
    reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import freqz_zpk
    >>> w, h = freqz_zpk([1.0], [0.5], 1.0, n_freqs=3)
    >>> np.round(np.abs(np.asarray(h)), 4)
    array([0.    , 1.1547, 1.3093], dtype=float32)
    """
    freqs, w = _freq_grid(n_freqs, sampling_rate, whole)
    zm = jnp.exp(1j * w)
    z = jnp.atleast_1d(jnp.asarray(z, dtype=zm.dtype))
    p = jnp.atleast_1d(jnp.asarray(p, dtype=zm.dtype))
    num = jnp.prod(zm[:, None] - z[None, :], axis=-1) if z.size else 1.0
    den = jnp.prod(zm[:, None] - p[None, :], axis=-1) if p.size else 1.0
    return freqs, k * num / den


def _freqs_grid(worN, num_like, den_like, kind):
    """Angular-frequency grid for the analog responses: int worN -> the
    findfreqs log-spaced auto range, array worN -> used directly."""
    if np.ndim(worN) == 0 and isinstance(worN, (int, np.integer)):
        from nx_signal_tpu.ops.ltisys import findfreqs
        return jnp.asarray(findfreqs(num_like, den_like, int(worN), kind=kind))
    return jnp.atleast_1d(jnp.asarray(worN))


def freqs(b, a, worN: int = 200):
    """Analog filter frequency response H(jw) = B(jw)/A(jw) —
    scipy.signal.freqs semantics: `worN` is either a point count (grid
    chosen by findfreqs over the system's interesting range) or an
    explicit array of angular frequencies. Returns (w, h). Not in the
    reference. Polynomials are evaluated as one (n_freqs, n_coefs) basis
    matmul like freqz above.

    Examples:

    The RC lowpass H(s) = 1 / (s + 1) at w = 0.5, 1, 2 rad/s:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import freqs
    >>> w, h = freqs(jnp.asarray([1.0]), jnp.asarray([1.0, 1.0]),
    ...              worN=jnp.asarray([0.5, 1.0, 2.0]))
    >>> np.round(np.abs(np.asarray(h)), 4)
    array([0.8944, 0.7071, 0.4472], dtype=float32)
    """
    w = _freqs_grid(worN, b, a, "ba")
    s = 1j * w.astype(_analysis_float())
    return w, jnp.polyval(jnp.asarray(b).astype(s.dtype), s) / \
        jnp.polyval(jnp.asarray(a).astype(s.dtype), s)


def freqs_zpk(z, p, k, worN: int = 200):
    """Analog zpk frequency response H(jw) = k * prod(jw - z)/prod(jw - p)
    — scipy.signal.freqs_zpk semantics (root-product form). Returns
    (w, h). Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import freqs_zpk
    >>> w, h = freqs_zpk([], [-1.0], 1.0, np.asarray([0.5, 1.0, 2.0]))
    >>> np.round(np.abs(np.asarray(h)), 4)
    array([0.8944, 0.7071, 0.4472], dtype=float32)
    """
    w = _freqs_grid(worN, z, p, "zp")
    s = (1j * w.astype(_analysis_float())).astype(
        jnp.complex128 if _analysis_float() == jnp.float64 else jnp.complex64)
    z = jnp.atleast_1d(jnp.asarray(z, dtype=s.dtype))
    p = jnp.atleast_1d(jnp.asarray(p, dtype=s.dtype))
    num = jnp.prod(s[:, None] - z[None, :], axis=-1) if z.size else 1.0
    den = jnp.prod(s[:, None] - p[None, :], axis=-1) if p.size else 1.0
    return w, k * num / den


def group_delay(b, a=None, *, n_freqs: int = 512, sampling_rate: float = 2.0,
                whole: bool = False):
    """Group delay -dphase/dw of a digital filter in samples —
    scipy.signal.group_delay semantics via the c = b * reverse(a)
    cepstral-derivative identity: tau(w) = Re(C'(w)/C(w)) - (len(a)-1),
    with C' the ramp-weighted polynomial. Returns (frequencies_hz, delay).
    Not in the reference.

    Examples:

    A linear-phase 2-tap FIR delays every frequency by half a sample:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import group_delay
    >>> w, gd = group_delay(jnp.asarray([0.5, 0.5]), n_freqs=4)
    >>> np.round(np.asarray(gd), 4)
    array([0.5, 0.5, 0.5, 0.5], dtype=float32)
    """
    b = jnp.atleast_1d(jnp.asarray(b))
    a = jnp.atleast_1d(jnp.asarray(a)) if a is not None else jnp.ones((1,), b.dtype)
    freqs, w = _freq_grid(n_freqs, sampling_rate, whole)
    c = jnp.convolve(b, a[::-1].conj())
    cr = c * jnp.arange(c.shape[0], dtype=w.dtype)
    num = _polyval_exp(cr, w)
    den = _polyval_exp(c, w)
    tau = jnp.real(num / den) - (a.shape[0] - 1)
    # scipy's singularity guard: zero the delay where the response vanishes
    tau = jnp.where(jnp.abs(den) == 0.0, jnp.zeros((), tau.dtype), tau)
    return freqs, tau


def _savgol_coeffs_np(window_length, polyorder, deriv, delta, pos, use):
    """f64 host math behind savgol_coeffs (design-time)."""
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        pos = halflen - 0.5 if rem == 0 else halflen
    if not 0 <= pos < window_length:
        raise ValueError("pos must be nonnegative and less than window_length")
    if use not in ("conv", "dot"):
        raise ValueError("use must be 'conv' or 'dot'")
    if deriv > polyorder:
        return np.zeros(window_length)
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    if use == "conv":
        x = x[::-1]
    order = np.arange(polyorder + 1)[:, None]
    a = x[None, :] ** order
    y = np.zeros(polyorder + 1)
    y[deriv] = math.factorial(deriv) / (delta**deriv)
    return np.linalg.lstsq(a, y, rcond=None)[0]


def savgol_coeffs(window_length: int, polyorder: int, *, deriv: int = 0,
                  delta: float = 1.0, pos=None, use: str = "conv",
                  dtype=DEFAULT_FLOAT):
    """Savitzky-Golay FIR coefficients — scipy.signal.savgol_coeffs
    semantics: the least-squares polynomial-fit weights for the `deriv`-th
    derivative at position `pos` of a length-`window_length` window, in
    'conv' (reversed, for convolution) or 'dot' orientation. f64 host
    design math. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import savgol_coeffs
    >>> np.round(np.asarray(savgol_coeffs(5, 2)), 4)
    array([-0.0857,  0.3429,  0.4857,  0.3429, -0.0857], dtype=float32)
    """
    return jnp.asarray(
        _savgol_coeffs_np(window_length, polyorder, deriv, delta, pos, use),
        dtype=dtype,
    )


def _savgol_edge_matrix(window_length, polyorder, deriv, delta, positions):
    """(len(positions), window_length) matrix mapping a raw edge window to
    the polyfit-interpolated derivative values at `positions` — the
    mode='interp' edge handling collapsed into one static matmul."""
    idx = np.arange(window_length, dtype=np.float64)
    a = idx[:, None] ** np.arange(polyorder + 1)[None, :]
    pinv = np.linalg.pinv(a)  # (polyorder+1, window_length)
    j = np.arange(polyorder + 1)
    # d-th derivative of sum c_j t^j: sum_{j>=d} c_j j!/(j-d)! t^(j-d)
    ff = np.where(j >= deriv,
                  [math.factorial(k) / math.factorial(max(k - deriv, 0))
                   if k >= deriv else 0.0 for k in j], 0.0)
    t = np.asarray(positions, dtype=np.float64)[:, None]
    powers = np.where(j[None, :] >= deriv, t ** np.maximum(j - deriv, 0), 0.0)
    v = powers * ff[None, :]
    return (v @ pinv) / (delta**deriv)


def savgol_filter(x, window_length: int, polyorder: int, *, deriv: int = 0,
                  delta: float = 1.0, axis: int = -1, mode: str = "interp",
                  cval: float = 0.0):
    """Savitzky-Golay smoothing/differentiation filter —
    scipy.signal.savgol_filter semantics (window_length must be odd here).

    Mapping: the sliding polynomial fit is a static FIR, applied with
    the blocked-Toeplitz matmul (ops/convolution.py: fir_convolve_1d);
    mode='interp' edge polyfits collapse into two host-precomputed
    (halflen, window_length) matrices, so the whole op is three matmuls.
    Not in the reference.

    Examples:

    A polyorder-2 fit reproduces a quadratic exactly (including the
    'interp' edges):

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import savgol_filter
    >>> x = jnp.asarray([0.0, 1.0, 4.0, 9.0, 16.0, 25.0])
    >>> np.round(np.asarray(savgol_filter(x, 5, 2)), 4)
    array([-0.,  1.,  4.,  9., 16., 25.], dtype=float32)
    """
    x = jnp.asarray(x)
    if not (jnp.issubdtype(x.dtype, jnp.floating)
            or jnp.issubdtype(x.dtype, jnp.complexfloating)):
        x = x.astype(DEFAULT_FLOAT)
    if window_length % 2 != 1:
        raise ValueError("window_length must be odd")
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    if mode not in ("interp", "mirror", "nearest", "constant", "wrap"):
        raise ValueError(
            "mode must be 'mirror', 'constant', 'nearest', 'wrap' or 'interp'"
        )
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    halflen = window_length // 2
    coeffs = _savgol_coeffs_np(window_length, polyorder, deriv, delta, None,
                               "conv")
    taps = jnp.asarray(coeffs, dtype=x.real.dtype)

    if mode == "interp":
        if window_length > n:
            raise ValueError(
                "If mode is 'interp', window_length must be less than or "
                "equal to the size of x."
            )
        interior = fir_convolve_1d(x, taps, mode="valid")
        left_m = jnp.asarray(
            _savgol_edge_matrix(window_length, polyorder, deriv, delta,
                                np.arange(halflen)), dtype=x.real.dtype)
        right_m = jnp.asarray(
            _savgol_edge_matrix(window_length, polyorder, deriv, delta,
                                np.arange(window_length - halflen,
                                          window_length)),
            dtype=x.real.dtype)
        left = x[..., :window_length] @ left_m.T
        right = x[..., n - window_length:] @ right_m.T
        return jnp.moveaxis(
            jnp.concatenate([left, interior, right], axis=-1), -1, axis)

    pad_map = {"mirror": "reflect", "nearest": "edge", "wrap": "wrap",
               "constant": "constant"}
    kwargs = {"constant_values": cval} if mode == "constant" else {}
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(halflen, halflen)],
                 mode=pad_map[mode], **kwargs)
    return jnp.moveaxis(fir_convolve_1d(xp, taps, mode="valid"), -1, axis)


def detrend(data, *, axis: int = -1, type: str = "linear"):
    """Remove the constant or least-squares linear trend along `axis` —
    scipy.signal.detrend semantics (bp breakpoints not supported).

    New relative to the reference (nx_signal has no detrend). The linear
    fit uses the closed-form normal equations on a centered time index
    (numerically safe in f32), fully batched — no lstsq solve per row.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import detrend
    >>> np.round(np.asarray(detrend(jnp.asarray([1.0, 3.0, 5.0, 7.0]))), 4)
    array([0., 0., 0., 0.], dtype=float32)
    >>> x = jnp.asarray([1.0, 2.0, 3.0, 4.0])
    >>> np.round(np.asarray(detrend(x, type="constant")), 4)
    array([-1.5, -0.5,  0.5,  1.5], dtype=float32)
    """
    x = jnp.asarray(data)
    if not jnp.issubdtype(x.dtype, jnp.floating) and not jnp.issubdtype(
        x.dtype, jnp.complexfloating
    ):
        x = x.astype(DEFAULT_FLOAT)
    axis = axis % x.ndim
    if type in ("constant", "c"):
        return x - jnp.mean(x, axis=axis, keepdims=True)
    if type not in ("linear", "l"):
        raise ValueError(f"type must be 'linear' or 'constant', got {type!r}")
    n = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = n
    t = (jnp.arange(n, dtype=x.real.dtype) - (n - 1) / 2.0).reshape(shape)
    mean = jnp.mean(x, axis=axis, keepdims=True)
    denom = jnp.sum(t * t)
    slope = jnp.sum((x - mean) * t, axis=axis, keepdims=True) / denom
    return x - mean - slope * t


def order_filter(a, domain, rank: int):
    """N-D order-statistic filter — scipy.signal.order_filter semantics:
    at each position, collect the neighborhood samples selected by the
    nonzero entries of `domain` (all dimensions odd, window centered,
    edges zero-padded) and output the rank-th smallest.

    Form: one shifted static slice per selected domain position
    stacked on a new axis, then a single vectorized sort — no gathers, and
    the sort length is the (static) number of selected positions. Not in
    the reference (its `median` is the anchored-window variant above).

    Examples:

    Rank 1 of each centered 3-window (the middle of three values):

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import order_filter
    >>> x = jnp.asarray([1.0, 5.0, 2.0, 4.0, 3.0])
    >>> np.asarray(order_filter(x, jnp.ones(3), 1))
    array([1., 2., 4., 3., 3.], dtype=float32)
    """
    a = jnp.asarray(a)
    dom = np.asarray(domain)
    if dom.ndim != a.ndim:
        raise ValueError("domain rank must match input rank")
    if any(s % 2 != 1 for s in dom.shape):
        raise ValueError(
            "Each dimension of domain argument should have an odd number of "
            "elements."
        )
    rank = int(rank)
    positions = np.argwhere(dom != 0)
    if not 0 <= rank < len(positions):
        raise ValueError(
            f"rank ({rank}) must be within [0, {len(positions)}) — the "
            "number of nonzero domain elements"
        )
    halves = [s // 2 for s in dom.shape]
    padded = jnp.pad(a, [(h, h) for h in halves])
    shifted = [
        padded[tuple(
            slice(int(p[d]), int(p[d]) + a.shape[d]) for d in range(a.ndim)
        )]
        for p in positions
    ]
    stack = jnp.stack(shifted, axis=0)
    return jnp.sort(stack, axis=0)[rank]


def medfilt(volume, kernel_size=None):
    """N-D median filter with centered windows and zero-padded edges —
    scipy.signal.medfilt semantics (kernel_size odd in every dimension,
    default 3). The reference's `median` (above) is the anchored-forward
    variant; this is the scipy-centered one, built on order_filter.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import medfilt
    >>> np.asarray(medfilt(jnp.asarray([1.0, 9.0, 2.0, 8.0, 3.0]), 3))
    array([1., 2., 8., 3., 3.], dtype=float32)
    """
    volume = jnp.asarray(volume)
    if kernel_size is None:
        kernel_size = 3
    if np.isscalar(kernel_size):
        kernel_size = (int(kernel_size),) * volume.ndim
    kernel_size = tuple(int(k) for k in kernel_size)
    if len(kernel_size) != volume.ndim:
        raise ValueError("kernel_size must have one element per dimension")
    if any(k % 2 != 1 for k in kernel_size):
        raise ValueError("Each element of kernel_size should be odd.")
    domain = np.ones(kernel_size, dtype=bool)
    size = int(np.prod(kernel_size))
    return order_filter(volume, domain, (size - 1) // 2)


def medfilt2d(input, kernel_size=3):
    """2-D median filter — scipy.signal.medfilt2d semantics (a 2-D
    specialization of medfilt; scipy ships it as the fast path).

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import medfilt2d
    >>> np.asarray(medfilt2d(jnp.arange(9.0).reshape(3, 3), 3))
    array([[0., 1., 0.],
           [1., 4., 2.],
           [0., 4., 0.]], dtype=float32)
    """
    input = jnp.asarray(input)
    if input.ndim != 2:
        raise ValueError("input must be 2-D")
    return medfilt(input, kernel_size)


def gammatone(freq, ftype: str, order: int = None, numtaps: int = None,
              fs: float = None):
    """Gammatone auditory filter design — scipy.signal.gammatone semantics.

    ftype='fir': sampled gammatone impulse response
    t^(order-1) e^(-2 pi bw t) cos(2 pi f t), unit gain at the center
    frequency (order default 4, numtaps default max(15, 15 ms)).
    ftype='iir': Slaney's 8th-order digital gammatone — four identical
    conjugate pole pairs at e^(-bw T +/- j 2 pi f T); assembled here by
    polynomial multiplication of the repeated biquad rather than scipy's
    hand-expanded coefficient table. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import gammatone
    >>> b, a = gammatone(440.0, 'fir', fs=16000.0)
    >>> np.asarray(b).shape, np.asarray(a)
    ((240,), array([1.]))
    """
    if fs is None:
        fs = 2.0
    fs = float(fs)
    freq = float(freq)
    if not 0 < freq <= fs / 2:
        raise ValueError(f"The frequency must be between 0 and {fs / 2} "
                         f"(nyquist), but given {freq}.")
    erb = 24.7 + freq / 9.26449  # Glasberg & Moore equivalent bandwidth
    if ftype == "fir":
        if order is None:
            order = 4
        order = int(order)
        if numtaps is None:
            numtaps = max(int(fs * 0.015), 15)
        numtaps = int(numtaps)
        if not 0 < order <= 24:
            raise ValueError("Invalid order: order must be > 0 and <= 24.")
        t = np.arange(numtaps, dtype=np.float64) / fs
        bw = 1.019 * erb
        b = t ** (order - 1) * np.exp(-2.0 * np.pi * bw * t) \
            * np.cos(2.0 * np.pi * freq * t)
        scale = 2.0 * (2.0 * np.pi * bw) ** order / math.factorial(order - 1) / fs
        # design-time coefficients stay f64 numpy (the iir_design convention)
        return b * scale, np.ones(1)
    if ftype != "iir":
        raise ValueError(f"ftype must be 'fir' or 'iir', got {ftype!r}")
    t_s = 1.0 / fs
    bw = 2.0 * np.pi * 1.019 * erb
    fr = 2.0 * np.pi * freq * t_s
    bw_t = bw * t_s
    # normalization gain at the center frequency (product over the four
    # first-order sections' responses)
    g1 = -2.0 * np.exp(2j * fr) * t_s
    g2 = 2.0 * np.exp(-bw_t + 1j * fr) * t_s
    g3 = math.sqrt(3.0 + 2.0 ** 1.5) * math.sin(fr)
    g4 = math.sqrt(3.0 - 2.0 ** 1.5) * math.sin(fr)
    g5 = np.exp(2j * fr)
    g = ((g1 + g2 * (math.cos(fr) - g4))
         * (g1 + g2 * (math.cos(fr) + g4))
         * (g1 + g2 * (math.cos(fr) - g3))
         * (g1 + g2 * (math.cos(fr) + g3)))
    g = g / ((-2.0 / np.exp(2.0 * bw_t) - 2.0 * g5
              + 2.0 * (1.0 + g5) / np.exp(bw_t)) ** 4)
    g = abs(g)
    # numerator: binomial envelope decaying at e^{-bw T} rotating at fr
    decay = np.exp(-bw_t)
    b = np.array([math.comb(4, q) * (-1) ** q * np.cos(q * fr) * decay ** q
                  for q in range(5)]) * t_s ** 4 / g
    # denominator: the conjugate pole pair to the 4th power
    biquad = np.array([1.0, -2.0 * decay * np.cos(fr), decay ** 2])
    a = np.ones(1)
    for _ in range(4):
        a = np.convolve(a, biquad)
    return b, a


def max_len_seq(nbits: int, state=None, length: int = None, taps=None):
    """Maximum-length sequence (m-sequence) via a Fibonacci LFSR —
    scipy.signal.max_len_seq semantics: returns (seq of 0/1 int8,
    final_state). Default taps tables for nbits 2..32; the LFSR runs as a
    jax.lax.scan (compiled loop) over the requested length. Not in the
    reference; the standard SDR/system-identification excitation.

    Examples:

    The period-7 m-sequence from a 3-bit register:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.filters import max_len_seq
    >>> seq, state = max_len_seq(3)
    >>> np.asarray(seq)
    array([1, 1, 1, 0, 1, 0, 0], dtype=int8)
    >>> np.asarray(state)
    array([1, 1, 1], dtype=int8)
    """
    from jax import lax

    _taps = {
        32: [31, 30, 10], 31: [28], 30: [29, 24, 23], 29: [27],
        28: [25], 27: [26, 25, 22], 26: [25, 24, 20], 25: [22],
        24: [23, 22, 17], 23: [18], 22: [21], 21: [19], 20: [17],
        19: [18, 17, 14], 18: [11], 17: [14], 16: [15, 13, 4], 15: [14],
        14: [13, 12, 2], 13: [12, 11, 8], 12: [11, 10, 4], 11: [9],
        10: [7], 9: [5], 8: [7, 6, 1], 7: [6], 6: [5], 5: [3],
        4: [3], 3: [2], 2: [1],
    }
    nbits = int(nbits)
    if taps is None:
        if nbits not in _taps:
            raise ValueError(f"nbits must be between 2 and 32 when taps is "
                             f"None, got {nbits}")
        taps = _taps[nbits]
    taps = np.unique(np.asarray(taps, dtype=np.int64))[::-1]
    if np.any(taps < 0) or np.any(taps > nbits) or taps.size < 1:
        raise ValueError("taps must be non-empty with values between "
                         "zero and nbits (inclusive)")
    n_max = (2 ** nbits) - 1
    length = n_max if length is None else int(length)
    if length < 0:
        raise ValueError("length must be greater than or equal to 0")
    if state is None:
        state = np.ones(nbits, dtype=np.int8)
    else:
        state = (np.asarray(state) != 0).astype(np.int8)
    if state.ndim != 1 or state.shape[0] != nbits:
        raise ValueError("state must be a 1-D array of size nbits")
    if np.all(state == 0):
        raise ValueError("state must not be all zeros")

    # scipy's in-place circular-buffer LFSR: for each output,
    # out = state[idx]; state[idx] ^= xor of state[(idx + t) % nbits] over
    # the taps; idx advances cyclically.
    s = jnp.asarray(state.astype(np.uint8))
    offs = jnp.asarray((np.asarray(taps) % nbits).astype(np.int32))

    def body(carry, _):
        s, idx = carry
        out = s[idx]
        fb = out
        for j in range(offs.shape[0]):
            fb = fb ^ s[(idx + offs[j]) % nbits]
        s = s.at[idx].set(fb)
        return (s, (idx + 1) % nbits), out

    (s_fin, idx_fin), seq = lax.scan(body, (s, jnp.asarray(0, jnp.int32)),
                                     None, length=length)
    final_state = jnp.roll(s_fin, -idx_fin)
    return seq.astype(jnp.int8), np.asarray(final_state).astype(np.int8)
