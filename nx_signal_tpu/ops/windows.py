"""Window functions (scipy.signal.windows-equivalent semantics).

Covers the reference window family (reference: lib/nx_signal/windows.ex):
rectangular, bartlett, triangular, blackman, hamming, hann, kaiser — each
cosine-family window supporting the periodic (DFT-even, default) vs symmetric
(filter-design) distinction (reference: windows.ex:170-198 periodic trick of
computing length n+1 and dropping the last sample).

All windows are tiny, design-time tensors — plain jnp is the right tool; no
kernels needed. Everything here is jit-compatible with `n` static.
"""

import math

import jax.numpy as jnp
import numpy as np
from jax.scipy.special import i0 as _bessel_i0

from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT

__all__ = [
    "rectangular",
    "bartlett",
    "triangular",
    "blackman",
    "hamming",
    "hann",
    "kaiser",
    "general_cosine",
    "general_hamming",
    "blackmanharris",
    "nuttall",
    "flattop",
    "bohman",
    "cosine",
    "barthann",
    "parzen",
    "lanczos",
    "gaussian",
    "general_gaussian",
    "tukey",
    "exponential",
    "taylor",
    "chebwin",
    "dpss",
    "kaiser_bessel_derived",
    "boxcar",
    "triang",
    "get_window",
]


def rectangular(n: int, *, dtype=jnp.int32):
    """All-ones window (reference: windows.ex:33-36; the reference defaults to
    s64 — here int32, the default integer width).

    Examples:

    >>> from nx_signal_tpu.ops.windows import rectangular
    >>> rectangular(5)
    Array([1, 1, 1, 1, 1], dtype=int32)
    """
    return jnp.ones((n,), dtype=dtype)


def bartlett(n: int, *, dtype=DEFAULT_FLOAT):
    """Periodic Bartlett window: rises 2i/n then falls 2 - 2i/n, split at
    n//2 + n%2 (reference: windows.ex:57-76). Note this is the *periodic*
    triangular variant (matches torch.bartlett_window(periodic=True)), not
    scipy.signal.windows.bartlett which is symmetric.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import bartlett
    >>> np.round(np.asarray(bartlett(6)), 4)
    array([0.    , 0.3333, 0.6667, 1.    , 0.6667, 0.3333], dtype=float32)
    """
    i = jnp.arange(n, dtype=dtype)
    left_size = n // 2 + n % 2
    return jnp.where(i < left_size, i * 2.0 / n, 2.0 - i * 2.0 / n).astype(dtype)


def triangular(n: int, *, dtype=DEFAULT_FLOAT):
    """Symmetric triangular window, scipy.signal.windows.triang semantics
    (reference: windows.ex:98-127): odd n -> peaks at 1, even n -> plateau.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import triangular
    >>> np.round(np.asarray(triangular(5)), 4)
    array([0.3333, 0.6667, 1.    , 0.6667, 0.3333], dtype=float32)
    """
    half = (n + 1) // 2
    idx = jnp.arange(1, half + 1, dtype=dtype)
    if n % 2 == 1:
        left = idx * 2.0 / (n + 1)
        return jnp.concatenate([left, left[::-1][1:]]).astype(dtype)
    left = (2.0 * idx - 1.0) / n
    return jnp.concatenate([left, left[::-1]]).astype(dtype)


def _cosine_window(n: int, coefs, periodic: bool, dtype):
    """General cosine-sum window: sum_k (-1)^k a_k cos(2 pi k i / (L-1))."""
    if n == 1:
        return jnp.ones((1,), dtype=dtype)  # scipy convention for M=1
    length = n + 1 if periodic else n
    if length == 1:
        w = jnp.ones((1,), dtype=dtype)
    else:
        cdt = dtype if jnp.issubdtype(dtype, jnp.floating) else jnp.float32
        i = jnp.arange(length, dtype=cdt)
        theta = 2.0 * math.pi * i / (length - 1)
        w = jnp.zeros((length,), dtype=cdt)
        for k, a in enumerate(coefs):
            sign = 1.0 if k % 2 == 0 else -1.0
            w = w + sign * a * jnp.cos(k * theta)
    w = w.astype(dtype)
    return w[:n] if periodic else w


def blackman(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Blackman window 0.42 - 0.5 cos + 0.08 cos(2·) (reference:
    windows.ex:160-199).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import blackman
    >>> np.round(np.asarray(blackman(8, periodic=False)), 4)
    array([-0.    ,  0.0905,  0.4592,  0.9204,  0.9204,  0.4592,  0.0905,
           -0.    ], dtype=float32)
    """
    return _cosine_window(n, (0.42, 0.5, 0.08), periodic, dtype)


def hamming(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Hamming window 0.54 - 0.46 cos (reference: windows.ex:225-252).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import hamming
    >>> np.round(np.asarray(hamming(6, periodic=False)), 4)
    array([0.08  , 0.3979, 0.9121, 0.9121, 0.3979, 0.08  ], dtype=float32)
    """
    return _cosine_window(n, (0.54, 0.46), periodic, dtype)


def hann(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Hann window 0.5 (1 - cos) (reference: windows.ex:278-305).

    Examples:

    >>> from nx_signal_tpu.ops.windows import hann
    >>> hann(8, periodic=False)
    Array([0.        , 0.1882551 , 0.6112605 , 0.9504844 , 0.9504844 ,
           0.6112603 , 0.18825516, 0.        ], dtype=float32)
    >>> hann(4)
    Array([0. , 0.5, 1. , 0.5], dtype=float32)
    """
    return _cosine_window(n, (0.5, 0.5), periodic, dtype)


def kaiser(n: int, *, beta: float = 12.0, periodic: bool = True, eps: float = 0.0,
           dtype=DEFAULT_FLOAT):
    """Kaiser window I0(beta sqrt(1 - r^2)) / I0(beta) over r in [-1, 1]
    (reference: windows.ex:341-369).

    Uses the exact Bessel I0 (jax.scipy.special.i0) rather than the
    reference's polynomial/asymptotic approximation (windows.ex:371-386),
    giving scipy-grade accuracy. `eps` floors the sqrt argument for exact
    reference parity (its default there is 1e-7); default 0 matches scipy.

    Examples:

    >>> from nx_signal_tpu.ops.windows import kaiser
    >>> kaiser(5, beta=12.0, periodic=False)
    Array([5.2773445e-05, 2.1567267e-01, 1.0000000e+00, 2.1567267e-01,
           5.2773445e-05], dtype=float32)
    """
    if n == 1:
        return jnp.ones((1,), dtype=dtype)  # scipy convention for M=1
    length = n + 1 if periodic else n
    if length == 1:
        w = jnp.ones((1,), dtype=dtype)
    else:
        ratio = jnp.linspace(-1.0, 1.0, length, dtype=jnp.float32)
        sqrt_arg = jnp.maximum(1.0 - ratio * ratio, eps)
        w = (_bessel_i0(beta * jnp.sqrt(sqrt_arg)) / _bessel_i0(jnp.float32(beta))).astype(dtype)
    return w[:n] if periodic else w


# --- Extended window family (beyond the reference's seven) -----------------
#
# The reference covers only the seven windows above (windows.ex). scipy.signal
# users expect the full windows module; these follow scipy.signal.windows
# semantics exactly. All are design-time math on tiny tensors: computed in
# float64 on host (so they fold into jit traces as constants — n is static
# anyway) and cast to the requested dtype. The periodic/symmetric handling is
# the reference's DFT-even trick (windows.ex:170-198): compute the symmetric
# window of length n+1 and drop the last sample.


def _host_window(n: int, periodic: bool, dtype, build):
    """Shared symmetric->periodic plumbing for host-computed windows."""
    if n == 0:
        return jnp.zeros((0,), dtype=dtype)
    if n == 1:
        return jnp.ones((1,), dtype=dtype)  # scipy convention for M=1
    length = n + 1 if periodic else n
    w = np.asarray(build(length), dtype=np.float64)
    return jnp.asarray(w[:n], dtype=dtype)


def general_cosine(n: int, coefs, *, periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Generic weighted cosine-sum window sum_k a_k cos(k th), th in [-pi, pi] —
    scipy.signal.windows.general_cosine semantics (centered phase convention:
    all-positive coefficients peak at the center). Not in the
    reference; generalizes windows.ex:160-199.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import general_cosine
    >>> np.round(np.asarray(general_cosine(6, [0.6, 0.4], periodic=False)), 4)
    array([0.2   , 0.4764, 0.9236, 0.9236, 0.4764, 0.2   ], dtype=float32)
    """
    def build(length):
        fac = np.linspace(-np.pi, np.pi, length)
        w = np.zeros(length)
        for k, a in enumerate(coefs):
            w += a * np.cos(k * fac)
        return w
    return _host_window(n, periodic, dtype, build)


def general_hamming(n: int, alpha: float, *, periodic: bool = True,
                    dtype=DEFAULT_FLOAT):
    """Generalized Hamming alpha - (1-alpha) cos —
    scipy.signal.windows.general_hamming semantics. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import general_hamming
    >>> np.round(np.asarray(general_hamming(6, 0.6, periodic=False)), 4)
    array([0.2   , 0.4764, 0.9236, 0.9236, 0.4764, 0.2   ], dtype=float32)
    """
    return general_cosine(n, [alpha, 1.0 - alpha], periodic=periodic, dtype=dtype)


def blackmanharris(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT):
    """4-term Blackman-Harris window (-92 dB sidelobes) —
    scipy.signal.windows.blackmanharris semantics. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import blackmanharris
    >>> np.round(np.asarray(blackmanharris(6, periodic=False)), 4)
    array([1.000e-04, 1.030e-01, 7.938e-01, 7.938e-01, 1.030e-01, 1.000e-04],
          dtype=float32)
    """
    return general_cosine(n, [0.35875, 0.48829, 0.14128, 0.01168],
                          periodic=periodic, dtype=dtype)


def nuttall(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Nuttall 4-term minimum-sidelobe window —
    scipy.signal.windows.nuttall semantics. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import nuttall
    >>> np.round(np.asarray(nuttall(6, periodic=False)), 4)
    array([4.000e-04, 1.105e-01, 7.983e-01, 7.983e-01, 1.105e-01, 4.000e-04],
          dtype=float32)
    """
    return general_cosine(n, [0.3635819, 0.4891775, 0.1365995, 0.0106411],
                          periodic=periodic, dtype=dtype)


def flattop(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Flat-top window (amplitude-accurate spectral measurement) —
    scipy.signal.windows.flattop semantics. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import flattop
    >>> np.round(np.asarray(flattop(7, periodic=False)), 4)
    array([-4.000e-04, -5.130e-02,  1.982e-01,  1.000e+00,  1.982e-01,
           -5.130e-02, -4.000e-04], dtype=float32)
    """
    return general_cosine(
        n,
        [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368],
        periodic=periodic, dtype=dtype,
    )


def bohman(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Bohman window (1-|x|)cos(pi|x|) + sin(pi|x|)/pi —
    scipy.signal.windows.bohman semantics. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import bohman
    >>> np.round(np.asarray(bohman(6, periodic=False)), 4)
    array([0.    , 0.1791, 0.8343, 0.8343, 0.1791, 0.    ], dtype=float32)
    """
    def build(length):
        fac = np.abs(np.linspace(-1.0, 1.0, length)[1:-1])
        w = (1.0 - fac) * np.cos(np.pi * fac) + np.sin(np.pi * fac) / np.pi
        return np.concatenate(([0.0], w, [0.0]))
    return _host_window(n, periodic, dtype, build)


def cosine(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Half-cycle sine window sin(pi (i+1/2) / L) —
    scipy.signal.windows.cosine semantics. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import cosine
    >>> np.round(np.asarray(cosine(6, periodic=False)), 4)
    array([0.2588, 0.7071, 0.9659, 0.9659, 0.7071, 0.2588], dtype=float32)
    """
    return _host_window(
        n, periodic, dtype,
        lambda length: np.sin(np.pi / length * (np.arange(length) + 0.5)),
    )


def barthann(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Bartlett-Hann window — scipy.signal.windows.barthann semantics.
    Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import barthann
    >>> np.round(np.asarray(barthann(6, periodic=False)), 4)
    array([0.    , 0.3586, 0.8794, 0.8794, 0.3586, 0.    ], dtype=float32)
    """
    def build(length):
        fac = np.abs(np.arange(length) / (length - 1.0) - 0.5)
        return 0.62 - 0.48 * fac + 0.38 * np.cos(2.0 * np.pi * fac)
    return _host_window(n, periodic, dtype, build)


def parzen(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Parzen (de la Vallee Poussin) piecewise-cubic window —
    scipy.signal.windows.parzen semantics. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import parzen
    >>> np.round(np.asarray(parzen(6, periodic=False)), 4)
    array([0.0093, 0.25  , 0.8611, 0.8611, 0.25  , 0.0093], dtype=float32)
    """
    def build(length):
        idx = np.arange(-(length - 1) / 2.0, (length - 1) / 2.0 + 0.5, 1.0)
        r = np.abs(idx) / (length / 2.0)
        return np.where(np.abs(idx) <= (length - 1) / 4.0,
                        1.0 - 6.0 * r**2 + 6.0 * r**3, 2.0 * (1.0 - r) ** 3)
    return _host_window(n, periodic, dtype, build)


def lanczos(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Lanczos (sinc) window sinc(2i/(L-1) - 1) —
    scipy.signal.windows.lanczos semantics. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import lanczos
    >>> np.round(np.asarray(lanczos(6, periodic=False)), 4)
    array([0.    , 0.5046, 0.9355, 0.9355, 0.5046, 0.    ], dtype=float32)
    """
    return _host_window(
        n, periodic, dtype,
        lambda length: np.sinc(2.0 * np.arange(length) / (length - 1.0) - 1.0),
    )


def gaussian(n: int, std: float, *, periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Gaussian window exp(-i^2 / (2 std^2)), centered —
    scipy.signal.windows.gaussian semantics. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import gaussian
    >>> np.round(np.asarray(gaussian(7, 1.5, periodic=False)), 4)
    array([0.1353, 0.4111, 0.8007, 1.    , 0.8007, 0.4111, 0.1353],
          dtype=float32)
    """
    def build(length):
        idx = np.arange(length) - (length - 1) / 2.0
        return np.exp(-(idx**2) / (2.0 * std * std))
    return _host_window(n, periodic, dtype, build)


def general_gaussian(n: int, p: float, sig: float, *, periodic: bool = True,
                     dtype=DEFAULT_FLOAT):
    """Generalized Gaussian exp(-1/2 |i/sig|^(2p)) —
    scipy.signal.windows.general_gaussian semantics. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import general_gaussian
    >>> np.round(np.asarray(general_gaussian(7, 1.5, 2.0, periodic=False)), 4)
    array([0.185 , 0.6065, 0.9394, 1.    , 0.9394, 0.6065, 0.185 ],
          dtype=float32)
    """
    def build(length):
        idx = np.arange(length) - (length - 1) / 2.0
        return np.exp(-0.5 * np.abs(idx / sig) ** (2.0 * p))
    return _host_window(n, periodic, dtype, build)


def tukey(n: int, alpha: float = 0.5, *, periodic: bool = True,
          dtype=DEFAULT_FLOAT):
    """Tukey (tapered-cosine) window — scipy.signal.windows.tukey semantics:
    cosine tapers over alpha/2 of the span at each end, flat middle.
    Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import tukey
    >>> np.round(np.asarray(tukey(8, 0.5, periodic=False)), 4)
    array([0.    , 0.6113, 1.    , 1.    , 1.    , 1.    , 0.6113, 0.    ],
          dtype=float32)
    """
    def build(length):
        if alpha <= 0:
            return np.ones(length)
        if alpha >= 1.0:
            return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(length)
                                       / (length - 1.0)))
        idx = np.arange(length)
        width = int(np.floor(alpha * (length - 1) / 2.0))
        n1 = idx[: width + 1]
        n3 = idx[length - width - 1:]
        w1 = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * n1 / alpha / (length - 1))))
        w3 = 0.5 * (1 + np.cos(np.pi * (-2.0 / alpha + 1
                                        + 2.0 * n3 / alpha / (length - 1))))
        return np.concatenate((w1, np.ones(length - 2 * width - 2), w3))
    return _host_window(n, periodic, dtype, build)


def exponential(n: int, center=None, tau: float = 1.0, *,
                periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Exponential (Poisson) window exp(-|i - center| / tau) —
    scipy.signal.windows.exponential semantics, including the rule that an
    explicit center requires the periodic (non-symmetric) form.
    Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import exponential
    >>> np.round(np.asarray(exponential(6, tau=2.0, periodic=False)), 4)
    array([0.2865, 0.4724, 0.7788, 0.7788, 0.4724, 0.2865], dtype=float32)
    """
    if not periodic and center is not None:
        raise ValueError("If periodic is False, center must be None.")
    def build(length):
        c = (length - 1) / 2.0 if center is None else center
        return np.exp(-np.abs(np.arange(length) - c) / tau)
    return _host_window(n, periodic, dtype, build)


def taylor(n: int, nbar: int = 4, sll: float = 30.0, *, norm: bool = True,
           periodic: bool = True, dtype=DEFAULT_FLOAT):
    """Taylor window (radar: near-constant sidelobes at -sll dB with nbar
    near-in sidelobes) — scipy.signal.windows.taylor semantics. The cosine-sum
    coefficients F_m come from the Chebyshev-matching product formula.
    Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import taylor
    >>> np.round(np.asarray(taylor(8, nbar=3, sll=20, periodic=False)), 4)
    array([0.5427, 0.6664, 0.848 , 0.981 , 0.981 , 0.848 , 0.6664, 0.5427],
          dtype=float32)
    """
    def build(length):
        big_b = 10.0 ** (sll / 20.0)
        big_a = np.arccosh(big_b) / np.pi
        s2 = nbar**2 / (big_a**2 + (nbar - 0.5) ** 2)
        ma = np.arange(1, nbar, dtype=np.float64)
        coefs = np.zeros(max(nbar - 1, 0))
        m2 = ma * ma
        for mi in range(len(ma)):
            numer = (-1.0) ** mi * np.prod(
                1.0 - m2[mi] / s2 / (big_a**2 + (ma - 0.5) ** 2))
            denom = 2.0 * np.prod(1.0 - m2[mi] / m2[:mi]) * np.prod(
                1.0 - m2[mi] / m2[mi + 1:])
            coefs[mi] = numer / denom

        def weight(pos):
            pos = np.atleast_1d(pos)
            return 1.0 + 2.0 * np.dot(
                coefs,
                np.cos(2.0 * np.pi * ma[:, None]
                       * (pos[None, :] - length / 2.0 + 0.5) / length))

        w = weight(np.arange(length))
        if norm:
            w = w / weight((length - 1) / 2.0)
        return w
    return _host_window(n, periodic, dtype, build)


def chebwin(n: int, at: float = 100.0, *, periodic: bool = True,
            dtype=DEFAULT_FLOAT):
    """Dolph-Chebyshev window with exactly `at` dB of equiripple sidelobe
    attenuation — scipy.signal.windows.chebwin semantics (Chebyshev polynomial
    sampled in the frequency domain, inverse DFT, peak-normalized).
    Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import chebwin
    >>> np.round(np.asarray(chebwin(7, 60, periodic=False)), 4)
    array([0.0871, 0.38  , 0.7947, 1.    , 0.7947, 0.38  , 0.0871],
          dtype=float32)
    """
    def build(length):
        order = length - 1
        beta = np.cosh(np.arccosh(10.0 ** (abs(at) / 20.0)) / order)
        x = beta * np.cos(np.pi * np.arange(length) / length)
        # T_order(x) evaluated stably on all three branches of |x| vs 1
        p = np.zeros(length)
        gt, lt = x > 1, x < -1
        mid = ~gt & ~lt
        p[gt] = np.cosh(order * np.arccosh(x[gt]))
        p[lt] = (2 * (length % 2) - 1) * np.cosh(order * np.arccosh(-x[lt]))
        p[mid] = np.cos(order * np.arccos(x[mid]))
        if length % 2:
            w = np.real(np.fft.fft(p))
            half = (length + 1) // 2
            w = w[:half]
            w = np.concatenate((w[half - 1:0:-1], w))
        else:
            p = p * np.exp(1j * np.pi / length * np.arange(length))
            w = np.real(np.fft.fft(p))
            half = length // 2 + 1
            w = np.concatenate((w[half - 1:0:-1], w[1:half]))
        return w / np.max(w)
    return _host_window(n, periodic, dtype, build)


def dpss(n: int, half_bandwidth: float, n_windows=None, *,
         periodic: bool = False, dtype=DEFAULT_FLOAT):
    """Discrete prolate spheroidal (Slepian) sequences, unit-energy
    normalization — scipy.signal.windows.dpss(..., norm=2) semantics,
    including the polarity conventions (even-order windows sum positive,
    odd-order windows start positive). Returns shape (n,) when `n_windows`
    is None, else (n_windows, n). Eigenvectors of the symmetric tridiagonal
    DPSS operator, solved densely on host (design-time). Not in the
    reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import dpss
    >>> np.round(np.asarray(dpss(6, 1.5, periodic=False)), 4)
    array([0.1329, 0.3766, 0.5835, 0.5835, 0.3766, 0.1329], dtype=float32)
    """
    if not 0 < half_bandwidth < n / 2.0:
        raise ValueError("half_bandwidth must be in (0, n/2)")
    k_max = 1 if n_windows is None else int(n_windows)
    if not 0 < k_max <= n:
        raise ValueError(f"n_windows must be in [1, n], got {n_windows}")
    length = n + 1 if periodic else n
    frac = half_bandwidth / length
    t = np.arange(length, dtype=np.float64)
    diag = ((length - 1 - 2.0 * t) / 2.0) ** 2 * np.cos(2.0 * np.pi * frac)
    off = t[1:] * (length - t[1:]) / 2.0
    mat = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    _, vecs = np.linalg.eigh(mat)
    wins = vecs[:, ::-1][:, :k_max].T.copy()  # (k_max, length), unit norm
    fix_even = wins[::2].sum(axis=1) < 0
    wins[::2][fix_even] *= -1
    thresh = max(1e-7, 1.0 / length)
    for i, w in enumerate(wins[1::2]):
        sig = w[w * w > thresh**2]
        if sig.size and sig[0] < 0:
            wins[2 * i + 1] *= -1
    wins = wins[:, :n]
    out = jnp.asarray(wins, dtype=dtype)
    return out[0] if n_windows is None else out


_WINDOW_BUILDERS = {
    "rectangular": lambda n, periodic, dtype: rectangular(n, dtype=dtype),
    # scipy.signal.get_window's name for the rectangular window
    "boxcar": lambda n, periodic, dtype: rectangular(n, dtype=dtype),
    "triang": lambda n, periodic, dtype: triangular(n, dtype=dtype),
    "bartlett": lambda n, periodic, dtype: bartlett(n, dtype=dtype),
    "triangular": lambda n, periodic, dtype: triangular(n, dtype=dtype),
    "blackman": lambda n, periodic, dtype: blackman(n, periodic=periodic, dtype=dtype),
    "hamming": lambda n, periodic, dtype: hamming(n, periodic=periodic, dtype=dtype),
    "hann": lambda n, periodic, dtype: hann(n, periodic=periodic, dtype=dtype),
    "blackmanharris": lambda n, periodic, dtype: blackmanharris(
        n, periodic=periodic, dtype=dtype),
    "nuttall": lambda n, periodic, dtype: nuttall(n, periodic=periodic, dtype=dtype),
    "flattop": lambda n, periodic, dtype: flattop(n, periodic=periodic, dtype=dtype),
    "bohman": lambda n, periodic, dtype: bohman(n, periodic=periodic, dtype=dtype),
    "cosine": lambda n, periodic, dtype: cosine(n, periodic=periodic, dtype=dtype),
    "barthann": lambda n, periodic, dtype: barthann(n, periodic=periodic, dtype=dtype),
    "parzen": lambda n, periodic, dtype: parzen(n, periodic=periodic, dtype=dtype),
    "lanczos": lambda n, periodic, dtype: lanczos(n, periodic=periodic, dtype=dtype),
    "tukey": lambda n, periodic, dtype: tukey(n, periodic=periodic, dtype=dtype),
    "exponential": lambda n, periodic, dtype: exponential(
        n, periodic=periodic, dtype=dtype),
    "taylor": lambda n, periodic, dtype: taylor(n, periodic=periodic, dtype=dtype),
    "chebwin": lambda n, periodic, dtype: chebwin(n, periodic=periodic, dtype=dtype),
}

# Windows whose spec carries positional parameters: name -> constructor taking
# (n, *params, periodic=..., dtype=...).
_PARAMETRIC_WINDOWS = {
    "kaiser_bessel_derived":
        lambda n, beta, periodic=False, dtype=None: kaiser_bessel_derived(
            n, beta, dtype=dtype if dtype is not None else DEFAULT_FLOAT),
    "gaussian": gaussian,
    "general_gaussian": general_gaussian,
    "general_cosine": general_cosine,
    "general_hamming": general_hamming,
    "tukey": tukey,
    "exponential": exponential,
    "taylor": taylor,
    "chebwin": chebwin,
    "dpss": dpss,
}


def get_window(window, n: int, *, periodic: bool = False, dtype=DEFAULT_FLOAT):
    """Build a window from a spec: a name string, or a (name, *params) tuple
    such as ('kaiser', beta), ('gaussian', std), ('tukey', alpha),
    ('chebwin', attenuation_db), ('dpss', half_bandwidth).

    The firwin dispatch analog (reference: lib/nx_signal/filters.ex:254-279),
    widened to the scipy.signal.get_window surface; defaults to symmetric
    windows as filter design requires.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import get_window
    >>> np.round(np.asarray(get_window("hann", 4)), 4)
    array([0.  , 0.75, 0.75, 0.  ], dtype=float32)
    >>> np.round(np.asarray(get_window(("kaiser", 8.0), 5)), 4)
    array([0.0023, 0.369 , 1.    , 0.369 , 0.0023], dtype=float32)
    """
    if isinstance(window, (tuple, list)):
        name, *params = window
        if name == "kaiser":
            (beta,) = params
            return kaiser(n, beta=beta, periodic=periodic, dtype=dtype)
        if name in _PARAMETRIC_WINDOWS:
            return _PARAMETRIC_WINDOWS[name](n, *params, periodic=periodic,
                                             dtype=dtype)
        raise ValueError(
            f"unknown window {window!r}, supported: "
            f"{sorted(set(_WINDOW_BUILDERS) | set(_PARAMETRIC_WINDOWS))} "
            "or (name, *params) with name in "
            f"{sorted(set(_PARAMETRIC_WINDOWS) | {'kaiser'})}"
        )
    if window not in _WINDOW_BUILDERS:
        raise ValueError(
            f"unknown window {window!r}, supported: "
            f"{sorted(set(_WINDOW_BUILDERS) | set(_PARAMETRIC_WINDOWS))} "
            "or (name, *params) with name in "
            f"{sorted(set(_PARAMETRIC_WINDOWS) | {'kaiser'})}"
        )
    if window in ("rectangular", "boxcar"):
        return rectangular(n, dtype=dtype) if jnp.issubdtype(dtype, jnp.integer) \
            else jnp.ones((n,), dtype=dtype)
    return _WINDOW_BUILDERS[window](n, periodic, dtype)


def kaiser_bessel_derived(n: int, beta: float, *, dtype=DEFAULT_FLOAT):
    """Kaiser-Bessel derived (KBD) window — scipy.signal.windows.
    kaiser_bessel_derived semantics: the MDCT analysis/synthesis window
    satisfying the Princen-Bradley condition, built from the cumulative
    energy of an (n/2 + 1)-point Kaiser window:
    w[k] = sqrt(cumsum(kaiser)[k] / sum(kaiser)) for the first half,
    mirrored. Only defined for even n (scipy raises likewise).
    Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import kaiser_bessel_derived
    >>> np.round(np.asarray(kaiser_bessel_derived(4, beta=4.0)), 4)
    array([0.2742, 0.9617, 0.9617, 0.2742], dtype=float32)
    """
    if n < 0:
        raise ValueError("Window length n must be non-negative")
    if n == 0:
        return jnp.zeros((0,), dtype=dtype)
    if n % 2:
        raise ValueError("Kaiser-Bessel Derived windows are only defined "
                         "for even number of points")
    kw = kaiser(n // 2 + 1, beta=float(beta), periodic=False,
                dtype=jnp.float32)
    csum = jnp.cumsum(kw)
    half = jnp.sqrt(csum[:-1] / csum[-1]).astype(dtype)
    return jnp.concatenate([half, half[::-1]])


def boxcar(n: int, *, dtype=DEFAULT_FLOAT):
    """Rectangular window under scipy's name (scipy.signal.windows.boxcar);
    float dtype by default, unlike `rectangular`'s reference-exact s64
    (windows.ex:33-36).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import boxcar
    >>> np.asarray(boxcar(3))
    array([1., 1., 1.], dtype=float32)
    """
    return jnp.ones((n,), dtype=dtype)


def triang(n: int, *, dtype=DEFAULT_FLOAT):
    """Triangular window under scipy's name (scipy.signal.windows.triang —
    non-zero endpoints, unlike bartlett); alias of `triangular` (always
    symmetric, as the reference defines it — windows.ex:98-127).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.windows import triang
    >>> np.round(np.asarray(triang(4)), 4)
    array([0.25, 0.75, 0.75, 0.25], dtype=float32)
    """
    return triangular(n, dtype=dtype)
