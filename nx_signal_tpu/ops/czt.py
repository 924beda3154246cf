"""Chirp-Z transform and zoom FFT — scipy.signal.czt / zoom_fft semantics.

New relative to the reference (nx_signal stops at plain FFT; SURVEY.md
§2.4). Design: two dispatch paths, mirroring kernels/dft.py —

- small n*m: the transform IS a matmul, X = (x * a^-n) @ W with
  W[n, k] = w^(nk); one matmul, no FFT at all (the same regime where the
  framed-DFT matmul beats XLA's FFT ~3x).
- large n*m: Bluestein's algorithm — the quadratic-phase factorization
  nk = (n^2 + k^2 - (k-n)^2)/2 turns the transform into one linear
  convolution, evaluated with power-of-two FFTs (utils/shapes.py
  fft_fast_length; some FFT backends lower non-pow-2 lengths to dense O(N^2)
  matmuls, so the pad is load-bearing).

Chirp phase tables are built host-side in f64 when the transform
parameters are concrete (the usual case — w and a are design-time
scalars), so the n^2/2 phases keep full accuracy before casting to the
device dtype.
"""

import math

import numpy as np

import jax.numpy as jnp

from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT
from nx_signal_tpu.utils.shapes import fft_fast_length

__all__ = ["czt", "zoom_fft", "czt_points", "CZT", "ZoomFFT"]

_MAX_MATMUL_NM = 1 << 21  # n*m above this -> Bluestein (a crossover not measured on the H100)

_CDTYPE = np.complex64 if DEFAULT_FLOAT == jnp.float32 else np.complex128


def _as_scalar_complex(v):
    return complex(np.asarray(v).reshape(()))


def _chirp_powers(base, exponents):
    """base**exponents with f64 phase accuracy: base = r e^{i t} ->
    r**e * exp(i t e), all in numpy f64."""
    base = _as_scalar_complex(base)
    exponents = np.asarray(exponents, dtype=np.float64)
    r = abs(base)
    t = math.atan2(base.imag, base.real)
    mag = np.exp(exponents * math.log(r)) if r != 1.0 else 1.0
    return (mag * np.exp(1j * t * exponents)).astype(np.complex128)


def czt(x, m: int = None, w=None, a=1.0 + 0.0j, *, axis: int = -1):
    """Chirp-Z transform: X[k] = sum_n x[n] z_k^{-n} along the spiral
    z_k = a * w^{-k}, k = 0..m-1 — scipy.signal.czt semantics (defaults
    m = len(x), w = exp(-2j*pi/m), a = 1: the plain DFT).

    Requires concrete (non-traced) `w`/`a` — they parameterize the
    transform and become compile-time weight tables, the deftransform/
    defn split of the reference (SURVEY.md §1 L1).

    Accuracy note: for |w| != 1 (decaying spirals) Bluestein's chirps span
    e^{±|log w| n^2/2} and cancel catastrophically — scipy's czt loses all
    digits by n ~ 100 at |w| = e^{-0.01}. The matmul path has no such
    blowup (|w^{nk}| <= spread of the answer itself), so this
    implementation is strictly more accurate in the matmul regime; tests
    gate against the direct-definition f64 oracle there, and against scipy
    on the unit circle.

    Examples:

    With the defaults czt is the DFT — a constant has all its energy in
    bin 0:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.czt import czt
    >>> y = czt(jnp.asarray([1.0, 1.0, 1.0, 1.0]), m=4)
    >>> np.round(np.asarray(y), 4)
    array([ 4.+0.j, -0.+0.j,  0.-0.j,  0.+0.j], dtype=complex64)
    """
    x = jnp.asarray(x)
    n = x.shape[axis]
    plan = _CztPlan(n, m, w, a)
    return plan.apply(x, axis=axis)


class _CztPlan:
    """Precomputed chirp tables for a fixed (n, m, w, a) transform.

    Built once host-side in f64, reused across calls — the class forms
    CZT/ZoomFFT amortize this across repeated same-length transforms
    (scipy.signal.CZT's stated purpose)."""

    def __init__(self, n, m=None, w=None, a=1.0 + 0.0j):
        if n <= 0:
            raise ValueError("input must be nonempty along the transform axis")
        if m is None:
            m = n
        if m <= 0:
            raise ValueError(f"m must be positive, got {m}")
        if w is None:
            w = np.exp(-2j * np.pi / m)
        self.n, self.m = int(n), int(m)
        self.w = _as_scalar_complex(w)
        self.a = _as_scalar_complex(a)

        n_idx = np.arange(self.n, dtype=np.float64)
        a_chirp = _chirp_powers(self.a, -n_idx)  # a^{-n}
        self._matmul = self.n * self.m <= _MAX_MATMUL_NM
        if self._matmul:
            # matmul path: one (.., n) @ (n, m) complex matmul
            nk = n_idx[:, None] * np.arange(self.m, dtype=np.float64)[None, :]
            self._weights = jnp.asarray(
                (a_chirp[:, None] * _chirp_powers(self.w, nk)).astype(_CDTYPE)
            )
            return
        # Bluestein: nk = (n^2 + k^2 - (k-n)^2) / 2
        m, n, w = self.m, self.n, self.w
        k_idx = np.arange(m, dtype=np.float64)
        wn2 = _chirp_powers(w, n_idx * n_idx / 2.0)      # w^{n^2/2}
        wk2 = _chirp_powers(w, k_idx * k_idx / 2.0)      # w^{k^2/2}
        length = fft_fast_length(n + m - 1)
        # v[j] = w^{-j^2/2} for j in -(n-1)..(m-1), circularly embedded
        v = np.zeros(length, dtype=np.complex128)
        v[:m] = _chirp_powers(w, -(k_idx * k_idx) / 2.0)
        if n > 1:
            j = np.arange(1, n, dtype=np.float64)
            v[length - n + 1 :] = _chirp_powers(w, -(j * j) / 2.0)[::-1]
        self._length = length
        self._v_f = jnp.asarray(np.fft.fft(v).astype(_CDTYPE))
        self._pre = jnp.asarray((a_chirp * wn2).astype(_CDTYPE))
        self._post = jnp.asarray(wk2.astype(_CDTYPE))

    def apply(self, x, *, axis: int = -1):
        x = jnp.asarray(x)
        if x.shape[axis] != self.n:
            raise ValueError(
                f"CZT defined for length {self.n}, got {x.shape[axis]}")
        xm = jnp.moveaxis(x, axis, -1)
        if self._matmul:
            out = jnp.matmul(xm.astype(self._weights.dtype), self._weights,
                             precision="highest")
            return jnp.moveaxis(out, -1, axis)
        u = xm.astype(_CDTYPE) * self._pre
        conv = jnp.fft.ifft(
            jnp.fft.fft(u, n=self._length, axis=-1) * self._v_f, axis=-1)
        out = conv[..., : self.m] * self._post
        return jnp.moveaxis(out, -1, axis)

    def points(self):
        """The z-plane evaluation points z_k = a * w^{-k}."""
        return czt_points(self.m, self.w, self.a)


def czt_points(m: int, w=None, a=1.0 + 0.0j):
    """The m points z_k = a * w^{-k} on the CZT's logarithmic spiral —
    scipy.signal.czt_points semantics (w defaults to exp(-2j*pi/m): the
    unit circle of the plain DFT). Not in the reference. Host-side f64
    chirp powers for phase accuracy.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.czt import czt_points
    >>> np.round(np.asarray(czt_points(3)), 4)
    array([ 1. +0.j   , -0.5+0.866j, -0.5-0.866j], dtype=complex64)
    """
    m = int(m)
    if m <= 0:
        raise ValueError(f"m must be positive, got {m}")
    if w is None:
        w = np.exp(-2j * np.pi / m)
    a = _as_scalar_complex(a)
    pts = a * _chirp_powers(w, -np.arange(m, dtype=np.float64))
    return jnp.asarray(pts.astype(_CDTYPE))


class CZT:
    """Callable chirp-Z transform of fixed length — scipy.signal.CZT
    semantics. Precomputes the chirp weight tables (the matmul weights
    or the Bluestein FFT tables) once at construction, so repeated
    transforms of same-length signals skip all host-side f64 table math.
    Not in the reference (nx_signal stops at plain FFT, SURVEY.md §2.4).

    Examples:

    A reusable plan evaluating the plain 8-point DFT:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.czt import CZT
    >>> plan = CZT(8, m=8)
    >>> np.round(np.asarray(plan(jnp.ones(8)))[:2], 4)
    array([8.+0.j, 0.-0.j], dtype=complex64)
    """

    def __init__(self, n: int, m: int = None, w=None, a=1.0 + 0.0j):
        self._plan = _CztPlan(n, m, w, a)

    def __call__(self, x, *, axis: int = -1):
        return self._plan.apply(x, axis=axis)

    @property
    def n(self):
        return self._plan.n

    @property
    def m(self):
        return self._plan.m

    @property
    def w(self):
        return self._plan.w

    @property
    def a(self):
        return self._plan.a

    def points(self):
        """The z-plane points this transform evaluates at."""
        return self._plan.points()


class ZoomFFT(CZT):
    """Callable zoom FFT of fixed length over a fixed band —
    scipy.signal.ZoomFFT semantics: a CZT along the unit-circle arc
    [f1, f2]. See `zoom_fft` for the band math. Not in the reference.

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.czt import ZoomFFT
    >>> plan = ZoomFFT(16, [0.1, 0.3], m=4, fs=1.0)
    >>> plan(jnp.ones(16)).shape
    (4,)
    """

    def __init__(self, n: int, fn, m: int = None, *, fs: float = 2.0,
                 endpoint: bool = False):
        f1, f2 = _parse_band(fn, fs)
        if m is None:
            m = n
        denom = (m - 1) if endpoint else m
        w = np.exp(-2j * np.pi * (f2 - f1) / (denom * fs))
        a = np.exp(2j * np.pi * f1 / fs)
        super().__init__(n, m, w, a)
        self.f1, self.f2, self.fs = f1, f2, fs


def _parse_band(fn, fs):
    fn = np.atleast_1d(np.asarray(fn, dtype=np.float64))
    if fn.size == 2:
        f1, f2 = float(fn[0]), float(fn[1])
    elif fn.size == 1:
        f1, f2 = 0.0, float(fn[0])
    else:
        raise ValueError("fn must be a scalar or a pair [f1, f2]")
    if not 0 <= f1 <= f2 <= fs / 2:
        raise ValueError(f"fn must satisfy 0 <= f1 <= f2 <= fs/2, got {fn}")
    return f1, f2


def zoom_fft(x, fn, m: int = None, *, fs: float = 2.0, endpoint: bool = False,
             axis: int = -1):
    """DFT of `x` evaluated only over the band `fn` = [f1, f2] (or [0, fn]
    for scalar fn) at `m` points — scipy.signal.zoom_fft semantics: a czt
    along the unit circle, equivalent to zero-padding the FFT to the matching
    resolution and slicing, without ever computing the full spectrum.

    Examples:

    Three bins over [0.2, 0.3] cycles/sample of a 0.125-cycle cosine (the
    leakage tail falls away from the tone):

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.czt import zoom_fft
    >>> x = jnp.cos(2 * jnp.pi * 0.125 * jnp.arange(16))
    >>> np.round(np.abs(np.asarray(zoom_fft(x, [0.2, 0.3], m=3, fs=1.0))), 3)
    array([1.522, 1.434, 1.175], dtype=float32)
    """
    f1, f2 = _parse_band(fn, fs)
    x = jnp.asarray(x)
    if m is None:
        m = x.shape[axis]
    denom = (m - 1) if endpoint else m
    w = np.exp(-2j * np.pi * (f2 - f1) / (denom * fs))
    a = np.exp(2j * np.pi * f1 / fs)
    return czt(x, m, w, a, axis=axis)
