"""B-spline signal processing (Unser's recursive prefilters) —
scipy.signal's spline family: smoothing IIR filters with mirror-symmetric
boundary conditions, 1-D/2-D B-spline coefficient transforms, and spline
evaluation. Not in the reference (nx_signal has no spline support).

Design notes: the forward/backward recursions run through ops/iir.py's
lfilter/sosfilt (log-depth associative scans, jittable); the
mirror-symmetric initial conditions are closed-form weighted sums (one
matvec) rather than scipy's sequential C loops, with the same convergence
criterion. Batched over leading axes where scipy is 1-D/2-D only.
"""

import math

import jax.numpy as jnp
import numpy as np

from nx_signal_tpu.ops.iir import lfilter, sosfilt

__all__ = [
    "gauss_spline", "cubic_bspline", "quadratic_bspline",
    "symiirorder1", "symiirorder2",
    "cspline1d", "qspline1d", "cspline1d_eval", "qspline1d_eval",
    "cspline2d", "qspline2d", "sepfir2d", "spline_filter",
]


def gauss_spline(x, n: int):
    """Gaussian approximation of an order-`n` B-spline —
    scipy.signal.gauss_spline semantics: a normal density with variance
    (n+1)/12.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.splines import gauss_spline
    >>> np.round(np.asarray(gauss_spline(jnp.asarray([0.0, 1.0]), 2)), 4)
    array([0.7979, 0.108 ], dtype=float32)
    """
    x = jnp.asarray(x)
    sigma2 = (n + 1) / 12.0
    return (1.0 / jnp.sqrt(2.0 * jnp.pi * sigma2)
            * jnp.exp(-(x ** 2) / (2.0 * sigma2)))


def cubic_bspline(x):
    """Centered cubic (order-3) B-spline basis function.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.splines import cubic_bspline
    >>> np.round(np.asarray(cubic_bspline(jnp.asarray([0.0, 0.5, 1.0]))), 4)
    array([0.6667, 0.4792, 0.1667], dtype=float32)
    """
    x = jnp.abs(jnp.asarray(x))
    inner = 2.0 / 3.0 - x**2 * (1.0 - x / 2.0)
    outer = (2.0 - x) ** 3 / 6.0
    return jnp.where(x < 1.0, inner, jnp.where(x < 2.0, outer, 0.0))


def quadratic_bspline(x):
    """Centered quadratic (order-2) B-spline basis function.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.splines import quadratic_bspline
    >>> np.round(np.asarray(quadratic_bspline(jnp.asarray([0.0, 0.5, 1.0]))), 4)
    array([0.75 , 0.5  , 0.125], dtype=float32)
    """
    x = jnp.abs(jnp.asarray(x))
    inner = 0.75 - x**2
    outer = (x - 1.5) ** 2 / 2.0
    return jnp.where(x < 0.5, inner, jnp.where(x < 1.5, outer, 0.0))


def _default_precision(precision, dtype):
    """scipy's defaults (measured against scipy 1.17: the convergence gate
    is |pole|^(n-1) < precision with default 1e-11 in f64, 1e-3 in f32)."""
    if precision is None or precision <= 0.0 or precision >= 1.0:
        return 1e-3 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-11
    return float(precision)


def _check_converged(decay, n, precision, what):
    if abs(decay) ** max(n - 1, 1) > precision:
        raise ValueError(
            f"Sum to find {what} boundary conditions did not converge "
            f"(|pole|^(n-1) = {abs(decay) ** (n - 1):.3e} > {precision:.3e}); "
            "use a longer signal"
        )


def symiirorder1(signal, c0, z1, precision: float = -1.0):
    """First-order smoothing IIR cascade with mirror-symmetric boundaries,
    H(z) = c0 / ((1 - z1/z)(1 - z1 z)) — scipy.signal.symiirorder1
    semantics, batched over leading axes.

    The forward starting value is the closed-form mirror sum
    y0 = x[0] + z1 * sum_k z1^k x[k] (one matvec); both passes are lfilter
    scans.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.splines import symiirorder1
    >>> y = symiirorder1(jnp.arange(16.0), 0.5, 0.1)
    >>> np.round(np.asarray(y)[:4], 4)
    array([0.0686, 0.6241, 1.2353, 1.8519], dtype=float32)
    """
    x = jnp.asarray(signal)
    if abs(z1) >= 1:
        raise ValueError("|z1| must be less than 1.0")
    n = x.shape[-1]
    precision = _default_precision(precision, x.dtype)
    _check_converged(z1, n, precision, "symmetric")
    powers = jnp.asarray(z1 ** np.arange(n))
    y0 = x[..., 0] + z1 * jnp.sum(powers * x, axis=-1)

    y_rest, _ = lfilter(jnp.asarray([1.0]), jnp.asarray([1.0, -z1]),
                        x[..., 1:], zi=(z1 * y0)[..., None])
    y1 = jnp.concatenate([y0[..., None], y_rest], axis=-1)

    out_last = (c0 / (1.0 - z1)) * y1[..., -1]
    out_rev, _ = lfilter(jnp.asarray([c0]), jnp.asarray([1.0, -z1]),
                         y1[..., -2::-1], zi=(z1 * out_last)[..., None])
    return jnp.concatenate([out_rev[..., ::-1], out_last[..., None]], axis=-1)


def _hc(k, cs, r, omega):
    return (cs / math.sin(omega) * r ** k * np.sin(omega * (k + 1))
            * (k > -1))


def _hs(k, cs, r, omega):
    rsq = r * r
    c0 = (cs * cs * (1 + rsq) / (1 - rsq)
          / (1 - 2 * rsq * math.cos(2 * omega) + rsq * rsq))
    gamma = (1 - rsq) / (1 + rsq) / math.tan(omega)
    ak = np.abs(k)
    return c0 * r ** ak * (np.cos(omega * ak) + gamma * np.sin(omega * ak))


def _symiirorder2_core(x, r, omega, precision, smooth_ics: bool):
    """Shared second-order mirror-symmetric cascade. The two scipy
    functions that use it disagree on the SECOND forward starting value:
    symiirorder2 uses y1 = hc(0) x1 + hc(1) x0 + sum hc(k+2) x[k], while
    the cubic smoothing-spline path (_cubic_smooth_coeff) uses
    y1 = hc(0) x0 + hc(1) x1 + sum hc(k+2) x[k] — both are replicated.

    Deviation note: scipy truncates these boundary sums once terms fall
    below `precision`; here they are full closed-form sums (strictly closer
    to the ideal infinite mirror sum), so agreement with scipy at the array
    edges is limited by SCIPY'S truncation error (~precision x the section
    gain), not ours."""
    n = x.shape[-1]
    _check_converged(r, n, precision, "symmetric")
    rsq = r * r
    a2 = 2 * r * math.cos(omega)
    a3 = -rsq
    cs = 1 - 2 * r * math.cos(omega) + rsq
    sos = jnp.asarray([[cs, 0.0, 0.0, 1.0, -a2, -a3]])

    k = np.arange(n)
    hck1 = jnp.asarray(_hc(k + 1, cs, r, omega))
    hck2 = jnp.asarray(_hc(k + 2, cs, r, omega))
    hc0, hc1 = float(_hc(0, cs, r, omega)), float(_hc(1, cs, r, omega))
    y0 = hc0 * x[..., 0] + jnp.sum(hck1 * x, axis=-1)
    if smooth_ics:
        y1 = hc0 * x[..., 0] + hc1 * x[..., 1] + jnp.sum(hck2 * x, axis=-1)
    else:
        y1 = hc0 * x[..., 1] + hc1 * x[..., 0] + jnp.sum(hck2 * x, axis=-1)

    def _zi(ic0, ic1):
        # DF2T biquad state reproducing out[k] = cs u[k] + a2 out[k-1]
        # + a3 out[k-2] with out[-1] = ic1, out[-2] = ic0
        z0 = a3 * ic0 + a2 * ic1
        z1s = a3 * ic1
        return jnp.stack([z0, z1s], axis=-1)[None]

    y_rest, _ = sosfilt(sos, x[..., 2:], zi=_zi(y0, y1))
    y_fwd = jnp.concatenate([y0[..., None], y1[..., None], y_rest], axis=-1)

    hsk = _hs(k, cs, r, omega)
    b0 = jnp.sum(jnp.asarray(hsk + _hs(k + 1, cs, r, omega))
                 * x[..., ::-1], axis=-1)
    b1 = jnp.sum(jnp.asarray(_hs(k - 1, cs, r, omega)
                             + _hs(k + 2, cs, r, omega))
                 * x[..., ::-1], axis=-1)
    out_rev, _ = sosfilt(sos, y_fwd[..., -3::-1], zi=_zi(b0, b1))
    return jnp.concatenate(
        [out_rev[..., ::-1], b1[..., None], b0[..., None]], axis=-1)


def symiirorder2(input, r, omega, precision: float = -1.0):
    """Second-order smoothing IIR cascade with mirror-symmetric boundaries,
    H(z) = cs^2 / ((1 - a2/z - a3/z^2)(1 - a2 z - a3 z^2)) with
    a2 = 2 r cos(omega), a3 = -r^2, cs = 1 - 2 r cos(omega) + r^2 —
    scipy.signal.symiirorder2 semantics, batched over leading axes. The
    boundary conditions are closed-form _hc/_hs weighted sums (one matvec);
    the passes run through sosfilt's associative scans.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.splines import symiirorder2
    >>> y = symiirorder2(jnp.arange(24.0), 0.5, 0.3)
    >>> np.round(np.asarray(y)[:4], 4)
    array([1.2119, 1.6048, 2.2748, 3.1113], dtype=float32)
    """
    x = jnp.asarray(input)
    if r >= 1.0:
        raise ValueError("r must be less than 1.0")
    precision = _default_precision(precision, x.dtype)
    return _symiirorder2_core(x, r, omega, precision, smooth_ics=False)


def _bspline_coeffs(x, zi_pole, scale):
    """Shared cubic/quadratic exact-interpolation prefilter: forward and
    backward first-order recursions with scipy's mirror initial conditions
    (cspline1d/_cubic_coeff structure), batched over leading axes."""
    x = jnp.asarray(x)
    n = x.shape[-1]
    if n == 1:
        yplus = x[..., 0] + zi_pole * x[..., 0]
        return (zi_pole / (zi_pole - 1.0) * yplus)[..., None] * scale
    powers = jnp.asarray(zi_pole ** np.arange(n))
    y0 = x[..., 0] + zi_pole * jnp.sum(powers * x, axis=-1)
    y_rest, _ = lfilter(jnp.asarray([1.0]), jnp.asarray([1.0, -zi_pole]),
                        x[..., 1:], zi=(zi_pole * y0)[..., None])
    yplus = jnp.concatenate([y0[..., None], y_rest], axis=-1)
    out_last = zi_pole / (zi_pole - 1.0) * yplus[..., -1]
    out_rev, _ = lfilter(jnp.asarray([-zi_pole]),
                         jnp.asarray([1.0, -zi_pole]),
                         yplus[..., -2::-1], zi=(zi_pole * out_last)[..., None])
    out = jnp.concatenate([out_rev[..., ::-1], out_last[..., None]], axis=-1)
    return out * scale


def cspline1d(signal, lamb: float = 0.0):
    """Cubic B-spline coefficients of a uniformly sampled signal —
    scipy.signal.cspline1d semantics (lamb=0, exact interpolation). The
    smoothing case routes through symiirorder2 with the smoothing root of
    `lamb` (scipy's _cubic_smooth_coeff equivalent, same transfer
    function).

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.splines import cspline1d
    >>> c = cspline1d(jnp.asarray([0.0, 1.0, 2.0, 3.0]))
    >>> np.round(np.asarray(c), 4)
    array([-0.2082,  1.0698,  1.929 ,  3.2142], dtype=float32)
    """
    if lamb != 0.0:
        x = jnp.asarray(signal)
        r, omega = _smooth_root(lamb)
        # scipy's 1-D smoothing path (_cubic_smooth_coeff) uses the
        # smooth-variant forward starting values — see _symiirorder2_core
        return _symiirorder2_core(
            x, r, omega, _default_precision(-1.0, x.dtype), smooth_ics=True)
    return _bspline_coeffs(signal, -2.0 + math.sqrt(3.0), 6.0)


def qspline1d(signal, lamb: float = 0.0):
    """Quadratic B-spline coefficients — scipy.signal.qspline1d semantics
    (smoothing not defined for quadratic splines, like scipy).

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.splines import qspline1d
    >>> np.round(np.asarray(qspline1d(jnp.asarray([0.0, 1.0, 2.0, 3.0]))), 4)
    array([-0.1465,  1.0293,  1.9706,  3.1471], dtype=float32)
    """
    if lamb != 0.0:
        raise ValueError("lambda must be zero for quadratic splines")
    return _bspline_coeffs(signal, -3.0 + 2.0 * math.sqrt(2.0), 8.0)


def _smooth_root(lamb):
    """(r, omega) of the cubic smoothing-spline pole for fall-off `lamb`
    (scipy's compute_root_from_lambda)."""
    tmp = math.sqrt(3 + 144 * lamb)
    xi = 1 - 96 * lamb + 24 * lamb * tmp
    omega = math.atan(math.sqrt((144 * lamb - 1.0) / xi))
    r = ((24 * lamb - 1 - math.sqrt(xi)) / (24 * lamb)
         * math.sqrt(48 * lamb + 24 * lamb * tmp) / math.sqrt(xi))
    return r, omega


def _mirror_fold(t, n):
    """Reflect arbitrary sample positions into [0, n-1] (whole-sample
    mirror symmetry, period 2(n-1))."""
    if n == 1:
        return jnp.zeros_like(t)
    period = 2.0 * (n - 1)
    t = jnp.abs(t) % period
    return jnp.minimum(t, period - t)


def _spline_eval(cj, newx, dx, x0, basis, half_support):
    cj = jnp.asarray(cj)
    newx = (jnp.asarray(newx, dtype=jnp.result_type(jnp.asarray(newx).dtype,
                                                    jnp.float32)) - x0) / dx
    n = cj.shape[-1]
    if n == 0:
        raise ValueError("Spline coefficients must not be empty.")
    t = _mirror_fold(newx, n)
    lower = jnp.floor(t - half_support).astype(jnp.int32) + 1
    offsets = jnp.arange(int(2 * half_support))
    idx = lower[..., None] + offsets  # neighbors covering the support
    # scipy folds the EVALUATION POINT but CLAMPS the neighbor indices
    idx_c = jnp.clip(idx, 0, n - 1)
    w = basis(t[..., None] - idx)
    return jnp.sum(cj[..., idx_c] * w, axis=-1)


def cspline1d_eval(cj, newx, dx: float = 1.0, x0=0):
    """Evaluate a cubic spline from its coefficients at arbitrary points,
    mirror-symmetric at the edges — scipy.signal.cspline1d_eval
    semantics (gather + 4-tap B-spline weights; no recursion).

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.splines import cspline1d, cspline1d_eval
    >>> cj = cspline1d(jnp.asarray([0.0, 1.0, 2.0, 3.0]))
    >>> np.round(np.asarray(cspline1d_eval(cj, jnp.asarray([0.5, 1.5, 2.5]))), 4)
    array([0.4487, 1.4996, 2.5537], dtype=float32)
    """
    return _spline_eval(cj, newx, float(dx), x0, cubic_bspline, 2.0)


def qspline1d_eval(cj, newx, dx: float = 1.0, x0=0):
    """Evaluate a quadratic spline — scipy.signal.qspline1d_eval
    semantics.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.splines import qspline1d, qspline1d_eval
    >>> cj = qspline1d(jnp.asarray([0.0, 1.0, 2.0, 3.0]))
    >>> np.round(np.asarray(qspline1d_eval(cj, jnp.asarray([0.5, 1.5, 2.5]))), 4)
    array([0.4414, 1.5   , 2.5588], dtype=float32)
    """
    return _spline_eval(cj, newx, float(dx), x0, quadratic_bspline, 1.5)


def sepfir2d(input, hrow, hcol):
    """Separable 2-D FIR with mirror-symmetric boundaries —
    scipy.signal.sepfir2d semantics: odd-length `hrow` along rows, `hcol`
    along columns, output the same shape. Reflect-pad + valid correlation
    (lax.conv via ops.convolution under the hood is unnecessary here —
    the kernels are tiny, a dot over the stacked shifts suffices).

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.splines import sepfir2d
    >>> h = jnp.asarray([1.0, 2.0, 1.0])
    >>> np.asarray(sepfir2d(jnp.arange(9.0).reshape(3, 3), h, h))
    array([[ 16.,  28.,  40.],
           [ 52.,  64.,  76.],
           [ 88., 100., 112.]], dtype=float32)
    """
    x = jnp.asarray(input)
    hrow = jnp.asarray(hrow).reshape(-1)
    hcol = jnp.asarray(hcol).reshape(-1)
    if x.ndim != 2:
        raise ValueError("input must be 2-D")
    if hrow.shape[0] % 2 != 1 or hcol.shape[0] % 2 != 1:
        raise ValueError("hrow and hcol must be odd length")

    def filt_last(a, h):
        k = h.shape[0]
        half = k // 2
        if half:
            # scipy's boundary is HALF-SAMPLE symmetric (edge repeated:
            # x[-1] = x[0]) — numpy/jnp mode='symmetric', not 'reflect'
            a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(half, half)],
                        mode="symmetric")
        stack = jnp.stack([a[..., i:i + a.shape[-1] - k + 1]
                           for i in range(k)], axis=-1)
        # correlation with the symmetric-use convention (scipy applies the
        # filter as a correlation; spline kernels are symmetric anyway)
        return stack @ h[::-1]

    out = filt_last(x, hrow)
    out = filt_last(out.T, hcol).T
    return out


def cspline2d(signal, lamb: float = 0.0, precision: float = -1.0):
    """2-D cubic B-spline coefficients — scipy.signal.cspline2d semantics:
    the separable symiirorder1 (exact) or symiirorder2 (smoothing,
    lamb > 1/144) prefilter applied along both axes.

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(24, 24)), jnp.float32)
    >>> from nx_signal_tpu.ops.splines import cspline2d, sepfir2d
    >>> c = cspline2d(x, 0.0)
    >>> h = jnp.asarray([1.0, 4.0, 1.0]) / 6.0
    >>> bool(jnp.abs(sepfir2d(c, h, h) - x).max() < 1e-5)   # interpolation
    True
    """
    x = jnp.asarray(signal)
    if x.ndim != 2:
        raise ValueError("signal must be 2-D")
    precision = _c2d_precision(precision, x.dtype)
    if lamb <= 1.0 / 144.0:
        r = -2.0 + math.sqrt(3.0)
        out = symiirorder1(x, -r * 6.0, r, precision=precision)
        out = symiirorder1(out.T, -r * 6.0, r, precision=precision).T
        return out
    r, omega = _smooth_root(lamb)
    out = symiirorder2(x, r, omega, precision=precision)
    out = symiirorder2(out.T, r, omega, precision=precision).T
    return out


def qspline2d(signal, lamb: float = 0.0, precision: float = -1.0):
    """2-D quadratic B-spline coefficients — scipy.signal.qspline2d
    semantics.

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(24, 24)), jnp.float32)
    >>> from nx_signal_tpu.ops.splines import qspline2d, sepfir2d
    >>> q = qspline2d(x, 0.0)
    >>> h = jnp.asarray([1.0, 6.0, 1.0]) / 8.0
    >>> bool(jnp.abs(sepfir2d(q, h, h) - x).max() < 1e-5)   # interpolation
    True
    """
    x = jnp.asarray(signal)
    if x.ndim != 2:
        raise ValueError("signal must be 2-D")
    if lamb > 0:
        raise ValueError("lambda must be negative or zero")
    precision = _c2d_precision(precision, x.dtype)
    r = -3.0 + 2.0 * math.sqrt(2.0)
    out = symiirorder1(x, -r * 8.0, r, precision=precision)
    out = symiirorder1(out.T, -r * 8.0, r, precision=precision).T
    return out


def _c2d_precision(precision, dtype):
    if precision < 0.0 or precision >= 1.0:
        return 1e-3 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-6
    return precision


def spline_filter(iin, lmbda: float = 5.0):
    """Smoothing-spline filter of a 2-D array — scipy.signal.spline_filter
    semantics: cubic smoothing coefficients then the separable [1,4,1]/6
    B-spline reconstruction.

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(24, 24)), jnp.float32)
    >>> from nx_signal_tpu.ops.splines import spline_filter
    >>> sf = spline_filter(x, lmbda=5.0)
    >>> sf.shape, bool(abs(float(sf.mean() - x.mean())) < 1e-5)  # DC kept
    ((24, 24), True)
    """
    x = jnp.asarray(iin)
    if not (jnp.issubdtype(x.dtype, jnp.floating)
            or jnp.issubdtype(x.dtype, jnp.complexfloating)):
        raise TypeError(f"Invalid data type for iin: {x.dtype}")
    hcol = jnp.asarray([1.0, 4.0, 1.0]) / 6.0
    ck = cspline2d(x, lmbda)
    return sepfir2d(ck, hcol, hcol).astype(x.dtype)
