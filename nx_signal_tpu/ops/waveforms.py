"""Waveform generators (scipy.signal-equivalent semantics).

Reference: lib/nx_signal/waveforms.ex. All generators are elementwise maps
over a time tensor — pure VPU work that XLA fuses; no kernels needed. Static
options stay at Python level so everything is jit-compatible.
"""

import math
from typing import NamedTuple

import jax.numpy as jnp

from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT, result_real_dtype

__all__ = [
    "sawtooth",
    "square",
    "gaussian_pulse",
    "gausspulse",
    "GaussianPulse",
    "chirp",
    "polynomial_sweep",
    "sweep_poly",
    "unit_impulse",
    "sinc",
]

_TWO_PI = 2.0 * math.pi


def _as_float(t):
    t = jnp.asarray(t)
    if not jnp.issubdtype(t.dtype, jnp.floating):
        t = t.astype(DEFAULT_FLOAT)
    return t


def sawtooth(t, *, width: float = 1.0):
    """Periodic sawtooth with period 2*pi: rises -1 -> 1 over [0, 2*pi*width],
    falls back over the rest (reference: waveforms.ex:29-54).

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.waveforms import sawtooth
    >>> t = jnp.asarray([0.0, jnp.pi / 2, jnp.pi, 3 * jnp.pi / 2])
    >>> np.round(np.asarray(sawtooth(t)), 4)
    array([-1. , -0.5,  0. ,  0.5], dtype=float32)
    """
    if not 0 <= width <= 1:
        raise ValueError(f"width must be between 0 and 1, inclusive. Got: {width}")
    t = _as_float(t)
    tmod = jnp.mod(t, _TWO_PI)
    if width == 1:
        return tmod / (math.pi * width) - 1.0
    if width == 0:
        return (math.pi * (width + 1.0) - tmod) / (math.pi * (1.0 - width))
    return jnp.where(
        tmod < _TWO_PI * width,
        tmod / (math.pi * width) - 1.0,
        (math.pi * (width + 1.0) - tmod) / (math.pi * (1.0 - width)),
    )


def square(t, *, duty=0.5):
    """Periodic square wave with period 2*pi: +1 while tmod < 2*pi*duty, else
    -1. `duty` may be a tensor for a time-varying duty cycle (reference:
    waveforms.ex:96-104). Returns int32 (+1/-1) like the reference's s32.

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.waveforms import square
    >>> square(jnp.asarray([0.0, 1.0, 2.0, 3.5, 5.0]))
    Array([ 1,  1,  1, -1, -1], dtype=int32)
    """
    t = _as_float(t)
    duty = jnp.asarray(duty)
    tmod = jnp.mod(t, _TWO_PI)
    return jnp.where(tmod < duty * _TWO_PI, jnp.int32(1), jnp.int32(-1))


class GaussianPulse(NamedTuple):
    envelope: jnp.ndarray
    in_phase: jnp.ndarray
    quadrature: jnp.ndarray


def gaussian_pulse(t, *, center_frequency: float = 1000.0, bandwidth: float = 0.5,
                   bandwidth_reference_level: float = -6.0):
    """Gaussian-modulated sinusoid e^{-a t^2} (cos, sin)(2 pi fc t); returns
    (envelope, in_phase, quadrature) (reference: waveforms.ex:161-198).

    Examples:

    Rows are [envelope, in-phase, quadrature]; the envelope peaks at t=0:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.waveforms import gaussian_pulse
    >>> t = jnp.asarray([-0.001, 0.0, 0.001])
    >>> out = gaussian_pulse(t, center_frequency=1000.0)
    >>> np.round(np.asarray(out)[:2], 4)
    array([[0.4094, 1.    , 0.4094],
           [0.4094, 1.    , 0.4094]], dtype=float32)
    """
    fc, bw, bwr = center_frequency, bandwidth, bandwidth_reference_level
    if fc < 0:
        raise ValueError(f"Center frequency must be greater than or equal to 0, got: {fc}")
    if bw <= 0:
        raise ValueError(f"Bandwidth must be greater than 0, got: {bw}")
    if bwr >= 0:
        raise ValueError(f"Bandwidth reference level must be less than 0, got: {bwr}")
    t = _as_float(t)
    ref = 10.0 ** (bwr / 20.0)
    a = -((math.pi * fc * bw) ** 2) / (4.0 * math.log(ref))
    envelope = jnp.exp(-a * t * t)
    phase = _TWO_PI * fc * t
    return GaussianPulse(envelope, envelope * jnp.cos(phase), envelope * jnp.sin(phase))


def chirp(t, f0: float, t1: float, f1: float, *, method: str = "linear",
          phi: float = 0.0, vertex_zero: bool = True):
    """Swept-frequency cosine from f0 at t=0 to f1 at t=t1 (reference:
    waveforms.ex:249-300; scipy.signal.chirp semantics).

    Methods: 'linear', 'quadratic' (with `vertex_zero`), 'logarithmic'
    (NaN if f0*f1 <= 0), 'hyperbolic'.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.waveforms import chirp
    >>> t = jnp.arange(4) / 4.0
    >>> np.round(np.asarray(chirp(t, f0=1.0, t1=1.0, f1=2.0)), 4)
    array([ 1.    , -0.1951, -0.7071,  0.9808], dtype=float32)
    """
    t = _as_float(t)
    if method == "linear":
        beta = (f1 - f0) / t1
        phase = _TWO_PI * (f0 * t + 0.5 * beta * t * t)
    elif method == "quadratic":
        beta = (f1 - f0) / (t1 * t1)
        if vertex_zero:
            phase = _TWO_PI * (f0 * t + beta * t**3 / 3.0)
        else:
            phase = _TWO_PI * (f1 * t + beta * ((t1 - t) ** 3 - t1**3) / 3.0)
    elif method == "logarithmic":
        if f0 * f1 <= 0:
            return jnp.full(t.shape, jnp.nan, dtype=t.dtype)
        if f0 == f1:
            phase = _TWO_PI * f0 * t
        else:
            beta = t1 / math.log(f1 / f0)
            phase = _TWO_PI * beta * f0 * ((f1 / f0) ** (t / t1) - 1.0)
    elif method == "hyperbolic":
        if f0 == f1:
            phase = _TWO_PI * f0 * t
        else:
            singular = -f1 * t1 / (f0 - f1)
            phase = _TWO_PI * (-singular * f0) * jnp.log(jnp.abs(1.0 - t / singular))
    else:
        raise ValueError(
            "invalid method, must be one of ['linear', 'quadratic', 'logarithmic', "
            f"'hyperbolic'], got: {method}"
        )
    return jnp.cos(phase + phi)


def polynomial_sweep(t, coefs, *, phi: float = 0.0, phi_unit: str = "radians"):
    """Cosine with instantaneous frequency given by a polynomial (highest
    power first); the polynomial is integrated analytically (reference:
    waveforms.ex:343-361; scipy.signal.sweep_poly semantics).

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.waveforms import polynomial_sweep
    >>> t = jnp.asarray([0.0, 0.5, 1.0])
    >>> np.round(np.asarray(polynomial_sweep(t, jnp.asarray([2.0, 1.0]))), 4)
    array([1., 0., 1.], dtype=float32)
    """
    t = _as_float(t)
    coefs = jnp.asarray(coefs, dtype=t.dtype)
    (n,) = coefs.shape
    powers = n - jnp.arange(n, dtype=t.dtype)  # n, n-1, ..., 1
    t_poly = t[None, :] ** powers[:, None]
    phase = jnp.dot(coefs / powers, t_poly, precision="highest")
    if phi_unit == "degrees":
        phi = phi * math.pi / 180.0
    elif phi_unit != "radians":
        raise ValueError(f"phi_unit must be 'radians' or 'degrees', got: {phi_unit}")
    return jnp.cos(_TWO_PI * phase + phi)


def sweep_poly(t, poly, phi: float = 0.0):
    """scipy.signal.sweep_poly-compatible spelling of `polynomial_sweep`:
    `poly` is a coefficient sequence (highest power first) or np.poly1d,
    `phi` is in DEGREES (scipy's convention). Not in the reference under
    this name (waveforms.ex:343-361 is the same math).

    Examples:

    Instantaneous frequency 2t + 1: phase crosses full cycles at t=0.5, 1:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.waveforms import sweep_poly
    >>> np.round(np.asarray(sweep_poly(jnp.asarray([0.0, 0.5, 1.0]),
    ...                                [2.0, 1.0])), 4)
    array([1., 0., 1.], dtype=float32)
    """
    coefs = getattr(poly, "coefficients", poly)
    return polynomial_sweep(t, coefs, phi=phi, phi_unit="degrees")


def gausspulse(t, fc: float = 1000.0, bw: float = 0.5, bwr: float = -6.0,
               tpr: float = -60.0, retquad: bool = False,
               retenv: bool = False):
    """scipy.signal.gausspulse-compatible spelling of `gaussian_pulse`:
    returns the in-phase component by default, optionally the quadrature
    and/or envelope, and accepts t='cutoff' to return the time where the
    envelope falls to `tpr` dB. The reference's map-returning form is
    `gaussian_pulse` (waveforms.ex:161-198).

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.waveforms import gausspulse
    >>> t = jnp.linspace(-0.5, 0.5, 5)
    >>> np.round(np.asarray(gausspulse(t, fc=2.0)), 4)
    array([ 0.4094, -0.7999,  1.    , -0.7999,  0.4094], dtype=float32)
    """
    if isinstance(t, str):
        if t != "cutoff":
            raise ValueError(f"If t is a string, it must be 'cutoff', got: {t}")
        if bwr >= 0:
            raise ValueError(
                f"Bandwidth reference level must be less than 0, got: {bwr}"
            )
        ref = 10.0 ** (bwr / 20.0)
        a = -((math.pi * fc * bw) ** 2) / (4.0 * math.log(ref))
        tref = 10.0 ** (tpr / 20.0)
        return math.sqrt(-math.log(tref) / a)
    pulse = gaussian_pulse(t, center_frequency=fc, bandwidth=bw,
                           bandwidth_reference_level=bwr)
    out = [pulse.in_phase]
    if retquad:
        out.append(pulse.quadrature)
    if retenv:
        out.append(pulse.envelope)
    return out[0] if len(out) == 1 else tuple(out)


def unit_impulse(shape, *, index=0, dtype=DEFAULT_FLOAT):
    """Delta function: 1 at `index` (an int, index tuple/array, or
    'midpoint'), 0 elsewhere (reference: waveforms.ex:406-437).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.waveforms import unit_impulse
    >>> np.asarray(unit_impulse(5, index=2))
    array([0., 0., 1., 0., 0.], dtype=float32)
    """
    if isinstance(shape, int):
        shape = (shape,)
    rank = len(shape)
    if isinstance(index, str):
        if index != "midpoint":
            raise ValueError(f"index must be an int, tuple, array or 'midpoint', got: {index}")
        idx = tuple(d // 2 for d in shape)
    else:
        idx = jnp.asarray(index).reshape((rank,))
        idx = tuple(idx[i] for i in range(rank))
    return jnp.zeros(shape, dtype=dtype).at[idx].set(1)


def sinc(t):
    """Normalized sinc(t) = sin(pi t) / (pi t) with sinc(0) = 1 (reference:
    waveforms.ex:451-457).

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.waveforms import sinc
    >>> np.round(np.asarray(sinc(jnp.asarray([0.0, 0.5, 1.0]))), 4)
    array([ 1.    ,  0.6366, -0.    ], dtype=float32)
    """
    t = _as_float(t)
    x = t * math.pi
    # Substitute 1 where x == 0 *before* dividing so no NaN enters the graph
    # (NaN * 0 through jnp.where would still propagate under autodiff).
    safe = jnp.where(x == 0, jnp.ones((), dtype=t.dtype), x)
    return jnp.where(x == 0, jnp.ones((), dtype=t.dtype), jnp.sin(safe) / safe)
