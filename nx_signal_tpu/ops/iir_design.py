"""IIR filter design: Butterworth / Chebyshev I & II / elliptic / Bessel
prototypes, frequency transforms, bilinear transform, and zpk/tf/sos
conversions.

Greenfield relative to the reference (nx_signal has only FIR design,
`firwin` — SURVEY.md §2.5 / lib/nx_signal/filters.ex:147-279); the contract
is scipy.signal semantics, the same oracle the reference pins firwin to
(filters_test.exs:246). Design is host-side f64 numpy — it runs once, on
tiny arrays, at Python level (the reference's deftransform level); only the
filter APPLICATION (ops/iir.py) runs on the device.

The elliptic prototype uses the Landen-transform formulation of the Jacobi
elliptic functions (cd/sn and inverse sn), which needs no external special-
function library and is accurate to ~1e-14 for realistic ripple specs.

SOS pairing note: `zpk2sos` pairs poles closest to the unit circle first
and matches each with its nearest zeros (sections ordered with the
highest-Q section last), which minimizes intermediate peak gain like
scipy's 'nearest' pairing. The section-level coefficients may differ from
scipy's in order/pairing; the cascaded transfer function is identical.
"""

import math

import numpy as np

__all__ = [
    "butter", "cheby1", "cheby2", "ellip", "bessel", "iirfilter",
    "iirnotch", "iirpeak", "iircomb", "iirdesign",
    "buttord", "cheb1ord", "cheb2ord", "ellipord",
    "buttap", "cheb1ap", "cheb2ap", "ellipap", "besselap",
    "lp2lp_zpk", "lp2hp_zpk", "lp2bp_zpk", "lp2bs_zpk", "bilinear_zpk",
    "lp2lp", "lp2hp", "lp2bp", "lp2bs",
    "zpk2tf", "tf2zpk", "zpk2sos", "tf2sos", "sos2tf", "sos2zpk",
]


# ---------------------------------------------------------------- prototypes

def buttap(n):
    """Analog lowpass Butterworth prototype: poles on the unit circle's left
    half, |H(jw)| = 1/sqrt(1 + w^(2n)). Returns (z, p, k).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import buttap
    >>> z, p, k = buttap(2)
    >>> np.round(p, 4), float(k)
    (array([-0.7071+0.7071j, -0.7071-0.7071j]), 1.0)
    """
    if n <= 0:
        raise ValueError("filter order must be a positive integer")
    m = np.arange(-n + 1, n, 2)
    p = -np.exp(1j * np.pi * m / (2 * n))
    return np.array([], dtype=complex), p, 1.0


def cheb1ap(n, rp):
    """Analog Chebyshev type-I prototype: `rp` dB passband ripple.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import cheb1ap
    >>> z, p, k = cheb1ap(2, 1.0)
    >>> np.round(p, 4), round(float(k), 4)
    (array([-0.5489+0.8951j, -0.5489-0.8951j]), 0.9826)
    """
    if n <= 0:
        raise ValueError("filter order must be a positive integer")
    eps = np.sqrt(10.0 ** (0.1 * rp) - 1.0)
    mu = np.arcsinh(1.0 / eps) / n
    m = np.arange(-n + 1, n, 2)
    theta = np.pi * m / (2 * n)
    p = -np.sinh(mu + 1j * theta)
    k = np.prod(-p).real
    if n % 2 == 0:
        k /= np.sqrt(1.0 + eps * eps)
    return np.array([], dtype=complex), p, float(k)


def cheb2ap(n, rs):
    """Analog Chebyshev type-II (inverse Chebyshev) prototype: `rs` dB
    stopband attenuation.

    Examples:

    >>> from nx_signal_tpu.ops.iir_design import cheb2ap
    >>> z, p, k = cheb2ap(3, 40.0)
    >>> len(z), len(p), round(float(k), 4)
    (2, 3, 0.03)
    """
    if n <= 0:
        raise ValueError("filter order must be a positive integer")
    de = 1.0 / np.sqrt(10.0 ** (0.1 * rs) - 1.0)
    mu = np.arcsinh(1.0 / de) / n
    if n % 2:
        m = np.concatenate((np.arange(-n + 1, 0, 2), np.arange(2, n, 2)))
    else:
        m = np.arange(-n + 1, n, 2)
    z = -np.conjugate(1j / np.sin(m * np.pi / (2 * n)))
    p = -np.exp(1j * np.pi * np.arange(-n + 1, n, 2) / (2 * n))
    p = np.sinh(mu) * p.real + 1j * np.cosh(mu) * p.imag
    p = 1.0 / p
    k = (np.prod(-p) / np.prod(-z)).real
    return z, p, float(k)


def besselap(n, norm="phase"):
    """Analog Bessel/Thomson prototype: roots of the degree-n reverse Bessel
    polynomial (exact integer coefficients, numpy roots + Newton polish).
    norm='phase' (scipy default) scales so the phase midpoint sits at w=1;
    norm='delay' keeps unit group delay at DC.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import besselap
    >>> z, p, k = besselap(2)
    >>> np.round(p, 4), float(k)
    (array([-0.866+0.5j, -0.866-0.5j]), 1.0)
    """
    if n <= 0:
        raise ValueError("filter order must be a positive integer")
    # theta_n(s) = sum_k c_k s^k, c_k = (2n-k)! / (2^(n-k) k! (n-k)!)
    c = [
        math.factorial(2 * n - k)
        // (2 ** (n - k) * math.factorial(k) * math.factorial(n - k))
        for k in range(n + 1)
    ]
    coeffs = np.array(c[::-1], dtype=np.float64)  # highest power first
    p = np.roots(coeffs)
    # Newton polish against the exact integer polynomial (np.roots loses
    # accuracy by n ~ 15)
    dcoeffs = coeffs[:-1] * np.arange(n, 0, -1)
    for _ in range(3):
        p = p - np.polyval(coeffs, p) / np.polyval(dcoeffs, p)
    a_last = float(c[0])  # theta_n(0) = (2n)!/(2^n n!)
    if norm == "phase":
        p = p * a_last ** (-1.0 / n)
        k = 1.0
    elif norm == "delay":
        k = a_last
    else:
        raise ValueError("norm must be 'phase' or 'delay'")
    return np.array([], dtype=complex), p, k


# ------------------------------------------- Jacobi elliptic (Landen form)

_EPS = np.finfo(np.float64).eps


def _landen(k):
    """Descending Landen modulus sequence k1 > k2 > ... until ~0."""
    ks = []
    while k > _EPS:
        kp = np.sqrt(max(1.0 - k * k, 0.0))
        k = (k / (1.0 + kp)) ** 2
        ks.append(k)
        if k < _EPS:
            break
    return ks


def _cde(u, k):
    """cd(u*K(k), k) for real or complex u (u normalized by the real
    quarter-period), via ascending Landen/Gauss recursion."""
    ks = _landen(k)
    w = np.cos(np.asarray(u) * np.pi / 2)
    for kn in reversed(ks):
        w = (1.0 + kn) * w / (1.0 + kn * w * w)
    return w


def _sne(u, k):
    """sn(u*K(k), k) for real or complex normalized u."""
    ks = _landen(k)
    w = np.sin(np.asarray(u) * np.pi / 2)
    for kn in reversed(ks):
        w = (1.0 + kn) * w / (1.0 + kn * w * w)
    return w


def _asne(w, k):
    """Inverse of _sne: u (normalized by K) with sn(u*K, k) = w."""
    ks = _landen(k)
    w = np.asarray(w, dtype=complex)
    k_prev = k
    for kn in ks:
        w = 2.0 * w / ((1.0 + kn) * (1.0 + np.sqrt(1.0 - k_prev * k_prev * w * w)))
        k_prev = kn
    return 2.0 * np.arcsin(w) / np.pi


def ellipap(n, rp, rs):
    """Analog elliptic (Cauer) prototype: `rp` dB passband ripple, `rs` dB
    stopband attenuation. Landen-transform construction (see module
    docstring); scipy.signal.ellipap is the parity oracle.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import ellipap
    >>> z, p, k = ellipap(2, 1.0, 40.0)
    >>> np.round(z, 4), round(float(k), 4)
    (array([0.+9.9376j, 0.-9.9376j]), 0.01)
    """
    if n <= 0:
        raise ValueError("filter order must be a positive integer")
    if rp <= 0 or rs <= rp:
        raise ValueError("must have 0 < rp < rs")
    if n == 1:
        # elliptic degenerates to Chebyshev-I for order 1
        eps = np.sqrt(10.0 ** (0.1 * rp) - 1.0)
        p = np.array([-1.0 / eps + 0j])
        return np.array([], dtype=complex), p, 1.0 / eps
    ep = np.sqrt(10.0 ** (0.1 * rp) - 1.0)
    es = np.sqrt(10.0 ** (0.1 * rs) - 1.0)
    k1 = ep / es
    k1p = np.sqrt(1.0 - k1 * k1)
    # degree equation: selectivity k from (n, k1)
    l = n // 2
    ui = (2.0 * np.arange(1, l + 1) - 1.0) / n
    kp = k1p ** n * np.prod(_sne(ui, k1p)) ** 4
    k = np.sqrt(max(1.0 - kp * kp, 0.0))

    zeta = _cde(ui, k).real
    z = 1j / (k * zeta)
    z = np.concatenate([z, np.conjugate(z)])

    v0 = (-1j * _asne(1j / ep, k1) / n).real
    p = 1j * _cde(ui - 1j * v0, k)
    p = np.concatenate([p, np.conjugate(p)])
    if n % 2:
        p0 = 1j * _sne(1j * v0, k)
        p = np.concatenate([p, [complex(p0)]])

    gain = (np.prod(-p) / np.prod(-z)).real
    if n % 2 == 0:
        gain /= np.sqrt(1.0 + ep * ep)
    return z, p, float(gain)


# ----------------------------------------------------- frequency transforms

def _degree(z, p):
    d = len(p) - len(z)
    if d < 0:
        raise ValueError("filter must have at least as many poles as zeros")
    return d


def lp2lp_zpk(z, p, k, wo=1.0):
    """Lowpass prototype -> lowpass at cutoff wo (zpk form).

    Examples:

    >>> from nx_signal_tpu.ops.iir_design import cheb2ap, lp2lp_zpk
    >>> z, p, k = cheb2ap(3, 40.0)
    >>> z2, p2, k2 = lp2lp_zpk(z, p, k, wo=2.0)
    >>> round(float(k2), 4)   # gain scales by wo^(degree difference)
    0.06
    """
    z, p = np.asarray(z, dtype=complex), np.asarray(p, dtype=complex)
    d = _degree(z, p)
    return z * wo, p * wo, k * wo ** d


def lp2hp_zpk(z, p, k, wo=1.0):
    """Lowpass prototype -> highpass at cutoff wo (zpk form).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import lp2hp_zpk
    >>> z, p, k = lp2hp_zpk(np.asarray([]), np.asarray([-1.0 + 0j]), 1.0, wo=2.0)
    >>> np.round(p, 4), float(k)
    (array([-2.-0.j]), 1.0)
    """
    z, p = np.asarray(z, dtype=complex), np.asarray(p, dtype=complex)
    d = _degree(z, p)
    z_hp = wo / z if len(z) else np.array([], dtype=complex)
    p_hp = wo / p
    z_hp = np.append(z_hp, np.zeros(d, dtype=complex))
    k_hp = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) or len(p) else k
    return z_hp, p_hp, float(k_hp)


def lp2bp_zpk(z, p, k, wo=1.0, bw=1.0):
    """Lowpass prototype -> bandpass centered at wo with bandwidth bw.

    Examples:

    >>> from nx_signal_tpu.ops.iir_design import cheb2ap, lp2bp_zpk
    >>> z, p, k = cheb2ap(3, 40.0)
    >>> z2, p2, k2 = lp2bp_zpk(z, p, k, wo=1.0, bw=0.5)
    >>> len(z2), len(p2)   # order doubles, degree gap filled with zeros
    (5, 6)
    """
    z, p = np.asarray(z, dtype=complex), np.asarray(p, dtype=complex)
    d = _degree(z, p)
    z_lp, p_lp = z * bw / 2, p * bw / 2
    z_bp = np.concatenate(
        [z_lp + np.sqrt(z_lp ** 2 - wo ** 2), z_lp - np.sqrt(z_lp ** 2 - wo ** 2)]
    )
    p_bp = np.concatenate(
        [p_lp + np.sqrt(p_lp ** 2 - wo ** 2), p_lp - np.sqrt(p_lp ** 2 - wo ** 2)]
    )
    z_bp = np.append(z_bp, np.zeros(d, dtype=complex))
    return z_bp, p_bp, k * bw ** d


def lp2bs_zpk(z, p, k, wo=1.0, bw=1.0):
    """Lowpass prototype -> bandstop centered at wo with bandwidth bw.

    Examples:

    >>> from nx_signal_tpu.ops.iir_design import cheb2ap, lp2bs_zpk
    >>> z, p, k = cheb2ap(3, 40.0)
    >>> z2, p2, k2 = lp2bs_zpk(z, p, k, wo=1.0, bw=0.5)
    >>> len(z2), len(p2)
    (6, 6)
    """
    z, p = np.asarray(z, dtype=complex), np.asarray(p, dtype=complex)
    d = _degree(z, p)
    z_hp = (bw / 2) / z if len(z) else np.array([], dtype=complex)
    p_hp = (bw / 2) / p
    z_bs = np.concatenate(
        [z_hp + np.sqrt(z_hp ** 2 - wo ** 2), z_hp - np.sqrt(z_hp ** 2 - wo ** 2)]
    )
    p_bs = np.concatenate(
        [p_hp + np.sqrt(p_hp ** 2 - wo ** 2), p_hp - np.sqrt(p_hp ** 2 - wo ** 2)]
    )
    z_bs = np.concatenate(
        [z_bs, np.full(d, 1j * wo), np.full(d, -1j * wo)]
    )
    k_bs = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) or len(p) else k
    return z_bs, p_bs, float(k_bs)


def bilinear_zpk(z, p, k, fs):
    """Analog zpk -> digital zpk via the bilinear (Tustin) transform at
    sample rate fs: s = 2 fs (z-1)/(z+1).

    Examples:

    The analog pole at -1 maps to z = 1/3 at fs = 1:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import bilinear_zpk
    >>> z, p, k = bilinear_zpk(np.asarray([]), np.asarray([-1.0 + 0j]), 1.0,
    ...                        fs=1.0)
    >>> np.round(p, 4), round(float(k), 4)
    (array([0.3333+0.j]), 0.3333)
    """
    z, p = np.asarray(z, dtype=complex), np.asarray(p, dtype=complex)
    d = _degree(z, p)
    fs2 = 2.0 * fs
    z_d = (fs2 + z) / (fs2 - z)
    p_d = (fs2 + p) / (fs2 - p)
    z_d = np.append(z_d, -np.ones(d))
    k_d = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return z_d, p_d, float(k_d)


# ------------------------------------------------------------- conversions

def _real_if_conjugate(poly_coeffs, tol=1e-10):
    c = np.asarray(poly_coeffs)
    if np.iscomplexobj(c) and np.max(np.abs(c.imag)) <= tol * max(
        1.0, np.max(np.abs(c.real))
    ):
        return c.real
    return c


def zpk2tf(z, p, k):
    """(zeros, poles, gain) -> (b, a) polynomial coefficients.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import zpk2tf
    >>> b, a = zpk2tf([1.0], [0.5, 0.25], 2.0)
    >>> np.round(b, 4), np.round(a, 4)
    (array([ 2., -2.]), array([ 1.   , -0.75 ,  0.125]))
    """
    b = k * np.atleast_1d(np.poly(np.asarray(z, dtype=complex)))
    a = np.atleast_1d(np.poly(np.asarray(p, dtype=complex)))
    return _real_if_conjugate(b), _real_if_conjugate(a)


def tf2zpk(b, a):
    """(b, a) -> (zeros, poles, gain).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import tf2zpk
    >>> z, p, k = tf2zpk([1.0, -1.0], [1.0, -0.25])
    >>> np.asarray(z), np.asarray(p), float(k)
    (array([1.]), array([0.25]), 1.0)
    """
    b = np.atleast_1d(np.asarray(b, dtype=np.float64) if not np.iscomplexobj(b)
                      else np.asarray(b))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64) if not np.iscomplexobj(a)
                      else np.asarray(a))
    b, a = np.trim_zeros(b, "f"), np.trim_zeros(a, "f")
    k = b[0] / a[0]
    z = np.roots(b / b[0]) if len(b) > 1 else np.array([], dtype=complex)
    p = np.roots(a / a[0]) if len(a) > 1 else np.array([], dtype=complex)
    return z, p, float(k.real) if not np.iscomplexobj(np.asarray(k)) else k


def _split_conj_pairs(roots, tol=1e-8):
    """Split roots into (conjugate/real pairs, leftover real singles). Each
    pair keeps real coefficients when expanded."""
    roots = np.asarray(roots, dtype=complex)
    real = sorted(
        [r.real for r in roots if abs(r.imag) <= tol * max(1.0, abs(r))],
    )
    cplx = [r for r in roots if abs(r.imag) > tol * max(1.0, abs(r))]
    upper = sorted([r for r in cplx if r.imag > 0], key=lambda r: (r.real, r.imag))
    lower = sorted([r for r in cplx if r.imag < 0], key=lambda r: (r.real, -r.imag))
    if len(upper) != len(lower):
        raise ValueError("complex roots do not form conjugate pairs")
    pairs = [(u, complex(l)) for u, l in zip(upper, lower)]
    # pair real roots greedily by proximity
    real_pairs = []
    real = list(real)
    while len(real) >= 2:
        r = real.pop(0)
        j = int(np.argmin([abs(r - s) for s in real]))
        real_pairs.append((complex(r), complex(real.pop(j))))
    singles = [complex(r) for r in real]
    return pairs + real_pairs, singles


def zpk2sos(z, p, k):
    """zpk -> second-order sections (n_sections, 6). Pairing: poles closest
    to the unit circle matched with nearest zeros, placed last (see module
    docstring; the cascaded transfer function equals scipy's).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import zpk2sos
    >>> np.round(zpk2sos([1.0, -1.0], [0.5j, -0.5j], 1.0), 4)
    array([[ 1.  ,  0.  , -1.  ,  1.  ,  0.  ,  0.25]])
    """
    z = np.asarray(z, dtype=complex)
    p = np.asarray(p, dtype=complex)
    if len(z) > len(p):
        raise ValueError("cannot have more zeros than poles in sos form")
    n = max(len(z), len(p))
    z = np.append(z, np.zeros(n - len(z), dtype=complex))
    p = np.append(p, np.zeros(n - len(p), dtype=complex))
    if n == 0:
        return np.array([[k, 0.0, 0.0, 1.0, 0.0, 0.0]])
    if n % 2:
        z = np.append(z, 0.0)
        p = np.append(p, 0.0)
        n += 1
    p_pairs, p_singles = _split_conj_pairs(p)
    z_pairs, z_singles = _split_conj_pairs(z)
    # promote leftover singles into pairs (padding happened above so counts
    # are even; singles only arise from odd real-root counts, which the
    # origin padding makes even)
    assert not p_singles and not z_singles, "internal pairing error"

    # order pole pairs by closeness to the unit circle (highest Q first)
    def circle_dist(pair):
        return min(abs(1.0 - abs(pair[0])), abs(1.0 - abs(pair[1])))

    p_order = sorted(range(len(p_pairs)), key=lambda i: circle_dist(p_pairs[i]))
    sections = []
    z_remaining = list(z_pairs)
    for idx in p_order:
        pp = p_pairs[idx]
        if z_remaining:
            dists = [abs(zz[0] - pp[0]) + abs(zz[1] - pp[1]) for zz in z_remaining]
            zz = z_remaining.pop(int(np.argmin(dists)))
        else:
            zz = (0.0 + 0j, 0.0 + 0j)
        b = np.real(np.poly(np.array(zz)))
        a = np.real(np.poly(np.array(pp)))
        sections.append(np.concatenate([b, a]))
    sections.reverse()  # highest-Q (closest to circle) last
    sos = np.asarray(sections, dtype=np.float64)
    sos[0, :3] *= k
    return sos


def tf2sos(b, a):
    """(b, a) -> second-order sections.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import tf2sos
    >>> np.round(tf2sos([1.0, 0.0, -1.0], [1.0, 0.0, 0.25]), 4)
    array([[ 1.  ,  0.  , -1.  ,  1.  ,  0.  ,  0.25]])
    """
    return zpk2sos(*tf2zpk(b, a))


def sos2tf(sos):
    """Second-order sections -> (b, a).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import sos2tf
    >>> b, a = sos2tf([[1.0, 0.0, -1.0, 1.0, 0.0, 0.25]])
    >>> np.round(b, 4), np.round(a, 4)
    (array([ 1.,  0., -1.]), array([1.  , 0.  , 0.25]))
    """
    sos = np.asarray(sos, dtype=np.float64)
    b, a = np.array([1.0]), np.array([1.0])
    for s in range(sos.shape[0]):
        b = np.polymul(b, np.trim_zeros(sos[s, :3], "b") if
                       np.any(sos[s, :3]) else sos[s, :1])
        a = np.polymul(a, np.trim_zeros(sos[s, 3:], "b") if
                       np.any(sos[s, 3:]) else sos[s, 3:4])
    return b, a


def sos2zpk(sos):
    """Second-order sections -> (z, p, k) — scipy.signal.sos2zpk semantics:
    every section contributes exactly two roots (sections with a shorter
    actual polynomial are padded with roots at the origin), so len(z) ==
    len(p) == 2 * n_sections.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import sos2zpk
    >>> z, p, k = sos2zpk([[1.0, 0.0, -1.0, 1.0, 0.0, 0.25]])
    >>> np.round(np.asarray(z), 4), float(k)
    (array([-1.+0.j,  1.+0.j]), 1.0)
    """
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos array must be shape (n_sections, 6)")
    n_sections = sos.shape[0]
    z = np.zeros(2 * n_sections, np.complex128)
    p = np.zeros(2 * n_sections, np.complex128)
    k = 1.0
    for s in range(n_sections):
        zs, ps, ks = tf2zpk(sos[s, :3], sos[s, 3:])
        z[2 * s : 2 * s + len(zs)] = zs
        p[2 * s : 2 * s + len(ps)] = ps
        k *= ks
    return z, p, k


def _lp2_tf(b, a, zpk_transform, *args):
    """tf-domain lowpass transform routed through the zpk form: the root-
    level transforms (lp2*_zpk above) are numerically robust where direct
    polynomial coefficient manipulation loses digits at high order."""
    from nx_signal_tpu.ops.ltisys import normalize

    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    z, p, k = tf2zpk(b, a)
    z2, p2, k2 = zpk_transform(z, p, k, *args)
    return normalize(*zpk2tf(z2, p2, k2))


def lp2lp(b, a, wo=1.0):
    """Lowpass-to-lowpass cutoff transform of an analog (b, a) transfer
    function, s -> s/wo — scipy.signal.lp2lp semantics (via lp2lp_zpk).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import lp2lp
    >>> b, a = lp2lp([1.0], [1.0, 1.0], wo=2.0)
    >>> np.round(b, 4), np.round(a, 4)
    (array([2.]), array([1., 2.]))
    """
    return _lp2_tf(b, a, lp2lp_zpk, float(wo))


def lp2hp(b, a, wo=1.0):
    """Lowpass-to-highpass transform, s -> wo/s — scipy.signal.lp2hp
    semantics (via lp2hp_zpk).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import lp2hp
    >>> b, a = lp2hp([1.0], [1.0, 1.0], wo=2.0)
    >>> np.round(b, 4), np.round(a, 4)
    (array([1., 0.]), array([1., 2.]))
    """
    return _lp2_tf(b, a, lp2hp_zpk, float(wo))


def lp2bp(b, a, wo=1.0, bw=1.0):
    """Lowpass-to-bandpass transform, s -> (s^2 + wo^2)/(bw*s) —
    scipy.signal.lp2bp semantics (via lp2bp_zpk).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import lp2bp
    >>> b, a = lp2bp([1.0], [1.0, 1.0], wo=2.0, bw=1.0)
    >>> np.round(b, 4), np.round(a, 4)
    (array([1., 0.]), array([1., 1., 4.]))
    """
    return _lp2_tf(b, a, lp2bp_zpk, float(wo), float(bw))


def lp2bs(b, a, wo=1.0, bw=1.0):
    """Lowpass-to-bandstop transform, s -> (bw*s)/(s^2 + wo^2) —
    scipy.signal.lp2bs semantics (via lp2bs_zpk).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import lp2bs
    >>> b, a = lp2bs([1.0], [1.0, 1.0], wo=2.0, bw=0.5)
    >>> np.round(np.asarray(b), 4), np.round(np.asarray(a), 4)
    (array([1., 0., 4.]), array([1. , 0.5, 4. ]))
    """
    return _lp2_tf(b, a, lp2bs_zpk, float(wo), float(bw))


# ------------------------------------------------------------ top-level API

_PROTOTYPES = {
    "butter": lambda n, rp, rs: buttap(n),
    "cheby1": lambda n, rp, rs: cheb1ap(n, rp),
    "cheby2": lambda n, rp, rs: cheb2ap(n, rs),
    "ellip": lambda n, rp, rs: ellipap(n, rp, rs),
    "bessel": lambda n, rp, rs: besselap(n),
}

_BTYPES = {
    "low": "lowpass", "lowpass": "lowpass",
    "high": "highpass", "highpass": "highpass",
    "band": "bandpass", "bandpass": "bandpass",
    "bandstop": "bandstop", "stop": "bandstop", "bs": "bandstop",
}


def _output_from_zpk(z, p, k, output):
    if output == "zpk":
        return z, p, k
    if output == "ba":
        return zpk2tf(z, p, k)
    if output == "sos":
        return zpk2sos(z, p, k)
    raise ValueError(f"output must be 'ba', 'zpk', or 'sos', got {output!r}")


def iirfilter(n, wn, rp=None, rs=None, btype="lowpass", analog=False,
              ftype="butter", output="ba", fs=None):
    """IIR filter design — scipy.signal.iirfilter semantics: analog
    prototype -> frequency transform (with tan pre-warping for digital) ->
    bilinear transform. `wn` is in half-cycles/sample (Nyquist = 1) unless
    `fs` is given (then in the same units as fs) or `analog=True` (rad/s).
    New relative to the reference (nx_signal has no IIR design).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import iirfilter
    >>> b, a = iirfilter(2, 0.3, ftype="butter")
    >>> np.round(np.asarray(b), 4)
    array([0.1311, 0.2622, 0.1311])
    >>> np.round(np.asarray(a), 4)
    array([ 1.    , -0.7478,  0.2722])
    """
    ftype = ftype.lower()
    if ftype not in _PROTOTYPES:
        raise ValueError(
            f"ftype must be one of {sorted(_PROTOTYPES)}, got {ftype!r}"
        )
    if btype.lower() not in _BTYPES:
        raise ValueError(f"invalid btype {btype!r}")
    btype = _BTYPES[btype.lower()]
    if ftype in ("cheby1", "ellip") and rp is None:
        raise ValueError("passband ripple (rp) must be provided")
    if ftype in ("cheby2", "ellip") and rs is None:
        raise ValueError("stopband attenuation (rs) must be provided")

    wn = np.atleast_1d(np.asarray(wn, dtype=np.float64))
    if fs is not None:
        if analog:
            raise ValueError("fs cannot be specified for an analog filter")
        wn = 2.0 * wn / fs
    if btype in ("lowpass", "highpass"):
        if wn.size != 1:
            raise ValueError(f"{btype} filter requires a scalar critical frequency")
    else:
        if wn.size != 2:
            raise ValueError(f"{btype} filter requires two critical frequencies")
        if wn[0] >= wn[1]:
            raise ValueError("Wn[0] must be less than Wn[1]")
    if not analog and (np.any(wn <= 0) or np.any(wn >= 1)):
        raise ValueError(
            "digital filter critical frequencies must be 0 < Wn < 1 "
            "(Nyquist = 1, or fs/2 when fs is given)"
        )

    z, p, k = _PROTOTYPES[ftype](int(n), rp, rs)

    if analog:
        warped = wn
    else:
        fs_internal = 2.0
        warped = 2.0 * fs_internal * np.tan(np.pi * wn / fs_internal)

    if btype == "lowpass":
        z, p, k = lp2lp_zpk(z, p, k, wo=warped[0])
    elif btype == "highpass":
        z, p, k = lp2hp_zpk(z, p, k, wo=warped[0])
    else:
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        if btype == "bandpass":
            z, p, k = lp2bp_zpk(z, p, k, wo=wo, bw=bw)
        else:
            z, p, k = lp2bs_zpk(z, p, k, wo=wo, bw=bw)

    if not analog:
        z, p, k = bilinear_zpk(z, p, k, fs=2.0)
    return _output_from_zpk(z, p, k, output)


def butter(n, wn, btype="lowpass", analog=False, output="ba", fs=None):
    """Butterworth design — scipy.signal.butter semantics.

    Examples:

    A digital 2nd-order lowpass at a quarter of Nyquist:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import butter
    >>> b, a = butter(2, 0.25)
    >>> np.round(np.asarray(b), 4)
    array([0.0976, 0.1953, 0.0976])
    >>> np.round(np.asarray(a), 4)
    array([ 1.    , -0.9428,  0.3333])

    ``output='sos'`` returns cascaded biquads (the recommended form,
    run with :func:`nx_signal_tpu.ops.iir.sosfilt`):

    >>> butter(4, 0.125, output="sos").shape
    (2, 6)
    """
    return iirfilter(n, wn, btype=btype, analog=analog, ftype="butter",
                     output=output, fs=fs)


def cheby1(n, rp, wn, btype="lowpass", analog=False, output="ba", fs=None):
    """Chebyshev type-I design — scipy.signal.cheby1 semantics.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import cheby1
    >>> b, a = cheby1(2, 1.0, 0.3)
    >>> np.round(np.asarray(b), 4)
    array([0.1382, 0.2765, 0.1382])
    >>> np.round(np.asarray(a), 4)
    array([ 1.    , -0.7735,  0.3939])
    """
    return iirfilter(n, wn, rp=rp, btype=btype, analog=analog, ftype="cheby1",
                     output=output, fs=fs)


def cheby2(n, rs, wn, btype="lowpass", analog=False, output="ba", fs=None):
    """Chebyshev type-II design — scipy.signal.cheby2 semantics.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import cheby2
    >>> b, a = cheby2(2, 40.0, 0.3)
    >>> np.round(np.asarray(b), 4)
    array([ 0.0137, -0.0087,  0.0137])
    >>> np.round(np.asarray(a), 4)
    array([ 1.    , -1.798 ,  0.8167])
    """
    return iirfilter(n, wn, rs=rs, btype=btype, analog=analog, ftype="cheby2",
                     output=output, fs=fs)


def ellip(n, rp, rs, wn, btype="lowpass", analog=False, output="ba", fs=None):
    """Elliptic (Cauer) design — scipy.signal.ellip semantics.

    Examples:

    1 dB passband ripple, 40 dB stopband attenuation:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import ellip
    >>> b, a = ellip(2, 1.0, 40.0, 0.3)
    >>> np.round(np.asarray(b), 4)
    array([0.1445, 0.2673, 0.1445])
    >>> np.round(np.asarray(a), 4)
    array([ 1.    , -0.7727,  0.3967])
    """
    return iirfilter(n, wn, rp=rp, rs=rs, btype=btype, analog=analog,
                     ftype="ellip", output=output, fs=fs)


def bessel(n, wn, btype="lowpass", analog=False, output="ba", fs=None):
    """Bessel/Thomson design (norm='phase') — scipy.signal.bessel
    semantics.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import bessel
    >>> b, a = bessel(2, 0.25)
    >>> np.round(np.asarray(b), 4)
    array([0.0908, 0.1817, 0.0908])
    >>> np.round(np.asarray(a), 4)
    array([ 1.    , -0.8771,  0.2404])
    """
    return iirfilter(n, wn, btype=btype, analog=analog, ftype="bessel",
                     output=output, fs=fs)


# ------------------------------------------------------- order selection

def _ellipk(m):
    """Complete elliptic integral K(m) via the arithmetic-geometric mean:
    K(m) = pi / (2 agm(1, sqrt(1-m))). f64-accurate for m in [0, 1)."""
    a, b = 1.0, math.sqrt(1.0 - m)
    for _ in range(60):
        if abs(a - b) < 1e-17 * a:
            break
        a, b = 0.5 * (a + b), math.sqrt(a * b)
    return math.pi / (2.0 * a)


def _ord_validate(wp, ws, analog, fs):
    wp = np.atleast_1d(np.asarray(wp, dtype=np.float64))
    ws = np.atleast_1d(np.asarray(ws, dtype=np.float64))
    if fs is not None:
        if analog:
            raise ValueError("fs cannot be specified for an analog filter")
        wp, ws = 2.0 * wp / fs, 2.0 * ws / fs
    if wp.shape != ws.shape or wp.size not in (1, 2):
        raise ValueError("wp and ws must both be scalars or both pairs")
    if not analog and (np.any(wp <= 0) or np.any(wp >= 1)
                       or np.any(ws <= 0) or np.any(ws >= 1)):
        raise ValueError("digital band edges must satisfy 0 < w < 1 "
                         "(Nyquist = 1, or fs/2 when fs is given)")
    # filter type: 1 lowpass, 2 highpass, 3 bandpass, 4 bandstop
    if wp.size == 1:
        ftype = 1 if wp[0] < ws[0] else 2
    else:
        if wp[0] < ws[0] and wp[1] > ws[1]:
            ftype = 4
        elif wp[0] > ws[0] and wp[1] < ws[1]:
            ftype = 3
        else:
            raise ValueError("passband and stopband edges must nest "
                             "(bandpass: ws outside wp; bandstop: inside)")
    return wp, ws, ftype


def _ord_selectivity(passb, stopb, ftype):
    """Equivalent lowpass-prototype selectivity ratio for each filter type."""
    if ftype == 1:
        return float(stopb[0] / passb[0])
    if ftype == 2:
        return float(passb[0] / stopb[0])
    if ftype == 3:
        nat = (stopb**2 - passb[0] * passb[1]) / (
            stopb * (passb[0] - passb[1]))
    else:
        nat = (stopb * (passb[0] - passb[1])) / (
            stopb**2 - passb[0] * passb[1])
    return float(np.min(np.abs(nat)))


def _ord_n(nat, gpass, gstop, kind):
    """Required (real-valued) order of the lowpass prototype."""
    gstop_l = 10.0 ** (0.1 * abs(gstop))
    gpass_l = 10.0 ** (0.1 * abs(gpass))
    if kind == "butter":
        return math.log10((gstop_l - 1.0) / (gpass_l - 1.0)) / (
            2.0 * math.log10(nat))
    if kind == "cheby":
        return math.acosh(math.sqrt((gstop_l - 1.0) / (gpass_l - 1.0))) / \
            math.acosh(nat)
    # elliptic: ratio of complete elliptic integral quotients
    arg1 = math.sqrt((gpass_l - 1.0) / (gstop_l - 1.0))
    arg0 = 1.0 / nat
    return (_ellipk(arg0**2) * _ellipk(1.0 - arg1**2)) / (
        _ellipk(1.0 - arg0**2) * _ellipk(arg1**2))


def _bandstop_optimize(passb, stopb, gpass, gstop, kind):
    """Bandstop passband edges can be moved inward without violating the
    spec; minimize the required order over each movable edge (scipy uses
    fminbound — here a golden-section search to 1e-10)."""
    gr = (math.sqrt(5.0) - 1.0) / 2.0

    def order_with_edge(ind, val):
        pb = passb.copy()
        pb[ind] = val
        nat = _ord_selectivity(pb, stopb, 4)
        return _ord_n(nat, gpass, gstop, kind)

    def golden(ind, lo, hi):
        a, b = lo, hi
        c, d = b - gr * (b - a), a + gr * (b - a)
        fc, fd = order_with_edge(ind, c), order_with_edge(ind, d)
        for _ in range(200):
            if abs(b - a) < 1e-10 * max(1.0, abs(b)):
                break
            if fc < fd:
                b, d, fd = d, c, fc
                c = b - gr * (b - a)
                fc = order_with_edge(ind, c)
            else:
                a, c, fc = c, d, fd
                d = a + gr * (b - a)
                fd = order_with_edge(ind, d)
        return 0.5 * (a + b)

    passb = passb.copy()
    passb[0] = golden(0, passb[0], stopb[0] - 1e-12)
    passb[1] = golden(1, stopb[1] + 1e-12, passb[1])
    return passb


def band_stop_obj(wp, ind, passb, stopb, gpass, gstop, type):
    """Band-stop objective: the (non-integer) analog band-stop filter order
    with passband edge `ind` moved to `wp` — scipy.signal.band_stop_obj
    call surface (`type` in 'butter'/'cheby'/'ellip'). This is the function
    the *ord order selectors minimize over each movable band-stop passband
    edge; exposed for scipy API parity (internally `_bandstop_optimize`
    evaluates the same selectivity/order math via golden-section search).
    Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import band_stop_obj
    >>> round(float(band_stop_obj(0.25, 0, np.array([0.2, 0.7]),
    ...       np.array([0.35, 0.5]), 3.0, 40.0, 'butter')), 4)
    4.1939
    """
    if type not in ("butter", "cheby", "ellip"):
        raise ValueError("type must be 'butter', 'cheby', or 'ellip', "
                         f"got {type!r}")
    pb = np.atleast_1d(np.asarray(passb, dtype=np.float64)).copy()
    sb = np.atleast_1d(np.asarray(stopb, dtype=np.float64))
    pb[int(ind)] = float(np.asarray(wp).reshape(-1)[0])
    nat = _ord_selectivity(pb, sb, 4)
    return _ord_n(nat, gpass, gstop, type)


def _ord_common(wp, ws, gpass, gstop, analog, fs, kind):
    wp, ws, ftype = _ord_validate(wp, ws, analog, fs)
    if analog:
        passb, stopb = wp.copy(), ws.copy()
    else:
        passb = np.tan(np.pi * wp / 2.0)
        stopb = np.tan(np.pi * ws / 2.0)
    if ftype == 4:
        passb = _bandstop_optimize(passb, stopb, gpass, gstop, kind)
    nat = _ord_selectivity(passb, stopb, ftype)
    order = int(math.ceil(_ord_n(nat, gpass, gstop, kind)))
    return wp, ws, ftype, passb, stopb, nat, order


def _unwarp(w_natural, analog, fs, scalar):
    if not analog:
        wn = (2.0 / math.pi) * np.arctan(w_natural)
    else:
        wn = np.asarray(w_natural, dtype=np.float64)
    if fs is not None:
        wn = wn * fs / 2.0
    wn = np.atleast_1d(wn)
    return float(wn[0]) if scalar else wn


def buttord(wp, ws, gpass, gstop, analog=False, fs=None):
    """Minimum Butterworth order (and the -gpass natural frequency wn to
    pass to `butter`) meeting gpass/gstop dB specs —
    scipy.signal.buttord semantics for all four band types, including the
    bandstop passband-edge optimization. Not in the reference.

    Examples:

    >>> from nx_signal_tpu.ops.iir_design import buttord
    >>> n, wn = buttord(0.2, 0.3, 3.0, 40.0)
    >>> n, round(wn, 6)
    (11, 0.20004)
    """
    scalar = np.ndim(wp) == 0
    wp, ws, ftype, passb, stopb, nat, order = _ord_common(
        wp, ws, gpass, gstop, analog, fs, "butter")
    gpass_l = 10.0 ** (0.1 * abs(gpass))
    if order == 0:
        w0 = 1.0
    else:
        w0 = (gpass_l - 1.0) ** (-1.0 / (2.0 * order))
    if ftype == 1:
        wnat = w0 * passb
    elif ftype == 2:
        wnat = passb / w0
    elif ftype == 3:
        # bandpass (scipy filter_type 4)
        w0v = np.array([-w0, w0])
        wnat = np.sort(np.abs(
            -w0v * (passb[1] - passb[0]) / 2.0
            + np.sqrt(w0v**2 / 4.0 * (passb[1] - passb[0]) ** 2
                      + passb[0] * passb[1])))
    else:
        # bandstop (scipy filter_type 3)
        discr = math.sqrt((passb[1] - passb[0]) ** 2
                          + 4.0 * w0**2 * passb[0] * passb[1])
        wnat = np.sort(np.abs(np.array([
            ((passb[1] - passb[0]) + discr) / (2.0 * w0),
            ((passb[1] - passb[0]) - discr) / (2.0 * w0),
        ])))
    return order, _unwarp(wnat, analog, fs, scalar)


def cheb1ord(wp, ws, gpass, gstop, analog=False, fs=None):
    """Minimum Chebyshev-I order and the passband edge wn —
    scipy.signal.cheb1ord semantics. Not in the reference.

    Examples:

    >>> from nx_signal_tpu.ops.iir_design import cheb1ord
    >>> n, wn = cheb1ord(0.2, 0.3, 3.0, 40.0)
    >>> n, round(float(wn), 4)
    (6, 0.2)
    """
    scalar = np.ndim(wp) == 0
    wp, ws, ftype, passb, stopb, nat, order = _ord_common(
        wp, ws, gpass, gstop, analog, fs, "cheby")
    # Chebyshev I keeps the (possibly optimized) passband edge.
    return order, _unwarp(passb, analog, fs, scalar)


def cheb2ord(wp, ws, gpass, gstop, analog=False, fs=None):
    """Minimum Chebyshev-II order and the stopband-matched wn —
    scipy.signal.cheb2ord semantics: wn is backed out so the response hits
    exactly -gstop dB at the stopband edge. Not in the reference.

    Examples:

    >>> from nx_signal_tpu.ops.iir_design import cheb2ord
    >>> n, wn = cheb2ord(0.2, 0.3, 3.0, 40.0)
    >>> n, round(float(wn), 4)
    (6, 0.2746)
    """
    scalar = np.ndim(wp) == 0
    wp, ws, ftype, passb, stopb, nat, order = _ord_common(
        wp, ws, gpass, gstop, analog, fs, "cheby")
    gstop_l = 10.0 ** (0.1 * abs(gstop))
    gpass_l = 10.0 ** (0.1 * abs(gpass))
    new_freq = 1.0 / math.cosh(
        math.acosh(math.sqrt((gstop_l - 1.0) / (gpass_l - 1.0))) / order)
    if ftype == 1:
        wnat = passb / new_freq
    elif ftype == 2:
        wnat = passb * new_freq
    elif ftype == 3:
        # bandpass (scipy filter_type 4)
        w0 = (1.0 / (2.0 * new_freq) * (passb[0] - passb[1])
              + math.sqrt((passb[1] - passb[0]) ** 2 / (4.0 * new_freq**2)
                          + passb[1] * passb[0]))
        wnat = np.array([w0, passb[0] * passb[1] / w0])
    else:
        # bandstop (scipy filter_type 3)
        w0 = (new_freq / 2.0 * (passb[0] - passb[1])
              + math.sqrt(new_freq**2 * (passb[1] - passb[0]) ** 2 / 4.0
                          + passb[1] * passb[0]))
        wnat = np.array([w0, passb[1] * passb[0] / w0])
    wnat = np.sort(np.abs(np.atleast_1d(wnat)))
    return order, _unwarp(wnat, analog, fs, scalar)


def ellipord(wp, ws, gpass, gstop, analog=False, fs=None):
    """Minimum elliptic order and the passband edge wn —
    scipy.signal.ellipord semantics (complete-elliptic-integral degree
    equation, K(m) by AGM). Not in the reference.

    Examples:

    >>> from nx_signal_tpu.ops.iir_design import ellipord
    >>> n, wn = ellipord(0.2, 0.3, 3.0, 40.0)
    >>> n, round(float(wn), 4)
    (4, 0.2)
    """
    scalar = np.ndim(wp) == 0
    wp, ws, ftype, passb, stopb, nat, order = _ord_common(
        wp, ws, gpass, gstop, analog, fs, "ellip")
    return order, _unwarp(passb, analog, fs, scalar)


_ORD_FOR_FTYPE = {
    "butter": buttord,
    "cheby1": cheb1ord,
    "cheby2": cheb2ord,
    "ellip": ellipord,
}


def iirdesign(wp, ws, gpass, gstop, analog=False, ftype="ellip", output="ba",
              fs=None):
    """Complete IIR design from band specs — scipy.signal.iirdesign
    semantics: pick the minimum order with the matching *ord function, then
    design with `iirfilter`. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import iirdesign
    >>> sos = iirdesign(0.2, 0.3, 1.0, 40.0, output='sos')
    >>> np.asarray(sos).shape   # minimum-order design: 2 biquads
    (2, 6)
    """
    if ftype not in _ORD_FOR_FTYPE:
        raise ValueError(
            f"ftype must be one of {sorted(_ORD_FOR_FTYPE)}, got {ftype!r}"
        )
    wp_a = np.atleast_1d(np.asarray(wp, dtype=np.float64))
    ws_a = np.atleast_1d(np.asarray(ws, dtype=np.float64))
    if wp_a.size == 1:
        btype = "lowpass" if wp_a[0] < ws_a[0] else "highpass"
    elif wp_a[0] > ws_a[0]:
        btype = "bandpass"
    else:
        btype = "bandstop"
    order, wn = _ORD_FOR_FTYPE[ftype](wp, ws, gpass, gstop, analog=analog,
                                      fs=fs)
    return iirfilter(order, wn, rp=gpass, rs=gstop, btype=btype,
                     analog=analog, ftype=ftype, output=output, fs=fs)


def iircomb(w0, q, ftype="notch", fs=2.0, *, pass_zero: bool = False):
    """Comb filter notching (or peaking) at w0 and all its harmonics —
    scipy.signal.iircomb semantics: order N = fs/w0 must be an integer;
    the single-section prototype gains place -3 dB points w0/q apart.
    `pass_zero=True` shifts the comb to odd harmonics (notches between the
    harmonics of w0). Returns (b, a). Not in the reference.

    Examples:

    An order-8 comb (w0 = 0.25 of Nyquist=1) has taps only at 0 and 8:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import iircomb
    >>> b, a = iircomb(0.25, 30.0)
    >>> np.round(np.asarray(b)[[0, 8]], 4), np.round(np.asarray(a)[[0, 8]], 4)
    (array([ 0.9502, -0.9502]), array([ 1.    , -0.9004]))
    """
    if ftype not in ("notch", "peak"):
        raise ValueError("ftype must be 'notch' or 'peak'")
    w0 = float(w0)
    if not 0 < w0 < fs / 2.0:
        raise ValueError("w0 must be between 0 and fs/2")
    n = fs / w0
    if abs(n - round(n)) > 1e-9 * n:
        raise ValueError("w0 must divide fs evenly")
    n = int(round(n))
    w0_rad = (2.0 * math.pi * w0) / fs
    w_delta = w0_rad / q
    # Base gains depend on ftype only; with gb = 1/sqrt(2) the
    # sqrt((gb^2-g0^2)/(g^2-gb^2)) factor is exactly 1 for both choices.
    if ftype == "notch":
        g0, g = 1.0, 0.0
    else:
        g0, g = 0.0, 1.0
    beta = math.tan(n * w_delta / 4.0)
    ax = (1.0 - beta) / (1.0 + beta)
    bx = (g0 + g * beta) / (1.0 + beta)
    cx = (g0 - g * beta) / (1.0 + beta)
    # Negative last coefficients give the peaking comb that passes zero or
    # the notching comb that doesn't (scipy's negative_coef rule).
    negative = (ftype == "notch") != pass_zero
    sgn = -1.0 if negative else 1.0
    b = np.zeros(n + 1)
    a = np.zeros(n + 1)
    b[0] = bx
    b[-1] = sgn * cx
    a[0] = 1.0
    a[-1] = sgn * ax
    return b, a


def _design_notch_peak(w0, q, kind, fs=2.0):
    w0 = 2.0 * w0 / fs
    if not 0 < w0 < 1:
        raise ValueError("w0 should be such that 0 < w0 < 1")
    bw = w0 / q * np.pi
    w0 = w0 * np.pi
    gb = 1.0 / np.sqrt(2.0)
    if kind == "notch":
        beta = (np.sqrt(1.0 - gb ** 2) / gb) * np.tan(bw / 2.0)
    else:
        beta = (gb / np.sqrt(1.0 - gb ** 2)) * np.tan(bw / 2.0)
    gain = 1.0 / (1.0 + beta)
    if kind == "notch":
        b = gain * np.array([1.0, -2.0 * np.cos(w0), 1.0])
    else:
        b = (1.0 - gain) * np.array([1.0, 0.0, -1.0])
    a = np.array([1.0, -2.0 * gain * np.cos(w0), 2.0 * gain - 1.0])
    return b, a


def iirnotch(w0, q, fs=2.0):
    """Second-order notch filter — scipy.signal.iirnotch semantics.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import iirnotch
    >>> b, a = iirnotch(0.25, 30.0)
    >>> np.round(np.asarray(b), 4)
    array([ 0.9871, -1.3959,  0.9871])
    >>> np.round(np.asarray(a), 4)
    array([ 1.    , -1.3959,  0.9742])
    """
    return _design_notch_peak(w0, q, "notch", fs)


def iirpeak(w0, q, fs=2.0):
    """Second-order peak (resonator) filter — scipy.signal.iirpeak
    semantics.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir_design import iirpeak
    >>> b, a = iirpeak(0.25, 30.0)
    >>> np.round(np.asarray(b), 4)
    array([ 0.0129,  0.    , -0.0129])
    """
    return _design_notch_peak(w0, q, "peak", fs)
