"""FIR filter design beyond the window method.

The reference stops at `firwin` (lib/nx_signal/filters.ex:147-279); scipy
users expect the rest of the design surface. This module adds, with
scipy.signal semantics:

- Kaiser-method sizing: `kaiser_beta`, `kaiser_atten`, `kaiserord`
- Arbitrary-response window design: `firwin2`
- Least-squares linear-phase design: `firls`
- Equiripple (Parks-McClellan / Remez exchange) design: `remez`
- Minimum-phase conversion: `minimum_phase`

All of it is design-time math on tiny tensors: computed in float64 numpy on
host (so results fold into jit traces as constants) and returned as device
arrays in the package default dtype. Accuracy is what matters here, not
device throughput — the designed taps then feed the device FIR paths
(ops/convolution.py: fir_convolve_1d).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

from nx_signal_tpu.ops.windows import get_window
from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT

__all__ = [
    "kaiser_beta",
    "kaiser_atten",
    "kaiserord",
    "firwin2",
    "firls",
    "remez",
    "minimum_phase",
]


def kaiser_beta(a: float) -> float:
    """Kaiser window beta for `a` dB of sidelobe attenuation — Kaiser's
    empirical formula (scipy.signal.kaiser_beta semantics). Not in the
    reference (its firwin takes beta directly, filters.ex:268-271).

    Examples:

    >>> from nx_signal_tpu.ops.fir_design import kaiser_beta
    >>> round(kaiser_beta(65.0), 5)
    6.20426
    """
    if a > 50:
        return 0.1102 * (a - 8.7)
    if a > 21:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    return 0.0


def kaiser_atten(numtaps: int, width: float) -> float:
    """Attenuation (dB) of a Kaiser-designed filter with `numtaps` taps and
    transition width `width` (fraction of Nyquist) —
    scipy.signal.kaiser_atten semantics. Not in the reference.

    Examples:

    >>> from nx_signal_tpu.ops.fir_design import kaiser_atten
    >>> round(kaiser_atten(81, 0.1), 4)
    65.3783
    """
    return 2.285 * (numtaps - 1) * math.pi * width + 7.95


def kaiserord(ripple: float, width: float):
    """(numtaps, beta) meeting `ripple` dB ripple/attenuation with transition
    width `width` (fraction of Nyquist) — scipy.signal.kaiserord semantics,
    including the odd result parity guarantee. Not in the reference.

    Examples:

    65 dB of attenuation over a tenth-of-Nyquist transition:

    >>> from nx_signal_tpu.ops.fir_design import kaiserord
    >>> numtaps, beta = kaiserord(65.0, 0.1)
    >>> numtaps, round(beta, 5)
    (81, 6.20426)
    """
    a = abs(ripple)
    if a < 8:
        raise ValueError(
            "Requested maximum ripple attenuation is too small for the "
            "Kaiser formula (need at least 8 dB)."
        )
    beta = kaiser_beta(a)
    numtaps = (a - 7.95) / 2.285 / (math.pi * width) + 1
    return int(math.ceil(numtaps)), beta


def firwin2(numtaps: int, freq, gain, *, nfreqs=None, window="hamming",
            antisymmetric: bool = False, sampling_rate: float = 2.0,
            dtype=DEFAULT_FLOAT):
    """FIR design from an arbitrary piecewise-linear magnitude response —
    scipy.signal.firwin2 semantics: interpolate (freq, gain) onto a dense
    grid, apply the linear-phase (and, for types 3/4, 90-degree) shift,
    inverse-rFFT, truncate to `numtaps`, window. Not in the reference
    (extends filters.ex:147-279 beyond multiband-brickwall responses).

    Examples:

    A lowpass whose gain falls linearly from 1 at half-band to 0 at
    Nyquist:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.fir_design import firwin2
    >>> h = firwin2(5, [0.0, 0.5, 1.0], [1.0, 1.0, 0.0])
    >>> np.round(np.asarray(h), 4)
    array([-0.0085,  0.1108,  0.75  ,  0.1108, -0.0085], dtype=float32)
    """
    nyq = 0.5 * sampling_rate
    freq = np.asarray(freq, dtype=np.float64)
    gain = np.asarray(gain, dtype=np.float64)
    if freq.ndim != 1 or freq.shape != gain.shape:
        raise ValueError("freq and gain must be 1-D arrays of the same length")
    if freq[0] != 0 or freq[-1] != nyq:
        raise ValueError(
            f"freq must start with 0 and end with the Nyquist frequency {nyq}"
        )
    d = np.diff(freq)
    if (d < 0).any():
        raise ValueError("freq must be nondecreasing")
    d2 = d[:-1] + d[1:]
    if (d2 == 0).any():
        raise ValueError("a value in freq must not occur more than twice")
    if freq[1] == 0:
        raise ValueError("freq cannot contain numerous values equal to 0")
    if freq[-2] == nyq:
        raise ValueError(
            "freq cannot contain numerous values equal to the Nyquist frequency"
        )

    if antisymmetric:
        ftype = 3 if numtaps % 2 else 4
    else:
        ftype = 1 if numtaps % 2 else 2
    if ftype == 2 and gain[-1] != 0.0:
        raise ValueError(
            "a Type II filter (even taps, symmetric) must have zero gain at "
            "the Nyquist frequency"
        )
    if ftype == 3 and (gain[0] != 0.0 or gain[-1] != 0.0):
        raise ValueError(
            "a Type III filter (odd taps, antisymmetric) must have zero gain "
            "at zero and Nyquist frequencies"
        )
    if ftype == 4 and gain[0] != 0.0:
        raise ValueError(
            "a Type IV filter (even taps, antisymmetric) must have zero gain "
            "at the zero frequency"
        )

    if nfreqs is None:
        nfreqs = 1 + 2 ** int(math.ceil(math.log2(numtaps)))
    if numtaps >= nfreqs:
        raise ValueError("nfreqs must be greater than numtaps")

    # Nudge repeated frequencies apart by eps so interpolation sees a step.
    if (d == 0).any():
        freq = freq.copy()
        eps = np.finfo(np.float64).eps * nyq
        for k in range(len(d)):
            if d[k] == 0:
                freq[k] -= eps
                freq[k + 1] += eps
        if (np.diff(freq) <= 0).any():
            raise ValueError(
                "freq cannot contain numerous values occurring more than twice"
            )

    x = np.linspace(0.0, nyq, nfreqs)
    fx = np.interp(x, freq, gain)
    # Linear-phase shift; types 3/4 add the Hilbert 90-degree factor.
    shift = np.exp(-(numtaps - 1) / 2.0 * 1j * math.pi * x / nyq)
    if ftype > 2:
        shift *= 1j
    out_full = np.fft.irfft(fx * shift)
    win_dtype = jnp.float64 if jax.config.jax_enable_x64 else DEFAULT_FLOAT
    win = np.asarray(get_window(window, numtaps, periodic=False,
                                dtype=win_dtype), dtype=np.float64)
    out = out_full[:numtaps] * win
    if ftype == 3:
        out[numtaps // 2] = 0.0
    return jnp.asarray(out, dtype=dtype)


def firls(numtaps: int, bands, desired, *, weight=None,
          sampling_rate: float = 2.0, dtype=DEFAULT_FLOAT):
    """Least-squares linear-phase (Type I) FIR design —
    scipy.signal.firls semantics: minimize the weighted integrated squared
    error against a piecewise-linear desired response over the given bands.
    Closed form: the normal equations Q g = b with Q built from band
    integrals of cos(pi k x) cos(pi j x) (a Toeplitz + Hankel pair) and b
    from the linear desired response, solved in f64. Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.fir_design import firls
    >>> h = firls(5, [0.0, 0.3, 0.4, 1.0], [1.0, 1.0, 0.0, 0.0])
    >>> np.round(np.asarray(h), 4)
    array([0.1265, 0.2786, 0.3451, 0.2786, 0.1265], dtype=float32)
    """
    numtaps = int(numtaps)
    if numtaps % 2 == 0 or numtaps < 1:
        raise ValueError("numtaps must be odd and >= 1")
    m = (numtaps - 1) // 2
    nyq = 0.5 * sampling_rate
    bands = np.asarray(bands, dtype=np.float64).flatten() / nyq
    if bands.size % 2:
        raise ValueError("bands must contain frequency pairs")
    if (bands < 0).any() or (bands > 1).any():
        raise ValueError("bands must be within [0, Nyquist]")
    bands = bands.reshape(-1, 2)
    if (np.diff(bands.ravel()) <= 0).any():
        raise ValueError("bands must be monotonically nondecreasing and non-overlapping")
    desired = np.asarray(desired, dtype=np.float64).flatten()
    if desired.size != bands.size:
        raise ValueError("desired must have one entry per band edge (2 per band)")
    desired = desired.reshape(-1, 2)
    if weight is None:
        weight = np.ones(len(desired))
    weight = np.asarray(weight, dtype=np.float64).flatten()
    if weight.size != len(desired):
        raise ValueError("weight must have one entry per band")

    x1, x2 = bands[:, 0], bands[:, 1]  # normalized: 1.0 == Nyquist
    # q[k] = sum_bands W * integral cos(pi k x) dx = W (x2 sinc(k x2) - x1 sinc(k x1))
    k = np.arange(numtaps)[:, None]
    q = ((np.sinc(k * x2) * x2 - np.sinc(k * x1) * x1) * weight).sum(axis=1)
    # Q[i, j] = 0.5 (q[|i-j|] + q[i+j]) for the cos(pi i x) basis
    i = np.arange(m + 1)
    qm = 0.5 * (q[np.abs(i[:, None] - i[None, :])] + q[i[:, None] + i[None, :]])

    # b[i] = sum_bands W * integral (m x + c) cos(pi i x) dx with the desired
    # response linear over each band: term1 = (m x + c) x sinc(i x) at the
    # edges, term2 = m (cos(pi i x2) - cos(pi i x1)) / (pi i)^2 (i > 0).
    slope = (desired[:, 1] - desired[:, 0]) / np.where(x2 == x1, 1.0, x2 - x1)
    const = desired[:, 0] - slope * x1
    iv = i[1:, None]
    term1 = ((slope * x2 + const) * x2 * np.sinc(iv * x2)
             - (slope * x1 + const) * x1 * np.sinc(iv * x1))
    term2 = slope * (np.cos(np.pi * iv * x2) - np.cos(np.pi * iv * x1)) \
        / (np.pi * iv) ** 2
    b = np.empty(m + 1)
    b[0] = (weight * (slope * (x2**2 - x1**2) / 2.0 + const * (x2 - x1))).sum()
    b[1:] = ((term1 + term2) * weight).sum(axis=1)

    g = np.linalg.lstsq(qm, b, rcond=None)[0]
    h = np.concatenate([g[m:0:-1] / 2.0, g[:1], g[1:] / 2.0])
    return jnp.asarray(h, dtype=dtype)


def _remez_dense_grid(bands, grid_density, r):
    """Dense frequency grid over the union of bands, plus per-point desired
    response and weight (desired is constant per band, scipy remez style)."""
    delf = 0.5 / (grid_density * r)
    grid, band_id = [], []
    for bi, (lo, hi) in enumerate(bands):
        n_pts = max(int(math.ceil((hi - lo) / delf)) + 1, 2)
        g = np.linspace(lo, hi, n_pts)
        grid.append(g)
        band_id.append(np.full(n_pts, bi))
    return np.concatenate(grid), np.concatenate(band_id)


def remez(numtaps: int, bands, desired, *, weight=None, maxiter: int = 250,
          grid_density: int = 16, sampling_rate: float = 2.0,
          dtype=DEFAULT_FLOAT):
    """Equiripple (minimax) FIR design by the Parks-McClellan Remez exchange —
    scipy.signal.remez semantics for the 'bandpass' (symmetric) filter type:
    `bands` is a flat list of band edges in the units of `sampling_rate`,
    `desired` one gain per band, `weight` one weight per band.

    Implementation: barycentric-Lagrange interpolation on the Chebyshev
    abscissa x = cos(pi f'), alternation-enforcing multiple-exchange of the
    r+1 extremal frequencies on a dense grid, then tap recovery by inverse
    DFT of the converged response. Even `numtaps` (Type II) is handled with
    the cos(pi f'/2) factorization. f64 host math. Not in the reference.

    Intentional deviations from scipy.signal.remez:
    - Even `numtaps` with nonzero desired gain in a band touching Nyquist
      raises ValueError (a Type II filter is structurally zero at Nyquist,
      so the spec is unmeetable); scipy silently designs the degenerate
      filter instead.
    - The exchange converges to a (valid) equiripple solution whose
      magnitude response can differ from scipy's C implementation by up to
      ~3e-4 — both are minimax-optimal to their own grid/stopping rule, so
      tap-level parity tests use a 1e-3 gate rather than the default 1e-4.

    Examples:

    A 7-tap lowpass (pass to 0.2, stop from 0.3, edges in cycles/sample
    with ``sampling_rate=1.0``):

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.fir_design import remez
    >>> h = remez(7, [0.0, 0.2, 0.3, 0.5], [1.0, 0.0], sampling_rate=1.0)
    >>> np.round(np.asarray(h), 4)
    array([-0.1196,  0.    ,  0.3131,  0.5   ,  0.3131, -0.    , -0.1196],
          dtype=float32)
    """
    numtaps = int(numtaps)
    if numtaps < 3:
        raise ValueError("numtaps must be >= 3")
    bands = np.asarray(bands, dtype=np.float64).flatten() / sampling_rate
    if bands.size % 2:
        raise ValueError("bands must contain frequency pairs")
    if (np.diff(bands) < 0).any() or (bands < 0).any() or (bands > 0.5).any():
        raise ValueError("bands must be nondecreasing within [0, sampling_rate/2]")
    bands = bands.reshape(-1, 2)
    desired = np.asarray(desired, dtype=np.float64).flatten()
    if desired.size != len(bands):
        raise ValueError("desired must have one gain per band")
    if weight is None:
        weight = np.ones(len(bands))
    weight = np.asarray(weight, dtype=np.float64).flatten()
    if weight.size != len(bands):
        raise ValueError("weight must have one weight per band")

    odd = numtaps % 2 == 1
    if not odd and desired[np.isclose(bands[:, 1], 0.5)].any():
        raise ValueError(
            "a Type II filter (even numtaps) must have zero gain at Nyquist; "
            "use odd numtaps"
        )
    # Number of cosine-basis coefficients in the approximation P(f).
    r = (numtaps + 1) // 2 if odd else numtaps // 2

    grid, band_id = _remez_dense_grid(bands, grid_density, r)
    dgrid = desired[band_id]
    wgrid = weight[band_id]
    if not odd:
        # Type II: H(f) = cos(pi f) P(f) on the half-integer basis. Divide the
        # desired response and fold the factor into the weight. Nudge any
        # grid point sitting exactly at Nyquist inward (Q(0.5) = 0 there,
        # reachable only in a zero-gain band).
        grid = np.where(np.isclose(grid, 0.5), 0.5 - 1e-9, grid)
        qfac = np.cos(np.pi * grid)
        dgrid = dgrid / qfac
        wgrid = wgrid * qfac

    npts = grid.size
    if npts <= r + 1:
        raise ValueError("grid too coarse for the requested numtaps; "
                         "increase grid_density or band widths")

    # Initial extremal guess: r+1 points spread evenly across the grid.
    ext = np.round(np.linspace(0, npts - 1, r + 1)).astype(int)

    x_grid = np.cos(2.0 * np.pi * grid)
    last_delta = None
    for _ in range(maxiter):
        xe = x_grid[ext]
        de = dgrid[ext]
        we = wgrid[ext]
        # Barycentric weights on the extremal abscissae.
        diff = xe[:, None] - xe[None, :]
        np.fill_diagonal(diff, 1.0)
        # Scale to keep products finite (classic PM trick: 2^k normalization).
        gamma = 1.0 / np.prod(diff * 2.0, axis=1)
        signs = (-1.0) ** np.arange(r + 1)
        delta = np.dot(gamma, de) / np.dot(gamma, signs / we)
        # Interpolate P through the r+1 points with the leveled error removed.
        ce = de - delta * signs / we
        # Barycentric evaluation of P on the whole grid.
        num = np.zeros(npts)
        den = np.zeros(npts)
        exact = np.full(npts, -1, dtype=int)
        for k_ in range(r + 1):
            dx = x_grid - xe[k_]
            hitk = dx == 0.0
            exact[hitk] = k_
            dx[hitk] = 1.0
            t = gamma[k_] / dx
            num += t * ce[k_]
            den += t
        p = num / den
        p[exact >= 0] = ce[exact[exact >= 0]]
        err = wgrid * (dgrid - p)

        # Multiple exchange: all local extrema of the signed error plus band
        # endpoints, then alternation enforced by keeping the largest |err|
        # within each same-sign run.
        e = err
        interior = np.nonzero(
            ((e[1:-1] > e[:-2]) & (e[1:-1] >= e[2:]))
            | ((e[1:-1] < e[:-2]) & (e[1:-1] <= e[2:]))
        )[0] + 1
        edges = np.nonzero(np.diff(band_id) != 0)[0]
        keep = np.unique(np.concatenate(
            [[0], interior, edges, edges + 1, [npts - 1]]))
        sgn = np.sign(err[keep])
        groups = []
        start = 0
        for idx in range(1, keep.size):
            if sgn[idx] != sgn[idx - 1]:
                groups.append(keep[start:idx])
                start = idx
        groups.append(keep[start:])
        new_ext = np.array([g[np.argmax(np.abs(err[g]))] for g in groups])
        # Trim to exactly r+1 alternations: drop the smaller-error end first.
        while new_ext.size > r + 1:
            if new_ext.size - (r + 1) >= 2:
                # Drop whichever end pair loses less peak error.
                if max(abs(err[new_ext[0]]), abs(err[new_ext[1]])) < max(
                        abs(err[new_ext[-1]]), abs(err[new_ext[-2]])):
                    new_ext = new_ext[1:]
                else:
                    new_ext = new_ext[:-1]
            else:
                if abs(err[new_ext[0]]) < abs(err[new_ext[-1]]):
                    new_ext = new_ext[1:]
                else:
                    new_ext = new_ext[:-1]
        if new_ext.size < r + 1:
            # Lost alternations (numerical): refill from the largest errors.
            break
        converged = np.array_equal(new_ext, ext) or (
            last_delta is not None
            and abs(abs(delta) - last_delta) < 1e-14 * max(1.0, abs(delta))
        )
        ext = new_ext
        last_delta = abs(delta)
        if converged:
            break

    # Recover taps: evaluate the converged response at numtaps uniform
    # frequencies and inverse-DFT (exact for a degree-(r-1) cosine series).
    m_half = (numtaps - 1) / 2.0
    fs_grid = np.arange(numtaps // 2 + 1) / numtaps
    xe = x_grid[ext]
    de = dgrid[ext]
    we = wgrid[ext]
    diff = xe[:, None] - xe[None, :]
    np.fill_diagonal(diff, 1.0)
    gamma = 1.0 / np.prod(diff * 2.0, axis=1)
    signs = (-1.0) ** np.arange(r + 1)
    delta = np.dot(gamma, de) / np.dot(gamma, signs / we)
    ce = de - delta * signs / we

    xs = np.cos(2.0 * np.pi * fs_grid)
    num = np.zeros_like(xs)
    den = np.zeros_like(xs)
    exact = np.full(xs.shape, -1, dtype=int)
    for k_ in range(r + 1):
        dx = xs - xe[k_]
        hitk = np.abs(dx) < 1e-15
        exact[hitk] = k_
        dx[hitk] = 1.0
        t = gamma[k_] / dx
        num += t * ce[k_]
        den += t
    p_s = num / den
    p_s[exact >= 0] = ce[exact[exact >= 0]]
    h_resp = p_s if odd else p_s * np.cos(np.pi * fs_grid)
    # Linear phase: H(f) = A(f) e^{-i 2 pi f M}; build the full DFT and invert.
    full = np.zeros(numtaps, dtype=np.complex128)
    phase = np.exp(-2j * np.pi * fs_grid * m_half)
    full[: numtaps // 2 + 1] = h_resp * phase
    full[numtaps // 2 + 1:] = np.conj(full[1: (numtaps + 1) // 2][::-1])
    h = np.fft.ifft(full).real
    return jnp.asarray(h, dtype=dtype)


def minimum_phase(h, *, n_fft=None, half: bool = True, dtype=DEFAULT_FLOAT):
    """Minimum-phase filter from a linear-phase FIR via the homomorphic
    (cepstral) method — scipy.signal.minimum_phase(method='homomorphic')
    semantics: half-magnitude log spectrum, fold the cepstrum causal,
    exponentiate. With `half=True` (default) the result has (len(h)+1)//2
    taps and sqrt-magnitude response, matching scipy. Not in the
    reference.

    Examples:

    The minimum-phase half of a linear-phase triangle:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.fir_design import minimum_phase
    >>> h = minimum_phase([0.25, 0.5, 0.25])
    >>> np.round(np.asarray(h), 4)
    array([0.494 , 0.5058], dtype=float32)
    """
    h = np.asarray(h, dtype=np.float64)
    if h.ndim != 1 or h.size <= 2:
        raise ValueError("h must be 1-D with at least 3 taps")
    if np.iscomplexobj(h):
        raise ValueError("complex filters are not supported")
    n_half = len(h) // 2
    if n_fft is None:
        n_fft = 2 ** int(math.ceil(math.log2(2 * (len(h) - 1) / 0.01)))
    if n_fft < len(h):
        raise ValueError("n_fft must be at least len(h)")
    # Log magnitude (regularized), halved when producing the half-length root.
    h_spec = np.abs(np.fft.fft(h, n_fft))
    h_spec += 1e-7 * h_spec[h_spec > 0].min()
    log_spec = np.log(h_spec)
    if half:
        log_spec *= 0.5
    # Fold the cepstrum to causal (minimum phase).
    cep = np.fft.ifft(log_spec).real
    win = np.zeros(n_fft)
    win[0] = 1.0
    stop = n_fft // 2
    win[1:stop] = 2.0
    if n_fft % 2 == 0:
        win[stop] = 1.0
    h_min = np.fft.ifft(np.exp(np.fft.fft(cep * win))).real
    n_out = (len(h) + 1) // 2 if half else len(h)
    return jnp.asarray(h_min[:n_out], dtype=dtype)
