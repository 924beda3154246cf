"""IIR filter application: lfilter / sosfilt / filtfilt / sosfiltfilt.

Greenfield relative to the reference (SURVEY.md §2.5 — nx_signal ships only
median/wiener/firwin; it has no IIR application at all), with
scipy.signal semantics as the contract (the same oracle the reference pins
its FIR tests to, test/nx_signal/filters_test.exs:246).

Design: a sequential per-sample loop is the worst possible shape
for XLA (serial dependency, no vectorization). Instead the recurrence

    y[n] = v[n] - a_1 y[n-1] - ... - a_N y[n-N]

is solved in O(log T) depth with `jax.lax.associative_scan` over affine
state maps (A, b): composing (A2@A1, A2 b1 + b2) where A is the NxN
companion matrix of `a`. Every combine step is a batch of tiny matmuls —
pure VPU work, fully vectorized over channels and time. The FIR part of the
transfer function is applied first as a causal convolution (shift-and-add,
static unroll), so the scan only carries the denominator.

The DF2T initial/final state convention matches scipy exactly: a given
`zi` enters as additive forcing on the first N samples (the zero-input
response of DF2T equals the recurrence driven by v[:N] = zi), and the
final state is recovered in closed form from the last N input/output
samples — no per-sample state materialization.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "lfilter",
    "lfilter_zi",
    "lfiltic",
    "filtfilt",
    "sosfilt",
    "sosfilt_zi",
    "sosfiltfilt",
]


def _causal_fir(x, b):
    """y[n] = sum_j b[j] x[n-j] (same length as x, zero initial history).

    Static shift-and-add unroll: K slices + K fused multiply-adds. IIR
    numerators are short (K <= a few dozen); long pure-FIR filters should
    go through ops.convolution (oaconvolve / fir_convolve_1d) instead.
    """
    k = b.shape[0]
    if k == 1:
        return b[0] * x
    t = x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 1) + [(k - 1, 0)]
    xp = jnp.pad(x, pad)
    acc = b[0] * x
    for j in range(1, k):
        acc = acc + b[j] * xp[..., k - 1 - j : k - 1 - j + t]
    return acc


def _linear_recurrence_seq(v, a_tail):
    """Sequential lax.scan fallback for orders > 2: the companion-matrix
    products of the parallel scan exhibit transient growth for non-normal
    high-order systems (poles clustered near the unit circle), losing
    ~digits-per-order; the sequential form matches scipy's rounding class.
    High-order filters should be applied as `sosfilt` cascades anyway."""
    n = a_tail.shape[0]
    vt = jnp.moveaxis(v, -1, 0)
    init = jnp.zeros(vt.shape[1:] + (n,), v.dtype)

    def step(carry, vn):
        yn = vn - jnp.sum(carry * a_tail, axis=-1)
        carry = jnp.concatenate([yn[..., None], carry[..., :-1]], axis=-1)
        return carry, yn

    _, ys = lax.scan(step, init, vt)
    return jnp.moveaxis(ys, 0, -1)


def _linear_recurrence(v, a_tail):
    """Solve y[n] = v[n] - sum_i a_tail[i-1] y[n-i] (zero initial history)
    in O(log T) depth via associative_scan over affine state maps (orders
    <= 2; higher orders fall back to a sequential scan — see
    _linear_recurrence_seq)."""
    n = a_tail.shape[0]
    if n == 0:
        return v
    dtype = v.dtype
    a_tail = a_tail.astype(dtype)
    if n > 2:
        return _linear_recurrence_seq(v, a_tail)
    if n == 1:
        c = -a_tail[0]
        cs = jnp.full(v.shape, c, dtype)

        def comb1(e1, e2):
            c1, b1 = e1
            c2, b2 = e2
            return c1 * c2, c2 * b1 + b2

        return lax.associative_scan(comb1, (cs, v), axis=-1)[1]

    # companion-matrix form, scan axis moved to the front so matrix and
    # vector leaves share the same positional axis
    a_mat = jnp.zeros((n, n), dtype).at[0, :].set(-a_tail)
    a_mat = a_mat.at[jnp.arange(1, n), jnp.arange(0, n - 1)].set(1)
    vt = jnp.moveaxis(v, -1, 0)  # (T, ...batch)
    t = vt.shape[0]
    batch = vt.shape[1:]
    mats = jnp.broadcast_to(a_mat, (t,) + batch + (n, n))
    vecs = jnp.zeros((t,) + batch + (n,), dtype).at[..., 0].set(vt)

    def comb(e1, e2):
        m1, b1 = e1
        m2, b2 = e2
        return m2 @ m1, (m2 @ b1[..., None])[..., 0] + b2

    _, states = lax.associative_scan(comb, (mats, vecs), axis=0)
    return jnp.moveaxis(states[..., 0], 0, -1)


def _normalize_ba(b, a, dtype):
    b = jnp.atleast_1d(jnp.asarray(b)).astype(dtype)
    a = jnp.atleast_1d(jnp.asarray(a)).astype(dtype)
    n = max(b.shape[0], a.shape[0]) - 1
    b = jnp.pad(b, (0, n + 1 - b.shape[0]))
    a = jnp.pad(a, (0, n + 1 - a.shape[0]))
    b = b / a[0]
    a = a / a[0]
    return b, a, n


def _lfilter_last_axis(b, a, x, zi=None):
    """lfilter along the last axis; zi (if given) has shape
    broadcastable to x.shape[:-1] + (order,). Returns y or (y, zf)."""
    dtype = jnp.result_type(x.dtype, jnp.asarray(b).dtype, jnp.asarray(a).dtype,
                            jnp.float32)
    x = jnp.asarray(x).astype(dtype)
    b, a, n = _normalize_ba(b, a, dtype)
    m = x.shape[-1]

    v = _causal_fir(x, b)
    if zi is not None:
        zi = jnp.asarray(zi).astype(dtype)
        zi = jnp.broadcast_to(zi, x.shape[:-1] + (n,))
        head = min(n, m)
        v = v.at[..., :head].add(zi[..., :head])
    y = _linear_recurrence(v, a[1:])
    if zi is None:
        return y
    # closed-form final DF2T state from the last samples:
    # zf_i = sum_{k=1..n-i} (b[i+k] x[M-k] - a[i+k] y[M-k])  (+ zi carryover
    # for signals shorter than the order)
    zf = []
    for i in range(n):
        acc = jnp.zeros(x.shape[:-1], dtype)
        for k in range(1, n - i + 1):
            if m - k >= 0:
                acc = acc + b[i + k] * x[..., m - k] - a[i + k] * y[..., m - k]
        if i + m <= n - 1:
            acc = acc + zi[..., i + m]
        zf.append(acc)
    return y, jnp.stack(zf, axis=-1)


def _move_zi(zi, x_ndim, axis):
    zi = jnp.asarray(zi)
    if zi.ndim == x_ndim:
        return jnp.moveaxis(zi, axis, -1)
    return zi


def lfilter(b, a, x, axis=-1, zi=None):
    """Filter `x` along `axis` with the rational transfer function b/a —
    scipy.signal.lfilter semantics (direct-form II transposed state
    convention for `zi`/`zf`). Returns y, or (y, zf) when zi is given.

    New relative to the reference (no IIR in nx_signal; SURVEY.md §2.5).
    Device path: causal FIR shift-add + log-depth associative-scan recurrence
    (see module docstring). Orders above ~8 pay O(N^2) state-map cost per
    sample; prefer `sosfilt` (cascaded biquads) for high-order filters, as
    scipy also recommends.

    Examples:

    The impulse response of y[n] = x[n] + 0.5 y[n-1]:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir import lfilter
    >>> b, a = jnp.asarray([1.0, 0.0]), jnp.asarray([1.0, -0.5])
    >>> y = lfilter(b, a, jnp.asarray([1.0, 0.0, 0.0, 0.0]))
    >>> np.round(np.asarray(y), 4)
    array([1.   , 0.5  , 0.25 , 0.125], dtype=float32)
    """
    x = jnp.asarray(x)
    axis = axis % x.ndim
    xm = jnp.moveaxis(x, axis, -1)
    zim = _move_zi(zi, x.ndim, axis) if zi is not None else None
    out = _lfilter_last_axis(b, a, xm, zim)
    if zi is None:
        return jnp.moveaxis(out, -1, axis)
    y, zf = out
    return jnp.moveaxis(y, -1, axis), jnp.moveaxis(zf, -1, axis)


def lfilter_zi(b, a):
    """Initial DF2T state for step-response steady state —
    scipy.signal.lfilter_zi semantics (solve (I - A^T) zi = B with A the
    companion matrix of `a` and B = b[1:] - a[1:] b[0]). Host-side f64
    numpy: filter design/state math is tiny and happens once.

    Examples:

    The one-pole smoother settles to zi = 1 for a unit step:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir import lfilter_zi
    >>> np.round(lfilter_zi([1.0, 0.0], [1.0, -0.5]), 4)
    array([1.])
    """
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    while len(a) > 1 and a[0] == 0.0:
        a = a[1:]
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    n = max(len(a), len(b))
    a = np.pad(a, (0, n - len(a)))
    b = np.pad(b, (0, n - len(b)))
    companion = np.zeros((n - 1, n - 1))
    companion[0, :] = -a[1:]
    if n > 2:
        companion[np.arange(1, n - 1), np.arange(0, n - 2)] = 1.0
    iminus_a = np.eye(n - 1) - companion.T
    rhs = b[1:] - a[1:] * b[0]
    return np.linalg.solve(iminus_a, rhs)


def lfiltic(b, a, y, x=None):
    """DF2T initial state `zi` that reproduces the given past outputs
    `y = [y[-1], y[-2], ...]` and past inputs `x = [x[-1], x[-2], ...]` —
    scipy.signal.lfiltic semantics: zi[m] = sum_i b[m+1+i] x[i] -
    sum_i a[m+1+i] y[i] after normalizing to a[0] == 1, with short y/x
    zero-extended. Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir import lfiltic
    >>> np.round(np.asarray(lfiltic(jnp.asarray([1.0, 0.0]),
    ...                             jnp.asarray([1.0, -0.5]),
    ...                             jnp.asarray([2.0]))), 4)
    array([1.])

    Host-side f64 numpy (tiny, runs once) feeding the
    jitted lfilter. Not in the reference (no IIR there)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a[0] != 1.0:
        if a[0] == 0.0:
            raise ValueError("a[0] must be nonzero")
        b = b / a[0]
        a = a / a[0]
    n = a.shape[0] - 1
    m = b.shape[0] - 1
    k = max(m, n)
    y = np.atleast_1d(np.asarray(y, dtype=np.float64))
    y = np.pad(y, (0, max(0, n - y.shape[0])))
    x = (np.zeros(m) if x is None
         else np.pad(np.atleast_1d(np.asarray(x, dtype=np.float64)),
                     (0, max(0, m - np.size(x)))))
    zi = np.zeros(k, dtype=np.float64)
    for i in range(m):
        zi[i] += np.sum(b[i + 1:] * x[: m - i])
    for i in range(n):
        zi[i] -= np.sum(a[i + 1:] * y[: n - i])
    return zi


def _odd_ext(x, n):
    """Odd extension of length n at both ends of the last axis."""
    left = 2 * x[..., :1] - x[..., n:0:-1]
    right = 2 * x[..., -1:] - x[..., -2 : -n - 2 : -1]
    return jnp.concatenate([left, x, right], axis=-1)


def _even_ext(x, n):
    left = x[..., n:0:-1]
    right = x[..., -2 : -n - 2 : -1]
    return jnp.concatenate([left, x, right], axis=-1)


def _const_ext(x, n):
    left = jnp.broadcast_to(x[..., :1], x.shape[:-1] + (n,))
    right = jnp.broadcast_to(x[..., -1:], x.shape[:-1] + (n,))
    return jnp.concatenate([left, x, right], axis=-1)


def _extend(x, n, padtype):
    if padtype == "odd":
        return _odd_ext(x, n)
    if padtype == "even":
        return _even_ext(x, n)
    if padtype == "constant":
        return _const_ext(x, n)
    raise ValueError(
        f"padtype must be 'odd', 'even', 'constant', or None, got {padtype!r}"
    )


def filtfilt(b, a, x, axis=-1, padtype="odd", padlen=None):
    """Zero-phase forward-backward filtering — scipy.signal.filtfilt 'pad'
    method semantics: odd-extend by 3*max(len(a),len(b)) (default), filter
    forward and backward with lfilter_zi-scaled initial states, slice the
    extension off. New relative to the reference (no IIR in nx_signal).

    Examples:

    Zero-phase smoothing settles onto a step without lag:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir import filtfilt
    >>> from nx_signal_tpu.ops.iir_design import butter
    >>> b, a = butter(2, 0.25)
    >>> x = jnp.concatenate([jnp.zeros(4), jnp.ones(8)])
    >>> np.round(np.asarray(filtfilt(b, a, x))[-3:], 4)
    array([1.0249, 1.0102, 0.9985], dtype=float32)
    """
    x = jnp.asarray(x)
    axis = axis % x.ndim
    ntaps = max(np.atleast_1d(a).shape[0], np.atleast_1d(b).shape[0])
    if padtype is None:
        edge = 0
    else:
        edge = int(3 * ntaps) if padlen is None else int(padlen)
    if edge >= x.shape[axis]:
        raise ValueError(
            "The length of the input vector x must be greater than padlen, "
            f"which is {edge}."
        )
    xm = jnp.moveaxis(x, axis, -1)
    ext = _extend(xm, edge, padtype) if edge > 0 else xm
    zi = jnp.asarray(lfilter_zi(b, a))
    y, _ = _lfilter_last_axis(b, a, ext, zi * ext[..., :1])
    y = y[..., ::-1]
    y, _ = _lfilter_last_axis(b, a, y, zi * y[..., :1])
    y = y[..., ::-1]
    if edge > 0:
        y = y[..., edge:-edge]
    return jnp.moveaxis(y, -1, axis)


def sosfilt(sos, x, axis=-1, zi=None):
    """Filter with cascaded second-order sections — scipy.signal.sosfilt
    semantics (zi shape (n_sections, ..., 2) in DF2T convention). Returns y
    or (y, zf). The recommended IIR path: each biquad is a 2x2
    associative-scan recurrence (log-depth, numerically robust at any
    order via cascading). New relative to the reference (no IIR).

    Examples:

    A one-pole low-pass (y[n] = 0.5 x[n] + 0.5 y[n-1]) impulse response:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir import sosfilt
    >>> sos = jnp.asarray([[0.5, 0.0, 0.0, 1.0, -0.5, 0.0]])
    >>> out = sosfilt(sos, jnp.asarray([1.0, 0.0, 0.0, 0.0]))
    >>> np.round(np.asarray(out), 4)
    array([0.5   , 0.25  , 0.125 , 0.0625], dtype=float32)
    """
    sos = jnp.asarray(sos)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos array must be shape (n_sections, 6)")
    n_sections = sos.shape[0]
    x = jnp.asarray(x)
    axis = axis % x.ndim
    out = jnp.moveaxis(x, axis, -1)
    zf_list = []
    for s in range(n_sections):
        b, a = sos[s, :3], sos[s, 3:]
        if zi is not None:
            zi_s = _move_zi(zi[s], x.ndim, axis)
            out, zf_s = _lfilter_last_axis(b, a, out, zi_s)
            zf_list.append(zf_s)
        else:
            out = _lfilter_last_axis(b, a, out)
    out = jnp.moveaxis(out, -1, axis)
    if zi is None:
        return out
    zf = jnp.stack([jnp.moveaxis(z, -1, axis) for z in zf_list], axis=0)
    return out, zf


def sosfilt_zi(sos):
    """Initial states for sosfilt step-response steady state —
    scipy.signal.sosfilt_zi semantics: per-section lfilter_zi scaled by the
    cumulative DC gain of the preceding sections. Host-side numpy.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir import sosfilt_zi
    >>> np.round(sosfilt_zi([[0.5, 0.0, 0.0, 1.0, -0.5, 0.0]]), 4)
    array([[0.5, 0. ]])
    """
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos array must be shape (n_sections, 6)")
    n_sections = sos.shape[0]
    zi = np.empty((n_sections, 2))
    scale = 1.0
    for s in range(n_sections):
        b, a = sos[s, :3], sos[s, 3:]
        zi[s] = scale * lfilter_zi(b, a)
        scale *= b.sum() / a.sum()
    return zi


def sosfiltfilt(sos, x, axis=-1, padtype="odd", padlen=None):
    """Zero-phase forward-backward SOS filtering —
    scipy.signal.sosfiltfilt semantics. New relative to the reference.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.iir import sosfiltfilt
    >>> from nx_signal_tpu.ops.iir_design import butter
    >>> sos = butter(2, 0.25, output="sos")
    >>> x = jnp.concatenate([jnp.zeros(4), jnp.ones(8)])
    >>> np.round(np.asarray(sosfiltfilt(sos, x))[-3:], 4)
    array([1.0249, 1.0102, 0.9985], dtype=float32)
    """
    sos_np = np.asarray(sos, dtype=np.float64)
    if sos_np.ndim != 2 or sos_np.shape[1] != 6:
        raise ValueError("sos array must be shape (n_sections, 6)")
    x = jnp.asarray(x)
    axis = axis % x.ndim
    n_sections = sos_np.shape[0]
    ntaps = 2 * n_sections + 1
    ntaps -= min((sos_np[:, 2] == 0).sum(), (sos_np[:, 5] == 0).sum())
    if padtype is None:
        edge = 0
    else:
        edge = int(3 * ntaps) if padlen is None else int(padlen)
    if edge >= x.shape[axis]:
        raise ValueError(
            "The length of the input vector x must be greater than padlen, "
            f"which is {edge}."
        )
    xm = jnp.moveaxis(x, axis, -1)
    ext = _extend(xm, edge, padtype) if edge > 0 else xm
    zi = jnp.asarray(sosfilt_zi(sos_np))  # (S, 2)
    zi_shaped = zi.reshape((n_sections,) + (1,) * (xm.ndim - 1) + (2,))

    def run(sig):
        out = sig
        z = zi_shaped * sig[..., :1][None]
        result = out
        for s in range(n_sections):
            result, _ = _lfilter_last_axis(
                sos_np[s, :3], sos_np[s, 3:], result, z[s]
            )
        return result

    y = run(ext)
    y = run(y[..., ::-1])[..., ::-1]
    if edge > 0:
        y = y[..., edge:-edge]
    return jnp.moveaxis(y, -1, axis)
