"""N-D FFT helpers with per-axis length control.

Reference: lib/nx_signal/transforms.ex (fft_nd/ifft_nd as a fold of 1-D FFTs
with optional per-axis lengths). These map directly onto XLA's batched
FFT; per-axis pad/truncate semantics are preserved via the `s` argument.
"""

import jax.numpy as jnp

__all__ = ["fft_nd", "ifft_nd", "rfft_nd", "irfft_nd", "hilbert", "hilbert2", "envelope"]


def _norm_axes_lengths(x, axes, lengths):
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(int(a) % x.ndim for a in axes)
    if lengths is not None:
        lengths = tuple(int(n) for n in lengths)
        if len(lengths) != len(axes):
            raise ValueError(
                f"lengths must match axes, got {len(lengths)} lengths for {len(axes)} axes"
            )
    return axes, lengths


def fft_nd(x, *, axes=None, lengths=None):
    """Forward FFT over `axes`, padding/truncating each axis to the matching
    entry of `lengths` (reference: transforms.ex:5-12).

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.transforms import fft_nd
    >>> X = fft_nd(jnp.ones((2, 4)), axes=[0, 1], lengths=[2, 8])
    >>> X.shape, X.dtype
    ((2, 8), dtype('complex64'))
    """
    x = jnp.asarray(x)
    axes, lengths = _norm_axes_lengths(x, axes, lengths)
    return jnp.fft.fftn(x, s=lengths, axes=axes)


def ifft_nd(x, *, axes=None, lengths=None):
    """Inverse FFT over `axes` (reference: transforms.ex:14-21).

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.transforms import fft_nd, ifft_nd
    >>> X = fft_nd(jnp.ones((2, 4)), axes=[1], lengths=[4])
    >>> np.round(np.asarray(ifft_nd(X, axes=[1]).real), 4)
    array([[1., 1., 1., 1.],
           [1., 1., 1., 1.]], dtype=float32)
    """
    x = jnp.asarray(x)
    axes, lengths = _norm_axes_lengths(x, axes, lengths)
    return jnp.fft.ifftn(x, s=lengths, axes=axes)


def rfft_nd(x, *, axes=None, lengths=None):
    """Real-input forward FFT over `axes` (half-spectrum on the last of
    `axes`) — the fast path for real convolution: half the FFT work and
    HBM traffic of `fft_nd`.

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.transforms import rfft_nd
    >>> R = rfft_nd(jnp.ones((2, 8)), axes=[1])
    >>> R.shape, R.dtype   # 8 real -> 5 = 8//2 + 1 bins
    ((2, 5), dtype('complex64'))
    """
    x = jnp.asarray(x)
    axes, lengths = _norm_axes_lengths(x, axes, lengths)
    return jnp.fft.rfftn(x, s=lengths, axes=axes)


def irfft_nd(x, *, axes=None, lengths=None):
    """Inverse of `rfft_nd`; `lengths` are the full (time-domain) lengths.

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.transforms import irfft_nd, rfft_nd
    >>> y = irfft_nd(rfft_nd(jnp.ones((2, 8)), axes=[1]), axes=[1], lengths=[8])
    >>> y.shape, y.dtype
    ((2, 8), dtype('float32'))
    """
    x = jnp.asarray(x)
    axes, lengths = _norm_axes_lengths(x, axes, lengths)
    return jnp.fft.irfftn(x, s=lengths, axes=axes)


def hilbert(x, *, n: int = None, axis: int = -1):
    """Analytic signal via the FFT method (scipy.signal.hilbert semantics):
    real input -> complex output whose real part is x and imaginary part its
    Hilbert transform; |hilbert(x)| is the envelope. Not in the reference;
    completes the envelope/demodulation workflows (ops/mixing.py).

    `n` defaults to the signal length (exact scipy parity). For long
    signals whose length factors badly, pass
    n=utils.shapes.fft_fast_length(length) and slice, accepting the slight
    boundary difference.

    Examples:

    The envelope of a full-period cosine is exactly 1:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.transforms import hilbert
    >>> xa = hilbert(jnp.cos(2 * jnp.pi * jnp.arange(8) / 8))
    >>> np.round(np.abs(np.asarray(xa)), 4)
    array([1., 1., 1., 1., 1., 1., 1., 1.], dtype=float32)
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("hilbert requires a real input signal")
    n_fft = int(n) if n is not None else x.shape[axis]
    spectrum = jnp.fft.fft(x, n=n_fft, axis=axis)
    h = jnp.zeros(n_fft)
    if n_fft % 2 == 0:
        h = h.at[0].set(1.0).at[n_fft // 2].set(1.0).at[1 : n_fft // 2].set(2.0)
    else:
        h = h.at[0].set(1.0).at[1 : (n_fft + 1) // 2].set(2.0)
    shape = [1] * x.ndim
    shape[axis] = n_fft
    return jnp.fft.ifft(spectrum * h.reshape(shape), axis=axis)


def hilbert2(x, *, n=None):
    """2-D analytic signal over the last two axes —
    scipy.signal.hilbert2 semantics: fft2, zero the negative-frequency
    half-planes (doubling the positive ones), ifft2. `n` is an optional
    (n0, n1) FFT shape. Real input required. Not in the reference.

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.transforms import hilbert2
    >>> hilbert2(jnp.ones((4, 4))).shape
    (4, 4)
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("x must be real")
    if x.ndim < 2:
        raise ValueError("x must have at least 2 dimensions")
    if n is None:
        shape = (x.shape[-2], x.shape[-1])
    else:
        shape = (int(n[0]), int(n[1])) if not jnp.isscalar(n) else (int(n), int(n))
        if shape[0] < 1 or shape[1] < 1:
            raise ValueError("n must be positive")
    zf = jnp.fft.fft2(x, s=shape, axes=(-2, -1))

    def half_filter(m):
        # single-orthant factor (1 + s_N): DC 1, strictly-positive bins
        # below Nyquist 2, Nyquist AND negative bins 0 — scipy zeroes the
        # even-N Nyquist bin here (unlike 1-D hilbert, which keeps it at 1)
        h = jnp.zeros((m,), zf.real.dtype)
        h = h.at[0].set(1.0)
        h = h.at[1 : (m + 1) // 2].set(2.0)
        return h

    h = half_filter(shape[0])[:, None] * half_filter(shape[1])[None, :]
    return jnp.fft.ifft2(zf * h, axes=(-2, -1))


def envelope(z, bp_in=(1, None), *, n_out=None, squared=False,
             residual="lowpass", axis=-1):
    """Envelope (and residual) of a signal — scipy.signal.envelope
    semantics: band-limit the spectrum to the `bp_in` bin range, take the
    analytic/baseband magnitude as the envelope (optionally squared,
    optionally resampled to `n_out`), and return the out-of-band rest as
    the residual ('lowpass' keeps only bins below the band; 'all' keeps
    everything outside; None returns just the envelope). Returns the
    envelope alone, or stack([envelope, residual]) along a new axis 0.
    Not in the reference.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.transforms import envelope
    >>> out = envelope(jnp.sin(2 * jnp.pi * 0.1 * jnp.arange(32)))
    >>> out.shape
    (2, 32)
    >>> np.round(np.asarray(out)[0, :3], 4)
    array([0.3119, 0.9088, 0.9576], dtype=float32)
    """
    z = jnp.asarray(z)
    if not (-z.ndim <= axis < z.ndim):
        raise ValueError(f"Invalid parameter axis={axis} for z.shape={z.shape}!")
    if z.shape[axis] <= 0:
        raise ValueError(f"z.shape[axis] not > 0 for z.shape={z.shape}")
    if len(bp_in) != 2 or not all(b is None or isinstance(b, int) for b in bp_in):
        raise ValueError(f"bp_in={bp_in!r} isn't a 2-tuple of (int | None)")
    if n_out is not None and (not isinstance(n_out, int) or n_out <= 0):
        raise ValueError(f"n_out={n_out!r} is not a positive integer or None")
    if residual not in ("lowpass", "all", None):
        raise ValueError(f"residual={residual!r} not in ['lowpass', 'all', None]")

    n = z.shape[axis]
    n_out = n if n_out is None else n_out
    fak = n_out / n
    lo = bp_in[0] if bp_in[0] is not None else -(n // 2)
    hi = bp_in[1] if bp_in[1] is not None else (n + 1) // 2
    if not (-(n // 2) <= lo < hi <= (n + 1) // 2):
        raise ValueError(f"-n//2 <= bp_in[0] < bp_in[1] <= (n+1)//2 does not "
                         f"hold for n={n} and bp_in={bp_in}")

    z = jnp.moveaxis(z, axis, -1)
    complex_input = jnp.issubdtype(z.dtype, jnp.complexfloating)
    if complex_input:
        zf = jnp.fft.fft(z)
    else:
        half = jnp.fft.rfft(z)
        zf = jnp.zeros(z.shape, dtype=half.dtype)
        zf = zf.at[..., : n // 2 + 1].set(half)
        # make the in-band signal analytic (double positive-frequency bins)
        if lo > 0:
            zf = zf.at[..., lo:hi].multiply(2)
        elif hi > 0:
            zf = zf.at[..., 1:hi].multiply(2)

    if not (lo <= 0 < hi):
        z_bb = jnp.fft.ifft(zf[..., lo:hi], n=n_out) * fak
    else:
        shifted = jnp.fft.fftshift(zf, axes=-1)
        z_bb = jnp.fft.ifft(shifted[..., lo + n // 2 : hi + n // 2],
                            n=n_out) * fak
    env = (jnp.real(z_bb) ** 2 + jnp.imag(z_bb) ** 2) if squared \
        else jnp.abs(z_bb)
    env = jnp.moveaxis(env, -1, axis)
    if residual is None:
        return env

    # zero the in-band bins, then (for 'lowpass') everything above the band
    if not (lo <= 0 < hi):
        zf = zf.at[..., lo:hi].set(0)
    else:
        zf = zf.at[..., :hi].set(0)
        zf = zf.at[..., lo:].set(0)
    if residual == "lowpass":
        if hi > 0:
            zf = zf.at[..., hi : (n + 1) // 2].set(0)
        else:
            zf = zf.at[..., lo:].set(0)
            zf = zf.at[..., 0 : (n + 1) // 2].set(0)
    if complex_input:
        from nx_signal_tpu.ops.resample import resample

        z_res = resample(jnp.fft.ifft(zf), n_out, axis=-1)
    else:
        m = min(n, n_out)
        if n_out != n and m % 2 == 0:
            zf = zf.at[..., m // 2].multiply(2.0 if n_out < n else 0.5)
        z_res = fak * jnp.fft.irfft(zf, n=n_out)
    return jnp.stack((env, jnp.moveaxis(z_res, -1, axis)), axis=0)
