"""Convolution and correlation (scipy.signal conventions).

Reference semantics: lib/nx_signal/convolution.ex — `convolve/3` dispatcher
(:38-58), direct N-D convolution (:95-211), `correlate/3` (:87-93),
`fftconvolve/3` (:252-347). `oaconvolve` is NEW: the overlap-add streaming
convolver the reference left unbuilt (its test block is commented out,
convolutions_test.exs:633-654) — it is both the fast path for long FIR
filtering and the time-block distribution seam (see nx_signal_tpu.parallel).

Design notes
------------
* Direct convolution lowers to `lax.conv_general_dilated` (1-D FIR to a
  blocked Toeplitz matmul). Complex inputs are decomposed into real
  convolutions: (a+bi)*(c+di) = (ac - bd) + i(ad + bc).
* FFT convolution pads each conv axis from the exact N+K-1 up to the next
  power-of-two length and slices back — results are
  identical, never circular. Real inputs take the rfft half-spectrum path:
  half the FFT flops and HBM traffic.
* Overlap-add framing/summation reuses the deterministic fold from
  spectral/framing.py, so sharded and single-device runs are bit-identical.
"""

import math

import jax.numpy as jnp
from jax import lax

from nx_signal_tpu.ops.transforms import fft_nd, ifft_nd, irfft_nd, rfft_nd
from nx_signal_tpu.spectral.framing import _ola_fold, as_windowed
from nx_signal_tpu.utils.dtypes import (
    default_complex,
    is_complex_dtype,
    result_real_dtype,
)
from nx_signal_tpu.utils.shapes import fft_fast_length

__all__ = ["convolve", "correlate", "correlation_lags", "deconvolve", "choose_conv_method", "fftconvolve", "oaconvolve",
           "fir_convolve_1d", "convolve2d", "correlate2d"]

_MODES = ("full", "same", "valid")


def _check_mode_method(mode, method):
    if mode not in _MODES:
        raise ValueError(f"expected mode to be one of ['full', 'same', 'valid'], got: {mode}")
    if method not in ("direct", "fft"):
        raise ValueError(f"expected method to be one of ['direct', 'fft'], got: {method}")


def convolve(in1, in2, *, mode="full", method="direct"):
    """Convolution of two tensors; `method` 'direct' (conv/matmul) or 'fft'.

    Modes (reference: convolution.ex:24-28): 'full' -> N+K-1 samples,
    'same' -> center N samples, 'valid' -> center N-K+1 samples.

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.convolution import convolve
    >>> convolve(jnp.asarray([1.0, 2.0, 3.0]), jnp.asarray([0.0, 1.0, 0.5]))
    Array([0. , 1. , 2.5, 4. , 1.5], dtype=float32)
    >>> convolve(jnp.asarray([1.0, 2.0, 3.0]), jnp.asarray([0.0, 1.0, 0.5]), mode="same")
    Array([1. , 2.5, 4. ], dtype=float32)
    """
    _check_mode_method(mode, method)
    if method == "direct":
        return _direct_convolve(in1, in2, mode)
    return fftconvolve(in1, in2, mode=mode)


def correlate(in1, in2, *, mode="full", method="direct"):
    """Cross-correlation: convolution with the reversed (conjugated, if
    complex) kernel (reference: convolution.ex:87-93).

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.convolution import correlate
    >>> correlate(jnp.asarray([1.0, 2.0, 3.0]), jnp.asarray([0.0, 1.0, 0.5]))
    Array([0.5, 2. , 3.5, 3. , 0. ], dtype=float32)
    """
    in2 = jnp.asarray(in2)
    kernel = jnp.flip(in2, axis=tuple(range(in2.ndim)))
    if is_complex_dtype(in2.dtype):
        kernel = jnp.conj(kernel)
    return convolve(in1, kernel, mode=mode, method=method)


_BOUNDARIES = {"fill": "constant", "wrap": "wrap", "symm": "symmetric"}


def convolve2d(in1, in2, *, mode="full", boundary="fill", fillvalue=0):
    """2-D convolution with boundary handling —
    scipy.signal.convolve2d semantics: `boundary` is 'fill' (pad with
    `fillvalue`), 'wrap' (circular), or 'symm' (symmetric reflection
    including the edge sample). Implemented as boundary padding by the full
    kernel overhang followed by a valid lax.conv and the scipy mode
    slices. Not in the reference (its convolve covers only zero boundaries,
    convolution.ex:95-211).

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.convolution import convolve2d
    >>> np.asarray(convolve2d(jnp.ones((3, 3)), jnp.ones((2, 2)), mode="valid"))
    array([[4., 4.],
           [4., 4.]], dtype=float32)
    """
    _check_mode_method(mode, "direct")
    if boundary not in _BOUNDARIES:
        raise ValueError(
            f"expected boundary to be one of ['fill', 'wrap', 'symm'], "
            f"got: {boundary}"
        )
    in1, in2 = jnp.asarray(in1), jnp.asarray(in2)
    if in1.ndim != 2 or in2.ndim != 2:
        raise ValueError("convolve2d inputs must both be rank 2")
    m, n = in1.shape
    p, q = in2.shape
    if mode == "valid" and ((m - p) * (n - q) < 0):
        raise ValueError(
            "For 'valid' mode, one must be at least as large as the other "
            "in every dimension"
        )
    if mode == "valid" and (m < p or n < q):
        in1, in2 = in2, in1
        m, n, p, q = p, q, m, n

    if boundary == "fill" and fillvalue == 0:
        full = convolve(in1, in2, mode="full")
    else:
        kwargs = {"constant_values": fillvalue} if boundary == "fill" else {}
        padded = jnp.pad(in1, [(p - 1, p - 1), (q - 1, q - 1)],
                         mode=_BOUNDARIES[boundary], **kwargs)
        full = convolve(padded, in2, mode="valid")
    if mode == "full":
        return full
    if mode == "same":
        r0, c0 = (p - 1) // 2, (q - 1) // 2
        return full[r0:r0 + m, c0:c0 + n]
    return full[p - 1:m, q - 1:n]


def correlate2d(in1, in2, *, mode="full", boundary="fill", fillvalue=0):
    """2-D cross-correlation with boundary handling —
    scipy.signal.correlate2d semantics: full convolution with the flipped
    (conjugated, if complex) kernel, but with correlation's own 'same'
    anchor — the window origin sits at index k//2 of the kernel, one sample
    later than convolution's (k-1)//2 for even kernel dims. When 'valid'
    mode requires swapping (in2 larger everywhere), the swapped result is
    reversed (scipy's pinned behavior: reversed but NOT conjugated). Not in
    the reference.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.convolution import correlate2d
    >>> np.asarray(correlate2d(jnp.ones((3, 3)), jnp.ones((2, 2)), mode="valid"))
    array([[4., 4.],
           [4., 4.]], dtype=float32)
    """
    _check_mode_method(mode, "direct")
    in1, in2 = jnp.asarray(in1), jnp.asarray(in2)
    if in1.ndim != 2 or in2.ndim != 2:
        raise ValueError("correlate2d inputs must both be rank 2")
    m, n = in1.shape
    p, q = in2.shape
    if mode == "valid" and (m < p or n < q):
        swapped = correlate2d(in2, in1, mode=mode, boundary=boundary,
                              fillvalue=fillvalue)
        return jnp.flip(swapped, axis=(0, 1))
    kernel = jnp.flip(in2, axis=(0, 1))
    if is_complex_dtype(in2.dtype):
        kernel = jnp.conj(kernel)
    full = convolve2d(in1, kernel, mode="full", boundary=boundary,
                      fillvalue=fillvalue)
    if mode == "full":
        return full
    if mode == "same":
        r0, c0 = p // 2, q // 2
        return full[r0:r0 + m, c0:c0 + n]
    return full[p - 1:m, q - 1:n]


def _float_cast(x):
    """Promote to the float/complex compute dtype (Nx.conv promotion:
    real -> f32, complex -> c64; reference behavior pinned by
    convolutions_test.exs:392-416)."""
    real_dtype = result_real_dtype(x.dtype)
    if is_complex_dtype(x.dtype):
        return x.astype(default_complex(real_dtype))
    return x.astype(real_dtype)


def _check_ranks(in1, in2):
    r1, r2 = in1.ndim, in2.ndim
    if r1 == r2:
        return r1
    if r1 == 0:
        raise ValueError(f"Incompatible ranks: {{0, {r2}}}")
    if r2 == 0:
        raise ValueError(f"Incompatible ranks: {{{r1}, 0}}")
    raise ValueError(
        "convolve requires both inputs to have the same rank or one of them "
        f"to be a scalar, got {r1} and {r2}"
    )


def _valid_swap(in1, in2):
    """'valid' requires one operand >= the other on every axis; put the
    dominant one first (reference: convolution.ex:115-135)."""
    ok1 = all(a >= b for a, b in zip(in1.shape, in2.shape))
    ok2 = all(a <= b for a, b in zip(in1.shape, in2.shape))
    if ok1:
        return in1, in2
    if ok2:
        return in2, in1
    raise ValueError(
        "For 'valid' mode, one must be at least as large as the other in every dimension"
    )


def _conv_real(volume, kernel, padding):
    """Real N-D convolution kernel: NC + spatial layout, single feature.
    Full float32 products: an accelerator's default may run them in TF32."""
    rank = volume.ndim
    dn = lax.conv_dimension_numbers(
        (1, 1) + volume.shape, (1, 1) + kernel.shape,
        ("NC" + "HWDXYZ"[:rank], "OI" + "HWDXYZ"[:rank], "NC" + "HWDXYZ"[:rank]),
    )
    out = lax.conv_general_dilated(
        volume.reshape((1, 1) + volume.shape),
        kernel.reshape((1, 1) + kernel.shape),
        window_strides=(1,) * rank,
        padding=padding,
        dimension_numbers=dn,
        precision="highest",
    )
    return out.reshape(out.shape[2:])


def _fir_block_size(k: int) -> int:
    """Output-block width for the Toeplitz-matmul FIR path: >= K so the
    flop waste factor (B+K-1)/B stays <= 2, a multiple of 128."""
    return max(512, -(-k // 128) * 128)


def fir_convolve_1d(x, taps, mode="full", *, origin: int = 0):
    """1-D convolution over the last axis as a blocked Toeplitz matmul —
    the direct FIR path.

    y_full[n] = sum_m taps[m] x[n-m] evaluated as (frames @ W): frames are
    gather-free (B+K-1)-wide windows at stride B of the zero-padded signal,
    W[t, j] = taps[j+K-1-t] banded Toeplitz. This replaces
    lax.conv_general_dilated for long 1-D kernels (its speed against the
    FFT paths on the H100 is not measured yet).

    `origin` aligns the block grid to a global full-conv index: output
    sample f lands in matmul column (f + origin) % B regardless of local
    offsets, so sharded overlap-save calls (nx_signal_tpu.parallel) produce
    bitwise-identical sums to the single-device call.
    
    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.convolution import fir_convolve_1d
    >>> y = fir_convolve_1d(jnp.asarray([1.0, 2.0, 3.0, 4.0]),
    ...                     jnp.asarray([1.0, 1.0]), mode="full")
    >>> np.round(np.asarray(y), 1)
    array([1., 3., 5., 7., 4.], dtype=float32)
    """
    from nx_signal_tpu.kernels.dft import blocked_frame_matmul, toeplitz_band

    x = jnp.asarray(x)
    taps = jnp.asarray(taps).reshape(-1)
    k = taps.shape[0]
    length = x.shape[-1]
    full_len = length + k - 1
    block = _fir_block_size(k)
    shift = origin % block

    batch = x.shape[:-1]
    num_frames = -(-(full_len + shift) // block)
    total = num_frames * block + k - 1
    xp = jnp.pad(
        x, [(0, 0)] * len(batch) + [(k - 1 + shift, total - (k - 1 + shift) - length)]
    )

    weights = toeplitz_band(taps, block)
    out_dtype = jnp.promote_types(x.dtype, taps.dtype)
    y = blocked_frame_matmul(
        xp.astype(out_dtype), weights.astype(out_dtype),
        window_length=block + k - 1, stride=block, num_frames=num_frames,
        precision="highest",
    )
    y = y.reshape(*batch, num_frames * block)[..., shift : shift + full_len]

    if mode == "full":
        return y
    if mode == "same":
        start = (k - 1) // 2
        return y[..., start : start + length]
    if mode == "valid":
        if length >= k:
            return y[..., k - 1 : length]
        return y[..., length - 1 : k]
    raise ValueError(f"expected mode to be one of ['full', 'same', 'valid'], got: {mode}")


def _is_1d_fir_case(in1, in2) -> bool:
    """True when in2 is a 1-D-over-last-axis kernel (leading dims all 1):
    leading axes convolve trivially (k=1 identity) and the last axis is a
    plain FIR — the Toeplitz-matmul fast path applies."""
    return (
        in1.ndim >= 1
        and all(d == 1 for d in in2.shape[:-1])
        and in2.shape[-1] >= 2
        and in1.shape[-1] >= 2
    )


def _direct_convolve(in1, in2, mode, use_matmul=True):
    in1, in2 = jnp.asarray(in1), jnp.asarray(in2)
    rank = _check_ranks(in1, in2)
    if rank == 0:
        return _float_cast(in1) * _float_cast(in2)

    if mode == "valid":
        in1, in2 = _valid_swap(in1, in2)

    in1 = _float_cast(in1)
    in2 = _float_cast(in2)

    if use_matmul and _is_1d_fir_case(in1, in2):
        return fir_convolve_1d(in1, in2, mode)

    # Flip the kernel on every axis: conv primitives correlate (reference
    # flips with Nx.reverse, convolution.ex:137).
    kernel = jnp.flip(in2, axis=tuple(range(rank)))

    if mode == "same":
        # Extra padding goes on the LEFT for even kernels (reference:
        # convolution.ex:166-173) — this is what centers the output like
        # scipy.signal.convolve(mode='same').
        padding = [((k - 1) - (k - 1) // 2, (k - 1) // 2) for k in kernel.shape]
    elif mode == "full":
        padding = [(k - 1, k - 1) for k in kernel.shape]
    else:  # valid
        padding = [(0, 0)] * rank

    c1, c2 = is_complex_dtype(in1.dtype), is_complex_dtype(in2.dtype)
    if not c1 and not c2:
        return _conv_real(in1, kernel, padding)
    a, b = jnp.real(in1), jnp.imag(in1)
    c, d = jnp.real(kernel), jnp.imag(kernel)
    real = _conv_real(a, c, padding) - _conv_real(b, d, padding)
    imag = _conv_real(a, d, padding) + _conv_real(b, c, padding)
    return real + 1j * imag.astype(real.dtype)


def _centered(out, new_shape):
    """Centered slice (reference: convolution.ex:319-329)."""
    starts = [(cur - new) // 2 for cur, new in zip(out.shape, new_shape)]
    return lax.slice(out, starts, [s + n for s, n in zip(starts, new_shape)])


def _apply_mode(out, s1, s2, mode):
    if mode == "full":
        return out
    if mode == "same":
        return _centered(out, s1)
    # valid: dominance check + swap on the full shapes (reference
    # convolution.ex:308-346)
    ok1 = all(a >= b for a, b in zip(s1, s2))
    ok2 = all(b >= a for a, b in zip(s1, s2))
    if ok1:
        big, small = s1, s2
    elif ok2:
        big, small = s2, s1
    else:
        raise ValueError(
            "For 'valid' mode, one must be at least as large as the other in every dimension."
        )
    return _centered(out, [a - b + 1 for a, b in zip(big, small)])


def fftconvolve(in1, in2, *, mode="full"):
    """N-D FFT convolution: per-axis DFT length N+K-1 (axes where either
    input has extent 1 are broadcast, not convolved), forward FFT both,
    multiply, inverse, real output iff both inputs are real (reference:
    convolution.ex:252-298).

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.convolution import fftconvolve
    >>> y = fftconvolve(jnp.asarray([1.0, 2.0, 3.0]), jnp.asarray([0.0, 1.0, 0.5]))
    >>> np.round(np.asarray(y), 4)
    array([-0. ,  1. ,  2.5,  4. ,  1.5], dtype=float32)

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.convolution import fftconvolve
    >>> out = fftconvolve(jnp.asarray([1.0, 2.0, 3.0]), jnp.asarray([0.0, 1.0, 0.5]))
    >>> np.round(np.asarray(out), 5)
    array([-0. ,  1. ,  2.5,  4. ,  1.5], dtype=float32)
    """
    if mode not in _MODES:
        raise ValueError(f"expected mode to be one of ['full', 'same', 'valid'], got: {mode}")
    in1, in2 = jnp.asarray(in1), jnp.asarray(in2)
    if in1.ndim != in2.ndim:
        raise ValueError("Rank of in1 and in2 must be equal.")
    if in1.ndim == 0:
        return _float_cast(in1) * _float_cast(in2)

    s1, s2 = in1.shape, in2.shape
    axes = [ax for ax in range(in1.ndim) if s1[ax] != 1 and s2[ax] != 1]
    exact = [s1[ax] + s2[ax] - 1 for ax in axes]
    fast = [fft_fast_length(n) for n in exact]

    in1 = _float_cast(in1)
    in2 = _float_cast(in2)
    complex_result = is_complex_dtype(in1.dtype) or is_complex_dtype(in2.dtype)

    if not axes:
        out = in1 * in2
    elif complex_result:
        sp = fft_nd(in1, axes=axes, lengths=fast) * fft_nd(in2, axes=axes, lengths=fast)
        out = ifft_nd(sp, axes=axes)
    else:
        sp = rfft_nd(in1, axes=axes, lengths=fast) * rfft_nd(in2, axes=axes, lengths=fast)
        out = irfft_nd(sp, axes=axes, lengths=fast)
    # Trim the fast-length padding back to the exact linear-conv extent.
    if axes:
        starts = [0] * out.ndim
        limits = list(out.shape)
        for ax, n in zip(axes, exact):
            limits[ax] = n
        out = lax.slice(out, starts, limits)

    full_shape = [
        max(a, b) if ax not in axes else s1[ax] + s2[ax] - 1
        for ax, (a, b) in enumerate(zip(s1, s2))
    ]
    out = jnp.broadcast_to(out, full_shape) if list(out.shape) != full_shape else out
    return _apply_mode(out, s1, s2, mode)


def _oa_block_length(k: int) -> int:
    """Pick the overlap-add FFT block size: minimize FFT work per output
    sample over smooth candidate sizes (classic OA cost model)."""
    best, best_cost = None, None
    n = fft_fast_length(2 * k)
    while n <= fft_fast_length(64 * k):
        step = n - k + 1
        cost = n * math.log2(max(n, 2)) / step
        if best_cost is None or cost < best_cost:
            best, best_cost = n, cost
        n = fft_fast_length(n + 1)
    return best


def oaconvolve(in1, in2, *, mode="full", block_length=None):
    """Overlap-add convolution along the last axis — the streaming/long-signal
    FIR fast path missing from the reference (convolutions_test.exs:633-654
    is commented out there).

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.convolution import oaconvolve
    >>> y = oaconvolve(jnp.asarray([1.0, 2.0, 3.0]), jnp.asarray([1.0, 1.0]),
    ...                mode="same")
    >>> np.round(np.asarray(y), 4)
    array([1., 3., 5.], dtype=float32)

    The signal (..., N) is cut into steps of B-K+1 samples, each block is
    convolved with the (..., K) kernel via rfft of power-of-two length B, and the
    K-1 block tails are overlap-added with the deterministic fold from
    spectral/framing.py. Leading axes must broadcast. Output matches
    `fftconvolve` (same mode semantics) within float tolerance.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.convolution import oaconvolve
    >>> out = oaconvolve(jnp.ones(16), jnp.asarray([0.25, 0.5, 0.25]), mode="same")
    >>> np.round(np.asarray(out), 5)
    array([0.75, 1.  , 1.  , 1.  , 1.  , 1.  , 1.  , 1.  , 1.  , 1.  , 1.  ,
           1.  , 1.  , 1.  , 1.  , 0.75], dtype=float32)
    """
    if mode not in _MODES:
        raise ValueError(f"expected mode to be one of ['full', 'same', 'valid'], got: {mode}")
    in1, in2 = jnp.asarray(in1), jnp.asarray(in2)
    if in1.ndim != in2.ndim:
        raise ValueError("Rank of in1 and in2 must be equal.")
    if in1.ndim == 0:
        return _float_cast(in1) * _float_cast(in2)
    s1, s2 = in1.shape, in2.shape
    n, k = s1[-1], s2[-1]
    if n == 1 or k == 1 or any(a != 1 and b != 1 and a != b for a, b in zip(s1[:-1], s2[:-1])):
        # Degenerate or multi-axis-conv cases: defer to fftconvolve.
        return fftconvolve(in1, in2, mode=mode)
    signal, kernel = (in1, in2) if n >= k else (in2, in1)
    n, k = signal.shape[-1], kernel.shape[-1]

    signal = _float_cast(signal)
    kernel = _float_cast(kernel)
    complex_result = is_complex_dtype(signal.dtype) or is_complex_dtype(kernel.dtype)

    block = int(block_length) if block_length is not None else _oa_block_length(k)
    block = max(block, k)
    step = block - k + 1
    num_blocks = -(-n // step)

    pad = [(0, 0)] * (signal.ndim - 1) + [(0, num_blocks * step - n)]
    blocks = jnp.pad(signal, pad).reshape(*signal.shape[:-1], num_blocks, step)

    if complex_result:
        sp_k = jnp.fft.fft(kernel, n=block, axis=-1)
        sp_b = jnp.fft.fft(blocks, n=block, axis=-1)
        conv_blocks = jnp.fft.ifft(sp_b * sp_k[..., None, :], axis=-1)
    else:
        sp_k = jnp.fft.rfft(kernel, n=block, axis=-1)
        sp_b = jnp.fft.rfft(blocks, n=block, axis=-1)
        conv_blocks = jnp.fft.irfft(sp_b * sp_k[..., None, :], n=block, axis=-1)

    # Each convolved block spans step + k - 1 samples; overlap-add with
    # overlap k-1 (deterministic fold => block-order summation).
    full_len = n + k - 1
    out = _ola_fold(conv_blocks[..., : step + k - 1], step,
                    num_blocks * step + k - 1)[..., :full_len]

    full_shape = [max(a, b) for a, b in zip(s1[:-1], s2[:-1])] + [full_len]
    out = jnp.broadcast_to(out, full_shape) if list(out.shape) != full_shape else out
    return _apply_mode(out, s1, s2, mode)


def correlation_lags(in1_len: int, in2_len: int, mode: str = "full"):
    """Lag indices for the output of `correlate(in1, in2, mode=mode)` —
    scipy.signal.correlation_lags semantics: lag k corresponds to
    correlation between in1 and in2 shifted by k samples. Host-side numpy
    (shape math, not tensor compute). Not in the reference.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.ops.convolution import correlation_lags
    >>> np.asarray(correlation_lags(3, 3, mode="full"))
    array([-2, -1,  0,  1,  2])
    """
    import numpy as np

    in1_len, in2_len = int(in1_len), int(in2_len)
    if in1_len < 1 or in2_len < 1:
        raise ValueError("input lengths must be >= 1")
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        lag_bound = in1_len // 2
        if in1_len % 2 == 0:
            return lags[mid - lag_bound : mid + lag_bound]
        return lags[mid - lag_bound : mid + lag_bound + 1]
    if mode == "valid":
        if in1_len >= in2_len:
            return np.arange(in1_len - in2_len + 1)
        return np.arange(in1_len - in2_len, 1)
    raise ValueError(
        f"invalid mode, expected one of 'full', 'same', 'valid', got: {mode}"
    )


def deconvolve(signal, divisor):
    """Polynomial/impulse-response deconvolution: find (quotient, remainder)
    with signal = convolve(divisor, quotient) + remainder —
    scipy.signal.deconvolve semantics via inverse filtering: the quotient is
    the impulse response of the IIR filter b=signal, a=divisor truncated to
    N - D + 1 samples. 1-D only, f64 host-grade accuracy through the scan
    lfilter. Not in the reference.

    Examples:

    (1 + x)^3 divided by (1 + x) gives (1 + x)^2 exactly:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.convolution import deconvolve
    >>> q, r = deconvolve(jnp.asarray([1.0, 3.0, 3.0, 1.0]),
    ...                   jnp.asarray([1.0, 1.0]))
    >>> np.round(np.asarray(q), 4)
    array([1., 2., 1.], dtype=float32)
    >>> np.round(np.asarray(r), 4)
    array([0., 0., 0., 0.], dtype=float32)
    """
    from nx_signal_tpu.ops.iir import lfilter

    num = jnp.atleast_1d(jnp.asarray(signal))
    den = jnp.atleast_1d(jnp.asarray(divisor))
    if num.ndim != 1 or den.ndim != 1:
        raise ValueError("deconvolve requires 1-D signal and divisor")
    n = num.shape[0] - den.shape[0] + 1
    if n <= 0:
        quot = jnp.zeros((0,), num.dtype)
        return quot, num
    impulse = jnp.zeros((n,), num.dtype).at[0].set(1.0)
    quot = lfilter(num, den, impulse)
    rem = num - convolve(den, quot, mode="full")
    return quot, rem


def choose_conv_method(in1, in2, mode: str = "full"):
    """Pick 'direct' or 'fft' for `convolve` by operand size —
    scipy.signal.choose_conv_method's contract with a size rule: the
    direct path (Toeplitz matmul / lax.conv) is chosen until the smaller
    operand is large (this crossover predates the H100 and is not
    measured there yet). Integer inputs always use
    'direct' (exact, like scipy).

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.convolution import choose_conv_method
    >>> choose_conv_method(jnp.zeros(100), jnp.zeros(5))
    'direct'
    """
    in1 = jnp.asarray(in1)
    in2 = jnp.asarray(in2)
    if jnp.issubdtype(in1.dtype, jnp.integer) and jnp.issubdtype(in2.dtype, jnp.integer):
        return "direct"
    if in1.ndim != in2.ndim:
        return "direct"  # fftconvolve requires equal ranks
    small = min(
        (np_prod_positive(in1.shape), np_prod_positive(in2.shape))
    )
    # crossover: the direct path until the smaller operand carries ~4k
    # taps (vs scipy's low hundreds on CPU)
    return "fft" if small >= 4096 else "direct"


def np_prod_positive(shape):
    out = 1
    for s in shape:
        out *= max(1, int(s))
    return out
