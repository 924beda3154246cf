"""Polyphase resampling and filterbanks (scipy.signal.upfirdn /
resample_poly semantics) — new components beyond the reference (BASELINE
configs 4-5: 48 kHz -> 16 kHz resample, wideband polyphase channelizer).

Design: no zero-stuffing ever happens. `upfirdn` is evaluated in
polyphase form — for output residue class r (mod up), the needed input
windows form a stride-`down` frame matrix (built with the gather-free
slice/reshape framing) and the phase filter is applied as a single
matvec. The polyphase channelizer is frames-reshape + weighted sum + one
batched FFT across channels.
"""

import math

import jax
import jax.numpy as jnp
from jax import lax

from nx_signal_tpu.ops.filters import firwin
from nx_signal_tpu.spectral.framing import as_windowed
from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT, is_complex_dtype

__all__ = ["upfirdn", "resample_poly", "pfb_analyze",
           "pfb_footprint_bytes", "resample", "decimate"]


def _upfirdn_out_len(n_in: int, k: int, up: int, down: int) -> int:
    return -(-((n_in - 1) * up + k) // down)


def _phase_bank(h, up: int):
    """Phase filter bank H[p, t] = h[p + t*up], reversed in t so a plain
    frame-window dot computes the correlation sum. Returns (bank (up, T), T)."""
    k = h.shape[0]
    num_phases = -(-k // up)  # taps per phase (T)
    h_pad = jnp.pad(h, (0, num_phases * up - k))
    return h_pad.reshape(num_phases, up).T[:, ::-1], num_phases


def _upfirdn_dtype(h, x):
    dtype = jnp.promote_types(h.dtype, x.dtype)
    if not (jnp.issubdtype(dtype, jnp.floating) or is_complex_dtype(dtype)):
        dtype = DEFAULT_FLOAT
    return dtype


def _upfirdn_phase_outputs(ext, bank, up: int, down: int, *, n_offset: int,
                           n_count: int):
    """Outputs n = n_offset .. n_offset+n_count-1 of the upfirdn correlation
    out[n] = sum_t H[p_n, t] * x[q_n - t], p_n = (n*down) % up,
    q_n = (n*down)//up, computed from an already-extended signal `ext` whose
    index convention is ext[q + T - 1] = x[q] (i.e. the caller prepends the
    T-1 samples of left context — zeros at the stream edge, halo samples in
    a sharded block). The local index ℓ = n - n_offset; outputs are grouped
    by ℓ mod up, each group one strided-frame matrix times a phase filter
    (a matvec); no stuffed zeros are ever materialized or multiplied.

    This same core serves the single-device `upfirdn` (n_offset=0) and the
    per-device body of parallel.sharded_upfirdn / sharded_resample_poly
    (n_offset = the global output offset, identical on every device because
    out_block*down == block_in*up makes the phase pattern device-periodic).

    Evaluation: ONE blocked conv-of-blocks matmul for a lane-filling TILE
    of R consecutive outputs per frame row (R a multiple of `up` near
    128, not the minimal R = up). Column r of the banded weight matrix
    holds phase filter p_r at row offset o_r - o_min (o_r = the output's
    window start), and the frame stride becomes (R//up)*down. At R = up
    the hop blocks are only `down` samples wide, which leaves the matmul
    almost empty for decimation; the R~128 tile gives it full-width rows
    at the cost of a mostly-zero banded weight (its speed on the H100 is
    not measured yet). Falls back to R = up when the banded weight would
    be huge (very large `down`).
    No frame matrix is ever materialized (the previous as_windowed +
    matvec form expanded the input T/down-fold: 14 GB for 64ch x 60 s @
    48 kHz with a 61-tap phase filter, found by scripts/configs_bench.py)."""
    import jax

    from nx_signal_tpu.kernels.dft import blocked_frame_matmul

    t_taps = bank.shape[1]
    batch = ext.shape[:-1]
    r_tile = -(-128 // up) * up
    est_window = t_taps + (r_tile // up) * down
    if r_tile > up and est_window * r_tile > (1 << 22):
        r_tile = up   # banded weight would exceed ~16 MB: minimal tile
    n_classes = min(r_tile, n_count)
    offsets = [((n_offset + r) * down) // up for r in range(n_classes)]
    phases = [((n_offset + r) * down) % up for r in range(n_classes)]
    o_min = min(offsets)
    window_length = t_taps + max(offsets) - o_min
    num_frames = (n_count - 1) // n_classes + 1
    if n_classes % up == 0:
        stride = (n_classes // up) * down
    else:
        # partial tile (n_classes == n_count, not a multiple of up):
        # num_frames == 1, so the stride only sizes the single frame
        stride = down
    if isinstance(bank, jax.core.Tracer):
        w = jnp.zeros((window_length, n_classes), dtype=bank.dtype)
        for r in range(n_classes):
            s = offsets[r] - o_min
            w = w.at[s:s + t_taps, r].set(bank[phases[r]])
    else:
        import numpy as _np

        bank_np = _np.asarray(bank)
        w_np = _np.zeros((window_length, n_classes), dtype=bank_np.dtype)
        for r in range(n_classes):
            s = offsets[r] - o_min
            w_np[s:s + t_taps, r] = bank_np[phases[r]]
        w = jnp.asarray(w_np)
    # conv-of-blocks when the block-axis kernel stays short; the C-tap
    # conv reuses each input sample inside the convolution (no frame
    # materialization). Long kernels (small `down`) and complex dtypes
    # take the materialized-frames matmul instead (lax.conv is real-only
    # here).
    c_blocks = -(-window_length // stride)
    strategy = ("conv" if c_blocks <= 32
                and not is_complex_dtype(ext.dtype)
                and not is_complex_dtype(w.dtype) else "materialize")
    out = blocked_frame_matmul(
        ext[..., o_min:], w, window_length=window_length, stride=stride,
        num_frames=num_frames, precision="highest", strategy=strategy,
    )  # (..., J, n_classes): cell (j, r) = output j*n_classes + r
    if n_classes == 1:
        return out[..., :n_count, 0]
    return out.reshape(*batch, num_frames * n_classes)[..., :n_count]


def upfirdn(h, x, up: int = 1, down: int = 1):
    """Upsample by `up` (conceptually zero-stuffing), FIR filter with `h`,
    downsample by `down` — scipy.signal.upfirdn semantics over the last axis
    of `x` (leading axes are batch).

    Polyphase evaluation: out[n] = sum_t H[p_n, t] * x[q_n - t] with
    p_n = (n*down) % up, q_n = (n*down) // up, H[p, t] = h[p + t*up].
    Outputs are grouped by n mod up so each group is one strided-frame
    matrix times a phase filter (a matvec); no stuffed zeros are ever
    materialized or multiplied.

    Examples:

    2x zero-stuffed upsampling through a length-3 boxcar:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.resample import upfirdn
    >>> h = jnp.asarray([1.0, 1.0, 1.0])
    >>> y = upfirdn(h, jnp.asarray([1.0, 2.0, 3.0]), up=2, down=1)
    >>> np.round(np.asarray(y), 4)
    array([1., 1., 3., 2., 5., 3., 3.], dtype=float32)
    """
    h = jnp.asarray(h)
    x = jnp.asarray(x)
    if h.ndim != 1:
        raise ValueError(f"h must be 1-D, got rank {h.ndim}")
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got: up={up}, down={down}")
    k = h.shape[0]
    n_in = x.shape[-1]
    n_out = _upfirdn_out_len(n_in, k, up, down)

    dtype = _upfirdn_dtype(h, x)
    h = h.astype(dtype)
    x = x.astype(dtype)
    bank, t_taps = _phase_bank(h, up)

    # Left-pad T-1 zeros (ext[q + T - 1] = x[q]) plus whatever right zeros
    # the final windows read past the signal end.
    batch = x.shape[:-1]
    q_max = ((n_out - 1) * down) // up
    pad_right = max(0, q_max + 1 - n_in)
    ext = jnp.pad(x, [(0, 0)] * len(batch) + [(t_taps - 1, pad_right)])
    return _upfirdn_phase_outputs(ext, bank, up, down, n_offset=0,
                                  n_count=n_out)


def _resample_poly_design(up: int, down: int, window, taps):
    """Shared resample_poly setup: gcd-reduce the ratio, design (or accept)
    the odd-length anti-alias prototype, apply scipy's group-delay
    pre-padding. Returns (up, down, h_padded, n_pre_remove)."""
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got: up={up}, down={down}")
    g = math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    if taps is None:
        max_rate = max(up, down)
        half_len = 10 * max_rate
        h = firwin(2 * half_len + 1, [1.0 / max_rate], window=window)
    else:
        h = jnp.asarray(taps)
        if h.shape[0] % 2 != 1:
            raise ValueError("resample_poly prototype filter must have odd length")
        half_len = (h.shape[0] - 1) // 2
    h = h * up
    # Zero-pad the filter front so its group delay lands on an output-grid
    # sample, then drop the delay (scipy's alignment).
    n_pre_pad = (down - half_len % down) % down
    h = jnp.concatenate([jnp.zeros(n_pre_pad, h.dtype), h])
    n_pre_remove = (half_len + n_pre_pad) // down
    return up, down, h, n_pre_remove


def resample_poly(x, up: int, down: int, *, window=("kaiser", 5.0), taps=None):
    """Rational-rate polyphase resampling, scipy.signal.resample_poly
    semantics over the last axis: gcd-reduce up/down, design an anti-alias
    FIR (kaiser 5.0 by default, 10*max(up,down) half-length) scaled by
    `up`, apply via `upfirdn`, and slice the centered n_in*up/down samples.
    Pass `taps` to use a custom prototype filter instead.

    Examples:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.resample import resample_poly
    >>> out = resample_poly(jnp.asarray([0.0, 1.0, 2.0, 3.0]), 2, 1)
    >>> np.round(np.asarray(out), 4)
    array([0.    , 0.5614, 1.0005, 1.2946, 2.001 , 2.9651, 3.0016, 1.6071],
          dtype=float32)
    """
    x = jnp.asarray(x)
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got: up={up}, down={down}")
    if int(up) == int(down):
        return x
    up, down, h, n_pre_remove = _resample_poly_design(up, down, window, taps)
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)

    y = upfirdn(h, x, up, down)
    return y[..., n_pre_remove : n_pre_remove + n_out]


def pfb_analyze(x, n_channels: int, *, taps_per_channel: int = 8, window=("kaiser", 5.0),
                taps=None, shift: bool = False, strategy: str = "auto",
                precision="highest"):
    """Critically-sampled polyphase analysis filterbank (DFT channelizer) —
    the wideband-SDR front end (BASELINE config 5).

    Splits the last axis of `x` into `n_channels` equal sub-bands, each
    decimated by n_channels: frames of n_channels*taps_per_channel samples
    at stride n_channels, weighted by the polyphase decomposition of the
    prototype low-pass, summed over taps, then a DFT across the channel
    axis. Returns (..., frames, channels) complex.

    The prototype defaults to firwin(n_channels*taps_per_channel,
    1/n_channels, kaiser 5.0); pass `taps` to override. `shift=True` applies
    fftshift over the channel axis (center-DC ordering).

    Execution strategies (all mathematically identical; the PFB *is* a
    framed DFT with the wrapped phase e^(-2i*pi*k*n/m), so it rides the
    chain's matmul machinery):

    * 'matmul' (real input): ONE conv-of-blocks matmul against the
      aliased-DFT weight matrix W[n, k] = proto[n] * e^(-2i*pi*k*n/m)
      of shape (m*taps_per_channel, 2*m) — zero frame materialization,
      the `blocked_frame_matmul` strategy='conv' path.
    * 'factored' (real input): polyphase sum first as taps_per_channel
      shifted multiply-adds over the free (blocks, m) reshape view (no
      frames buffer), then one (T, m) @ (m, 2*m) DFT matmul — the
      FLOP-minimal form, preferred for large m where the combined
      matmul's K = m*taps_per_channel costs taps_per_channel-fold more
      work.
    * 'einsum': the reference formulation (as_windowed frames + weighted
      sum + batched FFT) — a (taps_per_channel)-fold frame expansion in
      device memory;
      kept for complex input and as the oracle.
    * 'auto': 'factored' for real input with m >= 64, 'matmul' for
      smaller real filterbanks (its K = m*taps_per_channel keeps the
      contraction large), 'einsum' for complex input. This rule predates
      the H100 and is not measured there yet.

    Dtype note: the matmul strategies ('matmul', 'factored') compute in
    float32 (stacked-real weight layout). 'auto' therefore routes float64
    input to 'einsum', which preserves the promoted dtype; requesting an
    matmul strategy explicitly on float64 input downcasts to f32 and emits a
    UserWarning.

    Examples:

    An 8-band filterbank on one 4096-sample stream yields (1, frames, 8):

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.resample import pfb_analyze
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(1, 4096)),
    ...                 jnp.float32)
    >>> pfb_analyze(x, 8, taps_per_channel=4).shape
    (1, 509, 8)
    """
    x = jnp.asarray(x)
    m = n_channels
    if taps is None:
        proto = firwin(m * taps_per_channel, [1.0 / m], window=window)
    else:
        proto = jnp.asarray(taps)
        if proto.shape[0] % m != 0:
            raise ValueError(
                f"prototype length ({proto.shape[0]}) must be a multiple of "
                f"n_channels ({m})"
            )
        taps_per_channel = proto.shape[0] // m

    dtype = jnp.promote_types(x.dtype, proto.dtype)
    if not (jnp.issubdtype(dtype, jnp.floating) or is_complex_dtype(dtype)):
        dtype = DEFAULT_FLOAT
    x = x.astype(dtype)
    complex_in = is_complex_dtype(dtype)

    if strategy not in ("auto", "matmul", "factored", "einsum"):
        raise ValueError("strategy must be 'auto', 'matmul', 'factored' or "
                         f"'einsum', got {strategy!r}")
    if strategy == "auto":
        if complex_in or dtype == jnp.float64:
            # einsum preserves the promoted dtype; the matmul strategies
            # compute in f32 (stacked-real weights) — keep f64 callers at
            # f64 accuracy unless they opt in explicitly
            strategy = "einsum"
        elif m >= 64:
            strategy = "factored"
        else:
            strategy = "matmul"
    if strategy in ("matmul", "factored") and complex_in:
        raise ValueError(
            f"strategy={strategy!r} requires real input (the stacked-real "
            "weight layout); use 'einsum' for complex signals")
    if strategy in ("matmul", "factored") and dtype == jnp.float64:
        import warnings

        warnings.warn(
            f"pfb_analyze strategy={strategy!r} computes in float32 "
            "(stacked-real weights); float64 input is downcast. Use "
            "strategy='einsum' (or 'auto') to keep f64 accuracy.",
            UserWarning, stacklevel=2)

    window_length = m * taps_per_channel
    if x.shape[-1] < window_length:
        raise ValueError(
            f"signal length {x.shape[-1]} is shorter than the prototype "
            f"({window_length} taps)")

    if strategy == "matmul":
        channels = _pfb_matmul(x, proto, m, window_length, precision)
    elif strategy == "factored":
        # depthwise-conv sliding sum for m < 128, shifted adds at m >= 128
        channels = _pfb_factored(
            x, proto, m, taps_per_channel, precision,
            sum_mode="conv" if m < 128 else "shifts")
    else:
        weights = proto.reshape(taps_per_channel, m)
        frames = as_windowed(x, window_length=window_length, stride=m)
        batch_frames = frames.shape[:-1]
        blocks = frames.reshape(*batch_frames, taps_per_channel, m)
        # y[t, c] = sum_j w[j, c] * x[t*m + j*m + c]  (filter-and-decimate)
        summed = jnp.einsum("...jc,jc->...c", blocks, weights.astype(dtype),
                            precision="highest")
        channels = jnp.fft.fft(summed, axis=-1)
    if shift:
        channels = jnp.fft.fftshift(channels, axes=-1)
    return channels


def pfb_footprint_bytes(strategy: str, batch_elems: int, length: int,
                        n_channels: int, taps_per_channel: int) -> int:
    """Modeled peak HBM bytes of one `pfb_analyze` call (f32/c64 buffers,
    the `_auto_frame_chunks`-style planning model). Not in the reference.

    Per strategy, in units of the input size S = 4 * batch * length bytes:
    'einsum'   ~ (2 + tpc + 1 + 2 + 2) S  — input + padded copy + the
                 (frames, m*tpc) expansion (the tpc-fold As-windowed
                 blow-up) + summed + complex out;
    'matmul'   ~ (2 + 2 + 2) S            — input + padded copy + the
                 (frames, 2m) stacked Re|Im accumulator + complex out;
    'factored' ~ (2 + 1 + 2 + 2) S        — input + trimmed view's sum
                 buffer + accumulator + complex out.

    Example: the 1024-band config-5 point at 8 x 4.19 Msamples models
    ~0.9 GB ('factored') vs ~2.0 GB ('einsum').

    Examples:

    >>> from nx_signal_tpu.ops.resample import pfb_footprint_bytes
    >>> s = 4 * 8 * 4_194_304
    >>> pfb_footprint_bytes('factored', 8, 4_194_304, 1024, 8) // s
    7
    """
    s = 4 * batch_elems * length
    mults = {"einsum": 2 + taps_per_channel + 5, "matmul": 6, "factored": 7}
    if strategy not in mults:
        raise ValueError("strategy must be 'matmul', 'factored' or "
                         f"'einsum', got {strategy!r}")
    return mults[strategy] * s


def _pfb_matmul(x, proto, m, window_length, precision):
    """PFB as one conv-of-blocks framed-DFT matmul: Y[t, k] =
    frame_t @ W with W[n, k] = proto[n] e^(-2i*pi*k*n/m) — the DFT phase
    wraps mod m exactly as `_dft_weights` computes it for n_fft < frame."""
    import numpy as np

    from nx_signal_tpu.kernels.dft import _dft_weights, blocked_frame_matmul

    num_frames = (x.shape[-1] - window_length) // m + 1
    if isinstance(proto, jax.core.Tracer):
        # proto built inside an enclosing jit (e.g. the firwin default):
        # take _dft_weights' jnp path — XLA constant-folds the matrix when
        # the prototype is a trace-constant
        weights = _dft_weights(proto.astype(DEFAULT_FLOAT), window_length,
                               m, False, DEFAULT_FLOAT)
    else:
        proto_np = np.asarray(proto, dtype=np.float64)
        weights = jnp.asarray(
            _dft_weights(proto_np, window_length, m, False, np.float64)
            .astype(np.float32))
    acc = blocked_frame_matmul(
        x.astype(DEFAULT_FLOAT), weights, window_length=window_length,
        stride=m, num_frames=num_frames, precision=precision)
    return lax.complex(acc[..., :m], acc[..., m:])


def _pfb_factored(x, proto, m, taps_per_channel, precision,
                  sum_mode: str = "shifts"):
    """PFB with the polyphase sum factored out: the taps_per_channel-tap
    weighted sliding sum over the free hop-block view (16
    FLOP/sample), then one (T, m) @ (m, 2m) DFT matmul — the
    FLOP-minimal form (the combined matmul costs taps_per_channel-fold
    more work).

    `sum_mode` selects the sliding-sum lowering: 'shifts' =
    taps_per_channel shifted multiply-adds; 'conv' = ONE depthwise
    `lax.conv` over the block axis (tpc taps, feature_group_count=m) —
    a single fused pass instead of tpc slice reads, the same conv-
    emitter shape class that wins the chain (A/B:
    scripts/pfb_factored_conv_r4.py)."""
    import numpy as np

    from nx_signal_tpu.kernels.dft import _dft_weights

    x = x.astype(DEFAULT_FLOAT)
    batch = x.shape[:-1]
    length = x.shape[-1]
    nb = length // m
    num_frames = nb - taps_per_channel + 1
    u = x[..., :nb * m].reshape(*batch, nb, m)
    w = proto.astype(DEFAULT_FLOAT).reshape(taps_per_channel, m)
    if sum_mode == "conv":
        u2 = u.reshape(-1, nb, m)
        s = lax.conv_general_dilated(
            u2, w[:, None, :], window_strides=(1,), padding="VALID",
            dimension_numbers=("NWC", "WIO", "NWC"), feature_group_count=m,
            precision=precision)
        s = s.reshape(*batch, num_frames, m)
    else:
        s = w[0] * u[..., :num_frames, :]
        for j in range(1, taps_per_channel):
            s = s + w[j] * u[..., j:j + num_frames, :]
    ones = np.ones(m, dtype=np.float64)
    f_mat = jnp.asarray(
        _dft_weights(ones, m, m, False, np.float64).astype(np.float32))
    # Flatten leading axes into M for the DFT GEMM: one large matmul
    # instead of a batch of them, as in blocked_frame_matmul.
    # Bitwise-identical rows.
    lead = s.shape[:-1]
    acc = jnp.matmul(s.reshape(-1, m), f_mat, precision=precision)
    acc = acc.reshape(*lead, 2 * m)
    return lax.complex(acc[..., :m], acc[..., m:])


def resample(x, num: int, *, axis: int = -1, window=None):
    """Fourier-method resampling to exactly `num` samples along `axis` —
    scipy.signal.resample semantics: FFT, spectrum truncation/zero-padding
    with the even-length Nyquist-bin split, inverse FFT scaled by num/N.
    Assumes the signal is periodic (use `resample_poly` for streams).

    New relative to the reference (nx_signal has no resampling;
    SURVEY.md §2). `window` (a spec accepted by ops.windows.get_window or a
    length-N array) is applied to the spectrum, ifftshift-aligned, before
    resampling. Real input returns real output via the complex FFT (the
    Nyquist-split logic is exact either way).

    Examples:

    A 4-point sine period resampled to 8 points reproduces the sine:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.resample import resample
    >>> y = resample(jnp.asarray([0.0, 1.0, 0.0, -1.0]), 8)
    >>> np.round(np.asarray(y), 4)
    array([ 0.    ,  0.7071,  1.    ,  0.7071,  0.    , -0.7071, -1.    ,
           -0.7071], dtype=float32)
    """
    from nx_signal_tpu.ops.windows import get_window

    x = jnp.asarray(x)
    axis = axis % x.ndim
    n_in = x.shape[axis]
    if num <= 0:
        raise ValueError(f"num must be positive, got {num}")
    real_input = not is_complex_dtype(x.dtype)
    xm = jnp.moveaxis(x, axis, -1)
    spec = jnp.fft.fft(xm, axis=-1)
    if window is not None:
        # scipy conventions: a spec builds a PERIODIC (DFT-even) window and
        # is ifftshifted to fftfreq order; a callable is evaluated on
        # fftfreq(N); a raw array is already in fftfreq order.
        if callable(window):
            w = jnp.asarray(window(np.fft.fftfreq(n_in)))
        elif isinstance(window, (str, tuple, list)):
            w = jnp.fft.ifftshift(
                get_window(window, n_in, periodic=True, dtype=xm.real.dtype)
            )
        else:
            w = jnp.asarray(window)
        if w.shape != (n_in,):
            raise ValueError(
                f"window must have length {n_in}, got shape {w.shape}"
            )
        spec = spec * w
    n = min(num, n_in)
    nyq = n // 2 + 1
    out_shape = xm.shape[:-1] + (num,)
    y_spec = jnp.zeros(out_shape, dtype=spec.dtype)
    y_spec = y_spec.at[..., :nyq].set(spec[..., :nyq])
    if n > 2:
        y_spec = y_spec.at[..., nyq - n :].set(spec[..., nyq - n :])
    if n % 2 == 0:
        if num < n_in:
            # downsampling: fold the symmetric -N/2 component into the new
            # Nyquist bin
            y_spec = y_spec.at[..., n // 2].add(spec[..., n_in - n // 2])
        elif num > n_in:
            # upsampling: split the old Nyquist bin across +/- N/2
            y_spec = y_spec.at[..., n // 2].multiply(0.5)
            y_spec = y_spec.at[..., num - n // 2].set(y_spec[..., n // 2])
    y = jnp.fft.ifft(y_spec, axis=-1) * (num / n_in)
    if real_input:
        y = jnp.real(y)
    return jnp.moveaxis(y, -1, axis)


def decimate(x, q: int, *, n: int = None, ftype: str = "iir", axis: int = -1,
             zero_phase: bool = True):
    """Downsample by integer factor `q` after anti-alias filtering —
    scipy.signal.decimate semantics: ftype='iir' uses an order-8 Chebyshev-I
    filter (0.05 dB ripple, cutoff 0.8/q) applied zero-phase with filtfilt
    by default; ftype='fir' uses a 20*q+1-tap Hamming firwin at 1/q applied
    in centered polyphase form (group delay compensated).

    New relative to the reference. The IIR path runs as log-depth
    associative-scan biquads, the FIR path as the Toeplitz-matmul
    convolver — both on the device (ops/iir.py, ops/convolution.py).

    Examples:

    A ramp decimated 2x (FIR path) stays a ramp away from the edges:

    >>> import jax.numpy as jnp
    >>> import numpy as np
    >>> from nx_signal_tpu.ops.resample import decimate
    >>> y = decimate(jnp.arange(16.0), 2, ftype="fir")
    >>> np.round(np.asarray(y), 3)
    array([ 0.134,  2.027,  3.93 ,  6.139,  7.797, 10.348, 11.458, 15.104],
          dtype=float32)
    """
    from nx_signal_tpu.ops.iir import filtfilt, lfilter
    from nx_signal_tpu.ops.iir_design import cheby1

    if q <= 0:
        raise ValueError(f"q must be a positive integer, got {q}")
    x = jnp.asarray(x)
    axis = axis % x.ndim
    if ftype == "iir":
        order = 8 if n is None else int(n)
        b, a = cheby1(order, 0.05, 0.8 / q)
        y = filtfilt(b, a, x, axis=axis) if zero_phase else lfilter(b, a, x, axis=axis)
    elif ftype == "sos":
        # extension (not in scipy's decimate): the same Chebyshev-I
        # anti-alias filter as cascaded biquads -> every section runs as a
        # log-depth parallel scan instead of the order-8 sequential ba form
        from nx_signal_tpu.ops.iir import sosfilt, sosfiltfilt
        from nx_signal_tpu.ops.iir_design import cheby1 as _cheby1

        order = 8 if n is None else int(n)
        sos = _cheby1(order, 0.05, 0.8 / q, output="sos")
        y = sosfiltfilt(sos, x, axis=axis) if zero_phase else sosfilt(sos, x, axis=axis)
    elif ftype == "fir":
        numtaps = (20 * q if n is None else int(n)) + 1
        b = firwin(numtaps, [1.0 / q], window="hamming")
        xm = jnp.moveaxis(x, axis, -1)
        n_out = xm.shape[-1] // q + bool(xm.shape[-1] % q)
        if zero_phase:
            # polyphase with group-delay centering (scipy uses
            # resample_poly(x, 1, q, window=b) here)
            y = resample_poly(xm, 1, q, taps=b)[..., :n_out]
        else:
            y = upfirdn(b, xm, up=1, down=q)[..., :n_out]
        return jnp.moveaxis(y, -1, axis)
    else:
        raise ValueError(f"ftype must be 'iir', 'fir', or 'sos', got {ftype!r}")
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(None, None, q)
    return y[tuple(sl)]
