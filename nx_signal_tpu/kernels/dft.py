"""Fused framing + window + DFT as block matmuls.

The STFT's "fused window-multiply+frame" kernel (SURVEY.md §3.1). Instead
of materializing the (frames, frame_length) matrix and calling the FFT,
the whole transform is expressed as

    z = frames @ (diag(window) @ F)      F = DFT matrix [frame_length, bins]

and `frames` is never built: framing decomposes into C = ceil(frame/hop)
contiguous reshape-blocks of the signal (spectral/framing.py), so

    z = sum_r  x_block_r  @  W[r*hop : r*hop + w_r, :]

— C reshape+matmul+accumulate steps, zero gathers, zero materialization.
The DFT is O(N^2) against the FFT's O(N log N), so it can only pay for
small N; `good_matmul_fft_length` is the rule `method='auto'` follows.

Real and imaginary parts ride one stacked [Wr | Wi] matrix so each block is
a single f32 matmul with explicit `precision` (default 'highest': full
float32; lower settings may run the products in TF32 or bf16 passes).
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from nx_signal_tpu.spectral.framing import _frame_block_widths
from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT

__all__ = ["framed_dft", "framed_idft", "fir_framed_dft",
           "fir_dft_fold_weights",
           "fir_framed_dft_shared", "recognize_cosine_window",
           "good_matmul_fft_length", "blocked_frame_matmul", "toeplitz_band"]

#: largest fft_length for which `method='auto'` prefers the matmul DFT to
#: XLA's FFT. On the H100 the FFT won at every length timed, 128 to 2048,
#: and the FFT chain beat the FIR-folded matmul chain (PERF.md, bring-up
#: findings), so 'auto' never prefers the matmul DFT
_MAX_MATMUL_FFT = 0

#: share of the device's allocatable memory (`memory_stats()["bytes_limit"]`)
#: the 'auto' frame-chunking plans against; the rest is left to XLA's
#: workspace and to buffers the footprint model does not count
_DEVICE_MEMORY_MARGIN = 0.8

#: planning budget when the backend reports no memory stats (the CPU)
_NO_STATS_BUDGET = 12.5 * 1024 ** 3


def _hbm_budget() -> float:
    """Plannable device-memory bytes for the default device: its reported
    `bytes_limit` times `_DEVICE_MEMORY_MARGIN`, or `_NO_STATS_BUDGET`
    when the backend exposes no memory stats."""
    try:
        stats = jax.local_devices()[0].memory_stats()
        limit = stats.get("bytes_limit", 0) if stats else 0
    except Exception:
        limit = 0
    if not limit:
        return _NO_STATS_BUDGET
    return limit * _DEVICE_MEMORY_MARGIN


def _auto_frame_chunks(batch_elems: int, num_frames: int, cols: int,
                       in_elems: int) -> int:
    """Chunk count bounding peak device memory. Modeled footprints (f32
    bytes): dense = input + padded copy + power output + 1.15x the (batch,
    frames, cols) intermediate (conv workspace margin); chunked = the same
    with the intermediate divided by k and one extra output-sized buffer
    (the dynamic_update_slice chain's staging copy). Returns 1 whenever the
    dense dispatch fits: chunking is a fallback, not a default."""
    budget = _hbm_budget()
    in_b = 4 * in_elems
    out_b = 4 * batch_elems * num_frames * (cols // 2 + 1)
    inter = 4 * batch_elems * num_frames * cols
    if 2 * in_b + out_b + 1.15 * inter <= budget:
        return 1
    avail = budget - (2 * in_b + 2 * out_b)
    # floor at 5% of the budget: beyond that the fixed buffers dominate and
    # more chunks cannot help — chunk hard and let the attempt decide
    avail = max(avail, 0.05 * budget)
    return min(num_frames, max(1, int(-(-inter // avail))))


def toeplitz_band(taps, out_cols: int, xp=jnp):
    """Banded Toeplitz matrix of 1-D convolution: T[t, j] = taps[j + K-1 - t]
    for j <= t <= j+K-1, else 0 — shape (out_cols + K - 1, out_cols), so
    frames_ext @ T applies the filter. `xp` selects numpy (host-side weight
    folding) or jnp.

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.kernels.dft import toeplitz_band
    >>> np.round(np.asarray(toeplitz_band(jnp.asarray([1.0, 2.0, 3.0]), 4)), 1)
    array([[3., 0., 0., 0.],
           [2., 3., 0., 0.],
           [1., 2., 3., 0.],
           [0., 1., 2., 3.],
           [0., 0., 1., 2.],
           [0., 0., 0., 1.]], dtype=float32)
    """
    taps = xp.asarray(taps).reshape(-1)
    k = taps.shape[0]
    t_idx = xp.arange(out_cols + k - 1)[:, None]
    j_idx = xp.arange(out_cols)[None, :]
    m = j_idx + (k - 1) - t_idx
    zero = xp.zeros((), taps.dtype) if xp is jnp else taps.dtype.type(0)
    return xp.where((m >= 0) & (m < k), xp.take(taps, xp.clip(m, 0, k - 1)), zero)


def good_matmul_fft_length(n_fft: int) -> bool:
    """True when `method='auto'` prefers the O(N^2) matmul DFT to XLA's FFT
    for this length (`stft`, `istft`, `ShortTimeFFT`, `stft_fir_chain`).
    Whether the matmul DFT is *valid* is a separate, geometric question
    (real input, fft_length >= frame_length); explicit `method='matmul'`
    asks only that.

    Examples:

    >>> from nx_signal_tpu.kernels.dft import good_matmul_fft_length
    >>> good_matmul_fft_length(128), good_matmul_fft_length(4096)
    (False, False)
    """
    return n_fft <= _MAX_MATMUL_FFT


def blocked_frame_matmul(x, weights, *, window_length: int, stride: int,
                         num_frames: int, precision="highest",
                         strategy: str = "conv"):
    """Compute `as_windowed(x, window_length, stride)[:num_frames] @ weights`
    with gather-free framing (the C = ceil(window/stride) contiguous
    slice+reshape blocks of spectral/framing.py).

    Execution strategies (their speed on the H100 is not measured yet):

    * 'conv' (default): reshape the signal into NON-overlapping
      (num_frames + C - 1, stride) hop blocks — a free view — and run ONE
      `lax.conv` over the block axis with a C-tap kernel whose tap r holds
      weight rows [r*stride, (r+1)*stride). The frame matrix is never
      materialized: the C-fold input reuse happens inside the convolution
      instead of through a frames buffer in device memory.

    * 'materialize': build the (num_frames, window_length) frame matrix
      (C-fold expansion in device memory) and run one K = window_length
      matmul.

    * 'blocked': C separate (num_frames, w_r) @ (w_r, out) matmuls
      accumulating in device memory. Lowest peak memory.

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.windows import hann
    >>> x = jnp.asarray(np.sin(0.1 * np.arange(1024)), jnp.float32)
    >>> from nx_signal_tpu.kernels.dft import blocked_frame_matmul
    >>> wts = jnp.asarray(np.random.default_rng(0).normal(size=(256, 8)), jnp.float32)
    >>> acc = blocked_frame_matmul(x, wts, window_length=256, stride=64, num_frames=13)
    >>> acc.shape
    (13, 8)
    """
    x = jnp.asarray(x)
    weights = jnp.asarray(weights)
    widths = _frame_block_widths(window_length, stride)
    c_blocks = len(widths)
    needed = (num_frames + c_blocks - 1) * stride
    batch = x.shape[:-1]
    if needed > x.shape[-1]:
        x = jnp.pad(x, [(0, 0)] * len(batch) + [(0, needed - x.shape[-1])])
    if strategy == "conv" and c_blocks > 1:
        out_cols = weights.shape[-1]
        pad_rows = c_blocks * stride - window_length
        w = jnp.pad(weights, [(0, pad_rows), (0, 0)]) if pad_rows else weights
        kernel = w.reshape(c_blocks, stride, out_cols)          # WIO
        blocks = x[..., :needed].reshape(*batch, num_frames + c_blocks - 1,
                                         stride)
        flat = blocks.reshape(-1, num_frames + c_blocks - 1, stride)
        out = lax.conv_general_dilated(
            flat, kernel, window_strides=(1,), padding="VALID",
            dimension_numbers=("NWC", "WIO", "NWC"), precision=precision,
        )
        return out.reshape(*batch, num_frames, out_cols)
    if strategy in ("conv", "materialize") and c_blocks > 1:
        blocks = []
        for r, w_r in enumerate(widths):
            block = x[..., r * stride : (r + num_frames) * stride]
            block = block.reshape(*batch, num_frames, stride)
            blocks.append(block if w_r == stride else block[..., :w_r])
        frames = jnp.concatenate(blocks, axis=-1)
        if batch:
            # flatten leading batch axes into M: one large GEMM instead of
            # a stack of per-channel matmuls sharing the RHS
            flat = frames.reshape(-1, frames.shape[-1])
            out = jnp.matmul(flat, weights, precision=precision)
            return out.reshape(*batch, num_frames, weights.shape[-1])
        return jnp.matmul(frames, weights, precision=precision)
    acc = None
    for r, w_r in enumerate(widths):
        block = x[..., r * stride : (r + num_frames) * stride]
        block = block.reshape(*batch, num_frames, stride)
        if w_r < stride:
            block = block[..., :w_r]
        part = jnp.matmul(
            block, weights[r * stride : r * stride + w_r], precision=precision
        )
        acc = part if acc is None else acc + part
    return acc


def _dft_weights(window, frame_length: int, n_fft: int, onesided: bool, dtype):
    """[Wr | Wi] stacked (frame_length, 2*bins): the window-scaled DFT
    matrix restricted to the first frame_length input rows (zero-padding to
    n_fft is implicit).

    Concrete windows build in f64 numpy on host. A TRACED window (e.g. built
    inside an enclosing jit) takes a jnp path instead — the phase is reduced
    mod n_fft in exact integer arithmetic first so f32 cos/sin only ever see
    arguments in [-2pi, 0] (naive n*k/N angles reach ~3e3 rad, where f32
    range reduction loses most of the mantissa); XLA constant-folds the
    whole matrix at compile time when the window is a trace-constant."""
    bins = n_fft // 2 + 1 if onesided else n_fft
    if isinstance(window, jax.core.Tracer):
        k = jnp.arange(bins, dtype=jnp.int32)[None, :]
        n = jnp.arange(frame_length, dtype=jnp.int32)[:, None]
        angle = (-2.0 * np.pi / n_fft) * ((n * k) % n_fft).astype(dtype)
        w = window.astype(dtype)[:, None]
        return jnp.concatenate([w * jnp.cos(angle), w * jnp.sin(angle)], axis=1)
    bins_idx = np.arange(bins)[None, :]
    n = np.arange(frame_length)[:, None]
    angle = -2.0 * np.pi * n * bins_idx / n_fft
    w = np.asarray(window, dtype=np.float64)[:, None]
    wr = w * np.cos(angle)
    wi = w * np.sin(angle)
    return np.concatenate([wr, wi], axis=1).astype(dtype)


def framed_dft(x, window, *, stride: int, n_fft: int, onesided: bool = False,
               precision="highest", output: str = "complex"):
    """Windowed framed DFT of the (..., L) signal: returns complex
    (..., M, bins) with M = (L - frame_length)//stride + 1 — equal (to f32
    accuracy) to `fft(as_windowed(x, frame, stride) * window, n_fft)`.

    `output='power'` returns |z|^2 real directly from the stacked [Re | Im]
    matmul result (re^2 + im^2) without assembling complex values.

    The signal must already be padded (padding modes are handled by the
    caller, spectral/stft.py).

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.windows import hann
    >>> x = jnp.asarray(np.sin(0.1 * np.arange(1024)), jnp.float32)
    >>> from nx_signal_tpu.kernels.dft import framed_dft
    >>> z = framed_dft(x, hann(256), stride=64, n_fft=256, onesided=True)
    >>> z.shape
    (13, 129)
    >>> frame0 = np.asarray(x[:256]) * np.asarray(hann(256))
    >>> bool(np.abs(np.asarray(z[0]) - np.fft.rfft(frame0)).max() < 1e-3)
    True
    """
    x = jnp.asarray(x)
    window = jnp.asarray(window)
    frame_length = window.shape[-1]
    num_frames = (x.shape[-1] - frame_length) // stride + 1
    bins = n_fft // 2 + 1 if onesided else n_fft

    weights = jnp.asarray(
        _dft_weights(window, frame_length, n_fft, onesided, DEFAULT_FLOAT)
    )
    acc = blocked_frame_matmul(
        x.astype(DEFAULT_FLOAT), weights,
        window_length=frame_length, stride=stride, num_frames=num_frames,
        precision=precision,
    )
    if output == "power":
        return acc[..., :bins] ** 2 + acc[..., bins:] ** 2
    return lax.complex(acc[..., :bins], acc[..., bins:])


def _idft_weights(window, frame_length: int, n_fft: int, onesided: bool, dtype):
    """Inverse-DFT weight matrix fused with the synthesis-window multiply.

    Full spectrum: G = (1/N) conj(F)[:, :frame_length] * w  (complex,
    returned as the real 2x2 block matrix [[Gr, Gi], [-Gi, Gr]] so
    [Re z | Im z] @ G -> [Re frames | Im frames]).
    Onesided: real irfft weights with the conjugate-symmetry factor of 2 on
    interior bins; returns (2*bins, frame_length) mapping [Re z | Im z] to
    real frames.
    """
    if isinstance(window, jax.core.Tracer):
        # traced window: jnp build with exact integer phase reduction (see
        # _dft_weights); constant-folded by XLA for trace-constant windows
        n = jnp.arange(frame_length, dtype=jnp.int32)[None, :]
        w = window.astype(dtype)[None, :]
        if onesided:
            bins = n_fft // 2 + 1
            k = jnp.arange(bins, dtype=jnp.int32)[:, None]
            factor = np.full((bins, 1), 2.0, np.float64)
            factor[0, 0] = 1.0
            if n_fft % 2 == 0:
                factor[-1, 0] = 1.0
            factor = jnp.asarray(factor.astype(dtype))
            angle = (2.0 * np.pi / n_fft) * ((k * n) % n_fft).astype(dtype)
            g_re = factor * jnp.cos(angle) / n_fft * w
            g_im = -factor * jnp.sin(angle) / n_fft * w
            return jnp.concatenate([g_re, g_im], axis=0)
        k = jnp.arange(n_fft, dtype=jnp.int32)[:, None]
        angle = (2.0 * np.pi / n_fft) * ((k * n) % n_fft).astype(dtype)
        g_re = jnp.cos(angle) / n_fft * w
        g_im = jnp.sin(angle) / n_fft * w
        top = jnp.concatenate([g_re, g_im], axis=1)
        bot = jnp.concatenate([-g_im, g_re], axis=1)
        return jnp.concatenate([top, bot], axis=0)
    n = np.arange(frame_length)[None, :]
    w = np.asarray(window, dtype=np.float64)[None, :]
    if onesided:
        bins = n_fft // 2 + 1
        k = np.arange(bins)[:, None]
        factor = np.full((bins, 1), 2.0)
        factor[0, 0] = 1.0
        if n_fft % 2 == 0:
            factor[-1, 0] = 1.0
        angle = 2.0 * np.pi * k * n / n_fft
        g_re = factor * np.cos(angle) / n_fft * w
        g_im = -factor * np.sin(angle) / n_fft * w
        return jnp.asarray(np.concatenate([g_re, g_im], axis=0).astype(dtype))
    k = np.arange(n_fft)[:, None]
    angle = 2.0 * np.pi * k * n / n_fft
    g_re = np.cos(angle) / n_fft * w
    g_im = np.sin(angle) / n_fft * w
    top = np.concatenate([g_re, g_im], axis=1)      # z_re @ [Gr | Gi]
    bot = np.concatenate([-g_im, g_re], axis=1)     # z_im @ [-Gi | Gr]
    return jnp.asarray(np.concatenate([top, bot], axis=0).astype(dtype))


def framed_idft(z, window, *, n_fft: int, onesided: bool = False,
                precision="highest"):
    """Inverse of `framed_dft` fused with the synthesis-window multiply:
    (..., M, bins) spectrum -> windowed time frames, as matmuls.

    Full-spectrum input returns complex frames (= ifft(z) * window);
    onesided input returns real frames (irfft reconstruction). The caller
    overlap-adds (spectral/stft.py istft).

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.windows import hann
    >>> x = jnp.asarray(np.sin(0.1 * np.arange(1024)), jnp.float32)
    >>> from nx_signal_tpu.kernels.dft import framed_dft, framed_idft
    >>> z = framed_dft(x, hann(256), stride=64, n_fft=256, onesided=True)
    >>> f = framed_idft(z, hann(256), n_fft=256, onesided=True)
    >>> f.shape, f.dtype
    ((13, 256), dtype('float32'))
    """
    z = jnp.asarray(z)
    frame_length = jnp.asarray(window).shape[-1]
    # mirror (i)fft length semantics: pad/truncate the bin axis
    bins = n_fft // 2 + 1 if onesided else n_fft
    if z.shape[-1] < bins:
        z = jnp.pad(z, [(0, 0)] * (z.ndim - 1) + [(0, bins - z.shape[-1])])
    elif z.shape[-1] > bins:
        z = z[..., :bins]
    weights = _idft_weights(window, frame_length, n_fft, onesided, DEFAULT_FLOAT)
    stacked = jnp.concatenate(
        [jnp.real(z).astype(DEFAULT_FLOAT), jnp.imag(z).astype(DEFAULT_FLOAT)],
        axis=-1,
    )
    out = jnp.matmul(stacked, weights, precision=precision)
    if onesided:
        return out
    return lax.complex(out[..., :frame_length], out[..., frame_length:])


def fir_dft_fold_weights(taps, window, n_fft: int, onesided: bool,
                         traced: bool = False):
    """The fused chain's weight matrix T @ diag(w) @ F: the banded 'same'
    Toeplitz of `taps` folded into the window-scaled DFT matrix at build
    time. Shape (frame_length + K - 1, 2*bins) stacked [Re | Im]. Shared by
    `fir_framed_dft` and the sharded chain (parallel/sharded.py).

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.kernels.dft import fir_dft_fold_weights
    >>> from nx_signal_tpu.ops.windows import hann
    >>> W = fir_dft_fold_weights(jnp.asarray([0.25, 0.5, 0.25]), hann(256), 256, True)
    >>> W.shape
    (258, 258)
    """
    if traced:
        # jnp weight folding (constant-folded by XLA when taps/window are
        # trace-constants); full-f32 matmul for the host-side-equivalent fold
        taps = jnp.asarray(taps).reshape(-1)
        frame_length = window.shape[-1]
        toeplitz = toeplitz_band(taps.astype(DEFAULT_FLOAT), frame_length, jnp)
        if isinstance(window, jax.core.Tracer):
            dft_w = _dft_weights(window, frame_length, n_fft, onesided,
                                 DEFAULT_FLOAT)
        else:
            dft_w = jnp.asarray(
                _dft_weights(np.asarray(window, np.float64), frame_length,
                             n_fft, onesided, np.float64).astype(DEFAULT_FLOAT)
            )
        return jnp.matmul(toeplitz, dft_w, precision="highest")
    taps = np.asarray(taps, dtype=np.float64).reshape(-1)
    window = np.asarray(window, dtype=np.float64)
    frame_length = window.shape[-1]
    toeplitz = toeplitz_band(taps, frame_length, np)
    dft_w = _dft_weights(window, frame_length, n_fft, onesided, np.float64)
    return jnp.asarray((toeplitz @ dft_w).astype(DEFAULT_FLOAT))


def _fir_framed_dft_power_nopad(x, weights, *, ext, stride, pad_left,
                                num_frames, bins, precision):
    """Copy-free edge handling for the fused power chain: instead of
    materializing the padded signal copy xp (an ~8 B/sample memory round
    trip), shift the folded weight rows down by s = (-pad_left) % stride so
    the left context becomes WHOLE zero hop-blocks, then express both edge
    paddings as the conv's own spatial padding config — the convolution
    generates boundary zeros internally, no input copy exists.
    Requires the signal length to be a multiple of the hop and the shifted
    weights to still fit the same tap count (true for the bench geometry:
    766+1 <= 6*128). Returns None when the geometry does not apply (caller
    falls back to the padded-copy path). The extra all-zero weight rows
    contribute exact +0.0 terms, so accuracy is unchanged (same contraction
    values; association may differ from the padded path by the zero-row
    placement)."""
    length = x.shape[-1]
    s = (-pad_left) % stride
    c_blocks = -(-ext // stride)
    if length % stride or s + ext > c_blocks * stride or c_blocks <= 1:
        return None
    batch = x.shape[:-1]
    w = jnp.pad(weights, [(s, c_blocks * stride - ext - s), (0, 0)])
    kernel = w.reshape(c_blocks, stride, weights.shape[-1])     # WIO
    left_blocks = (pad_left + s) // stride
    n_in_blocks = length // stride
    # output position m contracts padded blocks [m, m + c_blocks); block j
    # of the padded sequence is input block j - left_blocks
    right_blocks = max(0, num_frames + c_blocks - 1
                       - (left_blocks + n_in_blocks))
    blocks = x.astype(DEFAULT_FLOAT).reshape(*batch, n_in_blocks, stride)
    flat = blocks.reshape(-1, n_in_blocks, stride)
    acc = lax.conv_general_dilated(
        flat, kernel, window_strides=(1,),
        padding=[(left_blocks, right_blocks)],
        dimension_numbers=("NWC", "WIO", "NWC"), precision=precision,
    )[:, :num_frames]
    acc = acc.reshape(*batch, num_frames, weights.shape[-1])
    return acc[..., :bins] ** 2 + acc[..., bins:] ** 2


def fir_framed_dft(x, taps, window, *, stride: int, n_fft: int,
                   onesided: bool = False, precision="highest",
                   output: str = "complex", frame_chunks=1, edge: str = "pad"):
    """FIR filtering fused INTO the framed DFT: the spectrum of
    convolve(x, taps, 'same') computed as one blocked matmul chain, with the
    Toeplitz filter matrix folded into the DFT weights at build time:

        z = frames_ext(x) @ (T @ diag(w) @ F)

    where frames_ext are (frame_length + K - 1)-wide windows of the signal
    (the extra K-1 samples supply the convolution context) and
    T[t, j] = taps[j + K - 1 - t] is the banded 'same'-mode Toeplitz. The
    filtered time signal is never materialized — one read of x per
    reshape-block, one write of z. This is the fast path of the
    STFT+FIR north-star chain when the filtered signal itself is not needed.

    `frame_chunks > 1` (power output only) splits the frame axis into that
    many sequential conv+power chunks inside one jit, each written into the
    output buffer via an in-place dynamic_update_slice. The (.., frames,
    2*bins) conv intermediate — which XLA materializes ahead of the power
    epilogue — then only ever exists one chunk at a time, cutting its peak
    memory footprint by the chunk count. Total memory traffic is
    unchanged; results match the unchunked path (same per-frame
    contractions). `frame_chunks='auto'` picks the smallest count whose
    modeled peak fits `_DEVICE_MEMORY_MARGIN` of the device's allocatable
    memory — 1 (no overhead) whenever the dense dispatch fits, so
    large-batch calls degrade to chunking instead of running out of
    memory.

    `edge='conv'` (power output, unchunked) eliminates the padded input
    COPY by folding the 'same' left context into the conv's own spatial
    padding (`_fir_framed_dft_power_nopad`): the weight rows shift by
    (-pad_left) % stride so both edges become whole zero hop-blocks the
    convolution generates internally — saving an ~8 B/sample memory round
    trip when the geometry applies (hop | signal length and the shifted
    weights keep their tap count); falls back to `edge='pad'` otherwise.

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.windows import hann
    >>> x = jnp.asarray(np.sin(0.1 * np.arange(1024)), jnp.float32)
    >>> from nx_signal_tpu.kernels.dft import fir_framed_dft
    >>> taps = jnp.asarray([0.25, 0.5, 0.25])
    >>> p = fir_framed_dft(x, taps, hann(256), stride=64, n_fft=256,
    ...                    onesided=True, output='power')
    >>> p.shape
    (13, 129)
    """
    x = jnp.asarray(x)
    traced = isinstance(taps, jax.core.Tracer) or isinstance(window, jax.core.Tracer)
    if traced:
        taps = jnp.asarray(taps).reshape(-1)
        window_arr = jnp.asarray(window)
    else:
        taps = np.asarray(taps, dtype=np.float64).reshape(-1)
        window_arr = np.asarray(window, dtype=np.float64)
    k = taps.shape[0]
    frame_length = window_arr.shape[-1]
    length = x.shape[-1]
    if length < frame_length:
        raise ValueError(
            f"window length {frame_length} exceeds signal length {length}"
        )
    num_frames = (length - frame_length) // stride + 1
    bins = n_fft // 2 + 1 if onesided else n_fft

    ext = frame_length + k - 1
    weights = fir_dft_fold_weights(taps, window_arr, n_fft, onesided,
                                   traced=traced)

    # 'same' alignment: frame m of the filtered signal starts at
    # y[m*stride] = full_conv[m*stride + (k-1)//2]; the extended frame
    # covers x[m*stride - pad_left, ...] with pad_left = (k-1) - (k-1)//2
    pad_left = (k - 1) - (k - 1) // 2
    batch = x.shape[:-1]
    if edge == "conv" and output == "power" and frame_chunks in (1, "auto"):
        out = _fir_framed_dft_power_nopad(
            x, weights, ext=ext, stride=stride, pad_left=pad_left,
            num_frames=num_frames, bins=bins, precision=precision)
        if out is not None:
            return out
    xp = jnp.pad(x.astype(DEFAULT_FLOAT), [(0, 0)] * len(batch) + [(pad_left, k - 1)])
    if frame_chunks == "auto":
        frame_chunks = _auto_frame_chunks(
            int(np.prod(batch, dtype=np.int64)) if batch else 1,
            num_frames, 2 * bins, x.size) if output == "power" else 1
    if output == "power" and frame_chunks > 1:
        c_blocks = len(_frame_block_widths(ext, stride))
        needed = (num_frames + c_blocks - 1) * stride
        if needed > xp.shape[-1]:  # pad once so chunk slices never re-pad
            xp = jnp.pad(xp, [(0, 0)] * len(batch)
                         + [(0, needed - xp.shape[-1])])
        per = -(-num_frames // frame_chunks)
        out = jnp.zeros((*batch, num_frames, bins), dtype=xp.dtype)
        for i in range(frame_chunks):
            f0 = i * per
            f1 = min(num_frames, f0 + per)
            if f0 >= f1:
                break
            xs = xp[..., f0 * stride : (f1 + c_blocks - 1) * stride]
            acc = blocked_frame_matmul(
                xs, weights, window_length=ext, stride=stride,
                num_frames=f1 - f0, precision=precision,
            )
            power = acc[..., :bins] ** 2 + acc[..., bins:] ** 2
            out = lax.dynamic_update_slice(
                out, power, (0,) * len(batch) + (f0, 0))
        return out
    acc = blocked_frame_matmul(
        xp, weights, window_length=ext, stride=stride, num_frames=num_frames,
        precision=precision,
    )
    if output == "power":
        return acc[..., :bins] ** 2 + acc[..., bins:] ** 2
    return lax.complex(acc[..., :bins], acc[..., bins:])


# --------------------------------------------------- shared-block strategy

#: signed cosine-sum coefficients of the standard periodic windows:
#: w[t] = sum_c b_c * cos(2*pi*c*t / N)
_COSINE_WINDOW_COEFFS = {
    "rectangular": (1.0,),
    "hann": (0.5, -0.5),
    "hamming": (0.54, -0.46),
    "blackman": (0.42, -0.5, 0.08),
}


def recognize_cosine_window(window, n_fft: int):
    """Signed cosine-sum coefficients (b_0, b_1, ...) of the PERIODIC
    window sampled in `window` when it matches one of the standard
    cosine-sum families over period `n_fft` to 1e-6, else None. Gate for
    the shared-block framed-DFT fast path (`fir_framed_dft_shared`), which
    applies the window as a sparse convolution in the frequency domain and
    therefore needs the window's exact spectral support.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu.kernels.dft import recognize_cosine_window
    >>> from nx_signal_tpu.ops.windows import hann, kaiser
    >>> recognize_cosine_window(np.asarray(hann(256)), 256)
    (0.5, -0.5)
    >>> recognize_cosine_window(np.asarray(kaiser(256, beta=8.0)), 256) is None
    True
    """
    w = np.asarray(window, dtype=np.float64)
    if w.ndim != 1 or w.shape[0] != n_fft:
        return None
    t = np.arange(n_fft)
    for coeffs in _COSINE_WINDOW_COEFFS.values():
        model = sum(
            b * np.cos(2.0 * np.pi * c * t / n_fft)
            for c, b in enumerate(coeffs)
        )
        if np.allclose(w, model, atol=1e-6):
            return tuple(coeffs)
    return None


def _conj_shift_minus(xr, xi, c, bins):
    """(X[k-c]) for one-sided spectra of a real signal: k >= c reads
    X[k-c]; k < c reflects through DC with conjugation (X[-m] = conj(X[m]))."""
    left_r = xr[..., 1:c + 1][..., ::-1]
    left_i = -xi[..., 1:c + 1][..., ::-1]
    return (
        jnp.concatenate([left_r, xr[..., :bins - c]], axis=-1),
        jnp.concatenate([left_i, xi[..., :bins - c]], axis=-1),
    )


def _conj_shift_plus(xr, xi, c, bins):
    """(X[k+c]) for one-sided spectra of a real signal (even n_fft):
    k <= bins-1-c reads X[k+c]; beyond Nyquist reflects with conjugation
    (X[n_fft - m] = conj(X[m]))."""
    right_r = xr[..., bins - 1 - c:bins - 1][..., ::-1]
    right_i = -xi[..., bins - 1 - c:bins - 1][..., ::-1]
    return (
        jnp.concatenate([xr[..., c:], right_r], axis=-1),
        jnp.concatenate([xi[..., c:], right_i], axis=-1),
    )


def fir_framed_dft_shared(x, taps, *, stride: int, n_fft: int,
                          window_coeffs, onesided: bool = False,
                          precision="highest", output: str = "complex"):
    """FIR + windowed framed DFT via SHARED hop-block partial DFTs — the
    2x-fewer-FLOPs reformulation of `fir_framed_dft` for cosine-sum
    windows with frame_length == n_fft and stride | n_fft.

    The conv-of-blocks form of the framed DFT gives each hop block a dense
    per-tap weight matrix — rows [j*stride, (j+1)*stride) of the windowed
    DFT matrix. Without the time-domain window those matrices are all the
    SAME (stride x bins) partial-DFT matrix E times a per-column twiddle
    e^(-2i*pi*j*k*stride/n_fft), so each block's product P[b] = u_block[b] @ E
    is computed ONCE and reused by all J = n_fft/stride frames that overlap
    it:

        X[m, k]  = sum_j tw[j, k] * P[m + j, k]         (diagonal combine)
        Xw[m, k] = b_0 X[m, k]
                   + sum_c (b_c / 2) (X[m, k-c] + X[m, k+c])   (window)

    where the second line applies the cosine-sum window w[t] =
    sum_c b_c cos(2 pi c t / n_fft) as its exact sparse spectral
    convolution (one-sided spectra reflect through DC/Nyquist with
    conjugation). The FIR is folded into E by the banded Toeplitz matrix
    exactly as in `fir_framed_dft`, so per input sample the matmul work is
    2*(stride + K - 1)*(2*bins)/stride FLOP instead of
    2*(n_fft + K - 1)*(2*bins)/stride — a J/(1 + (K-1)/stride)-fold matmul
    reduction (2.0x for the 512/128/255-tap chain). Equal to
    `fir_framed_dft` up to f32 association (NOT bitwise — different
    summation order).

    `taps=None` skips the FIR fold. Requires n_fft % stride == 0, even
    n_fft for onesided=True, and the window given as signed cosine
    coefficients (see `recognize_cosine_window`).

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.windows import hann
    >>> x = jnp.asarray(np.sin(0.1 * np.arange(1024)), jnp.float32)
    >>> from nx_signal_tpu.kernels.dft import fir_framed_dft, fir_framed_dft_shared
    >>> taps = jnp.asarray([0.25, 0.5, 0.25])
    >>> p = fir_framed_dft(x, taps, hann(256), stride=64, n_fft=256,
    ...                    onesided=True, output='power')
    >>> ps = fir_framed_dft_shared(x, taps, stride=64, n_fft=256,
    ...                            window_coeffs=(0.5, -0.5), onesided=True,
    ...                            output='power')
    >>> bool(jnp.max(jnp.abs(ps - p)) < 1e-4 * float(jnp.max(p)))
    True
    """
    if n_fft % stride != 0:
        raise ValueError(
            f"shared-block strategy needs stride | n_fft, got {stride}, {n_fft}"
        )
    if onesided and n_fft % 2 != 0:
        raise ValueError("onesided shared-block strategy needs even n_fft")
    window_coeffs = tuple(float(b) for b in window_coeffs)
    if len(window_coeffs) < 1 or len(window_coeffs) > stride:
        raise ValueError("window_coeffs must have 1..stride terms")
    x = jnp.asarray(x)
    length = x.shape[-1]
    if length < n_fft:
        raise ValueError(
            f"window length {n_fft} exceeds signal length {length}"
        )
    num_frames = (length - n_fft) // stride + 1
    j_taps = n_fft // stride
    num_blocks = num_frames + j_taps - 1
    bins = n_fft // 2 + 1 if onesided else n_fft

    # stage A: per-block partial DFT (FIR-folded), one matmul per block
    ones = np.ones(stride, dtype=np.float64)
    e_mat = _dft_weights(ones, stride, n_fft, onesided, np.float64)
    batch = x.shape[:-1]
    if taps is not None:
        taps = np.asarray(taps, dtype=np.float64).reshape(-1)
        k = taps.shape[0]
        weights = toeplitz_band(taps, stride, np) @ e_mat
        pad_left = (k - 1) - (k - 1) // 2
        xp = jnp.pad(x.astype(DEFAULT_FLOAT),
                     [(0, 0)] * len(batch) + [(pad_left, k - 1)])
        window_length = stride + k - 1
    else:
        weights = e_mat
        xp = x.astype(DEFAULT_FLOAT)
        window_length = stride
    p = blocked_frame_matmul(
        xp, jnp.asarray(weights.astype(DEFAULT_FLOAT)),
        window_length=window_length, stride=stride, num_frames=num_blocks,
        precision=precision,
    )
    p_re, p_im = p[..., :bins], p[..., bins:]

    # stage B: diagonal twiddle combine across the J overlapping blocks
    jk = (np.arange(j_taps)[:, None] * np.arange(bins)[None, :] * stride) % n_fft
    ang = -2.0 * np.pi * jk / n_fft
    twr = jnp.asarray(np.cos(ang).astype(np.float32))
    twi = jnp.asarray(np.sin(ang).astype(np.float32))
    x_re = jnp.zeros((*batch, num_frames, bins), DEFAULT_FLOAT)
    x_im = jnp.zeros((*batch, num_frames, bins), DEFAULT_FLOAT)
    for j in range(j_taps):
        pr = p_re[..., j:j + num_frames, :]
        pi = p_im[..., j:j + num_frames, :]
        x_re = x_re + twr[j] * pr - twi[j] * pi
        x_im = x_im + twr[j] * pi + twi[j] * pr

    # stage C: the window as its sparse spectral convolution
    out_r = window_coeffs[0] * x_re
    out_i = window_coeffs[0] * x_im
    for c, b in enumerate(window_coeffs[1:], start=1):
        if b == 0.0:
            continue
        if onesided:
            mr, mi = _conj_shift_minus(x_re, x_im, c, bins)
            pr_, pi_ = _conj_shift_plus(x_re, x_im, c, bins)
        else:
            mr, mi = (jnp.roll(x_re, c, axis=-1), jnp.roll(x_im, c, axis=-1))
            pr_, pi_ = (jnp.roll(x_re, -c, axis=-1), jnp.roll(x_im, -c, axis=-1))
        out_r = out_r + (b / 2.0) * (mr + pr_)
        out_i = out_i + (b / 2.0) * (mi + pi_)

    if output == "power":
        return out_r ** 2 + out_i ** 2
    return lax.complex(out_r, out_i)
