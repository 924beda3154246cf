"""Signal framing and overlap-add — the STFT engine's data-movement core.

Reference semantics: lib/nx_signal.ex `as_windowed/2` (:249-364) and
`overlap_and_add/2` (:684-727).

Design notes
----------------------
* `as_windowed` is NOT a gather (the reference vmaps Nx.slice over an iota of
  window starts, nx_signal.ex:354-364). Here framing is decomposed into
  C = ceil(window/stride) contiguous slice+reshape blocks: block r of the
  frame matrix, columns [r*stride, r*stride + w_r), is exactly
  x[r*stride : r*stride + M*stride] reshaped to (M, stride). All static
  slices/reshapes — XLA lowers them to pure data movement with no gather
  tables, which is the HBM-bandwidth-optimal form.

* `overlap_and_add` is NOT a scatter-add (the reference uses Nx.indexed_add,
  nx_signal.ex:723-724, whose accumulation order is backend-defined). Here it
  is the exact transpose of the framing decomposition: a left-fold of C
  shifted (M, stride) blocks, added in strictly increasing frame order for
  every output sample. This makes the summation order *deterministic and
  device-count-independent*, which is what makes sharded overlap-add
  bit-identical to single-device runs (the halo tail from the left neighbor
  seeds the accumulator, preserving global fold order — see
  nx_signal_tpu.parallel).
"""

import jax.numpy as jnp

__all__ = ["as_windowed", "overlap_and_add", "pad_for_windowing"]


def _frame_block_widths(window_length: int, stride: int):
    """Column widths of the C slice/reshape blocks."""
    num_blocks = -(-window_length // stride)  # ceil
    return [min(stride, window_length - r * stride) for r in range(num_blocks)]


def _frames_by_reshape(x, window_length: int, stride: int):
    """Frame a (..., L)-tensor into (..., M, window_length) via C contiguous
    slice+reshape blocks (no gather). Requires L >= window_length."""
    length = x.shape[-1]
    num_frames = (length - window_length) // stride + 1
    widths = _frame_block_widths(window_length, stride)
    needed = (num_frames + len(widths) - 1) * stride
    if needed > length:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, needed - length)]
        x = jnp.pad(x, pad)
    batch = x.shape[:-1]
    blocks = []
    for r, w in enumerate(widths):
        block = x[..., r * stride : (r + num_frames) * stride]
        block = block.reshape(*batch, num_frames, stride)
        blocks.append(block if w == stride else block[..., :w])
    if len(blocks) == 1:
        return blocks[0]
    return jnp.concatenate(blocks, axis=-1)


def _padding_config(length: int, window_length: int, padding):
    """Resolve a padding spec to (lo, hi) zeros over the signal axis
    (reference: nx_signal.ex:303-331)."""
    if padding == "valid":
        return (0, 0)
    if padding == "same":
        total = window_length - 1
        return (total // 2, total - total // 2)
    if isinstance(padding, (tuple, list)):
        if len(padding) == 1 and isinstance(padding[0], (tuple, list)):
            padding = padding[0]
        lo, hi = padding
        return (int(lo), int(hi))
    raise ValueError(
        "invalid padding mode specified, padding must be one of 'valid', 'same', "
        f"'reflect', or a (lo, hi) padding configuration, got: {padding}"
    )


def pad_for_windowing(x, window_length: int, padding):
    """Apply an `as_windowed` padding mode to the signal axis without
    framing it (used by fused kernels that frame implicitly).

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.spectral.framing import pad_for_windowing
    >>> y = pad_for_windowing(jnp.arange(6.0), window_length=4, padding='reflect')
    >>> np.asarray(y)
    array([2., 1., 0., 1., 2., 3., 4., 5., 4., 3.], dtype=float32)
    """
    x = jnp.asarray(x)
    if padding == "reflect":
        half = window_length // 2
        pad = [(0, 0)] * (x.ndim - 1) + [(half, half)]
        return jnp.pad(x, pad, mode="reflect")
    lo, hi = _padding_config(x.shape[-1], window_length, padding)
    if lo or hi:
        pad = [(0, 0)] * (x.ndim - 1) + [(lo, hi)]
        return jnp.pad(x, pad)
    return x


def as_windowed(x, *, window_length: int, stride: int = 1, padding="valid"):
    """Frame a signal into overlapping windows: (..., L) -> (..., M, window_length).

    Padding modes (reference: nx_signal.ex:175-178 docs, :249-364 impl):
      * 'valid' — no padding; M = (L - window_length)//stride + 1.
      * 'same' — zero-pad so the first window is centered at sample 0
        (left pad (window_length-1)//2, remainder on the right).
      * (lo, hi) — explicit zero padding of the signal.
      * 'reflect' — mirror-pad by window_length//2 on both sides (no edge
        duplication, numpy 'reflect' mode); first window centered at sample 0.

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.spectral.framing import as_windowed
    >>> as_windowed(jnp.arange(8), window_length=4, stride=2)
    Array([[0, 1, 2, 3],
           [2, 3, 4, 5],
           [4, 5, 6, 7]], dtype=int32)
    >>> as_windowed(jnp.arange(5), window_length=4, stride=1, padding="same")
    Array([[0, 0, 1, 2],
           [0, 1, 2, 3],
           [1, 2, 3, 4],
           [2, 3, 4, 0],
           [3, 4, 0, 0]], dtype=int32)
    """
    x = jnp.asarray(x)
    if stride < 1:
        raise ValueError(f"expected an integer >= 1 for stride, got: {stride}")
    x = pad_for_windowing(x, window_length, padding)
    if x.shape[-1] < window_length:
        raise ValueError(
            f"window length {window_length} exceeds padded signal length {x.shape[-1]}"
        )
    return _frames_by_reshape(x, window_length, stride)


def _ola_fold(frames, stride: int, out_length: int, init=None):
    """Deterministic overlap-add: left-fold of C shifted blocks so every
    output sample accumulates its contributing frames in increasing frame
    order. `init` (if given) seeds the accumulator — for a sample receiving
    frames m0 < m1 < ..., the result is (((init + f_m0) + f_m1) + ...) with
    exactly that association, enabling bit-identical sharded overlap-add.
    """
    *batch, num_frames, window_length = frames.shape
    widths = _frame_block_widths(window_length, stride)
    num_blocks = len(widths)
    num_rows = -(-out_length // stride)  # ceil: rows of the (Q, stride) grid
    acc_shape = (*batch, num_rows, stride)
    if init is None:
        acc = jnp.zeros(acc_shape, dtype=frames.dtype)
    else:
        init = init[..., : num_rows * stride]
        init = jnp.pad(
            init, [(0, 0)] * (len(batch)) + [(0, num_rows * stride - init.shape[-1])]
        )
        acc = init.reshape(acc_shape).astype(frames.dtype)
    # j descending => per-sample contributions arrive in increasing frame order
    # (sample p = q*stride + s receives frames[q - j, s + j*stride]).
    for j in range(num_blocks - 1, -1, -1):
        w = widths[j]
        block = frames[..., j * stride : j * stride + w]
        if w < stride:
            block = jnp.pad(block, [(0, 0)] * (len(batch) + 1) + [(0, stride - w)])
        # rows [j, j + num_frames) of the accumulator grid
        lo = j
        hi = num_rows - (j + num_frames)
        if hi < 0:
            block = block[..., : num_frames + hi, :]
            hi = 0
        block = jnp.pad(block, [(0, 0)] * len(batch) + [(lo, hi), (0, 0)])
        acc = acc + block
    return acc.reshape(*batch, num_rows * stride)[..., :out_length]


def overlap_and_add(frames, *, overlap_length: int, dtype=None):
    """Overlap-add an (..., M, N) stack of frames into an
    (..., M*stride + overlap_length) signal, stride = N - overlap_length
    (reference: nx_signal.ex:684-727).

    Unlike the reference's indexed_add scatter, accumulation order is
    deterministic (increasing frame order per output sample) — see module
    docstring.

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.spectral.framing import overlap_and_add
    >>> frames = jnp.asarray([[1, 1, 1, 1], [10, 10, 10, 10], [100, 100, 100, 100]])
    >>> overlap_and_add(frames, overlap_length=2)
    Array([  1,   1,  11,  11, 110, 110, 100, 100], dtype=int32)
    """
    frames = jnp.asarray(frames)
    if frames.ndim < 2:
        raise ValueError(f"expected a tensor of rank >= 2, got rank {frames.ndim}")
    num_frames, window_length = frames.shape[-2], frames.shape[-1]
    if overlap_length >= window_length:
        raise ValueError(
            "overlap_length must be a number less than the window size "
            f"{window_length}, got: {overlap_length}"
        )
    stride = window_length - overlap_length
    out_length = num_frames * stride + overlap_length
    out = _ola_fold(frames, stride, out_length)
    if dtype is not None:
        out = out.astype(dtype)
    return out
