"""Sharded DSP ops: time-block + channel parallelism with ppermute halos.

Greenfield components (SURVEY.md §2.9 — the reference is single-device).
All entry points are shard_map programs over a ('channel', 'block') mesh
(see parallel/mesh.py):

* channel axis — embarrassing data parallelism over leading batch axes;
* block axis — contiguous time blocks per device; the only communication is
  neighbor halo exchange via jax.lax.ppermute (non-cyclic permutations, so
  edge devices receive zeros — exactly the zero-padding semantics of the
  single-device ops).

Bit-comparability design: every output sample is produced by the same
primitive op on the same input values as the single-device path —
  * FIR 'same': each output sample is an independent K-tap dot; devices
    compute it from [left halo | block | right halo] with the identical conv
    primitive => bitwise equal.
  * STFT: frames never straddle device math — a frame belongs to the device
    where it starts and is completed by the right halo => bitwise equal.
  * ISTFT/overlap-add: the deterministic left-fold (spectral/framing.py)
    sums contributions in increasing frame order per sample; the left
    neighbor's tail partial SEEDS the accumulator, preserving the exact
    global association (((tail)+f_m)+f_{m+1})... => bitwise equal.
"""

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from nx_signal_tpu.ops.convolution import (
    _direct_convolve,
    _fir_block_size,
    _float_cast,
    convolve,
    fir_convolve_1d,
)
from nx_signal_tpu.kernels.dft import (
    blocked_frame_matmul,
    fir_dft_fold_weights,
    framed_dft,
    framed_idft,
    good_matmul_fft_length,
)
from nx_signal_tpu.spectral.framing import _ola_fold, as_windowed
from nx_signal_tpu.spectral.stft import STFTResult, _apply_scaling, _resolve_fft_length, fft_frequencies
from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT
from nx_signal_tpu.parallel.mesh import BLOCK_AXIS, CHANNEL_AXIS

__all__ = ["sharded_convolve_same", "sharded_fir_framed_dft_power", "sharded_oaconvolve_same", "sharded_stft", "sharded_istft", "sharded_pfb_analyze", "sharded_sosfilt", "sharded_upfirdn", "sharded_resample_poly"]


def _shift_from_left(x, n_block):
    """Each device receives its LEFT neighbor's trailing slice; device 0
    receives zeros (non-cyclic ppermute zero-fills uncovered outputs)."""
    return lax.ppermute(x, BLOCK_AXIS, [(j, j + 1) for j in range(n_block - 1)])


def _shift_from_right(x, n_block):
    """Each device receives its RIGHT neighbor's leading slice; the last
    device receives zeros."""
    return lax.ppermute(x, BLOCK_AXIS, [(j + 1, j) for j in range(n_block - 1)])


def _norm_2d(x):
    x = jnp.asarray(x)
    if x.ndim == 1:
        return x[None, :], True
    if x.ndim == 2:
        return x, False
    raise ValueError(f"expected a 1-D or 2-D (channels, time) signal, got rank {x.ndim}")


def _check_divisible(name, value, divisor):
    if value % divisor != 0:
        raise ValueError(f"{name} ({value}) must be divisible by {divisor}")


def sharded_convolve_same(x, taps, *, mesh, method="direct"):
    """'same'-mode FIR application, sharded over channels and time blocks.

    Overlap-save style: each device fetches (K-1)-sample halos — the left
    halo of (K-1) - (K-1)//2 samples and right halo of (K-1)//2 samples,
    matching the single-device 'same' padding split (ops/convolution.py) —
    then runs a local 'valid' convolution. There is no cross-device
    accumulation at all, so results match the single-device
    `convolve(x, taps, mode='same')` exactly up to the backend's matmul
    determinism: method='direct' (the Toeplitz-matmul path) is bitwise
    identical wherever the backend's GEMM sums in a fixed order for the
    local shape; method='conv' (lax.conv) is bitwise identical on the
    CPU; method='fft' matches to FFT accuracy. The halos travel by
    `lax.ppermute`, which XLA hands to the backend's collectives (NCCL
    on GPUs).

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    >>> mesh = make_dsp_mesh(2, 4)   # needs 8 devices, e.g.
    >>> # XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 4096)), jnp.float32)
    >>> from nx_signal_tpu.parallel.sharded import sharded_convolve_same
    >>> from nx_signal_tpu.ops.convolution import convolve
    >>> taps = jnp.asarray(np.random.default_rng(1).normal(size=63), jnp.float32)
    >>> y = sharded_convolve_same(x, taps, mesh=mesh)
    >>> bool((y[0] == convolve(x[0], taps, mode='same')).all())  # BITWISE
    True
    """
    x, squeeze = _norm_2d(x)
    taps = jnp.asarray(taps)
    (k,) = taps.shape
    n_channel, n_block = mesh.shape[CHANNEL_AXIS], mesh.shape[BLOCK_AXIS]
    _check_divisible("channels", x.shape[0], n_channel)
    length = x.shape[1]
    # Auto-pad to an even block split; the zeros match 'same' edge padding,
    # and the padded outputs are sliced away (bitwise-preserving). The block
    # is rounded to the FIR matmul block size so the Toeplitz block grid has
    # the same global phase on every device (origin is static under SPMD).
    grid = _fir_block_size(k) if method == "direct" else 1
    block_len = -(-length // (n_block * grid)) * grid
    if block_len * n_block != length:
        x = jnp.pad(x, [(0, 0), (0, block_len * n_block - length)])
    pad_right = (k - 1) // 2
    pad_left = (k - 1) - pad_right
    if max(pad_left, pad_right) > block_len:
        raise ValueError(
            f"filter halo ({k - 1}) exceeds the per-device block ({block_len}); "
            "use fewer blocks or a shorter filter"
        )
    kernel2d = taps[None, :]

    def local(x_blk):
        parts = []
        if pad_left:
            parts.append(_shift_from_left(x_blk[:, -pad_left:], n_block))
        parts.append(x_blk)
        if pad_right:
            parts.append(_shift_from_right(x_blk[:, :pad_right], n_block))
        ext = jnp.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0]
        if method == "direct":
            # origin: every device's ext starts pad_left samples before a
            # multiple of the (grid-aligned) block boundary, so the Toeplitz
            # grid has the same global phase as the single-device call.
            # Bitwise only where the GEMM's reduction order does not depend
            # on the batch extent; on CPU it does, so only ulp-tight
            # agreement holds there (method='conv' is bitwise on the CPU).
            return fir_convolve_1d(
                _float_cast(ext), _float_cast(taps), "valid", origin=-pad_left
            )
        if method == "conv":
            return _direct_convolve(ext, kernel2d, "valid", use_matmul=False)
        return convolve(ext, kernel2d, mode="valid", method=method)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=P(CHANNEL_AXIS, BLOCK_AXIS),
        out_specs=P(CHANNEL_AXIS, BLOCK_AXIS),
    )
    out = fn(x)[:, :length]
    return out[0] if squeeze else out


def _stft_frame_geometry(length, frame_length, stride, n_block):
    """Pick the padded per-device block (a multiple of stride) for an even
    frame split; padding is zeros whose frames are sliced away afterwards."""
    if length < frame_length:
        raise ValueError(
            f"window length {frame_length} exceeds signal length {length}"
        )
    block_len = -(-length // (n_block * stride)) * stride
    padded_len = block_len * n_block
    halo = frame_length - stride
    if halo > block_len:
        raise ValueError(
            f"frame halo ({halo}) exceeds the per-device block ({block_len}); "
            "use fewer blocks or a larger hop"
        )
    frames_per_block = block_len // stride
    num_frames = (length - frame_length) // stride + 1
    return block_len, padded_len, frames_per_block, num_frames, halo


def sharded_stft(x, window, *, mesh, sampling_rate=100, fft_length="power_of_two",
                 overlap_length=None, scaling=None, onesided=False, method="auto",
                 precision="highest"):
    """Block+channel-sharded STFT ('valid' padding), bitwise-comparable to
    the single-device `stft`.

    Each device owns the frames that START in its block; the trailing
    frame_length - stride samples arrive as a right-neighbor halo, so every
    frame is windowed and FFT'd wholly on one device. Devices compute
    block_len//stride frame slots; slots past the true frame count (tail of
    the last device) are sliced away from the global result.
    
    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    >>> mesh = make_dsp_mesh(2, 4)   # needs 8 devices, e.g.
    >>> # XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 4096)), jnp.float32)
    >>> from nx_signal_tpu.parallel.sharded import sharded_stft
    >>> from nx_signal_tpu.ops.windows import hann
    >>> z, t, f = sharded_stft(x, hann(256), mesh=mesh, overlap_length=192,
    ...                        fft_length=256, sampling_rate=8000.0)
    >>> z.shape   # (channels, frames, bins), frames span the full stream
    (4, 61, 256)
    """
    x, squeeze = _norm_2d(x)
    window = jnp.asarray(window)
    (frame_length,) = window.shape
    if overlap_length is None:
        overlap_length = frame_length // 2
    stride = frame_length - overlap_length
    n_fft = _resolve_fft_length(frame_length, fft_length)
    n_channel, n_block = mesh.shape[CHANNEL_AXIS], mesh.shape[BLOCK_AXIS]
    _check_divisible("channels", x.shape[0], n_channel)
    _, padded_len, _, num_frames, halo = _stft_frame_geometry(
        x.shape[1], frame_length, stride, n_block
    )
    if padded_len != x.shape[1]:
        x = jnp.pad(x, [(0, 0), (0, padded_len - x.shape[1])])

    real_input = not jnp.issubdtype(x.dtype, jnp.complexfloating)
    use_matmul = method == "matmul" or (
        method == "auto"
        and real_input
        and good_matmul_fft_length(n_fft)
        and n_fft >= frame_length
    )
    # same guards as the single-device stft (spectral/stft.py)
    if use_matmul and not real_input:
        raise ValueError("method='matmul' requires real input")
    if use_matmul and n_fft < frame_length:
        raise ValueError(
            "method='matmul' requires fft_length >= frame_length "
            f"(got {n_fft} < {frame_length}); use method='fft'"
        )

    def local(x_blk):
        if halo:
            ext = jnp.concatenate(
                [x_blk, _shift_from_right(x_blk[:, :halo], n_block)], axis=-1
            )
        else:
            ext = x_blk
        if use_matmul:
            return framed_dft(
                ext, window, stride=stride, n_fft=n_fft, onesided=onesided,
                precision=precision,
            )
        frames = as_windowed(ext, window_length=frame_length, stride=stride)
        fft = jnp.fft.rfft if onesided else jnp.fft.fft
        return fft(frames * window, n=n_fft, axis=-1)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=P(CHANNEL_AXIS, BLOCK_AXIS),
        out_specs=P(CHANNEL_AXIS, BLOCK_AXIS, None),
    )
    z = fn(x)[:, :num_frames, :]
    z = _apply_scaling(z, window, scaling, sampling_rate, inverse=False)
    if squeeze:
        z = z[0]
    frequencies = fft_frequencies(sampling_rate, fft_length=n_fft)
    if onesided:
        frequencies = frequencies[: n_fft // 2 + 1]
    time_step = frame_length / (2.0 * sampling_rate)
    times = jnp.linspace(time_step, time_step * num_frames, num_frames,
                         dtype=DEFAULT_FLOAT)
    return STFTResult(z, times, frequencies)


def sharded_istft(z, window, *, mesh, fft_length=None, overlap_length=None,
                  scaling=None, sampling_rate=1000, onesided=False, method="auto",
                  precision="highest"):
    """Block+channel-sharded inverse STFT, bitwise-comparable to the
    single-device `istft`.

    Frames are sharded over the block axis. Each device IFFTs and windows
    its frames, runs the deterministic local overlap-add, and sends the
    `overlap` samples that reach past its output range to the right
    neighbor. The neighbor SEEDS its accumulator with that tail, preserving
    the exact global left-fold association per sample (see module
    docstring). The final tail (past the last device's range) is emitted by
    the last device and appended. Requires num_frames divisible by the
    block-axis size and overlap <= per-device sample range.
    
    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    >>> mesh = make_dsp_mesh(2, 4)   # needs 8 devices, e.g.
    >>> # XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 4096)), jnp.float32)
    >>> from nx_signal_tpu.parallel.sharded import sharded_istft, sharded_stft
    >>> from nx_signal_tpu.ops.windows import hann
    >>> z, _, _ = sharded_stft(x, hann(256), mesh=mesh, overlap_length=192,
    ...                        fft_length=256, sampling_rate=8000.0)
    >>> xr = sharded_istft(z, hann(256), mesh=mesh, overlap_length=192,
    ...                    fft_length=256)
    >>> xr.shape
    (4, 4096)
    """
    z = jnp.asarray(z)
    squeeze = z.ndim == 2
    if squeeze:
        z = z[None]
    if z.ndim != 3:
        raise ValueError(f"expected (..., frames, fft) spectrum of rank 2 or 3, got {z.ndim}")
    window = jnp.asarray(window)
    if onesided and fft_length is None:
        n_fft = 2 * (z.shape[-1] - 1)
    else:
        n_fft = _resolve_fft_length(z.shape[-1], fft_length)
    use_matmul = method == "matmul" or (
        method == "auto"
        and good_matmul_fft_length(n_fft)
        and window.shape[-1] == n_fft
    )
    if overlap_length is None:
        overlap_length = window.shape[-1] // 2
    n_channel, n_block = mesh.shape[CHANNEL_AXIS], mesh.shape[BLOCK_AXIS]
    _check_divisible("channels", z.shape[0], n_channel)
    num_frames = z.shape[1]
    # Auto-pad to an even frame split: padded frames are zero spectra (zero
    # contributions) and their window-envelope terms are masked out below,
    # so results stay bitwise-comparable to the single-device fold.
    frames_per_block = -(-num_frames // n_block)
    if frames_per_block * n_block != num_frames:
        z = jnp.pad(z, [(0, 0), (0, frames_per_block * n_block - num_frames), (0, 0)])
    if overlap_length >= n_fft:
        raise ValueError(
            f"overlap_length must be a number less than the window size {n_fft}, "
            f"got: {overlap_length}"
        )
    stride = n_fft - overlap_length
    own = frames_per_block * stride  # per-device output range
    if overlap_length > own:
        raise ValueError(
            f"overlap ({overlap_length}) exceeds the per-device sample range ({own})"
        )
    out_length = num_frames * stride + overlap_length

    envelope = jnp.broadcast_to(
        jnp.abs(window).astype(DEFAULT_FLOAT) ** 2, (frames_per_block, n_fft)
    )

    def local(z_blk):
        if use_matmul:
            frames = framed_idft(z_blk, window, n_fft=n_fft, onesided=onesided,
                                 precision=precision)
            frames = _apply_scaling(frames, window, scaling, sampling_rate,
                                    inverse=True)
        else:
            ifft = jnp.fft.irfft if onesided else jnp.fft.ifft
            frames = ifft(z_blk, n=n_fft, axis=-1)
            frames = _apply_scaling(frames, window, scaling, sampling_rate,
                                    inverse=True)
            frames = frames * window
        # Mask the envelope of frames past the true frame count (auto-pad).
        idx = lax.axis_index(BLOCK_AXIS)
        global_m = idx * frames_per_block + jnp.arange(frames_per_block)
        valid = (global_m < num_frames).astype(DEFAULT_FLOAT)[:, None]
        local_len = own + overlap_length

        def folded(fr):
            # phase 1: pure local fold; its tail seeds the right neighbor
            partial = _ola_fold(fr, stride, local_len)
            tail = partial[..., own:]
            seeded = _shift_from_left(tail, n_block)
            pad = [(0, 0)] * (fr.ndim - 2) + [(0, own)]
            init = jnp.pad(seeded, pad)
            # phase 2: refold with the neighbor tail seeding the accumulator
            return _ola_fold(fr, stride, local_len, init=init)

        num = folded(frames)
        env_frames = jnp.broadcast_to(envelope * valid, frames.shape[:-2] + envelope.shape)
        env = folded(env_frames)
        env = jnp.where(env > 1e-10, env, jnp.ones((), dtype=env.dtype))
        out = num / env
        is_last = (idx == n_block - 1).astype(out.dtype)
        tail_out = lax.psum(out[..., own:] * is_last, BLOCK_AXIS)
        return out[..., :own], tail_out

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=P(CHANNEL_AXIS, BLOCK_AXIS, None),
        out_specs=(P(CHANNEL_AXIS, BLOCK_AXIS), P(CHANNEL_AXIS)),
    )
    main, tail = fn(z)
    out = jnp.concatenate([main, tail], axis=-1)[..., :out_length]
    return out[0] if squeeze else out


def sharded_pfb_analyze(x, n_channels: int, *, mesh, taps_per_channel: int = 8,
                        window=("kaiser", 5.0), taps=None, shift: bool = False):
    """Block+channel-sharded polyphase filterbank channelizer — the
    wideband-SDR front end at pod scale (BASELINE config 5: 1024-channel PFB
    on a 100 Msample/s stream, time-block sharded).

    Geometry mirrors `sharded_stft`: a PFB output frame at stride n_channels
    spans n_channels*taps_per_channel input samples, so each device fetches
    an (n_channels*(taps_per_channel-1))-sample right halo and channelizes
    its own frames wholly locally — no cross-device accumulation, results
    match the single-device `pfb_analyze` exactly up to matmul determinism.
    
    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    >>> mesh = make_dsp_mesh(2, 4)   # needs 8 devices, e.g.
    >>> # XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 4096)), jnp.float32)
    >>> from nx_signal_tpu.parallel.sharded import sharded_pfb_analyze
    >>> p = sharded_pfb_analyze(x, 16, mesh=mesh, taps_per_channel=4)
    >>> p.shape, p.dtype
    ((4, 253, 16), dtype('complex64'))
    """
    from nx_signal_tpu.ops.resample import pfb_analyze

    x, squeeze = _norm_2d(x)
    m = n_channels
    if taps is None:
        from nx_signal_tpu.ops.filters import firwin

        taps = firwin(m * taps_per_channel, [1.0 / m], window=window)
    taps = jnp.asarray(taps)
    window_length = taps.shape[0]
    if window_length % m != 0:
        raise ValueError(
            f"prototype length ({window_length}) must be a multiple of "
            f"n_channels ({m})"
        )
    n_channel_mesh, n_block = mesh.shape[CHANNEL_AXIS], mesh.shape[BLOCK_AXIS]
    _check_divisible("channels", x.shape[0], n_channel_mesh)
    _, padded_len, _, num_frames, halo = _stft_frame_geometry(
        x.shape[1], window_length, m, n_block
    )
    if padded_len != x.shape[1]:
        x = jnp.pad(x, [(0, 0), (0, padded_len - x.shape[1])])

    def local(x_blk):
        if halo:
            ext = jnp.concatenate(
                [x_blk, _shift_from_right(x_blk[:, :halo], n_block)], axis=-1
            )
        else:
            ext = x_blk
        return pfb_analyze(ext, m, taps=taps, shift=shift)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=P(CHANNEL_AXIS, BLOCK_AXIS),
        out_specs=P(CHANNEL_AXIS, BLOCK_AXIS, None),
    )
    out = fn(x)[:, :num_frames, :]
    return out[0] if squeeze else out


def _sos_state_space(sos):
    """One-sample cascade state space (A, B, C, D) of an (S, 6) sos array,
    host-side f64 numpy: state = [z00, z01, z10, z11, ...] (per-section
    DF2T states in sosfilt order), x -> y with z' = A z + B x,
    y = C z + D x. Used by sharded_sosfilt to chain device blocks."""
    import numpy as np

    sos = np.asarray(sos, dtype=np.float64)
    n_sections = sos.shape[0]
    n_state = 2 * n_sections
    a_mat = np.zeros((n_state, n_state))
    b_vec = np.zeros(n_state)
    c_cur = np.zeros(n_state)  # current inter-section signal: u = D x + C z
    d_cur = 1.0
    for s in range(n_sections):
        b0, b1, b2, a0, a1, a2 = sos[s]
        b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
        i0, i1 = 2 * s, 2 * s + 1
        # DF2T: y = b0 u + z0;  z0' = (b1 - a1 b0) u - a1 z0 + z1;
        #                       z1' = (b2 - a2 b0) u - a2 z0
        bu0, bu1 = b1 - a1 * b0, b2 - a2 * b0
        a_mat[i0] += bu0 * c_cur
        a_mat[i0, i0] += -a1
        a_mat[i0, i1] += 1.0
        a_mat[i1] += bu1 * c_cur
        a_mat[i1, i0] += -a2
        b_vec[i0] = bu0 * d_cur
        b_vec[i1] = bu1 * d_cur
        new_c = b0 * c_cur
        new_c[i0] += 1.0
        c_cur, d_cur = new_c, b0 * d_cur
    return a_mat, b_vec, c_cur, d_cur


def sharded_sosfilt(sos, x, *, mesh):
    """Causal IIR (cascaded biquads) sharded over channels AND time blocks —
    the parallel-in-time IIR (greenfield; neither the reference nor scipy
    distributes IIR state).

    The sequential dependency is broken with exact affine superposition:
    y(x, z_in) = y(x, 0) + ZIR(z_in) and z_out = A^L z_in + z_out(x, 0).
    Each device filters its block from zero state (local, parallel biquad
    scans — ops/iir.py), the tiny per-block final states are all_gathered
    and chained through the host-precomputed block transition matrix
    T = A^L (a B-step scan over B = n_block devices), and each device adds
    its incoming state's zero-input response as ONE tall-skinny matmul
    against the precomputed observability matrix G[n] = C A^n. Total
    communication: one (2*n_sections)-float all_gather. Matches the
    single-device `sosfilt` to f.p. accuracy (the block-local scans
    associate sums differently, so not bitwise).
    
    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    >>> mesh = make_dsp_mesh(2, 4)   # needs 8 devices, e.g.
    >>> # XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 1024)), jnp.float32)
    >>> from nx_signal_tpu.parallel.sharded import sharded_sosfilt
    >>> from nx_signal_tpu.ops.iir_design import butter
    >>> sos = butter(2, 0.2, output='sos')   # 1 biquad: keeps the doctest
    >>> # compile small (tests cover deep cascades)
    >>> y = sharded_sosfilt(jnp.asarray(sos, jnp.float32), x, mesh=mesh)
    >>> y.shape   # causal IIR across block boundaries (state chain)
    (4, 1024)
    """
    import numpy as np

    sos_np = np.asarray(sos, dtype=np.float64)
    if sos_np.ndim != 2 or sos_np.shape[1] != 6:
        raise ValueError("sos array must be shape (n_sections, 6)")
    from nx_signal_tpu.ops.iir import _lfilter_last_axis

    x, squeeze = _norm_2d(x)
    x = _float_cast(x)
    n_channel, n_block = mesh.shape[CHANNEL_AXIS], mesh.shape[BLOCK_AXIS]
    _check_divisible("channels", x.shape[0], n_channel)
    length = x.shape[1]
    block_len = -(-length // n_block)
    if block_len * n_block != length:
        x = jnp.pad(x, [(0, 0), (0, block_len * n_block - length)])
    n_sections = sos_np.shape[0]
    n_state = 2 * n_sections

    a_mat, _, c_vec, _ = _sos_state_space(sos_np)
    t_blk = np.linalg.matrix_power(a_mat, block_len)  # (2S, 2S)
    obs = np.empty((block_len, n_state))
    row = c_vec
    for i in range(block_len):  # G[n] = C A^n, f64 host build
        obs[i] = row
        row = row @ a_mat
    t_dev = jnp.asarray(t_blk.astype(DEFAULT_FLOAT))
    obs_t = jnp.asarray(obs.T.astype(DEFAULT_FLOAT))  # (2S, L)
    sos_dev = jnp.asarray(sos_np.astype(DEFAULT_FLOAT))

    def local(x_blk):
        c_local = x_blk.shape[0]
        out = x_blk
        zf_secs = []
        zi0 = jnp.zeros((c_local, 2), x_blk.dtype)
        for s in range(n_sections):
            out, zf = _lfilter_last_axis(sos_dev[s, :3], sos_dev[s, 3:], out, zi0)
            zf_secs.append(zf)
        zf0 = jnp.concatenate(zf_secs, axis=-1)  # (C, 2S), sosfilt order

        gathered = lax.all_gather(zf0, BLOCK_AXIS)  # (B, C, 2S)

        def chain(z_in, zf_b):
            z_out = z_in @ t_dev.T + zf_b
            return z_out, z_in

        _, z_ins = lax.scan(chain, jnp.zeros_like(zf0), gathered)
        my = lax.axis_index(BLOCK_AXIS)
        z_in = z_ins[my]  # (C, 2S) incoming state for this block
        return out + jnp.matmul(z_in, obs_t, precision="highest")

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=P(CHANNEL_AXIS, BLOCK_AXIS),
        out_specs=P(CHANNEL_AXIS, BLOCK_AXIS),
    )
    out = fn(x)[:, :length]
    return out[0] if squeeze else out


def sharded_oaconvolve_same(x, taps, *, mesh):
    """'same'-mode overlap-add FFT convolution, sharded over channels and
    time blocks — the FFT-method sibling of `sharded_convolve_same` for long
    filters where the Toeplitz matmul loses to O(N log N).

    Identical halo geometry to sharded_convolve_same (each device fetches
    the 'same'-split (K-1) halos and runs a local 'valid' convolution); the
    local method is ops.convolution.oaconvolve, so agreement with the
    single-device `oaconvolve(x, taps, mode='same')` is to FFT accuracy
    (~1e-6 relative), not bitwise — the overlap-add block phase differs per
    device. Fills the BASELINE config-2 workload at pod scale.
    
    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    >>> mesh = make_dsp_mesh(2, 4)   # needs 8 devices, e.g.
    >>> # XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 4096)), jnp.float32)
    >>> from nx_signal_tpu.parallel.sharded import sharded_oaconvolve_same
    >>> taps = jnp.asarray(np.random.default_rng(1).normal(size=63), jnp.float32)
    >>> y = sharded_oaconvolve_same(x, taps, mesh=mesh)
    >>> y.shape
    (4, 4096)
    """
    from nx_signal_tpu.ops.convolution import oaconvolve

    x, squeeze = _norm_2d(x)
    taps = jnp.asarray(taps)
    (k,) = taps.shape
    n_channel, n_block = mesh.shape[CHANNEL_AXIS], mesh.shape[BLOCK_AXIS]
    _check_divisible("channels", x.shape[0], n_channel)
    length = x.shape[1]
    block_len = -(-length // n_block)
    if block_len * n_block != length:
        x = jnp.pad(x, [(0, 0), (0, block_len * n_block - length)])
    pad_right = (k - 1) // 2
    pad_left = (k - 1) - pad_right
    if max(pad_left, pad_right) > block_len:
        raise ValueError(
            f"filter halo ({k - 1}) exceeds the per-device block ({block_len}); "
            "use fewer blocks or a shorter filter"
        )
    kernel2d = taps[None, :]

    def local(x_blk):
        parts = []
        if pad_left:
            parts.append(_shift_from_left(x_blk[:, -pad_left:], n_block))
        parts.append(x_blk)
        if pad_right:
            parts.append(_shift_from_right(x_blk[:, :pad_right], n_block))
        ext = jnp.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0]
        return oaconvolve(ext, kernel2d, mode="valid")

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=P(CHANNEL_AXIS, BLOCK_AXIS),
        out_specs=P(CHANNEL_AXIS, BLOCK_AXIS),
    )
    out = fn(x)[:, :length]
    return out[0] if squeeze else out


def _sharded_upfirdn_body(x, bank, t_taps, up, down, *, mesh, n_offset,
                          out_total):
    """Shared shard_map body of sharded_upfirdn / sharded_resample_poly.

    Geometry: the global input is padded to n_block equal blocks with
    block_in % down == 0, so every device owns out_block = block_in*up/down
    outputs and d*out_block*down = d*block_in*up ≡ 0 (mod up) — the
    polyphase phase pattern ((n_offset + ℓ)*down) % up is therefore
    IDENTICAL on every device and the local kernel is pure SPMD. Output ℓ's
    window ends at own-block input index q'_ℓ = ((n_offset + ℓ)*down)//up,
    so each device needs a (T-1)-sample LEFT halo (q'_0 >= 0) and a right
    halo of max(0, q'_{last} + 1 - block_in) samples (nonzero only when
    n_offset > 0, i.e. the resample_poly group-delay slice). ppermute
    zero-fill at the stream edges matches upfirdn's zero padding exactly.
    """
    n_channel, n_block = mesh.shape[CHANNEL_AXIS], mesh.shape[BLOCK_AXIS]
    _check_divisible("channels", x.shape[0], n_channel)
    length = x.shape[1]
    # The block split must cover OUT_TOTAL outputs (upfirdn's output runs
    # (T-1 filter-tail samples past the input end), so size blocks by
    # max(input length, the input extent the last output reads); the extra
    # zeros match upfirdn's right zero-padding exactly.
    required_in = max(length, -(-(n_offset + out_total) * down // up))
    block_in = -(-required_in // (n_block * down)) * down
    if block_in * n_block != length:
        x = jnp.pad(x, [(0, 0), (0, block_in * n_block - length)])
    out_block = block_in * up // down
    halo_left = t_taps - 1
    q_last = ((n_offset + out_block - 1) * down) // up
    halo_right = max(0, q_last + 1 - block_in)
    if max(halo_left, halo_right) > block_in:
        raise ValueError(
            f"polyphase halo ({max(halo_left, halo_right)}) exceeds the "
            f"per-device block ({block_in}); use fewer blocks or a shorter "
            "filter"
        )

    from nx_signal_tpu.ops.resample import _upfirdn_phase_outputs

    def local(x_blk):
        parts = []
        if halo_left:
            parts.append(_shift_from_left(x_blk[:, -halo_left:], n_block))
        parts.append(x_blk)
        if halo_right:
            parts.append(_shift_from_right(x_blk[:, :halo_right], n_block))
        ext = jnp.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0]
        return _upfirdn_phase_outputs(ext, bank, up, down, n_offset=n_offset,
                                      n_count=out_block)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=P(CHANNEL_AXIS, BLOCK_AXIS),
        out_specs=P(CHANNEL_AXIS, BLOCK_AXIS),
    )
    return fn(x)[:, :out_total]


def sharded_upfirdn(h, x, up: int = 1, down: int = 1, *, mesh):
    """Block+channel-sharded `ops.resample.upfirdn`: polyphase
    upsample-filter-downsample over a ('channel', 'block') mesh. Every
    output sample is the same T-tap phase dot over the same input values as
    the single-device path (left halo supplies the cross-block context), so
    results match `upfirdn(h, x, up, down)` up to matmul determinism.
    
    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    >>> mesh = make_dsp_mesh(2, 4)   # needs 8 devices, e.g.
    >>> # XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 4096)), jnp.float32)
    >>> from nx_signal_tpu.parallel.sharded import sharded_upfirdn
    >>> h = jnp.asarray(np.random.default_rng(2).normal(size=31), jnp.float32)
    >>> sharded_upfirdn(h, x, 2, 3, mesh=mesh).shape  # 2/3 rate change
    (4, 2741)
    """
    from nx_signal_tpu.ops.resample import (
        _phase_bank, _upfirdn_dtype, _upfirdn_out_len)

    h = jnp.asarray(h)
    if h.ndim != 1:
        raise ValueError(f"h must be 1-D, got rank {h.ndim}")
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got: up={up}, down={down}")
    x, squeeze = _norm_2d(x)
    dtype = _upfirdn_dtype(h, x)
    h, x = h.astype(dtype), x.astype(dtype)
    bank, t_taps = _phase_bank(h, up)
    n_out = _upfirdn_out_len(x.shape[1], h.shape[0], up, down)
    out = _sharded_upfirdn_body(x, bank, t_taps, up, down, mesh=mesh,
                                n_offset=0, out_total=n_out)
    return out[0] if squeeze else out


def sharded_resample_poly(x, up: int, down: int, *, mesh,
                          window=("kaiser", 5.0), taps=None):
    """Block+channel-sharded `ops.resample.resample_poly` —
    scipy.signal.resample_poly semantics at pod scale (BASELINE config 4:
    48 kHz -> 16 kHz on 64 channels x 10 min, channel-sharded on one host;
    the block axis adds time-block scaling on top).

    The group-delay slice [n_pre_remove, n_pre_remove + n_out) is absorbed
    into the polyphase output offset (n_offset), which keeps the per-device
    phase pattern device-independent — see _sharded_upfirdn_body.
    
    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    >>> mesh = make_dsp_mesh(2, 4)   # needs 8 devices, e.g.
    >>> # XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 4096)), jnp.float32)
    >>> from nx_signal_tpu.parallel.sharded import sharded_resample_poly
    >>> sharded_resample_poly(x, 1, 2, mesh=mesh).shape  # decimate by 2
    (4, 2048)
    """
    from nx_signal_tpu.ops.resample import (
        _phase_bank, _resample_poly_design, _upfirdn_dtype)

    x, squeeze = _norm_2d(x)
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got: up={up}, down={down}")
    if int(up) == int(down):
        return x[0] if squeeze else x
    up, down, h, n_pre_remove = _resample_poly_design(up, down, window, taps)
    dtype = _upfirdn_dtype(h, x)
    h, x = h.astype(dtype), x.astype(dtype)
    bank, t_taps = _phase_bank(h, up)
    n_out = -(-x.shape[1] * up // down)
    out = _sharded_upfirdn_body(x, bank, t_taps, up, down, mesh=mesh,
                                n_offset=n_pre_remove, out_total=n_out)
    return out[0] if squeeze else out


def sharded_fir_framed_dft_power(x, taps, window, *, mesh, stride: int,
                                 n_fft: int, onesided: bool = True,
                                 precision="highest"):
    """The FUSED bench chain — FIR folded into the framed-DFT power
    spectrogram (kernels/dft.py:fir_framed_dft, output='power') — sharded
    over channels and time blocks. This is the pod-scale form of bench.py's
    workload: one halo exchange supplies BOTH the FIR 'same' context and
    the frame tail, then every device runs the identical conv-of-blocks
    program on [left halo | block | right halo]; the filtered signal is
    never materialized anywhere in the pod.

    Halo geometry: extended frame m covers x[m*stride - pad_left,
    m*stride + frame + (K-1)//2 - 1], so each device fetches pad_left =
    (K-1) - (K-1)//2 left-neighbor samples (zeros at device 0 — exactly
    the single-device left pad) and frame - stride + (K-1)//2 right
    samples. Frames never straddle device math, so the sharded result
    equals the single-device call up to the conv's reduction order for
    the local shape (ulp-tight on CPU, where it varies with the batch
    extent).

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    >>> mesh = make_dsp_mesh(2, 4)   # needs 8 devices, e.g.
    >>> # XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 4096)), jnp.float32)
    >>> from nx_signal_tpu.parallel.sharded import sharded_fir_framed_dft_power
    >>> from nx_signal_tpu.ops.windows import hann
    >>> taps = jnp.asarray(np.random.default_rng(1).normal(size=63), jnp.float32)
    >>> pw = sharded_fir_framed_dft_power(x, taps, hann(256), mesh=mesh,
    ...                                   stride=128, n_fft=256)
    >>> pw.shape   # (channels, frames, onesided bins)
    (4, 31, 129)
    """
    x, squeeze = _norm_2d(x)
    taps = jnp.asarray(taps).reshape(-1)
    window = jnp.asarray(window)
    (frame_length,) = window.shape
    k = taps.shape[0]
    ext = frame_length + k - 1
    bins = n_fft // 2 + 1 if onesided else n_fft
    if n_fft < frame_length:
        raise ValueError(
            "sharded_fir_framed_dft_power requires a matmul-DFT geometry: "
            f"fft_length >= frame_length, got {n_fft} < {frame_length}")
    n_channel, n_block = mesh.shape[CHANNEL_AXIS], mesh.shape[BLOCK_AXIS]
    _check_divisible("channels", x.shape[0], n_channel)
    _, padded_len, _, num_frames, _ = _stft_frame_geometry(
        x.shape[1], frame_length, stride, n_block
    )
    if padded_len != x.shape[1]:
        x = jnp.pad(x, [(0, 0), (0, padded_len - x.shape[1])])
    block_len = padded_len // n_block
    pad_left = (k - 1) - (k - 1) // 2
    halo_right = frame_length - stride + (k - 1) // 2
    if max(pad_left, halo_right) > block_len:
        raise ValueError(
            f"chain halo (left {pad_left}, right {halo_right}) exceeds the "
            f"per-device block ({block_len}); use fewer blocks, a shorter "
            "filter, or a larger hop")
    weights = fir_dft_fold_weights(taps, window, n_fft, onesided,
                                   traced=isinstance(taps, jax.core.Tracer)
                                   or isinstance(window, jax.core.Tracer))
    frames_per_block = block_len // stride

    def local(x_blk):
        x_blk = x_blk.astype(DEFAULT_FLOAT)
        parts = []
        if pad_left:
            parts.append(_shift_from_left(x_blk[:, -pad_left:], n_block))
        parts.append(x_blk)
        if halo_right:
            parts.append(_shift_from_right(x_blk[:, :halo_right], n_block))
        ext_blk = jnp.concatenate(parts, axis=-1)
        acc = blocked_frame_matmul(
            ext_blk, weights, window_length=ext, stride=stride,
            num_frames=frames_per_block, precision=precision,
        )
        return acc[..., :bins] ** 2 + acc[..., bins:] ** 2

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=P(CHANNEL_AXIS, BLOCK_AXIS),
        out_specs=P(CHANNEL_AXIS, BLOCK_AXIS, None),
    )
    out = fn(x)[:, :num_frames, :]
    return out[0] if squeeze else out
