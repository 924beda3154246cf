"""Sharded spectral estimation: Welch PSD / CSD / coherence over a
('channel', 'block') device mesh.

Greenfield (SURVEY.md §2.9 — the reference is single-device, and stops at
the raw STFT anyway). Welch averaging is the natural distributed-DSP
reduction: each device computes the segment spectra of its own time block
(frame-tail halos via the sharded STFT machinery, parallel/sharded.py),
forms per-segment cross-power locally, and the segment mean reduces across
the block axis — XLA lowers the mean over the sharded segment axis to
per-device partial sums + one psum across the cards, so the only communications are
the (segment_length - stride)-sample halo and one bins-sized reduction.
"""

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from nx_signal_tpu.kernels.dft import blocked_frame_matmul
from nx_signal_tpu.parallel.mesh import BLOCK_AXIS, CHANNEL_AXIS
from nx_signal_tpu.parallel.sharded import (
    _norm_2d,
    _shift_from_right,
    _stft_frame_geometry,
    sharded_stft,
)
from nx_signal_tpu.spectral.estimation import (
    _detrend_basis_spectra,
    _detrend_columns,
    _finalize_csd,
    _spectral_params,
    _validate_detrend,
)
from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT

__all__ = ["sharded_csd", "sharded_welch", "sharded_coherence"]


def _sharded_frame_coefs(x2d, segment_length, stride, mesh, precision,
                         detrend):
    """(channels, segments, k) per-segment detrend coefficients (mean, and
    slope for 'linear') of the (channels, L) signal, segments sharded over
    the block axis with the same frame geometry and right halo as
    sharded_stft — one blocked mat-vec per device, no segment matrix
    materialized."""
    n_block = mesh.shape[BLOCK_AXIS]
    _, padded_len, _, num_frames, halo = _stft_frame_geometry(
        x2d.shape[1], segment_length, stride, n_block
    )
    if padded_len != x2d.shape[1]:
        x2d = jnp.pad(x2d, [(0, 0), (0, padded_len - x2d.shape[1])])
    cols = jnp.asarray(_detrend_columns(segment_length, detrend),
                       DEFAULT_FLOAT).astype(x2d.dtype)

    def local(x_blk):
        if halo:
            ext = jnp.concatenate(
                [x_blk, _shift_from_right(x_blk[:, :halo], n_block)], axis=-1
            )
        else:
            ext = x_blk
        nf = (ext.shape[-1] - segment_length) // stride + 1
        return blocked_frame_matmul(
            ext, cols, window_length=segment_length, stride=stride,
            num_frames=nf, precision=precision,
        )

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=P(CHANNEL_AXIS, BLOCK_AXIS),
        out_specs=P(CHANNEL_AXIS, BLOCK_AXIS, None),
    )
    return fn(x2d)[:, :num_frames, :]


def _sharded_segment_spectra(x, w, *, mesh, stride, n_fft, onesided, detrend,
                             method, precision):
    """(..., segments, bins) spectra of detrended windowed segments, with
    segments sharded over the mesh block axis (frames stay whole on the
    device where they start; see sharded_stft)."""
    _validate_detrend(detrend, allow_callable=False)
    segment_length = w.shape[-1]
    x2d, squeeze = _norm_2d(x)
    real_input = not jnp.issubdtype(x2d.dtype, jnp.complexfloating)
    z, _, _ = sharded_stft(
        x2d, w, mesh=mesh, sampling_rate=1.0, fft_length=n_fft,
        overlap_length=segment_length - stride,
        onesided=onesided and real_input, method=method,
    )
    if detrend in ("constant", "linear"):
        # frequency-domain detrend by linearity (see spectral/estimation
        # .py): subtract coefs @ [F(w); F(tc*w)] per segment
        coefs = _sharded_frame_coefs(x2d, segment_length, stride, mesh,
                                     precision, detrend)
        one_sided_fft = onesided and real_input
        wk = _detrend_basis_spectra(w, n_fft, one_sided_fft, detrend)
        z = z - coefs @ wk
    return z[0] if squeeze else z


def sharded_csd(x, y, *, mesh, sampling_rate=1.0, window="hann",
                segment_length=256, overlap_length=None, fft_length=None,
                detrend="constant", onesided=True, scaling="density",
                average="mean", method="auto", precision="highest"):
    """Cross power spectral density by Welch's method, sharded over
    channels and time blocks (scipy.signal.csd semantics — see
    spectral/estimation.py:csd for the option surface).

    Matches the single-device `csd` to FFT/matmul accuracy (the segment
    spectra are bit-comparable per sharded_stft; the segment-axis mean is
    a partial-sum + psum whose association differs from the single-device
    reduction only at the ulp level). `average='median'` gathers the
    segment axis (jnp.median over a sharded axis) — prefer 'mean' at scale.
    
    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    >>> mesh = make_dsp_mesh(2, 4)   # needs 8 devices, e.g.
    >>> # XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 4096)), jnp.float32)
    >>> from nx_signal_tpu.parallel.estimation import sharded_csd
    >>> f, C = sharded_csd(x, x, mesh=mesh, sampling_rate=8000.0,
    ...                    segment_length=256, overlap_length=128)
    >>> C.shape, C.dtype
    ((4, 129), dtype('complex64'))
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    w, stride, n_fft, scale = _spectral_params(
        window, segment_length, overlap_length, fft_length, scaling, average,
        sampling_rate,
    )
    complex_input = jnp.issubdtype(x.dtype, jnp.complexfloating) or \
        jnp.issubdtype(y.dtype, jnp.complexfloating)
    if onesided and complex_input:
        raise ValueError("onesided=True requires real input; "
                         "use onesided=False for complex signals")
    common = dict(mesh=mesh, stride=stride, n_fft=n_fft, onesided=onesided,
                  detrend=detrend, method=method, precision=precision)
    zx = _sharded_segment_spectra(x, w, **common)
    zy = zx if y is x else _sharded_segment_spectra(y, w, **common)
    pxy = jnp.conj(zx) * zy * scale
    return _finalize_csd(pxy, n_fft=n_fft, onesided=onesided, average=average,
                         sampling_rate=sampling_rate)


def sharded_welch(x, *, mesh, sampling_rate=1.0, window="hann",
                  segment_length=256, overlap_length=None, fft_length=None,
                  detrend="constant", onesided=True, scaling="density",
                  average="mean", method="auto", precision="highest"):
    """Welch PSD sharded over channels and time blocks; the distributed
    form of spectral/estimation.py:welch (returns (frequencies, P_xx) with
    P_xx real).

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    >>> mesh = make_dsp_mesh(2, 4)   # needs 8 devices, e.g.
    >>> # XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 4096)), jnp.float32)
    >>> from nx_signal_tpu.parallel.estimation import sharded_welch
    >>> f, P = sharded_welch(x, mesh=mesh, sampling_rate=8000.0,
    ...                      segment_length=256, overlap_length=128)
    >>> f.shape, P.shape
    ((129,), (4, 129))
    """
    x = jnp.asarray(x)
    freqs, pxx = sharded_csd(
        x, x, mesh=mesh, sampling_rate=sampling_rate, window=window,
        segment_length=segment_length, overlap_length=overlap_length,
        fft_length=fft_length, detrend=detrend, onesided=onesided,
        scaling=scaling, average=average, method=method, precision=precision,
    )
    return freqs, jnp.real(pxx)


def sharded_coherence(x, y, *, mesh, sampling_rate=1.0, window="hann",
                      segment_length=256, overlap_length=None,
                      fft_length=None, detrend="constant", method="auto",
                      precision="highest"):
    """Magnitude-squared coherence sharded over channels and time blocks;
    the distributed form of spectral/estimation.py:coherence.

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    >>> mesh = make_dsp_mesh(2, 4)   # needs 8 devices, e.g.
    >>> # XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 4096)), jnp.float32)
    >>> from nx_signal_tpu.parallel.estimation import sharded_coherence
    >>> y = jnp.asarray(np.roll(np.asarray(x), 1, axis=-1))
    >>> f, coh = sharded_coherence(x, y, mesh=mesh, sampling_rate=8000.0,
    ...                            segment_length=256, overlap_length=128)
    >>> bool(coh.min() >= 0.0) and bool(coh.max() <= 1.000001)
    True
    """
    common = dict(
        mesh=mesh, sampling_rate=sampling_rate, window=window,
        segment_length=segment_length, overlap_length=overlap_length,
        fft_length=fft_length, detrend=detrend, method=method,
        precision=precision,
    )
    freqs, pxx = sharded_welch(x, **common)
    _, pyy = sharded_welch(y, **common)
    _, pxy = sharded_csd(x, y, **common)
    return freqs, jnp.abs(pxy) ** 2 / (pxx * pyy)
