"""Stateful block-streaming DSP for unbounded streams.

The reference is stateless/batch-only; streaming is a greenfield component
(SURVEY.md §5: "carry overlap-save filter state (last K-1 samples) as
explicit carry"). Every processor here is a pure (state, chunk) -> (state,
out) function pair, so it composes with jax.lax.scan for compiled multi-
chunk runs and serializes trivially (the state is a pytree of arrays) for
checkpoint/resume of long streaming jobs.

Chunk lengths are static per jit-compilation (XLA static shapes); use a
fixed chunk size and pad the final chunk.
"""

from dataclasses import dataclass

import jax.numpy as jnp

from nx_signal_tpu.ops.convolution import fir_convolve_1d, _float_cast
from nx_signal_tpu.spectral.framing import _ola_fold, as_windowed
from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT

__all__ = ["StreamingFIR", "StreamingSTFT", "StreamingISTFT", "StreamingIIR",
           "StreamingPFB", "StreamingResamplePoly"]


@dataclass(frozen=True)
class StreamingFIR:
    """Causal overlap-save FIR: chunk outputs equal
    convolve(stream, taps, mode='full')[:len(stream)] — the filter's group
    delay is NOT compensated (that needs future samples). The carry is the
    last K-1 input samples.

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.streaming import StreamingFIR
    >>> fir = StreamingFIR(jnp.asarray([0.5, 0.5]))
    >>> state = fir.init_state()
    >>> state, y1 = fir.process(state, jnp.asarray([1.0, 2.0, 3.0, 4.0]))
    >>> state, y2 = fir.process(state, jnp.asarray([5.0, 6.0, 7.0, 8.0]))
    >>> np.round(np.concatenate([y1, y2]), 2)   # == full conv of the stream
    array([0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, 7.5], dtype=float32)
    """

    taps: jnp.ndarray

    def init_state(self, batch_shape=(), dtype=DEFAULT_FLOAT):
        k = jnp.asarray(self.taps).shape[-1]
        return jnp.zeros((*batch_shape, k - 1), dtype=dtype)

    def process(self, state, chunk):
        chunk = _float_cast(jnp.asarray(chunk))
        taps = _float_cast(jnp.asarray(self.taps))
        k = taps.shape[-1]
        ext = jnp.concatenate([state.astype(chunk.dtype), chunk], axis=-1)
        out = fir_convolve_1d(ext, taps, "valid")
        new_state = ext[..., -(k - 1) :] if k > 1 else state
        return new_state, out


@dataclass(frozen=True)
class StreamingSTFT:
    """Streaming frame extraction + windowed FFT. The carry holds the
    samples not yet consumed by a full frame (the frame_length - hop
    overlap context), initialized to zeros — so the stream behaves like the
    batch signal PREPENDED with frame_length - hop zeros: streaming frame i
    starts at stream sample i*hop - (frame_length - hop), and concatenating
    the per-chunk spectra equals
    stft(concat([zeros(frame_length - hop), stream]), padding='valid').
    Account for that fixed lead-in when aligning frame timestamps.

    Examples:

    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.windows import hann
    >>> from nx_signal_tpu.parallel.streaming import StreamingSTFT
    >>> sstft = StreamingSTFT(hann(8), hop=4, onesided=True)
    >>> state = sstft.init_state()
    >>> state, z1 = sstft.process(state, jnp.ones(8))
    >>> state, z2 = sstft.process(state, jnp.ones(8))
    >>> z1.shape, z2.shape   # 2 frames per 8-sample chunk at hop 4
    ((2, 5), (2, 5))
    """

    window: jnp.ndarray
    hop: int
    fft_length: int = None
    onesided: bool = False

    @property
    def frame_length(self):
        return jnp.asarray(self.window).shape[-1]

    def init_state(self, batch_shape=(), dtype=DEFAULT_FLOAT):
        return jnp.zeros((*batch_shape, self.frame_length - self.hop), dtype=dtype)

    def process(self, state, chunk):
        window = jnp.asarray(self.window)
        frame_length = window.shape[-1]
        if chunk.shape[-1] % self.hop != 0:
            raise ValueError(
                f"chunk length ({chunk.shape[-1]}) must be a multiple of the "
                f"hop ({self.hop}) so frame counts stay static"
            )
        ext = jnp.concatenate([state.astype(chunk.dtype), chunk], axis=-1)
        frames = as_windowed(ext, window_length=frame_length, stride=self.hop)
        n_fft = self.fft_length or frame_length
        fft = jnp.fft.rfft if self.onesided else jnp.fft.fft
        z = fft(frames * window, n=n_fft, axis=-1)
        consumed = frames.shape[-2] * self.hop
        return ext[..., consumed:], z


@dataclass(frozen=True)
class StreamingISTFT:
    """Streaming inverse STFT via the deterministic overlap-add fold. The
    carry is the overlap tail (the last frame_length - hop output samples,
    still accumulating). Emitted samples are normalized by the periodic NOLA
    window envelope, so the concatenated output equals the batch `istft`
    everywhere except the first and last half-window of the whole stream
    (which the batch version also reconstructs imperfectly).

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.windows import hann
    >>> from nx_signal_tpu.parallel.streaming import StreamingISTFT
    >>> sistft = StreamingISTFT(hann(8), hop=4)
    >>> state = sistft.init_state()
    >>> z = jnp.asarray(np.fft.fft(np.ones((2, 8))), jnp.complex64)
    >>> state, y = sistft.process(state, z)
    >>> y.shape   # hop * frames emitted, overlap tail carried
    (8,)
    """

    window: jnp.ndarray
    hop: int
    scaling: str = None
    sampling_rate: float = 1000.0

    def init_state(self, batch_shape=(), dtype=jnp.complex64):
        frame_length = jnp.asarray(self.window).shape[-1]
        return jnp.zeros((*batch_shape, frame_length - self.hop), dtype=dtype)

    def _envelope(self, frame_length):
        """Periodic interior NOLA envelope: env[s] = sum_j w^2[s + j*hop],
        one hop period."""
        w2 = jnp.abs(jnp.asarray(self.window)).astype(DEFAULT_FLOAT) ** 2
        pad = (-frame_length) % self.hop
        w2 = jnp.pad(w2, (0, pad))
        env = w2.reshape(-1, self.hop).sum(axis=0)
        return jnp.where(env > 1e-10, env, jnp.ones((), env.dtype))

    def process(self, state, z_chunk):
        from nx_signal_tpu.spectral.stft import _apply_scaling

        window = jnp.asarray(self.window)
        frame_length = window.shape[-1]
        overlap = frame_length - self.hop
        if z_chunk.shape[-1] != frame_length:
            raise ValueError(
                f"StreamingISTFT requires fft_length == window length "
                f"({frame_length}); got spectra with {z_chunk.shape[-1]} bins "
                "— decimating or cropping bins would silently corrupt the "
                "reconstruction"
            )
        frames = jnp.fft.ifft(z_chunk, n=frame_length, axis=-1)
        frames = _apply_scaling(frames, window, self.scaling, self.sampling_rate,
                                inverse=True)
        frames = frames * window
        m = frames.shape[-2]
        local_len = m * self.hop + overlap
        init = jnp.pad(
            state.astype(frames.dtype),
            [(0, 0)] * (frames.ndim - 2) + [(0, local_len - overlap)],
        )
        acc = _ola_fold(frames, self.hop, local_len, init=init)
        emitted = acc[..., : m * self.hop]
        env = self._envelope(frame_length)
        reps = -(-m * self.hop // self.hop)
        env_full = jnp.tile(env, reps)[: m * self.hop]
        return acc[..., m * self.hop :], emitted / env_full


@dataclass(frozen=True)
class StreamingPFB:
    """Streaming critically-sampled polyphase channelizer — `pfb_analyze`
    on an unbounded stream (the BASELINE config-5 front end consuming a
    live capture). The carry is the last (taps_per_channel-1)*n_channels
    input samples, zero-initialized, so the stream behaves like the batch
    signal PREPENDED with that many zeros: concatenating per-chunk outputs
    equals `pfb_analyze(concat([zeros((tpc-1)*m), stream]))`, and dropping
    the first `lead_frames` (= taps_per_channel-1) output frames gives
    `pfb_analyze(stream)` exactly (bit-for-bit where the GEMM's
    reduction order is fixed; to f32 GEMM accuracy on CPU). Chunk lengths
    must be multiples of n_channels and static per jit-compilation; the
    state is a plain array pytree, serializable with `io/checkpoint.py`
    for resume of long streaming jobs. Not in the reference (it has no
    streaming layer — SURVEY.md §5 checkpoint row).

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.resample import pfb_analyze
    >>> from nx_signal_tpu.parallel.streaming import StreamingPFB
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=512),
    ...                 jnp.float32)
    >>> pfb = StreamingPFB(8, taps_per_channel=4)
    >>> state = pfb.init_state()
    >>> state, z1 = pfb.process(state, x[:256])
    >>> state, z2 = pfb.process(state, x[256:])
    >>> z = jnp.concatenate([z1, z2], axis=-2)[pfb.lead_frames:]
    >>> ref = pfb_analyze(x, 8, taps_per_channel=4)
    >>> z.shape, bool(jnp.abs(z - ref).max() < 1e-5)
    ((61, 8), True)
    """

    n_channels: int
    taps_per_channel: int = 8
    window: tuple = ("kaiser", 5.0)
    taps: object = None
    shift: bool = False
    strategy: str = "auto"
    precision: str = "highest"

    def __post_init__(self):
        # design the prototype ONCE (host-side f64 firwin is ~ms per call
        # — noticeable when process() runs un-jitted per chunk) and
        # normalize taps_per_channel to a caller-provided prototype
        from nx_signal_tpu.ops.filters import firwin

        m = self.n_channels
        if self.taps is None:
            proto = firwin(m * self.taps_per_channel, [1.0 / m],
                           window=self.window)
            object.__setattr__(self, "taps", proto)
        else:
            proto = jnp.asarray(self.taps)
            if proto.shape[0] % m != 0:
                raise ValueError(
                    f"prototype length ({proto.shape[0]}) must be a "
                    f"multiple of n_channels ({m})")
            object.__setattr__(self, "taps", proto)
            object.__setattr__(self, "taps_per_channel",
                               proto.shape[0] // m)

    @property
    def lead_frames(self) -> int:
        """Zero-lead-in output frames to drop for batch alignment."""
        return self.taps_per_channel - 1

    def init_state(self, batch_shape=(), dtype=DEFAULT_FLOAT):
        carry = (self.taps_per_channel - 1) * self.n_channels
        return jnp.zeros((*batch_shape, carry), dtype=dtype)

    def process(self, state, chunk):
        from nx_signal_tpu.ops.resample import pfb_analyze

        m = self.n_channels
        chunk = _float_cast(jnp.asarray(chunk))
        if chunk.shape[-1] % m != 0 or chunk.shape[-1] < m:
            raise ValueError(
                f"chunk length ({chunk.shape[-1]}) must be a non-zero "
                f"multiple of n_channels ({m}) so frame counts stay static"
            )
        ext = jnp.concatenate([state.astype(chunk.dtype), chunk], axis=-1)
        out = pfb_analyze(
            ext, m, taps_per_channel=self.taps_per_channel,
            window=self.window, taps=self.taps, shift=self.shift,
            strategy=self.strategy, precision=self.precision)
        carry = (self.taps_per_channel - 1) * m
        new_state = ext[..., -carry:] if carry else state
        return new_state, out


@dataclass(frozen=True)
class StreamingResamplePoly:
    """Streaming rational-rate polyphase resampler — `resample_poly`
    (scipy semantics, gcd-reduced up/down, group-delay-aligned output
    grid) on an unbounded stream. Per chunk of C input samples (C a
    multiple of the reduced `down`) it emits exactly C*up/down output
    samples; the carry holds the last `taps-1 + Z` input samples, where
    the Z-sample zero lead (a multiple of `down`, covering the centered
    filter's group-delay lookahead) makes every chunk's outputs depend
    only on already-received input. Alignment: concatenating the per-call
    outputs and dropping the first `lead_out` (= Z*up/down) samples gives
    `resample_poly(stream)` sample-for-sample (bitwise where the GEMM's order is fixed; f32 GEMM
    accuracy on CPU); to drain the filter tail at end-of-stream, feed
    zero chunks until `lead_out + ceil(n_in*up/down)` total outputs have
    been collected. State is a plain array pytree (checkpoint/resume).
    Not in the reference (no streaming layer — SURVEY.md §5).

    Mirrors ops/resample.py:upfirdn's polyphase evaluation: the per-call
    phase pattern ((n_offset + l)*down) % up is chunk-invariant because
    C*up = (C*up/down)*down ≡ 0 (mod up) — the same SPMD-uniformity
    argument as parallel/sharded.py:sharded_upfirdn, with the chunk index
    in place of the device index.

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.ops.resample import resample_poly
    >>> from nx_signal_tpu.parallel.streaming import StreamingResamplePoly
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=600),
    ...                 jnp.float32)
    >>> sr = StreamingResamplePoly(2, 3)
    >>> state = sr.init_state()
    >>> outs = []
    >>> for k in range(4):   # 2 data chunks + 2 zero flush chunks
    ...     chunk = x[300 * k:300 * (k + 1)] if k < 2 else jnp.zeros(300)
    ...     state, y = sr.process(state, chunk)
    ...     outs.append(y)
    >>> y = jnp.concatenate(outs)[sr.lead_out:]
    >>> ref = resample_poly(x, 2, 3)
    >>> bool(jnp.abs(y[:ref.shape[0]] - ref).max() < 1e-5)
    True
    """

    up: int
    down: int
    window: tuple = ("kaiser", 5.0)
    taps: object = None

    def __post_init__(self):
        from nx_signal_tpu.ops.resample import (_phase_bank,
                                                _resample_poly_design)

        if self.up < 1 or self.down < 1:
            raise ValueError(
                f"up and down must be >= 1, got: up={self.up}, "
                f"down={self.down}")
        if int(self.up) == int(self.down):
            object.__setattr__(self, "_identity", True)
            object.__setattr__(self, "_z", 0)
            object.__setattr__(self, "_n_z", 0)
            return
        up, down, h, npr = _resample_poly_design(
            self.up, self.down, self.window, self.taps)
        bank, t_taps = _phase_bank(h, up)
        # Zero lead Z: a multiple of `down` covering the group-delay
        # lookahead (the last output of a chunk reads up to
        # ~npr*down/up samples past the chunk end) with a one-period
        # safety margin for the floor jitter.
        z0 = (npr * down) // up + down + up
        z = -(-z0 // down) * down
        object.__setattr__(self, "_identity", False)
        object.__setattr__(self, "_up", up)
        object.__setattr__(self, "_down", down)
        object.__setattr__(self, "_bank", bank)
        object.__setattr__(self, "_t_taps", t_taps)
        object.__setattr__(self, "_npr", npr)
        object.__setattr__(self, "_z", z)
        object.__setattr__(self, "_n_z", z * up // down)

    @property
    def lead_out(self) -> int:
        """Warm-up output samples to drop for batch alignment."""
        return self._n_z

    def init_state(self, batch_shape=(), dtype=DEFAULT_FLOAT):
        carry = 0 if self._identity else self._t_taps - 1 + self._z
        return jnp.zeros((*batch_shape, carry), dtype=dtype)

    def process(self, state, chunk):
        from nx_signal_tpu.ops.resample import (_upfirdn_dtype,
                                                _upfirdn_phase_outputs)

        chunk = _float_cast(jnp.asarray(chunk))
        if self._identity:
            return state, chunk
        up, down = self._up, self._down
        if chunk.shape[-1] % down != 0 or chunk.shape[-1] < down:
            raise ValueError(
                f"chunk length ({chunk.shape[-1]}) must be a non-zero "
                f"multiple of the reduced down factor ({down}) so output "
                "counts stay static"
            )
        n_c = chunk.shape[-1] * up // down
        bank = jnp.asarray(self._bank)
        dtype = _upfirdn_dtype(bank, chunk)
        ext = jnp.concatenate(
            [state.astype(dtype), chunk.astype(dtype)], axis=-1)
        out = _upfirdn_phase_outputs(
            ext, bank.astype(dtype), up, down, n_offset=self._npr,
            n_count=n_c)
        new_state = ext[..., -(self._t_taps - 1 + self._z):]
        return new_state, out


@dataclass(frozen=True)
class StreamingIIR:
    """Causal IIR filtering of an unbounded stream as cascaded second-order
    sections: chunk outputs equal sosfilt over the concatenated stream (the
    DF2T state is an exact stream summary; the chunked parallel scan
    associates sums differently, so equality is to f.p. accuracy rather
    than bitwise). The carry is the
    (n_sections, ..., 2) sosfilt state pytree — serializable for
    checkpoint/resume like every processor here.

    Within each chunk the biquads run as log-depth parallel scans
    (ops/iir.py); the sequential dependency is only chunk-to-chunk.
    
    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.streaming import StreamingIIR
    >>> sos = jnp.asarray([[0.2, 0.2, 0.0, 1.0, -0.6, 0.0]], jnp.float32)
    >>> siir = StreamingIIR(sos)
    >>> state = siir.init_state()
    >>> state, o1 = siir.process(state, jnp.ones(4))
    >>> np.round(np.asarray(o1), 3)   # == sosfilt over the whole stream
    array([0.2  , 0.52 , 0.712, 0.827], dtype=float32)
    """

    sos: jnp.ndarray

    def init_state(self, batch_shape=(), dtype=DEFAULT_FLOAT):
        n_sections = jnp.asarray(self.sos).shape[0]
        return jnp.zeros((n_sections, *batch_shape, 2), dtype=dtype)

    def process(self, state, chunk):
        from nx_signal_tpu.ops.iir import _lfilter_last_axis

        chunk = _float_cast(jnp.asarray(chunk))
        sos = jnp.asarray(self.sos)
        out = chunk
        new_states = []
        for s in range(sos.shape[0]):
            out, zf = _lfilter_last_axis(
                sos[s, :3], sos[s, 3:], out, state[s].astype(chunk.dtype)
            )
            new_states.append(zf)
        return jnp.stack(new_states, axis=0), out
