"""End-to-end DSP pipelines — the framework's "model" layer.

These compose the op/spectral layers into the workloads the reference ships
as Livebook guides (guides/filtering.livemd, guides/spectrogram.livemd) and
the benchmark configs (BASELINE.json): FIR filtering chains, spectrograms,
and log-mel front ends. Each pipeline is a pytree-friendly callable whose
__call__ is pure and jittable; construction (filter design, window build)
happens once at Python level.
"""

from dataclasses import dataclass

import jax.numpy as jnp

from nx_signal_tpu.ops.convolution import oaconvolve
from nx_signal_tpu.ops.filters import firwin
from nx_signal_tpu.ops.windows import hann
from nx_signal_tpu.spectral.mel import mel_filters
from nx_signal_tpu.spectral.stft import stft
from nx_signal_tpu.utils.dtypes import DEFAULT_FLOAT

__all__ = ["SpectrogramPipeline", "LogMelFrontend", "FIRFilterChain",
           "stft_fir_chain", "WidebandReceiver", "channelize_power_stream"]

#: matmul/conv precision of `stft_fir_chain` by default, and of `bench.py`:
#: the cheapest setting whose chain stays inside the 1e-4 gate against a
#: float32 reference on the H100 (PERF.md, bring-up findings)
CHAIN_PRECISION = "highest"


@dataclass(frozen=True)
class SpectrogramPipeline:
    """Hann-window STFT -> dBFS spectrogram, the guides/spectrogram.livemd
    workload (reference: spectrogram.livemd:79-91 — fft_length 1024, Hann,
    dBFS = 20 log10(|S| / max|S|))."""

    frame_length: int = 1024
    overlap_length: int = None
    fft_length: int = 1024
    sampling_rate: float = 16000.0

    def __call__(self, x):
        w = hann(self.frame_length)
        z, times, freqs = stft(
            x, w,
            sampling_rate=self.sampling_rate,
            fft_length=self.fft_length,
            overlap_length=self.overlap_length,
            scaling="spectrum",
        )
        mag = jnp.abs(z)
        db = 20.0 * jnp.log10(mag / jnp.max(mag) + 1e-12)
        return db, times, freqs


@dataclass(frozen=True)
class LogMelFrontend:
    """Whisper-style log-mel front end: STFT -> |z|^2 -> mel matmul -> log10
    with dynamic-range floor (reference: nx_signal.ex:486-513). The mel
    projection is precomputed and applied as a single matmul."""

    frame_length: int = 400
    hop_length: int = 160
    fft_length: int = 512
    mel_bins: int = 80
    sampling_rate: float = 16000.0

    def __call__(self, x):
        w = hann(self.frame_length)
        z, _, _ = stft(
            x, w,
            sampling_rate=self.sampling_rate,
            fft_length=self.fft_length,
            overlap_length=self.frame_length - self.hop_length,
            window_padding="reflect",
        )
        filters = mel_filters(self.fft_length, self.mel_bins, self.sampling_rate)
        freq_size = self.fft_length // 2
        power = jnp.abs(z).astype(DEFAULT_FLOAT) ** 2
        mel = jnp.matmul(power[..., :freq_size], filters[:, :freq_size].T,
                         precision="highest")
        log_spec = jnp.log10(jnp.clip(mel, 1e-10, None))
        log_spec = jnp.maximum(log_spec, jnp.max(log_spec) - 8.0)
        return (log_spec + 4.0) / 4.0


@dataclass(frozen=True)
class FIRFilterChain:
    """firwin design + overlap-add application — the guides/filtering.livemd
    chain (reference: filtering.livemd:58,126-128)."""

    num_taps: int = 255
    cutoff: tuple = (2000.0,)
    sampling_rate: float = 48000.0
    window: str = "hann"

    @property
    def taps(self):
        return firwin(
            self.num_taps, list(self.cutoff),
            window=self.window, sampling_rate=self.sampling_rate,
        )

    def __call__(self, x):
        taps = self.taps
        if x.ndim > 1:
            taps = taps.reshape((1,) * (x.ndim - 1) + (-1,))
        return oaconvolve(x, taps, mode="same")


def stft_fir_chain(x, taps, window, *, fft_length: int, overlap_length: int,
                   sampling_rate: float = 16000.0, fir_method: str = "direct",
                   onesided: bool = True, return_filtered: bool = True,
                   precision=CHAIN_PRECISION, frame_chunks=1):
    """The north-star benchmark chain (BASELINE.json): FIR low-pass then
    Hann STFT -> power spectrogram, returning (filtered, power) — or power
    alone with `return_filtered=False`, which, where `good_matmul_fft_length`
    prefers the matmul DFT, takes the fully-fused
    kernels/dft.py:fir_framed_dft path (the Toeplitz filter matrix is folded
    into the DFT weights; the filtered signal is never materialized).

    Defaults: direct FIR (the Toeplitz-matmul path; on the H100 the chain
    measured slower with it than with `fir_method='oa'`, PERF.md) and a
    one-sided power spectrum (real input). `precision` sets the matmul/conv precision of
    the DFT kernels (see spectral.stft); the default `CHAIN_PRECISION` is
    the cheapest setting that passes the 1e-4 gate on the H100. The DFT
    runs as a matmul where `good_matmul_fft_length` prefers it, as XLA's
    FFT otherwise. `frame_chunks > 1` (fused power path only) bounds the
    peak memory of the conv intermediate by chunking the frame axis
    (kernels/dft.py:fir_framed_dft)."""
    from nx_signal_tpu.ops.convolution import convolve
    from nx_signal_tpu.kernels.dft import (
        fir_framed_dft, framed_dft, good_matmul_fft_length)

    x = jnp.asarray(x)
    taps = jnp.asarray(taps)
    window = jnp.asarray(window)
    n_fft = fft_length
    frame_length = window.shape[-1]
    stride = frame_length - overlap_length
    real_input = not jnp.issubdtype(x.dtype, jnp.complexfloating)
    matmul_ok = (real_input and good_matmul_fft_length(n_fft)
                 and n_fft >= frame_length)
    if not return_filtered and matmul_ok:
        return fir_framed_dft(
            x, taps.reshape(-1), window,
            stride=stride, n_fft=n_fft, onesided=onesided, precision=precision,
            output="power", frame_chunks=frame_chunks,
        )

    taps_b = taps.reshape((1,) * (x.ndim - 1) + (-1,)) if x.ndim > 1 else taps
    if fir_method == "oa":
        y = oaconvolve(x, taps_b, mode="same")
    else:
        y = convolve(x, taps_b, mode="same", method=fir_method)
    if matmul_ok:
        # skip complex assembly: power straight from the [Re | Im] matmul
        # ('valid' window padding, matching the stft default)
        power = framed_dft(
            y, window, stride=stride, n_fft=n_fft, onesided=onesided,
            precision=precision, output="power",
        )
    else:
        z, _, _ = stft(
            y, window,
            sampling_rate=sampling_rate,
            fft_length=fft_length,
            overlap_length=overlap_length,
            onesided=onesided,
            precision=precision,
        )
        power = jnp.abs(z) ** 2
    if not return_filtered:
        return power
    return y, power


@dataclass(frozen=True)
class WidebandReceiver:
    """SDR-style wideband front end (BASELINE configs 4-5): polyphase
    channelize the input stream into `n_channels` sub-bands, then Hann-STFT
    each sub-band stream. Batched over leading channel axes; shard with
    parallel.sharded_pfb_analyze + sharded_stft at pod scale."""

    n_channels: int = 64
    taps_per_channel: int = 8
    frame_length: int = 128
    hop: int = 64
    sampling_rate: float = 100e6

    def __call__(self, x):
        from nx_signal_tpu.ops.resample import pfb_analyze

        channels = pfb_analyze(
            x, self.n_channels, taps_per_channel=self.taps_per_channel
        )  # (..., frames, n_channels)
        sub_streams = jnp.swapaxes(channels, -1, -2)  # (..., n_channels, frames)
        w = hann(self.frame_length)
        # sub-band streams are complex baseband: full-spectrum STFT
        z, _, _ = stft(
            sub_streams, w,
            sampling_rate=self.sampling_rate / self.n_channels,
            fft_length=self.frame_length,
            overlap_length=self.frame_length - self.hop,
        )
        return jnp.abs(z) ** 2


def channelize_power_stream(blocks, n_channels: int, *,
                            taps_per_channel: int = 8,
                            window=("kaiser", 5.0), taps=None,
                            strategy: str = "auto", precision="highest",
                            drop_tail: bool = False):
    """Consume an iterator of (channels, block_frames) float32 blocks —
    e.g. `io.raw.PrefetchingRawReader` decoding a live SDR capture — 
    through a `StreamingPFB` channelizer, accumulating per-band power ON
    DEVICE (the complex spectra are never transferred back). This is the
    BASELINE config-5 pipeline composed end-to-end: native ingest ->
    streaming channelizer -> band power. Returns
    (power (channels, n_channels) float32, frames_accumulated int).

    Blocks are staged through a host FIFO and processed in FIXED-length
    chunks (the first block's length rounded down to a multiple of
    n_channels), so the jitted step compiles exactly once regardless of
    ragged final blocks; a shorter multiple-of-m tail costs one extra
    compile unless `drop_tail=True` (a bench-mode concession for
    remote-compile backends where each new shape is expensive). The
    accumulated power equals `pfb_analyze` of the zero-prepended stream
    summed over frames — the `StreamingPFB.lead_frames` warm-up frames
    are included (their windows taper into the zero lead, the standard
    streaming-channelizer transient). Not in the reference (no IO or
    streaming layer — SURVEY.md §2/§5).

    Examples:

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.models.pipeline import channelize_power_stream
    >>> from nx_signal_tpu.ops.resample import pfb_analyze
    >>> x = np.random.default_rng(0).normal(size=(1, 4096)).astype(np.float32)
    >>> blocks = [x[:, :1536], x[:, 1536:3072], x[:, 3072:]]  # ragged tail
    >>> power, frames = channelize_power_stream(blocks, 16,
    ...                                         taps_per_channel=4)
    >>> ref = pfb_analyze(jnp.asarray(np.pad(x, [(0, 0), (48, 0)])), 16,
    ...                   taps_per_channel=4)
    >>> ref_p = jnp.sum(ref.real**2 + ref.imag**2, axis=-2)
    >>> power.shape, frames, bool(jnp.abs(power - ref_p).max() <
    ...                           1e-4 * float(ref_p.max()))
    ((1, 16), 256, True)
    """
    import jax

    import numpy as np

    from nx_signal_tpu.parallel.streaming import StreamingPFB

    m = n_channels
    pfb = StreamingPFB(m, taps_per_channel=taps_per_channel, window=window,
                       taps=taps, strategy=strategy, precision=precision)

    def step(state, acc, chunk):
        state, z = pfb.process(state, chunk)
        p = jnp.sum(jnp.real(z) ** 2 + jnp.imag(z) ** 2, axis=-2)
        return state, acc + p

    step = jax.jit(step)
    it = iter(blocks)
    try:
        first = np.asarray(next(it))
    except StopIteration:
        raise ValueError("empty block stream") from None
    if first.ndim != 2:
        raise ValueError(
            f"blocks must be (channels, frames), got shape {first.shape}")
    n_streams = first.shape[0]
    chunk_len = (first.shape[1] // m) * m
    if chunk_len == 0:
        raise ValueError(
            f"block length ({first.shape[1]}) is shorter than one "
            f"n_channels ({m}) stride")
    state = pfb.init_state(batch_shape=(n_streams,))
    acc = jnp.zeros((n_streams, m), DEFAULT_FLOAT)
    frames = 0
    fifo = [first]
    buffered = first.shape[1]

    def drain(fifo, buffered):
        nonlocal state, acc, frames
        while buffered >= chunk_len:
            buf = np.concatenate(fifo, axis=1) if len(fifo) > 1 else fifo[0]
            head, rest = buf[:, :chunk_len], buf[:, chunk_len:]
            state, acc = step(state, acc, jnp.asarray(head))
            frames += chunk_len // m
            fifo = [rest] if rest.shape[1] else []
            buffered = rest.shape[1]
        return fifo, buffered

    fifo, buffered = drain(fifo, buffered)
    for block in it:
        block = np.asarray(block)
        fifo.append(block)
        buffered += block.shape[1]
        fifo, buffered = drain(fifo, buffered)
    tail_len = (buffered // m) * m
    if tail_len and not drop_tail:
        buf = np.concatenate(fifo, axis=1) if len(fifo) > 1 else fifo[0]
        state, acc = step(state, acc, jnp.asarray(buf[:, :tail_len]))
        frames += tail_len // m
    return acc, frames
