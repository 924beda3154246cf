"""kernels/dft.py against a plain numpy reference: `np.fft` of explicitly
framed and windowed data, `np.convolve` for the FIR. Covers the framed
DFT, the FIR-folded chain with every execution strategy, edge handling and
frame chunking, the shared-block form, the validation errors, and the one
dispatch rule `stft`, `ShortTimeFFT` and `stft_fir_chain` follow."""

import importlib

import numpy as np
import pytest

from nx_signal_tpu.kernels import dft
from nx_signal_tpu.kernels.dft import (
    blocked_frame_matmul,
    fir_framed_dft,
    fir_framed_dft_shared,
    framed_dft,
    recognize_cosine_window,
)
from nx_signal_tpu.ops import windows


def np_fir_same(x, taps):
    """'same' FIR per row by np.convolve (scipy's centre alignment)."""
    x = np.asarray(x, np.float64)
    k, n = len(taps), x.shape[-1]
    rows = x.reshape(-1, n)
    full = np.stack([np.convolve(r, np.asarray(taps, np.float64))
                     for r in rows])
    start = (k - 1) // 2
    return full[:, start:start + n].reshape(x.shape)


def np_spectrum(y, window, stride, n_fft, onesided):
    """Spectrum of explicitly sliced, windowed frames."""
    y = np.asarray(y, np.float64)
    frame = len(window)
    m = (y.shape[-1] - frame) // stride + 1
    idx = np.arange(m)[:, None] * stride + np.arange(frame)[None, :]
    frames = y[..., idx] * np.asarray(window, np.float64)
    return (np.fft.rfft(frames, n_fft) if onesided
            else np.fft.fft(frames, n_fft))


def assert_close_to_peak(got, ref, tol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max())


# (channels, length, taps, frame, stride, n_fft): the bench chain's family,
# an extended frame that is not a multiple of the hop with n_fft > frame,
# and an even tap count with a short frame
GEOMETRIES = [
    (2, 5000, 255, 512, 128, 512),
    (1, 3000, 63, 384, 128, 512),
    (3, 4096, 100, 256, 128, 256),
]


@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("channels,length,frame,stride", [
    (2, 4096, 512, 128),
    (1, 2048, 256, 128),
    (3, 5000, 512, 256),
])
def test_framed_dft_matches_numpy(onesided, channels, length, frame, stride,
                                  rng):
    x = rng.normal(size=(channels, length)).astype(np.float32)
    w = np.asarray(windows.hann(frame))
    got = framed_dft(x, w, stride=stride, n_fft=frame, onesided=onesided)
    assert_close_to_peak(got, np_spectrum(x, w, stride, frame, onesided))


def test_framed_dft_1d_input(rng):
    x = rng.normal(size=4096).astype(np.float32)
    w = np.asarray(windows.hann(512))
    got = framed_dft(x, w, stride=128, n_fft=512, onesided=True)
    assert got.ndim == 2
    assert_close_to_peak(got, np_spectrum(x, w, 128, 512, True))


@pytest.mark.parametrize("strategy", ["conv", "materialize", "blocked"])
@pytest.mark.parametrize("length,window_length,stride,cols", [
    (5000, 766, 128, 514),    # the chain's extended frame
    (1024, 256, 64, 8),       # window a multiple of the hop
    (3000, 100, 100, 5),      # one block per frame (C = 1)
])
def test_blocked_frame_matmul_strategies(strategy, length, window_length,
                                         stride, cols, rng):
    x = rng.normal(size=(2, length)).astype(np.float32)
    wts = rng.normal(size=(window_length, cols)).astype(np.float32)
    m = (length - window_length) // stride + 1
    idx = np.arange(m)[:, None] * stride + np.arange(window_length)[None, :]
    ref = x.astype(np.float64)[..., idx] @ wts.astype(np.float64)
    got = blocked_frame_matmul(x, wts, window_length=window_length,
                               stride=stride, num_frames=m, strategy=strategy)
    assert_close_to_peak(got, ref)


@pytest.mark.parametrize("frame_chunks", [1, 2, "auto"])
@pytest.mark.parametrize("channels,length,taps,frame,stride,nfft", GEOMETRIES)
def test_fused_power_matches_numpy(frame_chunks, channels, length, taps,
                                   frame, stride, nfft, rng):
    x = rng.normal(size=(channels, length)).astype(np.float32)
    t = rng.normal(size=taps).astype(np.float32)
    w = np.asarray(windows.hann(frame))
    got = fir_framed_dft(x, t, w, stride=stride, n_fft=nfft, onesided=True,
                         output="power", frame_chunks=frame_chunks)
    z = np_spectrum(np_fir_same(x, t), w, stride, nfft, True)
    assert_close_to_peak(got, np.abs(z) ** 2)


@pytest.mark.parametrize("channels,length,taps,frame,stride,nfft", [
    (2, 5120, 255, 512, 128, 512),   # hop | length: copy-free edges apply
    (1, 3000, 63, 384, 128, 512),    # falls back to the padded copy
    (3, 4096, 100, 256, 128, 256),
])
def test_fused_power_edge_conv(channels, length, taps, frame, stride, nfft,
                               rng):
    x = rng.normal(size=(channels, length)).astype(np.float32)
    t = rng.normal(size=taps).astype(np.float32)
    w = np.asarray(windows.hann(frame))
    got = fir_framed_dft(x, t, w, stride=stride, n_fft=nfft, onesided=True,
                         output="power", edge="conv")
    z = np_spectrum(np_fir_same(x, t), w, stride, nfft, True)
    assert_close_to_peak(got, np.abs(z) ** 2)


@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("channels,length,taps,frame,stride,nfft",
                         GEOMETRIES[:2])
def test_fused_complex_spectrum(onesided, channels, length, taps, frame,
                                stride, nfft, rng):
    x = rng.normal(size=(channels, length)).astype(np.float32)
    t = rng.normal(size=taps).astype(np.float32)
    w = np.asarray(windows.hann(frame))
    got = fir_framed_dft(x, t, w, stride=stride, n_fft=nfft,
                         onesided=onesided)
    assert_close_to_peak(got, np_spectrum(np_fir_same(x, t), w, stride, nfft,
                                          onesided))


def test_fused_power_1d_input(rng):
    x = rng.normal(size=4000).astype(np.float32)
    t = rng.normal(size=100).astype(np.float32)
    w = np.asarray(windows.hann(256))
    got = fir_framed_dft(x, t, w, stride=128, n_fft=256, onesided=True,
                         output="power")
    assert got.ndim == 2
    z = np_spectrum(np_fir_same(x, t), w, 128, 256, True)
    assert_close_to_peak(got, np.abs(z) ** 2)


@pytest.mark.parametrize("shape,length,taps,stride,nfft,wname", [
    ((2,), 5000, 255, 128, 512, "hann"),       # the chain geometry
    ((3, 2), 9000, 63, 128, 512, "blackman"),  # 3-D batch, two cosine terms
    ((1,), 4000, 1, 256, 512, "hamming"),      # J = 2, 1-tap FIR
    ((2,), 20000, 129, 128, 1024, "hann"),     # J = 8
])
def test_shared_block_matches_numpy(shape, length, taps, stride, nfft, wname,
                                    rng):
    x = rng.normal(size=(*shape, length)).astype(np.float32)
    t = rng.normal(size=taps).astype(np.float32)
    w = np.asarray(getattr(windows, wname)(nfft))
    coeffs = recognize_cosine_window(w, nfft)
    assert coeffs is not None
    got = fir_framed_dft_shared(x, t, stride=stride, n_fft=nfft,
                                window_coeffs=coeffs, onesided=True,
                                output="power")
    z = np_spectrum(np_fir_same(x, t), w, stride, nfft, True)
    assert_close_to_peak(got, np.abs(z) ** 2, tol=1e-4)


@pytest.mark.parametrize("wname,expected", [
    ("hann", (0.5, -0.5)),
    ("hamming", (0.54, -0.46)),
    ("blackman", (0.42, -0.5, 0.08)),
    ("kaiser", None),
])
def test_recognize_cosine_window(wname, expected):
    w = (windows.kaiser(256, beta=8.0) if wname == "kaiser"
         else getattr(windows, wname)(256))
    assert recognize_cosine_window(np.asarray(w), 256) == expected


@pytest.mark.parametrize("call,match", [
    (lambda x: fir_framed_dft(x[:100], np.ones(3), np.hanning(256),
                              stride=64, n_fft=256), "exceeds signal length"),
    (lambda x: fir_framed_dft_shared(x, np.ones(3), stride=100, n_fft=256,
                                     window_coeffs=(0.5, -0.5)),
     "stride | n_fft"),
    (lambda x: fir_framed_dft_shared(x, None, stride=5, n_fft=255,
                                     window_coeffs=(1.0,), onesided=True),
     "even n_fft"),
    (lambda x: fir_framed_dft_shared(x, None, stride=2, n_fft=256,
                                     window_coeffs=(1.0, 0.5, 0.25)),
     "window_coeffs"),
    (lambda x: fir_framed_dft_shared(x[:100], None, stride=64, n_fft=256,
                                     window_coeffs=(1.0,)),
     "exceeds signal length"),
])
def test_validation_errors(call, match, rng):
    x = rng.normal(size=1024).astype(np.float32)
    with pytest.raises(ValueError, match=match):
        call(x)


def _spy_matmul_dft(monkeypatch, module, name):
    """Record whether `module.name` (a matmul-DFT entry point) is called."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("prefer", [True, False])
@pytest.mark.parametrize("entry", ["stft", "ShortTimeFFT", "stft_fir_chain"])
def test_one_dispatch_rule(entry, prefer, monkeypatch, rng):
    """`method='auto'` in stft, ShortTimeFFT and stft_fir_chain takes the
    matmul DFT exactly when `good_matmul_fft_length` prefers it, on every
    backend, and gives the same spectrum either way."""
    monkeypatch.setattr(dft, "_MAX_MATMUL_FFT", 4096 if prefer else 0)
    x = rng.normal(size=(2, 2048)).astype(np.float32)
    w = np.asarray(windows.hann(256))
    if entry == "stft":
        stft_mod = importlib.import_module("nx_signal_tpu.spectral.stft")

        calls = _spy_matmul_dft(monkeypatch, stft_mod, "framed_dft")
        got = stft_mod.stft(x, w, fft_length=256, overlap_length=192,
                            onesided=True).z
        ref = np_spectrum(x, w, 64, 256, True)
    elif entry == "ShortTimeFFT":
        from nx_signal_tpu.spectral import short_time_fft as sft_mod

        calls = _spy_matmul_dft(monkeypatch, sft_mod, "_dft_weights")
        sft = sft_mod.ShortTimeFFT(w, hop=64, fs=1.0)
        got = sft.stft(x)
        sft.fft_method = "fft"
        ref = sft.stft(x)
    else:
        from nx_signal_tpu.models.pipeline import stft_fir_chain

        calls = _spy_matmul_dft(monkeypatch, dft, "fir_framed_dft")
        t = rng.normal(size=31).astype(np.float32)
        got = stft_fir_chain(x, t, w, fft_length=256, overlap_length=192,
                             return_filtered=False)
        ref = np.abs(np_spectrum(np_fir_same(x, t), w, 64, 256, True)) ** 2
    assert bool(calls) == prefer
    assert_close_to_peak(got, ref)

