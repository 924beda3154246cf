"""STFT/ISTFT/mel tests — reference doctest golden vectors
(lib/nx_signal.ex:44-65, :384-394, :465-483, :545-579) plus scipy
round-trip checks."""

import numpy as np
import pytest

from nx_signal_tpu.ops import windows
from nx_signal_tpu.spectral import fft_frequencies, istft, mel_filters, stft, stft_to_mel
from tests.conftest import assert_all_close


class TestSTFT:
    def test_reference_doctest(self):
        # nx_signal.ex:46-65
        z, t, f = stft(
            np.arange(4), windows.rectangular(2),
            overlap_length=1, fft_length=2, sampling_rate=400,
        )
        expected_z = [[1, -1], [3, -1], [5, -1]]
        assert_all_close(z, expected_z, atol=1e-6)
        assert_all_close(t, [0.0025, 0.005, 0.0075], atol=1e-7)
        assert_all_close(f, [0.0, 200.0], atol=1e-4)

    def test_matches_manual_numpy(self, rng):
        x = rng.normal(size=1000).astype(np.float32)
        w = np.asarray(windows.hann(128))
        z, _, _ = stft(x, w, overlap_length=64, fft_length=128, sampling_rate=1000)
        hop = 64
        m = (1000 - 128) // hop + 1
        expected = np.stack(
            [np.fft.fft(x[i * hop : i * hop + 128] * w) for i in range(m)]
        )
        assert z.shape == (m, 128)
        assert_all_close(z, expected, atol=1e-3)

    def test_power_of_two_default(self):
        z, _, f = stft(np.arange(100, dtype=np.float32), windows.hann(48), sampling_rate=100)
        assert z.shape[-1] == 64  # next pow2 of 48
        assert f.shape == (64,)

    @pytest.mark.parametrize("scaling", ["spectrum", "psd"])
    def test_scaling(self, scaling, rng):
        x = rng.normal(size=256).astype(np.float32)
        w = np.asarray(windows.hann(64))
        z_none, _, _ = stft(x, w, fft_length=64, sampling_rate=100)
        z_s, _, _ = stft(x, w, fft_length=64, sampling_rate=100, scaling=scaling)
        factor = w.sum() if scaling == "spectrum" else np.sqrt(100 * (w**2).sum())
        assert_all_close(z_s * factor, z_none, atol=1e-4)

    def test_invalid_scaling(self):
        with pytest.raises(ValueError, match="invalid scaling"):
            stft(np.arange(16), windows.hann(4), scaling="bogus")

    def test_batched_channels(self, rng):
        x = rng.normal(size=(3, 256)).astype(np.float32)
        w = np.asarray(windows.hann(64))
        z, _, _ = stft(x, w, fft_length=64, sampling_rate=100)
        z0, _, _ = stft(x[0], w, fft_length=64, sampling_rate=100)
        assert z.shape == (3,) + z0.shape
        assert_all_close(z[0], z0, atol=0)


class TestISTFT:
    def test_reference_roundtrip_doctest(self):
        # nx_signal.ex:545-554: everything but the first sample reconstructs
        t = np.array([10, 10, 1, 0, 10, 10, 2, 20])
        w = np.asarray(windows.hann(4))
        z, _, _ = stft(t, w, sampling_rate=1, fft_length=4)
        result = istft(z, w, fft_length=4, sampling_rate=1)
        expected = [0, 10, 1, 0, 10, 10, 2, 20]
        np.testing.assert_array_equal(
            np.round(np.real(np.asarray(result))).astype(int), expected
        )

    @pytest.mark.parametrize("scaling", [None, "spectrum", "psd"])
    def test_roundtrip_scalings(self, scaling):
        t = np.array([10, 10, 1, 0, 10, 10, 2, 20], dtype=np.float32)
        w = np.asarray(windows.hann(4))
        z, _, _ = stft(t, w, sampling_rate=1, fft_length=4, scaling=scaling)
        result = istft(z, w, fft_length=4, sampling_rate=1, scaling=scaling)
        assert_all_close(np.real(np.asarray(result))[1:], t[1:], atol=1e-4)

    def test_long_roundtrip_interior(self, rng):
        x = rng.normal(size=4096).astype(np.float32)
        w = np.asarray(windows.hann(256))
        z, _, _ = stft(x, w, fft_length=256, sampling_rate=16000)
        y = np.real(np.asarray(istft(z, w, fft_length=256, sampling_rate=16000)))
        # interior reconstructs; edges distorted by half a window
        assert_all_close(y[128:-128], x[128 : len(y) - 128], atol=1e-3)


class TestMel:
    def test_mel_filters_reference_doctest(self):
        # nx_signal.ex:384-394
        got = mel_filters(10, 5, 8.0e3)
        expected = np.array([
            [0.0, 8.129208e-4, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 9.972017e-4, 2.1870289e-4, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 9.510892e-4, 4.1505092e-4, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 4.035892e-4, 5.276656e-4, 2.574124e-4, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 7.329034e-5, 2.3422057e-4, 3.8295105e-4, 2.871204e-4,
             1.9128979e-4, 9.545916e-5],
        ])
        assert_all_close(got, expected, atol=1e-7)

    def test_stft_to_mel_reference_doctest(self):
        # nx_signal.ex:465-483
        fft_length, sampling_rate = 16, 8.0e3
        z, _, _ = stft(
            np.arange(10), np.asarray(windows.hann(4)),
            overlap_length=2, fft_length=fft_length, sampling_rate=sampling_rate,
            window_padding="reflect",
        )
        assert z.shape == (6, 16)
        got = stft_to_mel(z, sampling_rate, fft_length=fft_length, mel_bins=4)
        expected = np.array([
            [0.29005307, 0.17422175, 0.18422472, 0.09807998],
            [0.6093881, 0.5647397, 0.43538243, 0.086352706],
            [0.75841033, 0.70850146, 0.5636921, 0.17911881],
            [0.8461772, 0.7952491, 0.64707625, 0.25204098],
            [0.9085489, 0.85726047, 0.70786566, 0.30867678],
            [0.9085489, 0.85726047, 0.70786566, 0.30867678],
        ])
        assert_all_close(got, expected, atol=1e-5)


def test_fft_frequencies():
    # nx_signal.ex:147-151
    got = fft_frequencies(1.6e4, fft_length=10)
    assert_all_close(got, np.arange(10) * 1.6e3, atol=1e-3)


class TestSTFTMethods:
    """The fused matmul framed-DFT path must agree with the FFT path."""

    def test_matmul_vs_fft(self, rng):
        import numpy as np
        from nx_signal_tpu.ops import windows as W

        x = rng.normal(size=(2, 2000)).astype(np.float32)
        w = np.asarray(W.hann(128))
        zm, tm, fm = stft(x, w, sampling_rate=1000, fft_length=128,
                          overlap_length=96, method="matmul")
        zf, tf, ff = stft(x, w, sampling_rate=1000, fft_length=128,
                          overlap_length=96, method="fft")
        assert zm.shape == zf.shape
        scale = np.abs(np.asarray(zf)).max()
        np.testing.assert_allclose(np.asarray(zm), np.asarray(zf),
                                   atol=1e-5 * scale)
        np.testing.assert_array_equal(np.asarray(tm), np.asarray(tf))
        np.testing.assert_array_equal(np.asarray(fm), np.asarray(ff))

    def test_matmul_zero_padded_fft_length(self, rng):
        import numpy as np
        from nx_signal_tpu.ops import windows as W

        x = rng.normal(size=500).astype(np.float32)
        w = np.asarray(W.hann(100))
        zm, _, _ = stft(x, w, sampling_rate=1000, method="matmul")  # nfft 128
        zf, _, _ = stft(x, w, sampling_rate=1000, method="fft")
        assert zm.shape == zf.shape == (np.asarray(zf).shape[0], 128)
        scale = np.abs(np.asarray(zf)).max()
        np.testing.assert_allclose(np.asarray(zm), np.asarray(zf),
                                   atol=1e-5 * scale)

    def test_onesided_is_half_spectrum(self, rng):
        import numpy as np
        from nx_signal_tpu.ops import windows as W

        x = rng.normal(size=1024).astype(np.float32)
        w = np.asarray(W.hann(64))
        z1, _, f1 = stft(x, w, sampling_rate=100, fft_length=64, onesided=True)
        z2, _, f2 = stft(x, w, sampling_rate=100, fft_length=64)
        assert z1.shape[-1] == 33 and f1.shape == (33,)
        scale = np.abs(np.asarray(z2)).max()
        np.testing.assert_allclose(np.asarray(z1), np.asarray(z2)[..., :33],
                                   atol=1e-5 * scale)

    def test_reflect_padding_matmul(self, rng):
        import numpy as np
        from nx_signal_tpu.ops import windows as W

        x = rng.normal(size=300).astype(np.float32)
        w = np.asarray(W.hann(64))
        zm, _, _ = stft(x, w, sampling_rate=100, fft_length=64,
                        window_padding="reflect", method="matmul")
        zf, _, _ = stft(x, w, sampling_rate=100, fft_length=64,
                        window_padding="reflect", method="fft")
        scale = np.abs(np.asarray(zf)).max()
        np.testing.assert_allclose(np.asarray(zm), np.asarray(zf),
                                   atol=1e-5 * scale)

    def test_complex_input_falls_back(self, rng):
        import numpy as np
        from nx_signal_tpu.ops import windows as W

        x = (rng.normal(size=512) + 1j * rng.normal(size=512)).astype(np.complex64)
        w = np.asarray(W.hann(64))
        z, _, _ = stft(x, w, sampling_rate=100, fft_length=64)  # auto -> fft
        assert z.shape[-1] == 64
        import pytest
        with pytest.raises(ValueError, match="requires real input"):
            stft(x, w, sampling_rate=100, fft_length=64, method="matmul")

    def test_invalid_method(self):
        import numpy as np
        import pytest
        from nx_signal_tpu.ops import windows as W

        with pytest.raises(ValueError, match="invalid method"):
            stft(np.arange(64.0), np.asarray(W.hann(16)), method="bogus")

    def test_window_built_inside_jit(self, rng):
        # the DFT weight matrices normally build host-side from a concrete
        # window; a window constructed INSIDE an enclosing jit is a tracer
        # and must take the staged (constant-folded) build instead
        import jax
        import numpy as np
        from nx_signal_tpu.kernels.dft import fir_framed_dft
        from nx_signal_tpu.ops import windows as W
        from nx_signal_tpu.spectral import istft

        x = rng.normal(size=2000).astype(np.float32)
        taps = rng.normal(size=31).astype(np.float32)

        @jax.jit
        def roundtrip(x, taps):
            w = W.hann(128)  # traced under jit
            z, _, _ = stft(x, w, sampling_rate=1000, fft_length=128,
                           overlap_length=96, method="matmul")
            zf = fir_framed_dft(x, taps, w, stride=32, n_fft=128)
            return istft(z, w, overlap_length=96, method="matmul"), zf

        r_jit, zf_jit = roundtrip(x, taps)
        w = np.asarray(W.hann(128))
        z, _, _ = stft(x, w, sampling_rate=1000, fft_length=128,
                       overlap_length=96, method="matmul")
        r = istft(z, w, overlap_length=96, method="matmul")
        zf = fir_framed_dft(x, taps, w, stride=32, n_fft=128)
        r_jit, r = np.asarray(r_jit), np.asarray(r)
        scale = np.abs(r).max()
        # edge samples divide by a tiny NOLA envelope, amplifying the
        # f32-vs-f64 weight-build rounding; interior is tight
        np.testing.assert_allclose(r_jit[128:-128], r[128:-128],
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(r_jit, r, atol=1e-3 * scale)
        np.testing.assert_allclose(np.asarray(zf_jit), np.asarray(zf),
                                   atol=1e-4 * np.abs(np.asarray(zf)).max())

    def test_frame_chunked_power(self, rng):
        # frame_chunks splits the fused power path into sequential
        # conv+power chunks written in place (bounds the conv
        # intermediate's peak memory); results must match the unchunked path to
        # f32 association (per-frame contractions are identical)
        import numpy as np
        from nx_signal_tpu.kernels.dft import fir_framed_dft
        from nx_signal_tpu.models.pipeline import stft_fir_chain

        x = rng.normal(size=(3, 7000)).astype(np.float32)
        taps = rng.normal(size=63).astype(np.float32)
        w = np.hanning(256).astype(np.float32)
        ref = np.asarray(fir_framed_dft(
            x, taps, w, stride=64, n_fft=256, onesided=True, output="power"))
        scale = np.abs(ref).max()
        for k in (2, 3, 7, 100):
            got = np.asarray(fir_framed_dft(
                x, taps, w, stride=64, n_fft=256, onesided=True,
                output="power", frame_chunks=k))
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, atol=1e-6 * scale)
        chained = np.asarray(stft_fir_chain(
            x, taps, w, fft_length=256, overlap_length=192,
            return_filtered=False, frame_chunks=4))
        np.testing.assert_allclose(chained, ref, atol=1e-6 * scale)
        # 'auto' picks 1 for small inputs (no chunk overhead) and a
        # footprint-bounding count when the intermediate would not fit
        from nx_signal_tpu.kernels import dft as K
        assert K._auto_frame_chunks(3, 105, 514, x.size) == 1
        assert K._auto_frame_chunks(768, 3744, 514, 768 * 480000) == 1
        assert K._auto_frame_chunks(1024, 3744, 514, 1024 * 480000) > 1
        # edge='conv': copy-free edges via conv spatial padding — must
        # match the padded-copy path (exact zero-term contraction)
        x_al = rng.normal(size=(3, 7040)).astype(np.float32)  # hop | length
        taps255 = rng.normal(size=255).astype(np.float32)
        w512 = np.hanning(512).astype(np.float32)
        ref_al = np.asarray(fir_framed_dft(
            x_al, taps255, w512, stride=128, n_fft=512, onesided=True,
            output="power"))
        nopad = np.asarray(fir_framed_dft(
            x_al, taps255, w512, stride=128, n_fft=512, onesided=True,
            output="power", edge="conv"))
        np.testing.assert_allclose(nopad, ref_al,
                                   atol=1e-6 * np.abs(ref_al).max())
        auto = np.asarray(fir_framed_dft(
            x, taps, w, stride=64, n_fft=256, onesided=True,
            output="power", frame_chunks="auto"))
        np.testing.assert_allclose(auto, ref, atol=1e-6 * scale)

    def test_precision_kwarg(self, rng):
        # 'high'/'default' may reduce precision on an accelerator; on CPU all
        # three run full-f32 matmuls, so gate loosely and mainly check the
        # knob plumbs through stft/istft end to end
        import numpy as np
        from nx_signal_tpu.ops import windows as W
        from nx_signal_tpu.spectral import istft

        x = rng.normal(size=2000).astype(np.float32)
        w = np.asarray(W.hann(128))
        z_hi, _, _ = stft(x, w, sampling_rate=1000, fft_length=128,
                          overlap_length=96, method="matmul")
        z_fast, _, _ = stft(x, w, sampling_rate=1000, fft_length=128,
                            overlap_length=96, method="matmul",
                            precision="high")
        scale = np.abs(np.asarray(z_hi)).max()
        np.testing.assert_allclose(np.asarray(z_fast), np.asarray(z_hi),
                                   atol=1e-3 * scale)
        r_hi = istft(z_hi, w, overlap_length=96, method="matmul")
        r_fast = istft(z_hi, w, overlap_length=96, method="matmul",
                       precision="high")
        np.testing.assert_allclose(np.asarray(r_fast), np.asarray(r_hi),
                                   atol=1e-3 * np.abs(np.asarray(r_hi)).max())


class TestSharedBlockDFT:
    """fir_framed_dft_shared: the shared hop-block partial-DFT strategy
    must equal the dense fir_framed_dft/framed_dft to f32 association
    (kernels/dft.py; its speed on the H100 is not measured yet)."""

    @pytest.fixture
    def rng(self):
        return np.random.default_rng(11)

    @pytest.mark.parametrize("onesided", [True, False])
    @pytest.mark.parametrize("output", ["complex", "power"])
    def test_matches_dense_fir_path(self, rng, onesided, output):
        from nx_signal_tpu.kernels.dft import (
            fir_framed_dft,
            fir_framed_dft_shared,
        )

        x = rng.normal(size=(2, 2048)).astype(np.float32)
        taps = rng.normal(size=63).astype(np.float32)
        w = np.asarray(windows.hann(256))
        dense = np.asarray(fir_framed_dft(
            x, taps, w, stride=64, n_fft=256, onesided=onesided,
            output=output))
        shared = np.asarray(fir_framed_dft_shared(
            x, taps, stride=64, n_fft=256, window_coeffs=(0.5, -0.5),
            onesided=onesided, output=output))
        scale = np.abs(dense).max()
        np.testing.assert_allclose(shared, dense, atol=1e-5 * scale,
                                   rtol=1e-5)

    @pytest.mark.parametrize("name,coeffs", [
        ("hann", (0.5, -0.5)),
        ("hamming", (0.54, -0.46)),
        ("blackman", (0.42, -0.5, 0.08)),
    ])
    def test_no_fir_and_window_families(self, rng, name, coeffs):
        from nx_signal_tpu.kernels.dft import (
            fir_framed_dft_shared,
            framed_dft,
            recognize_cosine_window,
        )

        w = np.asarray(getattr(windows, name)(128))
        assert recognize_cosine_window(w, 128) == pytest.approx(coeffs)
        x = rng.normal(size=1024).astype(np.float32)
        dense = np.asarray(framed_dft(x, w, stride=32, n_fft=128,
                                      onesided=True))
        shared = np.asarray(fir_framed_dft_shared(
            x, None, stride=32, n_fft=128, window_coeffs=coeffs,
            onesided=True))
        scale = np.abs(dense).max()
        np.testing.assert_allclose(shared, dense, atol=1e-5 * scale,
                                   rtol=1e-5)

    def test_recognize_rejects_non_cosine(self):
        from nx_signal_tpu.kernels.dft import recognize_cosine_window

        assert recognize_cosine_window(np.asarray(windows.kaiser(64)), 64) \
            is None
        # symmetric (non-periodic) hann is not a period-n cosine sum
        assert recognize_cosine_window(
            np.asarray(windows.hann(64, periodic=False)), 64) is None

    def test_validation(self, rng):
        from nx_signal_tpu.kernels.dft import fir_framed_dft_shared

        x = rng.normal(size=512).astype(np.float32)
        with pytest.raises(ValueError, match="stride"):
            fir_framed_dft_shared(x, None, stride=48, n_fft=128,
                                  window_coeffs=(0.5, -0.5))
        with pytest.raises(ValueError, match="even"):
            fir_framed_dft_shared(x, None, stride=45, n_fft=135,
                                  window_coeffs=(0.5, -0.5), onesided=True)


class TestISTFTMethods:
    """The fused iDFT+window matmul path must agree with the IFFT path, and
    onesided round-trips must reconstruct."""

    def test_matmul_vs_fft(self, rng):
        z = (rng.normal(size=(3, 40, 256)) + 1j * rng.normal(size=(3, 40, 256))
             ).astype(np.complex64)
        w = np.asarray(windows.hann(256))
        ym = istft(z, w, fft_length=256, overlap_length=128, method="matmul")
        yf = istft(z, w, fft_length=256, overlap_length=128, method="fft")
        scale = np.abs(np.asarray(yf)).max()
        np.testing.assert_allclose(np.asarray(ym), np.asarray(yf), atol=1e-5 * scale)

    @pytest.mark.parametrize("method", ["matmul", "fft"])
    def test_onesided_roundtrip(self, method, rng):
        x = rng.normal(size=2048).astype(np.float32)
        w = np.asarray(windows.hann(256))
        z, _, _ = stft(x, w, sampling_rate=100, fft_length=256,
                       overlap_length=192, onesided=True)
        assert z.shape[-1] == 129
        y = istft(z, w, fft_length=256, overlap_length=192, method=method,
                  onesided=True)
        assert not np.iscomplexobj(np.asarray(y))  # onesided reconstructs real
        y = np.asarray(y)
        np.testing.assert_allclose(y[256:-256], x[256 : len(y) - 256], atol=1e-3)

    def test_onesided_infers_fft_length(self, rng):
        z = (rng.normal(size=(10, 129)) + 1j * rng.normal(size=(10, 129))
             ).astype(np.complex64)
        w = np.asarray(windows.hann(256))
        y = istft(z, w, overlap_length=128)  # bins=129 -> n_fft=256... needs onesided
        # without onesided flag, bins=129 -> pow2 fft_length 256 and complex out
        assert np.asarray(y).ndim == 1
        y2 = istft(z, w, overlap_length=128, onesided=True)
        assert not np.iscomplexobj(np.asarray(y2))

    @pytest.mark.parametrize("scaling", [None, "spectrum", "psd"])
    def test_matmul_scaling_roundtrip(self, scaling):
        t = np.array([10, 10, 1, 0, 10, 10, 2, 20], dtype=np.float32)
        w = np.asarray(windows.hann(4))
        z, _, _ = stft(t, w, sampling_rate=1, fft_length=4, scaling=scaling)
        y = istft(z, w, fft_length=4, sampling_rate=1, scaling=scaling,
                  method="matmul")
        assert_all_close(np.real(np.asarray(y))[1:], t[1:], atol=1e-4)


class TestRoundtripSNR:
    """BASELINE config 3: STFT->ISTFT perfect-reconstruction SNR bound on
    long stereo audio (downscaled from 60 s to 10 s for CPU test time)."""

    def test_stereo_snr(self, rng):
        fs = 44100
        t = np.arange(10 * fs) / fs
        left = np.sin(2 * np.pi * 440 * t) + 0.3 * rng.normal(size=t.size)
        right = np.sin(2 * np.pi * 523.25 * t) + 0.3 * rng.normal(size=t.size)
        x = np.stack([left, right]).astype(np.float32)
        w = np.asarray(windows.hann(2048))
        z, _, _ = stft(x, w, sampling_rate=fs, fft_length=2048,
                       overlap_length=1536, onesided=True)
        y = np.asarray(istft(z, w, fft_length=2048, overlap_length=1536,
                             onesided=True))
        n = y.shape[1]
        sig = x[:, 2048 : n - 2048]
        err = y[:, 2048 : n - 2048] - sig
        snr_db = 10 * np.log10((sig**2).sum() / (err**2).sum())
        assert snr_db > 100.0, f"round-trip SNR {snr_db:.1f} dB"


def test_hbm_budget_is_device_aware(monkeypatch):
    """`frame_chunks='auto'` plans against the DEVICE's reported memory
    times the stated margin: on a 32 GB device the 1024-channel chain fits
    dense; on an 8 GB one it chunks harder than on 16 GB; with no memory
    stats (the CPU) it plans against the fixed no-stats budget."""
    from nx_signal_tpu.kernels import dft as K

    class _FakeDev:
        def __init__(self, limit):
            self._limit = limit

        def memory_stats(self):
            return {"bytes_limit": self._limit} if self._limit else None

    def fake_devices(limit):
        monkeypatch.setattr(K.jax, "local_devices",
                            lambda: [_FakeDev(limit)])

    gib = 1024 ** 3
    fake_devices(32 * gib)
    assert K._hbm_budget() == 32 * gib * K._DEVICE_MEMORY_MARGIN
    # 1024ch x 10 s @ 48 kHz (~15.8 GiB modeled dense): chunks on 16 GB,
    # dense on 32 GB
    assert K._auto_frame_chunks(1024, 3744, 514, 1024 * 480000) == 1
    fake_devices(16 * gib)
    chunks_16 = K._auto_frame_chunks(1024, 3744, 514, 1024 * 480000)
    assert chunks_16 > 1
    fake_devices(8 * gib)
    assert K._auto_frame_chunks(1024, 3744, 514, 1024 * 480000) > chunks_16
    fake_devices(None)  # no stats (CPU) -> fixed planning budget
    assert K._hbm_budget() == K._NO_STATS_BUDGET
