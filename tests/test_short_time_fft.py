"""scipy-oracle tests for spectral/short_time_fft.py (ShortTimeFFT)."""

import numpy as np
import pytest
import scipy.signal as sps

from nx_signal_tpu.spectral.short_time_fft import (
    ShortTimeFFT,
    closest_STFT_dual_window,
)

RNG_SEED = 0


def _pair(win, hop, fs, **kw):
    return ShortTimeFFT(win, hop=hop, fs=fs, **kw), \
        sps.ShortTimeFFT(win, hop=hop, fs=fs, **kw)


PROPS = ("m_num", "m_num_mid", "mfft", "p_min", "k_min", "f_pts",
         "delta_t", "delta_f", "T", "onesided_fft", "invertible")


def _check_all(ours, ref, n, x=None, stft_atol=1e-10, **stft_kw):
    x = np.random.default_rng(RNG_SEED).normal(size=n) if x is None else x
    for prop in PROPS:
        assert np.allclose(getattr(ours, prop), getattr(ref, prop)), prop
    assert ours.p_max(n) == ref.p_max(n)
    assert ours.k_max(n) == ref.k_max(n)
    assert ours.lower_border_end == ref.lower_border_end
    assert ours.upper_border_begin(n) == ref.upper_border_begin(n)
    np.testing.assert_allclose(ours.f, ref.f, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ours.dual_win), ref.dual_win,
                               atol=1e-12)
    np.testing.assert_allclose(ours.t(n), ref.t(n), atol=1e-12)
    s1 = np.asarray(ours.stft(x, **stft_kw))
    s2 = ref.stft(x, **stft_kw)
    np.testing.assert_allclose(s1, s2, atol=stft_atol)
    x1 = np.asarray(ours.istft(s1, k1=n))
    x2 = ref.istft(s2, k1=n)
    np.testing.assert_allclose(x1, x2, atol=1e-9)
    want = x if np.isrealobj(x1) else x.astype(complex)
    np.testing.assert_allclose(x1, want, atol=1e-8)  # perfect reconstruction


class TestParity:
    def test_hann_onesided(self):
        _check_all(*_pair(np.hanning(8), 3, 10.0), n=50)

    def test_gaussian_twosided(self):
        w = sps.windows.gaussian(17, std=4, sym=True)
        _check_all(*_pair(w, 5, 1.0, fft_mode="twosided"), n=77)

    def test_centered_with_mfft(self):
        w = sps.windows.gaussian(17, std=4, sym=True)
        _check_all(*_pair(w, 4, 2.0, fft_mode="centered", mfft=32), n=64)

    @pytest.mark.parametrize("scaling", ["magnitude", "psd"])
    def test_onesided2X_scaled(self, scaling):
        w = sps.windows.gaussian(17, std=4, sym=True)
        _check_all(*_pair(w, 4, 2.0, scale_to=scaling,
                          fft_mode="onesided2X"), n=64)

    @pytest.mark.parametrize("phase_shift", [None, 2, -3])
    def test_phase_shift(self, phase_shift):
        _check_all(*_pair(np.hanning(8), 3, 10.0, phase_shift=phase_shift),
                   n=45)

    def test_complex_twosided_and_istft_subrange(self):
        rng = np.random.default_rng(1)
        zc = rng.normal(size=60) + 1j * rng.normal(size=60)
        w = sps.windows.gaussian(17, std=4, sym=True)
        ours, ref = _pair(w, 3, 4.0, fft_mode="twosided")
        s1, s2 = np.asarray(ours.stft(zc)), ref.stft(zc)
        np.testing.assert_allclose(s1, s2, atol=1e-10)
        np.testing.assert_allclose(np.asarray(ours.istft(s1, k0=10, k1=50)),
                                   ref.istft(s2, k0=10, k1=50), atol=1e-9)


class TestPaddingAxesExtras:
    def setup_method(self):
        self.x = np.random.default_rng(2).normal(size=(3, 60))
        self.ours, self.ref = _pair(np.hanning(8), 3, 10.0)

    @pytest.mark.parametrize("padding", ["zeros", "edge", "even", "odd"])
    def test_padding_modes(self, padding):
        np.testing.assert_allclose(
            np.asarray(self.ours.stft(self.x, padding=padding)),
            self.ref.stft(self.x, padding=padding), atol=1e-10)

    def test_axis_handling(self):
        np.testing.assert_allclose(np.asarray(self.ours.stft(self.x.T, axis=0)),
                                   self.ref.stft(self.x.T, axis=0), atol=1e-10)

    def test_spectrogram_and_detrend(self):
        np.testing.assert_allclose(np.asarray(self.ours.spectrogram(self.x[0])),
                                   self.ref.spectrogram(self.x[0]), atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(self.ours.stft_detrend(self.x[0], "linear")),
            self.ref.stft_detrend(self.x[0], "linear"), atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(self.ours.spectrogram(self.x[0], self.x[1])),
            self.ref.spectrogram(self.x[0], self.x[1]), atol=1e-10)

    def test_p_slice_range(self):
        s1 = np.asarray(self.ours.stft(self.x[0], p0=2, p1=10))
        s2 = self.ref.stft(self.x[0], p0=2, p1=10)
        np.testing.assert_allclose(s1, s2, atol=1e-10)


class TestConstructors:
    def test_from_window(self):
        ours = ShortTimeFFT.from_window(("kaiser", 5.0), 100.0, 16, 12)
        ref = sps.ShortTimeFFT.from_window(("kaiser", 5.0), 100.0, 16, 12)
        # our kaiser evaluates some intermediates in f32 (repo-wide window
        # convention; the reference gates kaiser at 1e-3)
        np.testing.assert_allclose(np.asarray(ours.win), ref.win, atol=1e-6)
        assert ours.hop == ref.hop and ours.fs == ref.fs

    def test_from_dual(self):
        w = sps.windows.gaussian(17, std=4, sym=True)
        ours = ShortTimeFFT.from_dual(w, 5, 1.0)
        ref = sps.ShortTimeFFT.from_dual(w, 5, 1.0)
        np.testing.assert_allclose(np.asarray(ours.win), ref.win, atol=1e-12)
        np.testing.assert_allclose(np.asarray(ours.dual_win), w, atol=1e-12)

    def test_extent(self):
        w = sps.windows.gaussian(17, std=4, sym=True)
        ours, ref = _pair(w, 5, 1.0)
        assert ours.extent(50) == ref.extent(50)
        assert ours.extent(50, "ft", True) == ref.extent(50, "ft", True)


class TestValidation:
    def test_bad_args(self):
        with pytest.raises(ValueError):
            ShortTimeFFT(np.hanning(8), hop=0, fs=1.0)
        with pytest.raises(ValueError):
            ShortTimeFFT(np.hanning(8), hop=3, fs=1.0, fft_mode="bogus")
        with pytest.raises(ValueError):
            ShortTimeFFT(np.hanning(8), hop=3, fs=1.0, mfft=4)
        with pytest.raises(ValueError):
            ShortTimeFFT(np.hanning(8), hop=3, fs=1.0,
                         fft_mode="onesided2X")  # needs scaling
        st = ShortTimeFFT(np.hanning(8), hop=3, fs=1.0)
        with pytest.raises(ValueError):
            st.stft(np.zeros(50) + 1j)  # complex input, onesided
        with pytest.raises(ValueError):
            st.p_range(50, -5, 3)
        with pytest.raises(ValueError):
            st.scale_to("bogus")
        with pytest.raises(ValueError, match="invertible"):
            ShortTimeFFT(np.hanning(8), hop=9, fs=1.0).dual_win

    def test_non_invertible_flag(self):
        st = ShortTimeFFT(np.hanning(8), hop=9, fs=1.0)
        assert not st.invertible


class TestClosestDualWindow:
    """closest_STFT_dual_window vs scipy at machine precision."""

    def _cmp(self, w, hop, g=None, scaled=True):
        d1, a1 = sps.closest_STFT_dual_window(w, hop, g, scaled=scaled)
        d2, a2 = closest_STFT_dual_window(w, hop, g, scaled=scaled)
        np.testing.assert_allclose(a2, a1, atol=1e-12)
        np.testing.assert_allclose(d2, d1, atol=1e-12)

    def test_rect_dual_scaled_and_not(self):
        w = sps.windows.hann(32, sym=False)
        self._cmp(w, 8)
        self._cmp(w, 8, scaled=False)
        self._cmp(w, 5)

    def test_desired_dual(self):
        rng = np.random.default_rng(3)
        w = sps.windows.kaiser(33, 10.0)
        g = rng.standard_normal(33)
        self._cmp(w, 16, g)
        self._cmp(w, 16, g, scaled=False)

    def test_complex(self):
        rng = np.random.default_rng(4)
        w = sps.windows.hann(24, sym=False) * np.exp(
            1j * rng.standard_normal(24))
        g = rng.standard_normal(24) + 1j * rng.standard_normal(24)
        self._cmp(w, 6)
        self._cmp(w, 6, g)
        self._cmp(w, 6, g, scaled=False)

    def test_cola_detection(self):
        # a COLA (win, hop) pair has a constant dual: rect desired is exact
        w = sps.windows.hann(32, sym=False)
        d, alpha = closest_STFT_dual_window(w, 16)  # hann hop n/2 is COLA
        np.testing.assert_allclose(d, np.full(32, np.real(alpha)), atol=1e-12)

    def test_invalid(self):
        with pytest.raises(ValueError):
            closest_STFT_dual_window(np.zeros(16), 4)
        with pytest.raises(ValueError):
            closest_STFT_dual_window(sps.windows.hann(16), 0)
        with pytest.raises(ValueError):
            closest_STFT_dual_window(sps.windows.hann(16), 4,
                                     np.ones(8))


class TestFromWinEqualsDual:
    """from_win_equals_dual vs scipy: per-residue-class normalization plus
    all four scale_to modes (incl. 'unitary', constructor-only in scipy)."""

    @pytest.mark.parametrize("scale_to", [None, "magnitude", "psd",
                                          "unitary"])
    def test_parity(self, scale_to):
        g = sps.windows.hann(32, sym=False)
        ours = ShortTimeFFT.from_win_equals_dual(g, 8, fs=100.0,
                                                 scale_to=scale_to)
        ref = sps.ShortTimeFFT.from_win_equals_dual(g, 8, fs=100.0,
                                                    scale_to=scale_to)
        np.testing.assert_allclose(ours.win, ref.win, atol=1e-12)
        np.testing.assert_allclose(ours.dual_win, ref.dual_win, atol=1e-10)

    def test_self_dual_roundtrip(self):
        g = sps.windows.kaiser(48, 8.0)
        S = ShortTimeFFT.from_win_equals_dual(g, 12, fs=50.0)
        np.testing.assert_allclose(S.dual_win, S.win, atol=1e-12)
        x = np.random.default_rng(5).normal(size=400)
        rec = np.asarray(S.istft(S.stft(x), k1=400))
        np.testing.assert_allclose(rec, x, atol=1e-5)

    def test_invalid(self):
        with pytest.raises(ValueError):
            ShortTimeFFT.from_win_equals_dual(
                np.concatenate([np.zeros(8), sps.windows.hann(8)]), 12,
                fs=1.0)


class TestMatmulForwardPath:
    """fft_method='matmul' (the matmul DFT) must match the FFT path
    and scipy for both onesided modes, including the istft round trip."""

    @pytest.mark.parametrize("fft_mode", ["onesided", "onesided2X"])
    def test_parity(self, fft_mode):
        x = np.random.default_rng(9).normal(size=500)
        g = sps.windows.hann(64, sym=False)
        kw = dict(fft_mode=fft_mode)
        if fft_mode == "onesided2X":
            kw["scale_to"] = "psd"
        ours = ShortTimeFFT(g, hop=16, fs=100.0, **kw)
        ours.fft_method = "matmul"
        ref = sps.ShortTimeFFT(g, hop=16, fs=100.0, **kw)
        np.testing.assert_allclose(np.asarray(ours.stft(x)), ref.stft(x),
                                   atol=1e-10)

    def test_roundtrip(self):
        x = np.random.default_rng(10).normal(size=400)
        S = ShortTimeFFT(sps.windows.hann(48, sym=False), hop=12, fs=50.0)
        S.fft_method = "matmul"
        rec = np.asarray(S.istft(S.stft(x), k1=400))
        np.testing.assert_allclose(rec, x, atol=1e-10)
