"""Fourier resample / decimate / detrend tests — scipy.signal oracle.
All three are new relative to the reference (nx_signal has no resampling
or detrend; SURVEY.md §2)."""

import numpy as np
import pytest
import scipy.signal as sps

import jax

from nx_signal_tpu.ops.filters import detrend
from nx_signal_tpu.ops.resample import decimate, resample
from tests.conftest import assert_all_close


class TestResampleFourier:
    @pytest.mark.parametrize("num", [37, 50, 64, 99, 100, 101, 150, 200])
    def test_real_parity(self, num, rng):
        x = rng.normal(size=(3, 100))
        assert_all_close(resample(x, num), sps.resample(x, num, axis=-1),
                         atol=1e-12, rtol=1e-10)

    @pytest.mark.parametrize("n_in,num", [(99, 44), (99, 150), (64, 32)])
    def test_lengths(self, n_in, num, rng):
        x = rng.normal(size=n_in)
        assert_all_close(resample(x, num), sps.resample(x, num),
                         atol=1e-12, rtol=1e-10)

    def test_complex(self, rng):
        x = rng.normal(size=100) + 1j * rng.normal(size=100)
        got = resample(x, 63)
        assert np.iscomplexobj(np.asarray(got))
        assert_all_close(got, sps.resample(x, 63), atol=1e-12, rtol=1e-10)

    def test_window_spec(self, rng):
        x = rng.normal(size=(2, 100))
        assert_all_close(
            resample(x, 50, window="hamming"),
            sps.resample(x, 50, axis=-1, window="hamming"),
            atol=1e-12, rtol=1e-10,
        )

    def test_window_array_fft_order(self, rng):
        x = rng.normal(size=(2, 100))
        w = (np.abs(np.fft.fftfreq(100)) < 0.3).astype(np.float64)
        assert_all_close(
            resample(x, 50, window=w),
            sps.resample(x, 50, axis=-1, window=w),
            atol=1e-12, rtol=1e-10,
        )

    def test_axis(self, rng):
        x = rng.normal(size=(4, 80, 3))
        assert_all_close(resample(x, 40, axis=1), sps.resample(x, 40, axis=1),
                         atol=1e-12, rtol=1e-10)

    def test_tone_preserved(self):
        # band-limited tone resamples exactly (periodic assumption holds)
        t = np.arange(128) / 128.0
        x = np.sin(2 * np.pi * 5 * t)
        y = np.asarray(resample(x, 256))
        t2 = np.arange(256) / 256.0
        assert_all_close(y, np.sin(2 * np.pi * 5 * t2), atol=1e-7, rtol=1e-6)

    def test_validation(self):
        with pytest.raises(ValueError, match="positive"):
            resample(np.zeros(10), 0)
        with pytest.raises(ValueError, match="length"):
            resample(np.zeros(10), 5, window=np.ones(7))

    def test_jit(self, rng):
        x = rng.normal(size=(2, 100))
        got = jax.jit(lambda s: resample(s, 50))(x)
        assert_all_close(got, sps.resample(x, 50, axis=-1), atol=1e-10, rtol=1e-8)


class TestDecimate:
    @pytest.mark.parametrize("q", [2, 4, 5, 8])
    def test_iir_parity(self, q, rng):
        x = rng.normal(size=(2, 500))
        assert_all_close(decimate(x, q), sps.decimate(x, q), atol=1e-8, rtol=1e-6)

    def test_iir_no_zero_phase(self, rng):
        x = rng.normal(size=400)
        assert_all_close(decimate(x, 4, zero_phase=False),
                         sps.decimate(x, 4, zero_phase=False),
                         atol=1e-10, rtol=1e-8)

    @pytest.mark.parametrize("zero_phase", [True, False])
    def test_fir_parity(self, zero_phase, rng):
        # firwin design runs in f32 (DEFAULT_FLOAT) -> 1e-5 gate, matching
        # the repo-wide firwin tolerance
        x = rng.normal(size=(2, 500))
        assert_all_close(
            decimate(x, 3, ftype="fir", zero_phase=zero_phase),
            sps.decimate(x, 3, ftype="fir", zero_phase=zero_phase),
            atol=1e-5, rtol=1e-5,
        )

    def test_sos_extension_matches_iir_semantics(self, rng):
        # ftype='sos' (an extension): same anti-alias filter as
        # cascaded biquads; must match scipy's ba-form result
        x = rng.normal(size=(2, 500))
        assert_all_close(decimate(x, 4, ftype="sos"), sps.decimate(x, 4),
                         atol=1e-10, rtol=1e-8)

    def test_axis(self, rng):
        x = rng.normal(size=(300, 3))
        assert_all_close(decimate(x, 3, axis=0), sps.decimate(x, 3, axis=0),
                         atol=1e-8, rtol=1e-6)

    def test_validation(self):
        with pytest.raises(ValueError, match="positive"):
            decimate(np.zeros(10), 0)
        with pytest.raises(ValueError, match="ftype"):
            decimate(np.zeros(100), 2, ftype="nope")


class TestDetrend:
    def test_linear(self, rng):
        t = np.arange(100.0)
        x = 3.0 + 0.5 * t + rng.normal(size=(4, 100))
        assert_all_close(detrend(x), sps.detrend(x), atol=1e-10, rtol=1e-8)

    def test_constant(self, rng):
        x = 7.0 + rng.normal(size=(4, 100))
        assert_all_close(detrend(x, type="constant"),
                         sps.detrend(x, type="constant"), atol=1e-12, rtol=1e-10)

    def test_axis(self, rng):
        x = rng.normal(size=(50, 4)) + np.arange(50.0)[:, None]
        assert_all_close(detrend(x, axis=0), sps.detrend(x, axis=0),
                         atol=1e-10, rtol=1e-8)

    def test_int_input_promoted(self):
        x = np.arange(10)
        got = np.asarray(detrend(x))
        assert got.dtype.kind == "f"
        assert_all_close(got, sps.detrend(x.astype(np.float32)), atol=1e-5)

    def test_validation(self):
        with pytest.raises(ValueError, match="type"):
            detrend(np.zeros(10), type="quadratic")

    def test_jit(self, rng):
        x = rng.normal(size=(2, 64)) + np.arange(64.0)
        got = jax.jit(detrend)(x)
        assert_all_close(got, sps.detrend(x), atol=1e-10, rtol=1e-8)
