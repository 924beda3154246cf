"""Resampling tests: scipy.signal.upfirdn / resample_poly are the oracle;
the PFB channelizer is validated by tone-isolation SNR."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps

from nx_signal_tpu.ops.resample import pfb_analyze, resample_poly, upfirdn
from tests.conftest import assert_all_close


class TestUpfirdn:
    @pytest.mark.parametrize("up,down", [
        (1, 1), (1, 3), (3, 1), (2, 3), (3, 2), (7, 5), (160, 147), (1, 13),
    ])
    @pytest.mark.parametrize("n,k", [(50, 11), (128, 31), (13, 40)])
    def test_vs_scipy(self, up, down, n, k, rng):
        x = rng.normal(size=n)
        h = rng.normal(size=k)
        got = upfirdn(h, x, up, down)
        expected = sps.upfirdn(h, x, up, down)
        assert got.shape == expected.shape
        assert_all_close(got, expected, atol=1e-8)

    def test_batched(self, rng):
        x = rng.normal(size=(3, 64))
        h = rng.normal(size=9)
        got = upfirdn(h, x, 2, 3)
        expected = np.stack([sps.upfirdn(h, row, 2, 3) for row in x])
        assert_all_close(got, expected, atol=1e-8)

    def test_identity(self):
        x = np.arange(10.0)
        got = upfirdn(np.array([1.0]), x, 1, 1)
        np.testing.assert_allclose(np.asarray(got), x)

    def test_complex(self, rng):
        x = rng.normal(size=40) + 1j * rng.normal(size=40)
        h = rng.normal(size=7)
        assert_all_close(upfirdn(h, x, 2, 5), sps.upfirdn(h, x, 2, 5), atol=1e-8)

    def test_validations(self):
        with pytest.raises(ValueError, match="must be 1-D"):
            upfirdn(np.ones((2, 2)), np.ones(4))
        with pytest.raises(ValueError, match=">= 1"):
            upfirdn(np.ones(3), np.ones(4), up=0)

    @pytest.mark.parametrize("up,down,n,k", [
        (1, 3, 10000, 61),    # BASELINE decimation: multi-tile + partial
        (2, 3, 9999, 63),     # rational, odd length
        (1, 1, 3000, 31),     # pure FIR through the tile path
        (7, 5, 4000, 35),     # coprime, r_tile = 133
        (1, 1000, 5000, 21),  # huge down: banded-weight FALLBACK to R=up
        (160, 1, 500, 320),   # up > 128: tile degenerates to R=up
        (2, 3, 5, 9),         # n_count < up (single partial frame)
    ])
    def test_lane_tile_geometry_vs_scipy(self, up, down, n, k, rng):
        # the lane-filling output tile (R ~ 128 outputs per frame row)
        # across its geometry edge cases: multi-frame
        # tiles with partial last frames, the huge-down fallback, and
        # tiles that degenerate back to R = up
        x = rng.normal(size=n)
        h = rng.normal(size=k)
        got = upfirdn(h, x, up, down)
        expected = sps.upfirdn(h, x, up, down)
        assert got.shape == expected.shape
        assert_all_close(got, expected,
                         atol=1e-6 * max(1.0, np.abs(expected).max()))


class TestResamplePoly:
    @pytest.mark.parametrize("up,down", [(1, 3), (2, 1), (2, 3), (160, 147), (48, 16)])
    def test_vs_scipy(self, up, down, rng):
        x = rng.normal(size=1000)
        got = resample_poly(x, up, down)
        expected = sps.resample_poly(x, up, down)
        assert got.shape == expected.shape
        # interiors match tightly; scipy pads edges differently (we use zero
        # edges like upfirdn itself), so compare away from the boundary
        m = 30
        assert_all_close(np.asarray(got)[m:-m], expected[m:-m], atol=1e-6)

    def test_48k_to_16k_tone(self):
        # BASELINE config 4: decimate 48 kHz -> 16 kHz; a 1 kHz tone must
        # survive with the right frequency and amplitude
        fs = 48000
        t = np.arange(fs) / fs
        x = np.sin(2 * np.pi * 1000 * t).astype(np.float32)
        y = np.asarray(resample_poly(x, 1, 3))
        assert y.shape == (fs // 3,)
        spec = np.abs(np.fft.rfft(y[1000:9000] * np.hanning(8000)))
        peak = np.argmax(spec)
        freq = peak * 16000 / 8000
        assert abs(freq - 1000) < 5
        # tone amplitude preserved within 1%
        assert abs(np.abs(y[2000:14000]).max() - 1.0) < 0.01

    def test_batched(self, rng):
        x = rng.normal(size=(4, 300))
        got = resample_poly(x, 2, 3)
        expected = np.stack([sps.resample_poly(row, 2, 3) for row in x])
        assert got.shape == expected.shape
        assert_all_close(np.asarray(got)[:, 10:-10], expected[:, 10:-10], atol=1e-6)


class TestPFB:
    def test_tone_isolation(self):
        # a tone centered in sub-band k lands in output channel k and is
        # >40 dB above every other channel
        m, fs = 32, 32000.0
        t = np.arange(16384) / fs
        k = 5
        f_k = k * fs / m  # center of channel k
        x = np.exp(2j * np.pi * f_k * t).astype(np.complex64)
        y = np.asarray(pfb_analyze(x, m, taps_per_channel=12))
        power = (np.abs(y[50:-50]) ** 2).mean(axis=0)
        others = np.delete(power, k)
        assert power[k] > 1e3 * others.max()

    def test_output_shape(self, rng):
        x = rng.normal(size=4096).astype(np.float32)
        y = pfb_analyze(x, 64, taps_per_channel=8)
        n_frames = (4096 - 64 * 8) // 64 + 1
        assert y.shape == (n_frames, 64)
        assert np.iscomplexobj(np.asarray(y))

    def test_f64_explicit_mxu_strategy_warns(self, rng):
        # 'auto' keeps f64 on the dtype-preserving einsum path; an
        # explicit matmul strategy downcasts to f32 and must say so
        import warnings

        x = rng.normal(size=2048).astype(np.float64)
        with pytest.warns(UserWarning, match="computes in float32"):
            pfb_analyze(jnp.asarray(x), 16, taps_per_channel=4,
                        strategy="matmul")
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # 'auto' must NOT warn
            y = pfb_analyze(jnp.asarray(x), 16, taps_per_channel=4)
        assert np.asarray(y).dtype == np.complex128

    def test_custom_prototype(self, rng):
        x = rng.normal(size=1024).astype(np.float32)
        taps = sps.firwin(16 * 6, 1 / 16)
        y = pfb_analyze(x, 16, taps=taps)
        assert y.shape[-1] == 16

    def test_prototype_length_validation(self):
        with pytest.raises(ValueError, match="multiple of"):
            pfb_analyze(np.ones(256), 16, taps=np.ones(100))

    @pytest.mark.parametrize("strategy", ["matmul", "factored"])
    @pytest.mark.parametrize("m,tpc,shape,length", [
        (64, 8, (2,), 50000),    # BASELINE config 4/5 single-chip family
        (8, 4, (), 4096),        # 1-D squeeze
        (1024, 8, (1,), 100000),  # config 5's stated channel count
        (16, 6, (2, 3), 5000),   # stacked batch dims, odd tap count
    ])
    def test_mxu_strategies_match_einsum(self, strategy, m, tpc, shape,
                                         length, rng):
        # the PFB *is* a framed DFT with wrapped phase:
        # both matmul strategies must equal the reference einsum formulation
        x = rng.normal(size=(*shape, length)).astype(np.float32)
        ref = np.asarray(pfb_analyze(x, m, taps_per_channel=tpc,
                                     strategy="einsum"))
        got = np.asarray(pfb_analyze(x, m, taps_per_channel=tpc,
                                     strategy=strategy))
        assert got.shape == ref.shape
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, atol=2e-6 * scale)

    @pytest.mark.parametrize("strategy", ["matmul", "factored"])
    def test_mxu_strategies_under_jit(self, strategy, rng):
        # the default prototype (firwin) becomes a TRACER inside jit —
        # the weight build must take the jnp path, not np.asarray
        import jax

        x = rng.normal(size=(2, 30000)).astype(np.float32)
        ref = np.asarray(pfb_analyze(x, 32, taps_per_channel=6,
                                     strategy="einsum"))
        fn = jax.jit(lambda x: pfb_analyze(x, 32, taps_per_channel=6,
                                           strategy=strategy))
        got = np.asarray(fn(x))
        np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max())

    def test_auto_strategy_dispatch(self, rng):
        # complex input falls back to einsum; real uses the matmul paths;
        # the matmul paths reject complex input with a clear error
        xc = (rng.normal(size=3000)
              + 1j * rng.normal(size=3000)).astype(np.complex64)
        r_auto = np.asarray(pfb_analyze(xc, 8, taps_per_channel=4,
                                        shift=True))
        r_ein = np.asarray(pfb_analyze(xc, 8, taps_per_channel=4,
                                       strategy="einsum", shift=True))
        np.testing.assert_array_equal(r_auto, r_ein)
        with pytest.raises(ValueError, match="real input"):
            pfb_analyze(xc, 8, taps_per_channel=4, strategy="matmul")
        with pytest.raises(ValueError, match="strategy"):
            pfb_analyze(np.ones(4096, np.float32), 8, strategy="bogus")
        with pytest.raises(ValueError, match="shorter"):
            pfb_analyze(np.ones(100, np.float32), 64, taps_per_channel=8)
