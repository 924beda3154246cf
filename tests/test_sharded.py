"""Sharding-layer tests on the simulated 8-device CPU mesh.

Bit-comparability contract (SURVEY.md north star): every path that does not
cross an FFT is asserted BITWISE identical to the single-device op; FFT
paths are asserted to 1e-6 relative because the CPU FFT (ducc) is not
run-to-run bitwise deterministic (verified empirically — identical inputs
give ulp-different outputs across calls); the deterministic framing/fold
logic around it is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nx_signal_tpu.ops import windows
from nx_signal_tpu.ops.convolution import convolve
from nx_signal_tpu.parallel.mesh import channel_block_sharding, make_dsp_mesh
from nx_signal_tpu.parallel.sharded import (
    sharded_convolve_same,
    sharded_istft,
    sharded_stft,
)
from nx_signal_tpu.spectral import istft, stft

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device CPU mesh"
)


def rel_close(a, b, tol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max()
    np.testing.assert_allclose(a, b, atol=tol * max(scale, 1e-30), rtol=tol)


@pytest.fixture(params=[(1, 8), (2, 4), (4, 2), (8, 1)])
def mesh(request):
    c, b = request.param
    return make_dsp_mesh(c, b)


class TestShardedFIR:
    @pytest.mark.parametrize("length,k", [(4096, 255), (4096, 256), (1000, 31), (4099, 17)])
    def test_bitwise_vs_single_device(self, mesh, length, k, rng):
        # method='conv' (lax.conv): per-sample dots are shape-independent, so
        # bitwise equality holds even on CPU.
        from nx_signal_tpu.ops.convolution import _direct_convolve

        c = mesh.shape["channel"]
        x = rng.normal(size=(8, length)).astype(np.float32)
        if 8 % c:
            pytest.skip("channel split")
        taps = rng.normal(size=k).astype(np.float32)
        got = sharded_convolve_same(x, taps, mesh=mesh, method="conv")
        expected = _direct_convolve(x, taps[None, :], "same", use_matmul=False)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))

    @pytest.mark.parametrize("length,k", [(4096, 255), (4099, 17), (1000, 31)])
    def test_matmul_path_vs_single_device(self, mesh, length, k, rng):
        # method='direct' (Toeplitz matmul): the block grid is globally
        # phase-aligned, but the CPU GEMM reduction order varies with the
        # batch extent, so the CPU gate is ulp-tight agreement.
        c = mesh.shape["channel"]
        x = rng.normal(size=(8, length)).astype(np.float32)
        if 8 % c:
            pytest.skip("channel split")
        taps = rng.normal(size=k).astype(np.float32)
        got = sharded_convolve_same(x, taps, mesh=mesh, method="direct")
        expected = convolve(x, taps[None, :], mode="same")
        rel_close(got, expected, tol=1e-6)

    def test_1d_input(self, rng):
        mesh = make_dsp_mesh(1, 8)
        x = rng.normal(size=2048).astype(np.float32)
        taps = rng.normal(size=33).astype(np.float32)
        got = sharded_convolve_same(x, taps, mesh=mesh)
        expected = convolve(x[None], taps[None, :], mode="same")[0]
        rel_close(got, expected, tol=1e-6)

    def test_halo_too_large_raises(self, rng):
        # method='conv' keeps the raw block split (no matmul-grid rounding),
        # so an over-long filter halo is a real error there
        mesh = make_dsp_mesh(1, 8)
        with pytest.raises(ValueError, match="halo .* exceeds"):
            sharded_convolve_same(np.zeros(64, np.float32), np.zeros(33, np.float32),
                                  mesh=mesh, method="conv")

    def test_small_signal_direct_pads(self, rng):
        # the direct path rounds blocks up to the matmul grid, so small
        # signals are padded rather than rejected
        mesh = make_dsp_mesh(1, 8)
        x = rng.normal(size=64).astype(np.float32)
        taps = rng.normal(size=33).astype(np.float32)
        got = sharded_convolve_same(x, taps, mesh=mesh)
        expected = convolve(x[None], taps[None, :], mode="same")[0]
        rel_close(got, expected, tol=1e-6)


class TestShardedSTFT:
    @pytest.mark.parametrize("length,wl,overlap", [
        (16000, 512, 384),   # flagship: 1 s @ 16 kHz, hop 128 (auto-pad path)
        (16384, 512, 384),   # aligned
        (8192, 256, 128),    # hop = half
        (4096, 128, 0),      # no overlap
    ])
    def test_vs_single_device(self, mesh, length, wl, overlap, rng):
        c = mesh.shape["channel"]
        if 8 % c:
            pytest.skip("channel split")
        x = rng.normal(size=(8, length)).astype(np.float32)
        w = windows.hann(wl)
        zs, ts, fs_ = sharded_stft(x, w, mesh=mesh, sampling_rate=16000,
                                   fft_length=wl, overlap_length=overlap)
        z1, t1, f1 = stft(x, w, sampling_rate=16000, fft_length=wl,
                          overlap_length=overlap)
        assert zs.shape == z1.shape
        rel_close(zs, z1)
        np.testing.assert_array_equal(np.asarray(ts), np.asarray(t1))
        np.testing.assert_array_equal(np.asarray(fs_), np.asarray(f1))

    def test_scaling(self, rng):
        mesh = make_dsp_mesh(1, 8)
        x = rng.normal(size=(1, 8192)).astype(np.float32)
        w = windows.hann(256)
        zs, _, _ = sharded_stft(x, w, mesh=mesh, sampling_rate=100,
                                fft_length=256, scaling="spectrum")
        z1, _, _ = stft(x, w, sampling_rate=100, fft_length=256, scaling="spectrum")
        rel_close(zs, z1)


class TestShardedISTFT:
    @pytest.mark.parametrize("m,n_fft,overlap", [
        (120, 512, 384),
        (122, 512, 384),    # ragged frame count (auto-pad path)
        (64, 256, 128),
        (37, 128, 64),      # ragged
    ])
    def test_bitwise_vs_single_device(self, mesh, m, n_fft, overlap, rng):
        c = mesh.shape["channel"]
        if 8 % c:
            pytest.skip("channel split")
        z = (rng.normal(size=(8, m, n_fft)) + 1j * rng.normal(size=(8, m, n_fft))
             ).astype(np.complex64)
        w = windows.hann(n_fft)
        got = sharded_istft(z, w, mesh=mesh, fft_length=n_fft, overlap_length=overlap)
        expected = istft(z, w, fft_length=n_fft, overlap_length=overlap)
        assert got.shape == expected.shape
        # The overlap-add fold and halo seeding are exactly associative-
        # matched; only the IFFT itself is (CPU-)nondeterministic.
        rel_close(got, expected, tol=1e-6)

    def test_roundtrip_through_sharded_pipeline(self, rng):
        mesh = make_dsp_mesh(2, 4)
        x = rng.normal(size=(2, 16384)).astype(np.float32)
        w = windows.hann(512)
        z, _, _ = sharded_stft(x, w, mesh=mesh, sampling_rate=16000,
                               fft_length=512, overlap_length=384)
        y = sharded_istft(z, w, mesh=mesh, fft_length=512, overlap_length=384,
                          sampling_rate=16000)
        y = np.real(np.asarray(y))
        np.testing.assert_allclose(y[:, 512:-512], x[:, 512 : y.shape[1] - 512],
                                   atol=1e-3)

    @pytest.mark.parametrize("scaling", ["spectrum", "psd"])
    def test_scaling(self, scaling, rng):
        mesh = make_dsp_mesh(1, 8)
        z = (rng.normal(size=(1, 64, 256)) + 1j * rng.normal(size=(1, 64, 256))
             ).astype(np.complex64)
        w = windows.hann(256)
        got = sharded_istft(z, w, mesh=mesh, fft_length=256, scaling=scaling,
                            sampling_rate=100)
        expected = istft(z, w, fft_length=256, scaling=scaling, sampling_rate=100)
        rel_close(got, expected)


class TestShardedPFB:
    def test_vs_single_device(self, rng):
        from nx_signal_tpu.ops.resample import pfb_analyze
        from nx_signal_tpu.parallel.sharded import sharded_pfb_analyze

        mesh = make_dsp_mesh(2, 4)
        x = rng.normal(size=(2, 65536)).astype(np.float32)
        got = sharded_pfb_analyze(x, 64, mesh=mesh, taps_per_channel=8)
        expected = pfb_analyze(x, 64, taps_per_channel=8)
        assert got.shape == expected.shape
        rel_close(got, expected, tol=1e-6)

    def test_uneven_length_pads(self, rng):
        from nx_signal_tpu.ops.resample import pfb_analyze
        from nx_signal_tpu.parallel.sharded import sharded_pfb_analyze

        mesh = make_dsp_mesh(1, 8)
        x = rng.normal(size=50000).astype(np.float32)
        got = sharded_pfb_analyze(x, 32, mesh=mesh, taps_per_channel=4)
        expected = pfb_analyze(x, 32, taps_per_channel=4)
        assert got.shape == expected.shape
        rel_close(got, expected, tol=1e-6)


class TestShardedGuards:
    def test_matmul_rejects_complex(self, rng):
        mesh = make_dsp_mesh(1, 8)
        x = (rng.normal(size=(1, 8192)) + 1j).astype(np.complex64)
        with pytest.raises(ValueError, match="requires real input"):
            sharded_stft(x, windows.hann(256), mesh=mesh, fft_length=256,
                         method="matmul")

    def test_matmul_rejects_short_fft(self, rng):
        mesh = make_dsp_mesh(1, 8)
        x = rng.normal(size=(1, 8192)).astype(np.float32)
        with pytest.raises(ValueError, match="fft_length >= frame_length"):
            sharded_stft(x, windows.hann(512), mesh=mesh, fft_length=256,
                         method="matmul")

    def test_short_signal_raises(self, rng):
        mesh = make_dsp_mesh(1, 8)
        with pytest.raises(ValueError, match="exceeds signal length"):
            sharded_stft(np.zeros(100, np.float32), windows.hann(256),
                         mesh=mesh, fft_length=256)


class TestShardedSosfilt:
    def test_vs_single_device(self, mesh, rng):
        import scipy.signal as sps
        from nx_signal_tpu.ops.iir import sosfilt
        from nx_signal_tpu.parallel.sharded import sharded_sosfilt

        sos = sps.butter(6, 0.2, output="sos")
        x = rng.normal(size=(8, 4096)).astype(np.float32)
        got = sharded_sosfilt(sos, x, mesh=mesh)
        want = sosfilt(jnp.asarray(sos, jnp.float32), x)
        rel_close(got, want, tol=1e-5)

    def test_vs_scipy_f64(self, rng):
        import scipy.signal as sps
        from nx_signal_tpu.parallel.sharded import sharded_sosfilt

        sos = sps.ellip(8, 0.5, 60.0, 0.15, output="sos")  # high-Q cascade
        x = rng.normal(size=(4, 4096)).astype(np.float32)
        got = sharded_sosfilt(sos, x, mesh=make_dsp_mesh(2, 4))
        rel_close(got, sps.sosfilt(sos, x.astype(np.float64)), tol=1e-4)

    def test_1d_and_uneven_length(self, rng):
        import scipy.signal as sps
        from nx_signal_tpu.parallel.sharded import sharded_sosfilt

        sos = sps.butter(4, 0.3, output="sos")
        x = rng.normal(size=5000).astype(np.float32)  # not divisible by 8
        got = sharded_sosfilt(sos, x, mesh=make_dsp_mesh(1, 8))
        assert got.shape == (5000,)
        rel_close(got, sps.sosfilt(sos, x.astype(np.float64)), tol=1e-4)

    def test_state_space_impulse_response(self, rng):
        # the host-built (A, B, C, D) must reproduce the sos impulse response
        import scipy.signal as sps
        from nx_signal_tpu.parallel.sharded import _sos_state_space

        sos = sps.cheby1(6, 1.0, 0.25, output="sos")
        a_mat, b_vec, c_vec, d = _sos_state_space(sos)
        n = 64
        imp = np.zeros(n); imp[0] = 1.0
        ref = sps.sosfilt(sos, imp)
        z = np.zeros(a_mat.shape[0]); out = np.empty(n)
        for i in range(n):
            out[i] = c_vec @ z + d * imp[i]
            z = a_mat @ z + b_vec * imp[i]
        np.testing.assert_allclose(out, ref, atol=1e-12, rtol=1e-10)


class TestShardedFusedChain:
    """sharded_fir_framed_dft_power — the pod-scale fused bench chain —
    vs the single-device fir_framed_dft power output."""

    @pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2), (8, 1)])
    def test_matches_single_device(self, mesh_shape, rng):
        from nx_signal_tpu.kernels.dft import fir_framed_dft
        from nx_signal_tpu.parallel.sharded import sharded_fir_framed_dft_power

        nc, nb = mesh_shape
        mesh = make_dsp_mesh(nc, nb)
        ch = max(2, 2 * nc)
        x = jnp.asarray(rng.normal(size=(ch, 4096)), jnp.float32)
        taps = rng.normal(size=63).astype(np.float32)
        win = np.hanning(256).astype(np.float32)
        ref = np.asarray(fir_framed_dft(
            x, taps, win, stride=64, n_fft=256, onesided=True,
            output="power", precision="highest"))
        got = np.asarray(sharded_fir_framed_dft_power(
            jax.device_put(x, channel_block_sharding(mesh, ndim=2)),
            taps, win, mesh=mesh, stride=64, n_fft=256,
            precision="highest"))
        assert got.shape == ref.shape
        # CPU GEMM/conv reduction order varies with the spatial extent, so
        # ulp-tight here
        np.testing.assert_allclose(got, ref,
                                   atol=2e-6 * np.abs(ref).max())

    def test_halo_and_geometry_validation(self, rng):
        from nx_signal_tpu.parallel.sharded import sharded_fir_framed_dft_power

        mesh = make_dsp_mesh(1, 8)
        x = jnp.asarray(rng.normal(size=(2, 2048)), jnp.float32)
        taps = rng.normal(size=63).astype(np.float32)
        with pytest.raises(ValueError):   # frame halo exceeds tiny blocks
            sharded_fir_framed_dft_power(
                x, taps, np.hanning(1024).astype(np.float32),
                mesh=mesh, stride=64, n_fft=1024)
        with pytest.raises(ValueError, match="fft_length >= frame_length"):
            # non-matmul geometry: the matmul DFT cannot truncate frames
            sharded_fir_framed_dft_power(
                x, taps, np.hanning(256).astype(np.float32),
                mesh=mesh, stride=64, n_fft=128)
