"""Sharded polyphase resampling + OA convolution vs single device
(BASELINE configs 2 and 4 across devices)."""

import jax.numpy as jnp
import numpy as np
import pytest

from nx_signal_tpu.ops.convolution import oaconvolve
from nx_signal_tpu.ops.resample import resample_poly, upfirdn
from nx_signal_tpu.parallel.mesh import make_dsp_mesh
from nx_signal_tpu.parallel.sharded import (
    sharded_oaconvolve_same,
    sharded_resample_poly,
    sharded_upfirdn,
)

pytestmark = pytest.mark.slow

MESHES = [(1, 8), (2, 4), (4, 2), (8, 1)]


def _rng_sig(channels=8, length=4096, seed=0):
    return np.random.default_rng(seed).normal(
        size=(channels, length)).astype(np.float32)


class TestShardedUpfirdn:
    @pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
    @pytest.mark.parametrize("up,down", [(1, 1), (2, 3), (3, 2), (1, 4), (5, 1)])
    def test_vs_single_device(self, mesh_shape, up, down):
        mesh = make_dsp_mesh(*mesh_shape)
        x = _rng_sig()
        h = np.random.default_rng(1).normal(size=31).astype(np.float32)
        got = sharded_upfirdn(h, x, up, down, mesh=mesh)
        want = upfirdn(h, x, up, down)
        assert got.shape == want.shape
        # same banded dot on the same values; CPU GEMM reduction order
        # varies with batch extent (CLAUDE.md), and the lane-filling
        # output tile's K ~ stride+taps contraction spreads the ulps a
        # little wider than the old per-phase T-tap dot — gate at ~1e-5
        # relative (observed: 1-3 of 33008 elements past 1e-6)
        scale = np.abs(np.asarray(want)).max()
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-5, atol=2e-5 * scale)

    def test_1d_squeeze(self):
        mesh = make_dsp_mesh(1, 8)
        x = _rng_sig(1)[0]
        h = np.random.default_rng(1).normal(size=19).astype(np.float32)
        got = sharded_upfirdn(h, x, 3, 2, mesh=mesh)
        want = upfirdn(h, x, 3, 2)
        assert got.ndim == 1
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)

    def test_halo_too_large_raises(self):
        mesh = make_dsp_mesh(1, 8)
        with pytest.raises(ValueError, match="halo"):
            sharded_upfirdn(np.ones(600, np.float32),
                            np.zeros((1, 512), np.float32), 1, 1, mesh=mesh)


class TestShardedResamplePoly:
    @pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
    @pytest.mark.parametrize("up,down", [(1, 3), (3, 1), (2, 3), (160, 441)])
    def test_vs_single_device(self, mesh_shape, up, down):
        mesh = make_dsp_mesh(*mesh_shape)
        x = _rng_sig(length=8820)
        got = sharded_resample_poly(x, up, down, mesh=mesh)
        want = resample_poly(x, up, down)
        assert got.shape == want.shape
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    def test_vs_scipy(self):
        import scipy.signal as sps

        mesh = make_dsp_mesh(2, 4)
        x = _rng_sig(2, 4800)
        got = sharded_resample_poly(x, 1, 3, mesh=mesh)
        want = sps.resample_poly(x.astype(np.float64), 1, 3, axis=-1)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-4)

    def test_identity_ratio(self):
        mesh = make_dsp_mesh(2, 4)
        x = _rng_sig(2, 1024)
        got = sharded_resample_poly(x, 7, 7, mesh=mesh)
        np.testing.assert_array_equal(np.asarray(got), x)


class TestShardedOaconvolve:
    @pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
    def test_vs_single_device(self, mesh_shape):
        mesh = make_dsp_mesh(*mesh_shape)
        x = _rng_sig()
        taps = np.random.default_rng(2).normal(size=255).astype(np.float32)
        got = sharded_oaconvolve_same(x, taps, mesh=mesh)
        want = oaconvolve(x, taps[None, :], mode="same")
        assert got.shape == want.shape
        scale = np.max(np.abs(np.asarray(want)))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-5 * scale)

    def test_halo_too_large_raises(self):
        mesh = make_dsp_mesh(1, 8)
        with pytest.raises(ValueError, match="halo"):
            sharded_oaconvolve_same(np.zeros((1, 512), np.float32),
                                    np.ones(600, np.float32), mesh=mesh)
