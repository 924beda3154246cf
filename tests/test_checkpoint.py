"""Checkpoint/resume of streaming carry state (SURVEY.md §5).

The contract: interrupting a streaming run at any chunk boundary, saving the
carry with io.checkpoint.save_state, and resuming in a FRESH PROCESS yields
the same outputs as the uninterrupted run — bitwise for the deterministic
paths (FIR framing/Toeplitz, IIR scan), and to f.p. tolerance for paths
through the CPU FFT (which is not run-to-run bitwise: CLAUDE.md).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from nx_signal_tpu.io.checkpoint import load_state, save_state
from nx_signal_tpu.parallel.streaming import (
    StreamingFIR,
    StreamingIIR,
    StreamingISTFT,
    StreamingSTFT,
)
from nx_signal_tpu.ops.windows import hann

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_chunks(proc, state, chunks):
    outs = []
    for c in chunks:
        state, out = proc.process(state, c)
        outs.append(np.asarray(out))
    return state, outs


class TestSaveLoad:
    def test_roundtrip_bitwise_array(self, tmp_path):
        path = str(tmp_path / "st.npz")
        state = jnp.asarray(
            np.random.default_rng(0).normal(size=(3, 7)).astype(np.float32))
        save_state(path, state, meta={"step": 42})
        got, meta = load_state(path)
        assert meta == {"step": 42}
        np.testing.assert_array_equal(np.asarray(state), got)

    def test_roundtrip_nested_pytree(self, tmp_path):
        path = str(tmp_path / "st.npz")
        state = {
            "fir": jnp.arange(6, dtype=jnp.float32),
            "iir": (jnp.zeros((2, 4, 2)), jnp.ones((3,), jnp.complex64)),
            "step": jnp.asarray(7),
        }
        save_state(path, state)
        got, meta = load_state(path)
        assert meta == {}
        assert set(got) == {"fir", "iir", "step"}
        np.testing.assert_array_equal(got["fir"],
                                      np.arange(6, dtype=np.float32))
        assert got["iir"][1].dtype == np.complex64
        assert int(got["step"]) == 7

    def test_atomic_overwrite(self, tmp_path):
        path = str(tmp_path / "st.npz")
        save_state(path, jnp.zeros(4), meta={"step": 1})
        save_state(path, jnp.ones(4), meta={"step": 2})
        got, meta = load_state(path)
        assert meta["step"] == 2
        np.testing.assert_array_equal(got, np.ones(4, np.float64))
        assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


class TestResumeInProcess:
    """Same-process resume: save at the midpoint, reload, continue —
    bitwise-equal tails for every processor."""

    @pytest.mark.parametrize("make", [
        lambda: StreamingFIR(jnp.asarray(
            np.random.default_rng(1).normal(size=33).astype(np.float32))),
        lambda: StreamingIIR(jnp.asarray([
            [0.2, 0.4, 0.2, 1.0, -0.5, 0.25],
            [0.1, 0.2, 0.1, 1.0, -0.3, 0.1],
        ], jnp.float32)),
    ], ids=["fir", "iir"])
    def test_fir_iir_bitwise(self, make, tmp_path):
        proc = make()
        rng = np.random.default_rng(2)
        chunks = [jnp.asarray(rng.normal(size=512).astype(np.float32))
                  for _ in range(6)]
        _, full = _run_chunks(proc, proc.init_state(), chunks)

        state, _ = _run_chunks(proc, proc.init_state(), chunks[:3])
        path = str(tmp_path / "mid.npz")
        save_state(path, state, meta={"chunk": 3})
        restored, meta = load_state(path)
        assert meta["chunk"] == 3
        _, tail = _run_chunks(proc, restored, chunks[3:])
        for got, want in zip(tail, full[3:]):
            np.testing.assert_array_equal(got, want)

    def test_stft_istft_roundtrip_after_resume(self, tmp_path):
        w = hann(64)
        stft_p = StreamingSTFT(w, hop=16)
        istft_p = StreamingISTFT(w, hop=16)
        rng = np.random.default_rng(3)
        chunks = [jnp.asarray(rng.normal(size=256).astype(np.float32))
                  for _ in range(6)]

        st_s, zs_full = _run_chunks(stft_p, stft_p.init_state(), chunks)
        st_i, ys_full = _run_chunks(
            istft_p, istft_p.init_state(), [jnp.asarray(z) for z in zs_full])

        st_s, _ = _run_chunks(stft_p, stft_p.init_state(), chunks[:3])
        st_i, _ = _run_chunks(
            istft_p, istft_p.init_state(),
            [jnp.asarray(z) for z in zs_full[:3]])
        p1, p2 = str(tmp_path / "s.npz"), str(tmp_path / "i.npz")
        save_state(p1, st_s)
        save_state(p2, st_i)
        rs, _ = load_state(p1)
        ri, _ = load_state(p2)
        _, zs_tail = _run_chunks(stft_p, rs, chunks[3:])
        _, ys_tail = _run_chunks(
            istft_p, ri, [jnp.asarray(z) for z in zs_tail])
        # FFT paths: CPU FFT is not bitwise run-to-run; gate at 1e-6 rel
        for got, want in zip(zs_tail, zs_full[3:]):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.max(
                np.abs(want)))
        for got, want in zip(ys_tail, ys_full[3:]):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.max(
                np.abs(want)))


RESUME_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from nx_signal_tpu.io.checkpoint import load_state, save_state
from nx_signal_tpu.parallel.streaming import StreamingFIR

ckpt, out_path = sys.argv[1], sys.argv[2]
taps = jnp.asarray(np.random.default_rng(1).normal(size=33).astype(np.float32))
proc = StreamingFIR(taps)
rng = np.random.default_rng(2)
chunks = [jnp.asarray(rng.normal(size=512).astype(np.float32)) for _ in range(6)]
state, meta = load_state(ckpt)
assert meta["chunk"] == 3, meta
outs = []
for c in chunks[3:]:
    state, out = proc.process(state, c)
    outs.append(np.asarray(out))
np.save(out_path, np.concatenate(outs))
print("RESUME_OK")
"""


class TestResumeFreshProcess:
    def test_fir_resume_across_process_restart(self, tmp_path):
        """Restore in a fresh process, bitwise
        continuation vs the uninterrupted run."""
        taps = jnp.asarray(
            np.random.default_rng(1).normal(size=33).astype(np.float32))
        proc = StreamingFIR(taps)
        rng = np.random.default_rng(2)
        chunks = [jnp.asarray(rng.normal(size=512).astype(np.float32))
                  for _ in range(6)]
        _, full = _run_chunks(proc, proc.init_state(), chunks)

        state, _ = _run_chunks(proc, proc.init_state(), chunks[:3])
        ckpt = str(tmp_path / "mid.npz")
        save_state(ckpt, state, meta={"chunk": 3})

        out_path = str(tmp_path / "tail.npy")
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        res = subprocess.run(
            [sys.executable, "-c", RESUME_SCRIPT, ckpt, out_path],
            env=env, capture_output=True, text=True, timeout=300,
        )
        assert res.returncode == 0, res.stdout + res.stderr
        assert "RESUME_OK" in res.stdout
        tail = np.load(out_path)
        np.testing.assert_array_equal(tail, np.concatenate(full[3:]))
