"""chip_smoke.py on the CPU: it must refuse to run without a GPU, and its
phases must agree with their reference at a tiny size (the full-size run
needs the card)."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from nx_signal_tpu.ops.filters import firwin  # noqa: E402
from nx_signal_tpu.ops.windows import hann  # noqa: E402


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_refused(res):
    assert res.returncode != 0
    lines = res.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


def test_refuses_to_run_on_the_cpu():
    res = _run_script(os.path.join(REPO, "chip_smoke.py"), REPO)
    _assert_refused(res)
    assert "needs a GPU" in res.stderr


def test_refuses_to_run_without_the_repo(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
    _assert_refused(_run_script(str(script), str(tmp_path)))


@pytest.fixture
def tiny():
    x = cs.make_signal(4, 4096, 0)
    return x, firwin(31, [0.2]), hann(64)


def test_reference_matches_numpy(tiny):
    x, taps, window = tiny
    xn, tn, wn = (np.asarray(a, np.float64) for a in tiny)
    y = np.asarray(cs.reference_fir_same(x, taps))
    y_np = np.stack([np.convolve(r, tn)[15:15 + x.shape[1]] for r in xn])
    np.testing.assert_allclose(y, y_np, atol=1e-5 * np.abs(y_np).max())
    p = np.asarray(cs.reference_power(x, window, 16, 64))
    m = (x.shape[1] - 64) // 16 + 1
    idx = np.arange(m)[:, None] * 16 + np.arange(64)[None, :]
    p_np = np.abs(np.fft.rfft(xn[:, idx] * wn, 64)) ** 2
    np.testing.assert_allclose(p, p_np, atol=1e-5 * p_np.max())


def test_phase_chain(tiny, capsys):
    x, taps, window = tiny
    errors = cs.phase_chain(x, taps, window, hop=16, n_fft=64)
    assert set(errors) == {
        "chain", "chain filtered",
        "chain power with filtered", "matmul-DFT chain[highest]",
        "matmul-DFT chain[high]"}
    assert max(errors.values()) < 1e-5
    assert "memory_analysis" in capsys.readouterr().out


def test_phase_chain_fails_outside_the_gate(tiny, monkeypatch):
    x, taps, window = tiny
    monkeypatch.setattr(cs, "GATE", 0.0)
    with pytest.raises(AssertionError, match="gate"):
        cs.phase_chain(x, taps, window, hop=16, n_fft=64)


def test_phase_stft_roundtrip(tiny):
    x, _, window = tiny
    assert cs.phase_stft_roundtrip(x, window, hop=16, n_fft=64) < 1e-5


def test_phase_four_cards(tiny):
    x, taps, window = tiny
    results = cs.phase_four_cards(x, taps, window, jax.devices()[:4], hop=16,
                                  n_fft=64, claims={})
    assert set(results) == {"fir_framed_dft_power", "convolve_same", "stft",
                            "istft", "istft_fft"}
    assert all(err < 1e-5 for _, err in results.values())


def test_phase_four_cards_checks_bitwise_claims(tiny, monkeypatch):
    # a claim the comparison cannot confirm fails the phase
    x, taps, window = tiny
    monkeypatch.setattr(cs, "_compare_on", lambda device, got, ref: (False, 0.0))
    with pytest.raises(AssertionError, match="claimed bitwise"):
        cs.phase_four_cards(x, taps, window, jax.devices()[:4], hop=16,
                            n_fft=64, claims={"istft": True})
