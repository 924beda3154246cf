"""bench.py on the CPU: its speed-of-light model, and its refusal to time
anything without a GPU."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
from nx_signal_tpu.kernels import dft  # noqa: E402
from nx_signal_tpu.utils.profiling import device_peaks  # noqa: E402

H100 = device_peaks("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("prefer_matmul,precision,flops,rate", [
    (False, "highest", 2.0 * (512 + 254), 67e12),   # Toeplitz FIR, float32
    (False, "high", 2.0 * (512 + 254), 67e12),      # the FIR stays float32
    (True, "highest", 2.0 * 766 * 514 / 128, 67e12),
    (True, "high", 2.0 * 766 * 514 / 128, 495e12),  # TF32 tensor cores
])
def test_chain_speed_of_light(prefer_matmul, precision, flops, rate,
                              monkeypatch):
    monkeypatch.setattr(dft, "_MAX_MATMUL_FFT", 4096 if prefer_matmul else 0)
    sol, bound = bench.chain_speed_of_light(H100, precision)
    memory = 3.35e12 / (4.0 + 257 * 4.0 / 128)
    assert sol == pytest.approx(min(rate / flops, memory))
    assert bound == ("compute" if rate / flops < memory else "memory")


def test_unknown_precision_has_no_rate():
    with pytest.raises(ValueError, match="no rate model"):
        bench.matmul_rate(H100, "BF16_BF16_F32_X3")


def test_refuses_to_run_on_the_cpu():
    res = subprocess.run([sys.executable, "bench.py"], cwd=REPO,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "needs a GPU" in res.stderr
    assert "stft_fir_chain_throughput" not in res.stdout
