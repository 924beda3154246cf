"""Real multi-process exercise of parallel/multihost.py.

Spawns a 2-process CPU 'cluster' (jax.distributed with a local coordinator,
4 virtual devices per process = 8 global devices) in subprocesses and runs
every collective family in parallel/ across the process boundary: a sharded
FIR's ppermute halo (bitwise vs single device), sharded_sosfilt's
all_gather state chain, and sharded_welch's psum segment reduction. This is
the "multi-node without a real cluster" strategy from SURVEY.md §4 — the
collectives between block 3 (process 0) and block 4 (process 1) travel over
the distributed backend, not device-local memory.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker_env():
    env = dict(os.environ)
    # Workers manage their own platform/device-count flags; scrub the
    # parent test session's.
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.slow
def test_two_process_sharded_fir_bitwise():
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), "2", str(port)],
            env=_worker_env(),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER_OK {i}" in out, f"worker {i} output:\n{out}"


@pytest.mark.slow
def test_dead_peer_detected_across_processes():
    """parallel/failure.py heartbeat must detect a dead peer: worker 1
    joins the cluster then exits; worker 0's cross-process probe must end
    in FailureDetected (hung collective or torn-down runtime) within the
    deadline — the liveness layer SURVEY.md §5 scoped as the detection
    half of elastic recovery."""
    port = _free_port()
    worker = os.path.join(REPO, "tests", "failure_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(port)],
            env=_worker_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("failure workers timed out:\n" + "\n".join(outs))
    assert "PEER_EXITING" in outs[1], outs[1]
    assert "DETECTED_OK" in outs[0], outs[0]
    assert procs[0].returncode == 0


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["channel", "block"])
def test_pod_bench_two_process_smoke(mode):
    """scripts/pod_bench.py must run on the 2-process CPU cluster and emit
    the scaling-efficiency JSON line (the script is the ready-to-run pod
    measurement for the first real multi-chip session)."""
    import json

    port = _free_port()
    script = os.path.join(REPO, "scripts", "pod_bench.py")
    common = [
        sys.executable, script, "--coordinator", f"localhost:{port}",
        "--num-processes", "2", "--virtual-devices", "2",
        "--mode", mode, "--channels-per-chip", "2",
        "--seconds", "0.1", "--rate", "16000", "--steps", "1",
        "--repeats", "2", "--single-chip-msps", "100.0",
    ]
    procs = [
        subprocess.Popen(
            common + ["--process-id", str(i)],
            env=_worker_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("pod_bench workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pod_bench worker {i} failed:\n{out}"
    line = next(l for l in outs[0].splitlines()
                if l.startswith("{") and "pod_chain_scaling" in l)
    rec = json.loads(line)
    assert rec["devices"] == 4 and rec["hosts"] == 2
    assert rec["mode"] == mode
    assert rec["msamples_per_s"] > 0
    assert rec["efficiency_vs_single_chip"] is not None


def test_initialize_noop_single_process():
    # The no-arg path must be a clean no-op outside any cluster environment.
    code = (
        "import os; os.environ['XLA_FLAGS']='--xla_force_host_platform_device_count=4';"
        "os.environ.setdefault('JAX_PLATFORMS','cpu');"
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from nx_signal_tpu.parallel import multihost;"
        "multihost.initialize();"
        "assert jax.process_count() == 1;"
        "assert jax.local_device_count() == 4;"
        "m = multihost.make_pod_mesh(n_channel=2);"
        "assert m.devices.shape == (2, 2);"
        "lo, hi = multihost.process_block_range(1000, m);"
        "assert (lo, hi) == (0, 1000), (lo, hi);"
        "print('NOOP_OK')"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], env=_worker_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NOOP_OK" in res.stdout
