"""Worker process for tests/test_multihost.py — NOT collected by pytest.

Each worker is one 'host' of a 2-process CPU cluster (4 virtual devices
each), exercising parallel/multihost.py for real: jax.distributed wiring,
the pod mesh, process_block_range feeding of process-local data, and all
three collective families crossing the process boundary — ppermute halos
(sharded FIR, bitwise vs single device; method='conv' is bitwise on CPU,
parallel/sharded.py:83), the all_gather state chain (sharded_sosfilt), and
the psum segment reduction (sharded_welch).

Usage: multihost_worker.py <process_id> <num_processes> <port>
Prints 'WORKER_OK <pid>' on success; any assertion kills the exit code.
"""

import os
import sys


def main():
    proc_id, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import jax

    jax.config.update("jax_platforms", "cpu")

    from nx_signal_tpu.parallel import multihost

    multihost.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=proc_id,
    )

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert jax.process_count() == nproc, jax.process_count()
    assert jax.process_index() == proc_id
    assert jax.local_device_count() == 4
    assert jax.device_count() == 4 * nproc

    from nx_signal_tpu.ops.convolution import _direct_convolve
    from nx_signal_tpu.parallel.mesh import BLOCK_AXIS, CHANNEL_AXIS
    from nx_signal_tpu.parallel.sharded import sharded_convolve_same

    # n_channel=1: all 8 mesh positions are time blocks, so the halo between
    # block 3 (process 0) and block 4 (process 1) is a REAL cross-process
    # ppermute over the distributed backend.
    mesh = multihost.make_pod_mesh(n_channel=1)
    assert mesh.shape[CHANNEL_AXIS] == 1
    assert mesh.shape[BLOCK_AXIS] == 4 * nproc

    channels, length, k = 4, 4096, 33
    rng = np.random.default_rng(0)
    x = rng.normal(size=(channels, length)).astype(np.float32)
    taps = rng.normal(size=(k,)).astype(np.float32)

    # Feed process-local data only — the multihost ingestion path.
    start, end = multihost.process_block_range(length, mesh)
    assert end > start, (start, end)
    sharding = NamedSharding(mesh, P(CHANNEL_AXIS, BLOCK_AXIS))
    gx = jax.make_array_from_process_local_data(sharding, x[:, start:end])
    assert gx.shape == (channels, length)

    out = sharded_convolve_same(gx, taps, mesh=mesh, method="conv")

    # Single-device reference, computed independently in every process
    # (lax.conv path — bitwise match to the sharded method='conv' run).
    want = np.asarray(_direct_convolve(x, taps[None, :], "same",
                                       use_matmul=False))
    for shard in out.addressable_shards:
        got = np.asarray(shard.data)
        sl = shard.index
        np.testing.assert_array_equal(got, want[sl])

    # Local coverage sanity: the two processes' block ranges tile [0, length).
    ranges = {0: (0, length // 2), 1: (length // 2, length)}
    assert (start, end) == ranges[proc_id], (start, end)

    # --- all_gather collective family across the process boundary:
    # sharded_sosfilt chains per-block IIR states via all_gather
    # (parallel/sharded.py), so blocks 4..7 (process 1) depend on state
    # gathered from process 0.
    import scipy.signal as sps

    from nx_signal_tpu.ops.iir import sosfilt
    from nx_signal_tpu.parallel.sharded import sharded_sosfilt

    sos = sps.butter(6, 0.2, output="sos")
    sos_j = np.asarray(sos, np.float32)
    got_sos = sharded_sosfilt(sos_j, gx, mesh=mesh)
    want_sos = np.asarray(sosfilt(sos_j, x))
    for shard in got_sos.addressable_shards:
        np.testing.assert_allclose(np.asarray(shard.data),
                                   want_sos[shard.index],
                                   atol=1e-5, rtol=1e-5)

    # --- psum collective family across the process boundary:
    # sharded_welch's segment-axis mean reduces partial sums over the
    # block axis, crossing the process boundary (the network between hosts in a real job).
    from nx_signal_tpu.parallel.estimation import sharded_welch
    from nx_signal_tpu.spectral.estimation import welch

    fq_s, p_s = sharded_welch(gx, mesh=mesh, sampling_rate=100.0,
                              segment_length=256)
    fq, p = welch(x, sampling_rate=100.0, segment_length=256)
    np.testing.assert_array_equal(np.asarray(fq_s), np.asarray(fq))
    want_p = np.asarray(p)
    scale = np.abs(want_p).max()
    for shard in p_s.addressable_shards:
        np.testing.assert_allclose(np.asarray(shard.data),
                                   want_p[shard.index],
                                   atol=1e-6 * scale, rtol=1e-6)

    print(f"WORKER_OK {proc_id}", flush=True)


if __name__ == "__main__":
    main()
