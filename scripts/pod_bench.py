"""Multi-card scaling benchmark of the STFT+FIR chain.

Measures global samples/s of the chain over every card in a (multi-host)
job and reports the scaling efficiency against a single-card reference
(BASELINE.md: >= 85% from 1 card -> 1 host -> >= 2 hosts). Start ONE
process per host; each process drives every card of its host:

    # one host (all of its cards, or one card to record the baseline):
    python scripts/pod_bench.py
    # each host of a multi-host job, with its index $I:
    python scripts/pod_bench.py --coordinator host0:1234 \
        --num-processes <hosts> --process-id $I --single-chip-msps <baseline>

Modes: 'channel' (default) shards channels across cards — the
embarrassingly-parallel throughput workload, no communication, the >=85%
row's subject; 'block' shards ONE stream's time axis across cards so the
FIR halos + STFT frame tails cross cards (NVLink within a host) and hosts
(the network) every step.

Prints ONE JSON line from process 0:
    {"metric": "pod_chain_scaling", "devices": D, "hosts": H,
     "msamples_per_s": global, "msamples_per_s_per_chip": per-chip,
     "efficiency_vs_single_chip": per-chip/baseline or null, ...}

Smoke-tested by tests/test_multihost.py on the 2-process CPU cluster
(--virtual-devices sets up the CPU mesh before jax imports).
"""

import argparse
import json
import os
import sys
import time


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port (multi-host only)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--mode", choices=["channel", "block"], default="channel")
    p.add_argument("--channels-per-chip", type=int, default=64)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rate", type=int, default=48000)
    p.add_argument("--steps", type=int, default=1,
                   help="calls per timed repeat")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--single-chip-msps", type=float, default=None,
                   help="single-chip Msamples/s baseline for the "
                        "efficiency ratio (run this script on 1 chip first)")
    p.add_argument("--virtual-devices", type=int, default=None,
                   help="force N virtual CPU devices per process "
                        "(testing only; must precede jax import)")
    return p.parse_args()


def main():
    args = parse_args()
    if args.virtual_devices:
        os.environ["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={args.virtual_devices}"
        )
        os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import jax

    if args.virtual_devices:
        jax.config.update("jax_platforms", "cpu")
    from nx_signal_tpu.parallel import multihost
    from nx_signal_tpu.utils.profiling import configure_compile_cache

    configure_compile_cache()

    multihost.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nx_signal_tpu.models.pipeline import CHAIN_PRECISION
    from nx_signal_tpu.ops.filters import firwin
    from nx_signal_tpu.ops.windows import hann
    from nx_signal_tpu.parallel.mesh import BLOCK_AXIS, CHANNEL_AXIS

    n_dev = jax.device_count()
    n_hosts = jax.process_count()
    frame, hop, nfft, num_taps = 512, 128, 512, 255
    rate = args.rate
    taps = firwin(num_taps, [2000.0], sampling_rate=float(rate))
    window = hann(frame)

    if args.mode == "channel":
        # channel-DP: chips work on disjoint channels, zero communication
        mesh = multihost.make_pod_mesh(n_channel=n_dev)
        channels = args.channels_per_chip * n_dev
        length = int(args.seconds * rate)
        sharding = NamedSharding(mesh, P(CHANNEL_AXIS, None))

        from nx_signal_tpu.models.pipeline import stft_fir_chain

        def step(x):
            return stft_fir_chain(
                x, taps, window, fft_length=nfft,
                overlap_length=frame - hop, sampling_rate=float(rate),
                onesided=True, return_filtered=False, precision=CHAIN_PRECISION,
            )

        # feed process-local channels only
        my_rows = args.channels_per_chip * jax.local_device_count()
        local = np.random.default_rng(jax.process_index()).normal(
            size=(my_rows, length)).astype(np.float32)
        x = jax.make_array_from_process_local_data(sharding, local)
    else:
        # block-SP: ONE stream's time axis across all chips; FIR halos and
        # STFT frame tails cross card (NVLink) and host (network) boundaries
        mesh = multihost.make_pod_mesh(n_channel=1)
        channels = args.channels_per_chip
        block = int(args.seconds * rate)  # per-device block
        length = block * n_dev
        sharding = NamedSharding(mesh, P(CHANNEL_AXIS, BLOCK_AXIS))

        from nx_signal_tpu.parallel.sharded import (
            sharded_fir_framed_dft_power,
        )

        # the FUSED bench chain sharded over the block axis: one halo
        # exchange (FIR context + frame tail), then the identical
        # conv-of-blocks power program per chip — the filtered signal is
        # never materialized anywhere in the pod
        def step(x):
            return sharded_fir_framed_dft_power(
                x, taps, window, mesh=mesh, stride=hop, n_fft=nfft,
                onesided=True, precision=CHAIN_PRECISION,
            )

        start, end = multihost.process_block_range(length, mesh)
        local = np.random.default_rng(jax.process_index()).normal(
            size=(channels, end - start)).astype(np.float32)
        x = jax.make_array_from_process_local_data(sharding, local)

    from nx_signal_tpu.utils.metrics import ThroughputMeter, log_event

    total_samples = channels * length
    step_j = jax.jit(step)
    jax.block_until_ready(step_j(x))  # compile + warm up

    meter = ThroughputMeter(n_devices=n_dev)
    times = []
    for rep in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            out = step_j(x)
        jax.block_until_ready(out)
        rep_dt = (time.perf_counter() - t0) / args.steps
        times.append(rep_dt)
        meter.update(total_samples * args.steps, rep_dt * args.steps)
        if jax.process_index() == 0:
            log_event("pod_bench_repeat", repeat=rep,
                      ms_per_step=round(rep_dt * 1e3, 3),
                      **meter.snapshot())
    dt = sorted(times)[len(times) // 2]

    msps = total_samples / dt / 1e6
    per_chip = msps / n_dev
    eff = (per_chip / args.single_chip_msps
           if args.single_chip_msps else None)
    if jax.process_index() == 0:
        print(json.dumps({
            "metric": "pod_chain_scaling",
            "mode": args.mode,
            "devices": n_dev,
            "hosts": n_hosts,
            "channels": channels,
            "ms_per_step": round(dt * 1e3, 3),
            "msamples_per_s": round(msps, 1),
            "msamples_per_s_per_chip": round(per_chip, 1),
            "efficiency_vs_single_chip":
                round(eff, 4) if eff is not None else None,
        }))
    else:
        print(f"POD_BENCH_OK {jax.process_index()}", file=sys.stderr)


if __name__ == "__main__":
    main()
