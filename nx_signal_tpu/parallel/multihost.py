"""Multi-host runtime: process initialization and cross-host mesh layout.

Design (SURVEY.md §2.9/§5 — all greenfield; the reference is single-device):

* SPMD single-controller-per-host: every host runs the same program;
  `initialize()` wires jax.distributed so jax.devices() spans the pod slice
  and global arrays shard across hosts.
* Mesh layout: 'block' (time-block sequence parallelism) goes on the
  TRAILING mesh axis so ppermute halo exchange stays between the cards of
  one host (NVLink); 'channel' (no communication) spans hosts over the
  network. `make_pod_mesh` builds this from the global device list.
* Halos cross host boundaries only at the two block-edge devices per host —
  O(filter_length) bytes per step over the network, everything else
  within a host.
* Elastic recovery: streaming jobs checkpoint their carry state (see
  parallel/streaming.py — the carries are small pytrees) and restart from
  the last block boundary; there is no in-flight state anywhere else
  because every op is pure.

This module is exercised on multi-host slices only; on a single process it
degrades to the local mesh (tested via the CPU virtual mesh +
__graft_entry__.dryrun_multichip).
"""

import jax

from nx_signal_tpu.parallel.mesh import BLOCK_AXIS, CHANNEL_AXIS, make_dsp_mesh

__all__ = ["initialize", "make_pod_mesh", "process_block_range"]


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize the multi-host runtime. Call before any other jax API on
    every host.

    With no arguments, attempts jax.distributed.initialize()'s automatic
    cluster detection (SLURM and the other environments JAX knows); if no cluster
    environment is detected this is a warning-free no-op on a plain single
    process, but a detected-yet-failing environment raises rather than
    silently degrading to a host-local mesh (which would zero-fill halos at
    host boundaries). With explicit arguments, initializes exactly as told.

    Examples:

    >>> from nx_signal_tpu.parallel.multihost import initialize
    >>> # must run BEFORE any jax computation initializes the backend
    >>> # (in scripts: initialize() as the first jax call on every host)
    >>> import jax
    >>> jax.process_count()   # single process here, so no cluster to wire
    1
    """
    if num_processes is not None:
        if num_processes > 1:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        return
    try:
        jax.distributed.initialize()
    except ValueError:
        # no cluster auto-detection available: single-process run
        pass


def make_pod_mesh(n_channel: int = 1):
    """('channel', 'block') mesh over ALL devices in the (multi-host) job,
    channel axis first so time-block halos stay within each host.

    Examples:

    >>> from nx_signal_tpu.parallel.multihost import make_pod_mesh
    >>> dict(make_pod_mesh(2).shape)   # all local+remote devices
    {'channel': 2, 'block': 4}
    """
    return make_dsp_mesh(n_channel, jax.device_count() // n_channel)


def process_block_range(total_samples: int, mesh):
    """Half-open [start, end) sample range of the time blocks owned by THIS
    process — for feeding per-host data into a global sharded array with
    jax.make_array_from_process_local_data.

    Examples:

    >>> from nx_signal_tpu.parallel.multihost import make_pod_mesh, process_block_range
    >>> process_block_range(48000, make_pod_mesh(2))  # this process owns all
    (0, 48000)
    """
    n_block = mesh.shape[BLOCK_AXIS]
    block = -(-total_samples // n_block)
    devices = mesh.devices  # (n_channel, n_block) array of Devices
    me = jax.process_index()
    local_ids = sorted(
        b
        for c in range(devices.shape[0])
        for b in range(devices.shape[1])
        if devices[c, b].process_index == me
    )
    if not local_ids:
        return (0, 0)
    return (local_ids[0] * block, min((local_ids[-1] + 1) * block, total_samples))
