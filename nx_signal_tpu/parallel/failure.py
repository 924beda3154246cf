"""Failure detection + elastic recovery for long streaming jobs.

SURVEY.md §5 (failure-detection row): the reference fails fast on bad
options and has nothing else; a multi-host streaming framework needs (a) a
LIVENESS PROBE — in a multi-host job a dead or wedged peer does not error, it
makes the next collective hang forever, so detection is a deadline on a
tiny cross-device reduction — and (b) a RESTART PATH — every op here is
pure, so the only state is the streaming carry, which io/checkpoint.py
already snapshots atomically; recovery is "reload the last carry and
replay from that block".

`heartbeat` is the probe; `run_with_recovery` is the supervised driver
loop gluing probe + checkpoint + replay together. In-process recovery
handles transient failures (preempted device, flaky collective); a killed
process restarts and `run_with_recovery` resumes from the checkpoint file
it finds (fresh-process bitwise resume is tested in
tests/test_checkpoint.py).
"""

import os
import threading
import time

import jax
import jax.numpy as jnp

from nx_signal_tpu.io.checkpoint import load_state, save_state

__all__ = ["FailureDetected", "heartbeat", "run_with_recovery"]


class FailureDetected(RuntimeError):
    """A peer (or the local runtime) failed a liveness probe.

    Examples:

    >>> from nx_signal_tpu.parallel.failure import FailureDetected
    >>> issubclass(FailureDetected, RuntimeError)   # raised by heartbeat()
    True
    """


def _default_probe():
    """Tiny all-device reduction: one scalar per device, psum'd. Any dead
    peer (process or chip) makes this hang or raise."""
    n = jax.device_count()
    xs = [jax.device_put(jnp.ones(()), d) for d in jax.devices()]
    total = sum(float(x) for x in xs)  # pulls every device's scalar
    if jax.process_count() > 1:
        # cross-process probe: a collective over the global mesh
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(jax.devices(), ("d",))
        arr = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P("d")),
            jnp.ones((jax.local_device_count(),)),
        )
        total = float(jnp.sum(arr))
    if total != float(n):
        raise FailureDetected(f"liveness probe summed {total}, expected {n}")


def heartbeat(*, timeout: float = 30.0, probe=None) -> float:
    """Run a liveness probe with a hard deadline; returns elapsed seconds.

    Raises FailureDetected if the probe does not complete within `timeout`
    (a hung collective = dead peer) or raises (a torn-down distributed
    runtime). The probe runs in a daemon thread so a hang cannot block the
    caller past the deadline; a timed-out probe thread is abandoned (the
    process is expected to exit and be restarted by the job scheduler —
    elastic recovery is restart-from-checkpoint, not thread surgery).
    
    Examples:

    >>> from nx_signal_tpu.parallel.failure import heartbeat
    >>> heartbeat(timeout=5.0) >= 0.0   # seconds the all-reduce probe took
    True
    """
    probe = probe or _default_probe
    err = []
    done = threading.Event()

    def run():
        try:
            probe()
        except BaseException as e:  # noqa: BLE001 — report, don't die silently
            err.append(e)
        finally:
            done.set()

    t0 = time.perf_counter()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    if not done.wait(timeout):
        raise FailureDetected(
            f"liveness probe did not complete within {timeout}s "
            "(hung collective — a peer is dead or wedged)"
        )
    if err:
        raise FailureDetected(f"liveness probe failed: {err[0]!r}") from err[0]
    return time.perf_counter() - t0


def run_with_recovery(step_fn, init_state, num_steps: int, *,
                      checkpoint_path, checkpoint_every: int = 10,
                      max_restarts: int = 3, heartbeat_every: int = 0,
                      heartbeat_timeout: float = 30.0, on_restart=None):
    """Supervised streaming loop with checkpoint/replay elastic recovery.

    Runs `state = step_fn(state, step)` for step in [0, num_steps),
    atomically checkpointing the carry every `checkpoint_every` steps
    (io/checkpoint.py). On ANY exception from a step (or a failed
    `heartbeat`, probed every `heartbeat_every` steps when > 0), reloads
    the last checkpoint and replays from its step — up to `max_restarts`
    times, then re-raises. If `checkpoint_path` already exists at entry,
    resumes from it (the process-level restart path: the job scheduler
    relaunches the program and it picks up where the carry left off).

    step_fn must be effectively idempotent per step (pure compute + an
    idempotent sink, e.g. writing block i to file offset i) — replayed
    steps re-run. Returns the final state. `on_restart(step, exc)` is an
    optional callback for logging/metrics.
    
    Examples:

    >>> import tempfile, os
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.parallel.failure import run_with_recovery
    >>> p = os.path.join(tempfile.mkdtemp(), 'ck.npz')
    >>> final = run_with_recovery(lambda s, i: s + 1.0, jnp.zeros(()), 5,
    ...                           checkpoint_path=p, checkpoint_every=2)
    >>> float(final)
    5.0
    """
    start = 0
    state = init_state
    if os.path.exists(checkpoint_path):
        state, meta = load_state(checkpoint_path)
        start = int(meta.get("step", 0))
    restarts = 0
    step = start
    while step < num_steps:
        try:
            if heartbeat_every and step % heartbeat_every == 0:
                heartbeat(timeout=heartbeat_timeout)
            state = step_fn(state, step)
            step += 1
            if step % checkpoint_every == 0 or step == num_steps:
                save_state(checkpoint_path, state, meta={"step": step})
        except Exception as exc:  # noqa: BLE001 — the recovery boundary
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(step, exc)
            if os.path.exists(checkpoint_path):
                state, meta = load_state(checkpoint_path)
                step = int(meta.get("step", 0))
            else:
                state, step = init_state, 0
    return state
