"""Structured metrics & logging: counters, timers, throughput/scaling
meters, and one-JSON-line-per-event structured logs.

SURVEY.md §5 (metrics/logging row): the reference has no observability
layer; this framework's north-star metrics are samples/s,
Msamples/s/chip, and scaling efficiency (BASELINE.md ≥85% row), so those
are first-class here. Used by scripts/pod_bench.py; `bench.py` keeps its
own single-line driver contract.

Not in the reference (extra_applications: [:logger] is never used there,
mix.exs:32).
"""

import json
import sys
import time
from contextlib import contextmanager

import jax

__all__ = ["Metrics", "ThroughputMeter", "log_event"]


def log_event(event: str, *, stream=None, **fields):
    """Emit one structured JSON log line: {"event", "ts", **fields}.
    Values must be JSON-serializable (cast device scalars with float()/int()
    first — never log a live jax.Array, that forces a device sync).

    Examples:

    >>> import io, json
    >>> from nx_signal_tpu.utils.metrics import log_event
    >>> buf = io.StringIO()
    >>> log_event('bench', stream=buf, device='gpu')
    >>> rec = json.loads(buf.getvalue())
    >>> rec['event'], rec['device'], 'ts' in rec
    ('bench', 'gpu', True)
    """
    rec = {"event": event, "ts": round(time.time(), 3)}
    rec.update(fields)
    print(json.dumps(rec), file=stream or sys.stderr, flush=True)


class Metrics:
    """Named counter/gauge/timer registry with JSON snapshots.

    Counters accumulate (`count`), gauges overwrite (`gauge`), timers
    accumulate wall seconds + call counts (`timer` context manager).
    `emit` prints one structured line via `log_event`; `snapshot` returns
    the plain dict for programmatic use.
    
    Examples:

    >>> from nx_signal_tpu.utils.metrics import Metrics
    >>> m = Metrics()
    >>> m.count('frames', 3)
    >>> m.gauge('lag_s', 0.5)
    >>> with m.timer('step'):
    ...     pass
    >>> s = m.snapshot()
    >>> s['frames'], s['lag_s'], s['step_calls']
    (3, 0.5, 1)
    """

    def __init__(self):
        self._counters = {}
        self._gauges = {}
        self._timers = {}  # name -> [seconds, calls]

    def count(self, name: str, value=1):
        self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value):
        self._gauges[name] = value

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            sec, calls = self._timers.get(name, (0.0, 0))
            self._timers[name] = (sec + dt, calls + 1)

    def snapshot(self) -> dict:
        out = {}
        for k, v in self._counters.items():
            out[k] = v
        for k, v in self._gauges.items():
            out[k] = v
        for k, (sec, calls) in self._timers.items():
            out[f"{k}_seconds"] = round(sec, 6)
            out[f"{k}_calls"] = calls
        return out

    def emit(self, event: str = "metrics", *, stream=None, **extra):
        log_event(event, stream=stream, **self.snapshot(), **extra)


class ThroughputMeter:
    """samples/s, Msamples/s/chip, and scaling-efficiency accounting —
    the BASELINE.md counters. Feed it (samples, seconds) per timed step;
    it reports medians-free simple totals (callers time their own medians;
    this aggregates across a run).

    `scaling_efficiency(single_chip_msps)` is per-chip throughput divided
    by the single-chip baseline — the ≥0.85 target from 1 chip → 1 host →
    ≥2 hosts (BASELINE.md).
    
    Examples:

    >>> from nx_signal_tpu.utils.metrics import ThroughputMeter
    >>> tm = ThroughputMeter(n_devices=2)
    >>> tm.update(1_000_000, 0.5)
    >>> tm.samples_per_second, tm.msamples_per_second_per_chip
    (2000000.0, 1.0)
    >>> tm.scaling_efficiency(1.25)   # vs a 1.25 Ms/s/chip single-chip run
    0.8
    """

    def __init__(self, n_devices=None):
        self.n_devices = n_devices if n_devices is not None else jax.device_count()
        self.samples = 0
        self.seconds = 0.0

    def update(self, samples: int, seconds: float):
        self.samples += int(samples)
        self.seconds += float(seconds)

    @property
    def samples_per_second(self) -> float:
        return self.samples / self.seconds if self.seconds else 0.0

    @property
    def msamples_per_second_per_chip(self) -> float:
        return self.samples_per_second / self.n_devices / 1e6

    def scaling_efficiency(self, single_chip_msamples_per_s: float) -> float:
        return self.msamples_per_second_per_chip / single_chip_msamples_per_s

    def snapshot(self) -> dict:
        return {
            "samples": self.samples,
            "seconds": round(self.seconds, 6),
            "samples_per_second": round(self.samples_per_second, 1),
            "msamples_per_second_per_chip": round(
                self.msamples_per_second_per_chip, 3),
            "devices": self.n_devices,
        }
