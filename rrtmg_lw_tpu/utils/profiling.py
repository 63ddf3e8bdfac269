"""Observability: throughput counters, stage timers, device traces.

The reference's only instrumentation is an unused CPU timer
(aer_rt_utils/util_gfortran.f90:169 ``CPUTIM``) and version strings
written to the output footer (rrlw_vsn.f90).  This framework's
equivalents (SURVEY §5):

  * ``ThroughputMeter`` — columns/sec accounting for production serving
    loops, with jax.block_until_ready-accurate wall timing;
  * ``StageTimer`` — named stage timing with warm-up discard, used by
    tools/profile_stages.py and available to users;
  * ``trace`` — context manager around jax.profiler for xprof/
    TensorBoard device traces of the jitted pipeline;
  * ``device_memory_stats`` — HBM usage snapshot per device.

Everything here is host-side and adds zero work inside jit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import jax


def _sync(tree):
    jax.block_until_ready(tree)
    return tree


@dataclasses.dataclass
class ThroughputMeter:
    """Accumulates columns processed / wall seconds across steps.

    Store the step's output in the yielded holder so the meter can
    block on device completion before stopping the clock — otherwise
    only the (microsecond) async dispatch is timed::

        meter = ThroughputMeter()
        for batch in stream:
            with meter.step(ncols=batch.play.shape[0]) as h:
                h["result"] = step_fn(batch)   # synced on exit
        print(meter.columns_per_sec)
    """

    columns: int = 0
    steps: int = 0
    seconds: float = 0.0

    @contextlib.contextmanager
    def step(self, ncols: int, result=None):
        t0 = time.perf_counter()
        holder = {}
        if result is not None:
            holder["result"] = result
        try:
            yield holder
        finally:
            if "result" in holder:
                _sync(holder["result"])
            self.seconds += time.perf_counter() - t0
            self.columns += int(ncols)
            self.steps += 1

    @property
    def columns_per_sec(self) -> float:
        return self.columns / self.seconds if self.seconds else 0.0

    def report(self) -> Dict[str, float]:
        return {"columns": self.columns, "steps": self.steps,
                "seconds": round(self.seconds, 4),
                "columns_per_sec": round(self.columns_per_sec, 1)}


class StageTimer:
    """Per-stage wall timing with device sync and warm-up discard."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times: Dict[str, list] = {}

    def measure(self, name: str, fn, *args, iters: int = 10):
        out = _sync(fn(*args))
        for _ in range(max(self.warmup - 1, 0)):
            _sync(fn(*args))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _sync(out)
        dt = (time.perf_counter() - t0) / iters
        self._times.setdefault(name, []).append(dt)
        return out

    def report(self) -> Dict[str, float]:
        return {k: round(min(v) * 1e3, 3) for k, v in self._times.items()}

    def __str__(self):
        return "\n".join(f"{k:12s} {v:8.3f} ms"
                         for k, v in self.report().items())


@contextlib.contextmanager
def trace(logdir: str = "/tmp/rrtmg_lw_trace",
          host_tracer_level: int = 2):
    """Capture an xprof/TensorBoard device trace of the enclosed block.

    View with ``tensorboard --logdir <logdir>`` (Profile tab) or
    xprofiler.  Wrap a few *warmed-up* steps only; tracing a compile
    produces an unreadable trace.
    """
    opts = jax.profiler.ProfileOptions()
    opts.host_tracer_level = host_tracer_level
    jax.profiler.start_trace(logdir, profiler_options=opts)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """HBM allocation snapshot (bytes) for one device, or None when the
    backend does not expose memory stats (e.g. CPU)."""
    d = device or jax.devices()[0]
    stats = getattr(d, "memory_stats", lambda: None)()
    if not stats:
        return None
    keys = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
    return {k: int(stats[k]) for k in keys if k in stats}
