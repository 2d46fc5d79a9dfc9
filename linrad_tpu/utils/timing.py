"""Per-stage timing and workload telemetry.

The reference accounts per-thread CPU time at ~1 Hz (thread_workload[],
menu.c:914-957; lir_get_thread_time lxsys.c:383; T-display timing.c:361,
z_TIMING.txt).  The equivalent here measures jitted-step wall time with
``block_until_ready`` probes and reports samples/s and realtime factor —
the numbers that replace the on-screen workload percentages."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax


@dataclass
class StepTimer:
    """Collects per-step timings; use around the jitted step call."""

    sample_rate: float
    samples_per_step: int
    _times: list = field(default_factory=list)
    _t0: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, *arrays) -> float:
        for a in arrays:
            jax.block_until_ready(a)
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        return dt

    @property
    def mean_step_s(self) -> float:
        t = self._times[1:] or self._times  # skip compile step
        return sum(t) / max(len(t), 1)

    @property
    def samples_per_second(self) -> float:
        return self.samples_per_step / max(self.mean_step_s, 1e-12)

    @property
    def realtime_factor(self) -> float:
        """>1 means faster than the A/D produces samples (the headroom
        the reference's workload % expresses inversely)."""
        return self.samples_per_second / self.sample_rate

    def report(self) -> dict:
        return {
            "steps": len(self._times),
            "mean_step_ms": 1e3 * self.mean_step_s,
            "msamples_per_s": self.samples_per_second / 1e6,
            "realtime_factor": self.realtime_factor,
        }


def profile_stages(fns: dict, repeats: int = 10) -> dict:
    """Time a dict of name -> zero-arg callables returning jax arrays
    (per-stage cost attribution, the per-thread CPU% analog)."""
    out = {}
    for name, fn in fns.items():
        jax.block_until_ready(fn())  # compile
        t0 = time.perf_counter()
        for _ in range(repeats):
            r = fn()
        jax.block_until_ready(r)
        out[name] = (time.perf_counter() - t0) / repeats
    return out
