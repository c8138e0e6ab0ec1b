"""Profiling and observability helpers.

The reference's only observability hook is a plotting callback invoked
inside the hot loop (src/particleFilter.m:215-217). Here: named trace
scopes per engine phase for `jax.profiler`, and a host-side throughput
meter for the particle-steps/s headline metric (BASELINE.json).
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def phase_annotation(name: str):
    """Named scope visible in device profiler traces."""
    with jax.profiler.TraceAnnotation(name):
        yield


class ThroughputMeter:
    """Accumulates particle-steps and wall time."""

    def __init__(self):
        self.particle_steps = 0
        self.elapsed = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, n_particles: int, n_steps: int):
        self.elapsed += time.perf_counter() - self._t0
        self.particle_steps += n_particles * n_steps
        self._t0 = None

    @property
    def particle_steps_per_s(self) -> float:
        return self.particle_steps / self.elapsed if self.elapsed else 0.0


def trace_to(logdir: str):
    """Context manager: capture a profiler trace viewable in XProf."""
    return jax.profiler.trace(logdir)
