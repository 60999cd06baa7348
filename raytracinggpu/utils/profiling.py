"""Tracing / profiling utilities.

The reference's observability is wall-clock chrono prints around the render
section (cpu_launcher.cpp:660,721-723; optimized.cu:783,879-881) plus ad-hoc
nvprof artifacts implied by .gitignore (SURVEY.md §5).  The equivalents
here: phase timers, jax.profiler traces (xplane/perfetto), and
per-frame ray statistics derived from the integrator's wavefront masks.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class PhaseTimer:
    """Named wall-clock phases (host-side; call .block() on device values
    before stopping a phase for honest device timing)."""

    phases: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k}: {v:.3f}s ({v/total:.0%})" for k, v in self.phases.items()]
        return " | ".join(lines)


@contextlib.contextmanager
def device_trace(out_dir: str | None):
    """jax.profiler trace wrapper; no-op when out_dir is None.  View with
    tensorboard or perfetto."""
    if out_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def ray_report(stats, spp: int, width: int, height: int, wall_s: float) -> dict:
    """Per-frame ray statistics from the integrator's TraceStats (the
    'metrics fall out of the wavefront masks for free' item, SURVEY.md §5)."""
    import numpy as np

    hit = np.asarray(stats.hit, np.int64)
    diffuse = np.asarray(stats.diffuse, np.int64)
    primary = width * height * spp
    bounce = int(hit.sum())
    shadow = int(diffuse.sum())
    total = primary + bounce + shadow
    return {
        "primary_rays": primary,
        "bounce_rays": bounce,
        "shadow_rays": shadow,
        "total_rays": total,
        "mrays_per_sec": total / wall_s / 1e6 if wall_s > 0 else 0.0,
        "bounce_histogram": hit.tolist(),
        "tir_histogram": np.asarray(stats.tir).tolist(),
        "shadowed_histogram": np.asarray(stats.shadowed).tolist(),
    }
