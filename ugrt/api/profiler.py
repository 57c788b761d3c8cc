"""Per-stage timing + tracing harness.

The reference instruments every stage with cutil GPU timers and prints
milliseconds to stdout (SURVEY.md §5: per_frame_funcs.h:47-54,
frustum_grid.h:293-302, frustum_tracer.h:47-55, decision_data.h:173-267,
shader.h:77-85).  The equivalents here:

* `StageTimer` — wall-clock stage timing with block_until_ready
  bracketing (the analog of cudaThreadSynchronize around each launch);
* `trace_to` — a jax.profiler trace context producing TensorBoard-
  compatible traces for deep dives (XLA op-level, the structured profile
  the reference never had).
"""

from __future__ import annotations

import contextlib
import time

import jax


class StageTimer:
    """Accumulates per-stage wall-clock timings across frames."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result_holder=None):
        t0 = time.perf_counter()
        yield
        if result_holder is not None:
            jax.block_until_ready(result_holder)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def time_stage(self, name: str, fn, *args, **kwargs):
        """Run fn, block on its outputs, record the stage time."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return out

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:32s} {total * 1000 / n:9.2f} ms/call x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_to(logdir: str):
    """jax.profiler trace context (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
