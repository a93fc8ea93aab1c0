"""Structured timing/tracing subsystem (port of mpsfm_tpu/utils/profiling.py).

Replaces the reference's print-based timers (BaseClass.log tstart/tend,
mpsfm/baseclass.py:40-51) with a process-wide phase timer registry plus
optional torch.profiler trace capture. The timers read the host clock
and do not synchronize the device, as in the JAX package: a phase that
ends with device work still queued times its dispatch.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path


class PhaseTimers:
    """Accumulating named wall-clock timers with nesting support."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._stack: list = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        self._stack.append(name)
        try:
            yield
        finally:
            self._stack.pop()
            dt = time.time() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda k: -self.totals[k]):
            lines.append(
                f"{self.totals[name]:9.2f}s x{self.counts[name]:5d}  {name}"
            )
        return "\n".join(lines)

    def to_json(self, path=None):
        data = {
            k: {"total_s": self.totals[k], "count": self.counts[k]} for k in self.totals
        }
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            Path(path).write_text(json.dumps(data, indent=2))
        return data

    def reset(self):
        self.totals.clear()
        self.counts.clear()


TIMERS = PhaseTimers()


@contextlib.contextmanager
def device_trace(log_dir):
    """Capture a torch.profiler trace (CPU and CUDA activities) around a
    block and export it as a Chrome trace into log_dir, in TensorBoard's
    layout (tensorboard_trace_handler)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
