"""The traced run's device record: torch.profiler's CUDA activity (kernels,
copies and sets, with CUPTI's timestamps on the host's wall clock) over the
window, and the harness's host spans (the program's TIMERS phases and each
scene), to say what the host did while the device idled."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class HostSpans:
    """Spans (name, start_ns, end_ns) on time.time_ns's clock, the clock of
    the profiler's events."""

    def __init__(self):
        self.spans = []

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def around_phases(self, timers):
        """Record each of the program's TIMERS phases as a span while the
        returned context is open."""
        orig = timers.phase
        spans = self

        @contextlib.contextmanager
        def phase(name):
            with spans.span(name), orig(name):
                yield

        @contextlib.contextmanager
        def ctx():
            timers.phase = phase
            try:
                yield
            finally:
                del timers.phase  # the instance attribute goes; the class's method is back

        return ctx()


def device_events(prof):
    """[(name, start_ns, duration_ns)] of the device's operations."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def merged(intervals):
    """Union of [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceRecord:
    """What the readers take from a traced window: busy seconds, kernel
    seconds by name, and the idle gaps attributed to host spans."""

    def __init__(self, events, spans, t0_ns, t1_ns):
        self.window_s = (t1_ns - t0_ns) / 1e9
        clipped = [(max(s, t0_ns), min(s + d, t1_ns)) for _, s, d in events if s + d > t0_ns and s < t1_ns]
        busy = merged([iv for iv in clipped if iv[1] > iv[0]])
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self.by_name = defaultdict(float)
        for name, _, d in events:
            self.by_name[name] += d / 1e9
        self.outside = sum(1 for _, s, d in events if s < t0_ns or s + d > t1_ns + 10**8)
        gaps, last = [], t0_ns
        for s, e in busy:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if t1_ns > last:
            gaps.append((last, t1_ns))
        self.idle_by_span = defaultdict(float)
        order = sorted(spans, key=lambda sp: sp[1])
        active, k = [], 0
        for s, e in gaps:  # in time order: a sweep over the spans, the open ones few
            mid = (s + e) // 2
            while k < len(order) and order[k][1] <= mid:
                active.append(order[k])
                k += 1
            active = [sp for sp in active if sp[2] > mid]
            name = max(active, key=lambda sp: (sp[1], -sp[2]))[0] if active else "(outside any span)"
            self.idle_by_span[name] += (e - s) / 1e9

    def kernel_s(self, patterns):
        """Device seconds of the kernels whose name holds one of `patterns`."""
        return sum(v for k, v in self.by_name.items() if any(p in k for p in patterns))

    def breakdown(self):
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
