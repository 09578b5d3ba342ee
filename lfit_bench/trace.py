"""Reading the profiler's trace of a traced window: the device's kernels,
its busy and idle time, and what the host did while it idled.

The window runs under ``torch.profiler`` with CPU and CUDA activities,
inside a ``record_function`` range named :data:`WINDOW`; the harness also
marks each step (:data:`STEP`) and each posterior call (:data:`POSTERIOR`).
Events are read from the profiler's kineto results directly, which is
much faster than building its ``FunctionEvent`` tree for the hundreds of
thousands of events of a gradient step.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["WINDOW", "STEP", "POSTERIOR", "Trace", "read_trace"]

WINDOW = "bench.window"
STEP = "bench.step"
POSTERIOR = "bench.posterior"
_NOT_KERNELS = ("Memcpy", "Memset")
_SCAN = 5000


@dataclass
class Trace:
    """A traced window: its span (ns on the profiler's clock), the device
    events in it as (name, start ns, duration ns) and the host's ranges as
    (name, start ns, end ns)."""
    window: tuple
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-9

    def kernels(self, match=None):
        """The device kernels (no copy or set), those whose name holds
        ``match`` where given."""
        return [e for e in self.device
                if not e[0].startswith(_NOT_KERNELS)
                and (match is None or match in e[0])]

    def busy_intervals(self):
        """The union of the device's events, clipped to the window, as
        sorted disjoint (start, end) intervals."""
        w0, w1 = self.window
        spans = sorted((max(s, w0), min(s + d, w1)) for _, s, d in self.device
                       if s + d > w0 and s < w1)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def idle_gaps(self):
        """The window's stretches with nothing on the device, (start,
        end) ns."""
        w0, w1 = self.window
        gaps, t = [], w0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < w1:
            gaps.append((t, w1))
        return gaps

    def device_ops(self, top=10):
        """[[kernel name, seconds]] of the device events that took most
        time in the window, summed by name."""
        by = defaultdict(int)
        for name, _, d in self.device:
            by[_short(name)] += d
        return [[n, d * 1e-9] for n, d in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_by_host(self, top=10):
        """[[what the host was doing, seconds]] of the idle stretches:
        each gap's time goes to the innermost host range open at its
        midpoint (the window itself where none is), summed by name."""
        ranges = sorted(self.host, key=lambda r: r[1])
        starts = [r[1] for r in ranges]
        by = defaultdict(int)
        for s, e in self.idle_gaps():
            mid = 0.5 * (s + e)
            label = WINDOW
            # the latest-starting range open at mid; ranges that closed
            # before it are skipped, at most _SCAN of them
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - _SCAN, -1), -1):
                if ranges[j][2] >= mid:
                    label = _short(ranges[j][0])
                    break
            by[label] += e - s
        return [[n, d * 1e-9] for n, d in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _short(name, n=120):
    return name if len(name) <= n else name[:n - 3] + "..."


def _annotation(ev):
    """True for a user range (``record_function``) rather than work."""
    flag = getattr(ev, "is_user_annotation", None)
    if (flag is not None and flag()) or ev.name() in (WINDOW, STEP,
                                                      POSTERIOR):
        return True
    return "user_annotation" in str(getattr(ev, "activity_type",
                                            lambda: "")()).lower()


def _ns(ev, which):
    fn = getattr(ev, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{which}_us")() * 1000)


def read_trace(prof):
    """The :class:`Trace` of a finished ``torch.profiler.profile``: its
    :data:`WINDOW` range, the device events inside it (kernels, copies and
    sets; the ranges that ``record_function`` mirrors onto the device's
    timeline are not device work) and the host's ranges.  Raises if the
    window range is missing."""
    from torch.autograd import DeviceType

    host, device, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, dur = _ns(ev, "start"), _ns(ev, "duration")
        if ev.device_type() == DeviceType.CUDA:
            if not _annotation(ev):
                device.append((name, start, dur))
        else:
            if name == WINDOW:
                window = (start, start + dur)
            host.append((name, start, start + dur))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} range")
    w0, w1 = window
    device = [d for d in device if d[1] < w1 and d[1] + d[2] > w0]
    host = [h for h in host if h[1] < w1 and h[2] > w0 and h[0] != WINDOW]
    return Trace(window, device, host)
