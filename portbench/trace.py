"""The traced run's device record: every kernel's interval from the
profiler, on the host's wall clock (``time.time_ns``, the clock the
profiler stamps its events with), beside the benchmark's own spans.

Only CUDA activity is recorded: the host side of the record is the
harness's own spans (dispatches, bakes, listener moves), so that the
profiler adds no event per host operator.
"""
from __future__ import annotations


class Tracer:
    def __init__(self):
        self.kernels = []          # (name, start_ns, end_ns)
        self.t0_ns = self.t1_ns = 0
        self._prof = None

    def start(self) -> None:
        """Start recording; the set-up that follows runs under the profiler
        too, so that its first launch of each kernel is not the window's."""
        import time

        import torch
        from torch.profiler import ProfilerActivity, profile
        # a machine without a card (a CPU rehearsal) records no kernels
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU])
        self._prof.start()
        self.t0_ns = time.time_ns()

    def mark(self) -> None:
        """The measured window starts now: the record keeps what follows."""
        import time
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        import time

        import torch
        from torch.autograd import DeviceType
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self._prof.stop()
        for e in self._prof.profiler.kineto_results.events():
            if (e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
                    and e.end_ns() > self.t0_ns):
                self.kernels.append((e.name(), e.start_ns(), e.end_ns()))
        self.kernels.sort(key=lambda k: k[1])
        self._prof = None


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_in(kernels, windows) -> int:
    """Nanoseconds in which a kernel ran inside the windows [(lo, hi)]."""
    import bisect
    cover = merged((k[1], k[2]) for k in kernels)
    starts = [c[0] for c in cover]
    total = 0
    for lo, hi in windows:
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        while i < len(cover) and cover[i][0] < hi:
            total += max(0, min(hi, cover[i][1]) - max(lo, cover[i][0]))
            i += 1
    return total


def breakdown(kernels, host_spans, t0, t1) -> dict:
    """The ten device operations that took most time, and the ten longest
    kinds of idle gap by what the host was doing then. ``host_spans`` is a
    list of span lists, innermost first, each [(label, start_ns, end_ns)]
    without overlaps; a gap inside none is "other"."""
    import bisect
    by_name = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, cur = [], t0
    for s, e in sorted((k[1], k[2]) for k in kernels):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    levels = []
    for spans in host_spans:
        spans = sorted(spans, key=lambda h: h[1])
        levels.append((spans, [h[1] for h in spans]))
    by_host = {}
    for a, b in gaps:
        mid = (a + b) // 2
        label = "other"
        for spans, starts in levels:
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and mid < spans[i][2]:
                label = spans[i][0]
                break
        by_host[label] = by_host.get(label, 0) + (b - a)
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v / 1e9] for n, v in ops],
            "idle_gaps": [[n, v / 1e9] for n, v in idle]}
