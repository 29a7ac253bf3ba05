"""The device trace of a slice of a run, reduced in memory.

``torch.profiler`` records the slice (device operations, and the host's
operators and runtime calls that name the idle gaps; a long slice records
the runtime calls alone, whose overhead is smaller); the events are reduced here and never
written out: the seconds in which some operation ran on the device (the
union of their intervals, so overlapping kernels count once), the traced
wall time, the device time of each operation by name, and the longest idle
gaps named by what the host was doing in them.
"""

import bisect
import time

import torch


class DeviceTrace:
    """Context manager over a slice: synchronises at both edges, so that
    ``window_s`` is the slice's wall time and every device operation of the
    slice lies inside it."""

    def __init__(self, host=True):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
        self.prof = profile(activities=acts)
        self.kernels, self.host_ops = [], []
        self.window_s = self.busy_s = 0.0
        self.reduce_s = 0.0

    def __enter__(self):
        torch.cuda.synchronize()
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            t = time.perf_counter()
            self._reduce(self.prof.profiler.kineto_results.events())
            self.reduce_s = time.perf_counter() - t
        return False

    def _reduce(self, events):
        from torch.autograd import DeviceType

        for e in events:
            s = e.start_ns()
            span = (s, s + e.duration_ns(), e.name())
            if e.device_type() != DeviceType.CUDA:
                self.host_ops.append(span)
            elif not getattr(e, "is_user_annotation", lambda: False)():  # not a range
                self.kernels.append(span)
        self.kernels.sort()
        busy, end = 0, None
        for s, t, _ in self.kernels:
            if end is None or s > end:
                busy += t - s
                end = t
            elif t > end:
                busy += t - end
                end = t
        self.busy_s = busy / 1e9

    def by_name(self):
        """``{name: (seconds, launches)}`` of the device operations."""
        out = {}
        for s, t, name in self.kernels:
            sec, n = out.get(name, (0.0, 0))
            out[name] = (sec + (t - s) / 1e9, n + 1)
        return out

    def matching(self, *patterns):
        """Seconds and launches of the operations whose name holds any of ``patterns``."""
        sec = n = 0
        for name, (s, c) in self.by_name().items():
            if any(p in name for p in patterns):
                sec, n = sec + s, n + c
        return sec, n

    def top_ops(self, n=10):
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:120], sec] for name, (sec, _) in ops]

    def idle_gaps(self, n=10):
        """The ``n`` longest gaps between device operations inside the slice,
        each named by the innermost host event (an operator or a runtime
        call) running at its middle, or "host: between operators", and by
        the operation that ended it."""
        gaps, end = [], None
        for s, t, name in self.kernels:
            if end is not None and s > end:
                gaps.append((s - end, end, name))
            end = t if end is None else max(end, t)
        gaps = sorted(gaps, reverse=True)[:n]
        ops = sorted(self.host_ops)
        starts = [o[0] for o in ops]
        out = []
        for length, at, nxt in gaps:
            mid = at + length // 2
            inner = None
            for s, t, name in ops[max(0, bisect.bisect_right(starts, mid) - 2000):
                                  bisect.bisect_right(starts, mid)]:
                if s <= mid <= t and (inner is None or t - s < inner[1] - inner[0]):
                    inner = (s, t, name)
            host = inner[2] if inner else "host: between operators"
            out.append([f"{host[:60]} | before {nxt[:60]}", length / 1e9])
        return out
