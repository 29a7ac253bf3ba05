"""The arithmetic of the per-layer metrics read from the program's own
spans (``ccvs_tpu_torch.utils.profiling``), joined with the device trace of
the same slice.

The program records its spans while ``torch.profiler`` records (a root
span opened under a profiler turns its tracer on), stamped on the clock of
the profiler's host records. The join: each device operation carries the
correlation id of the CUDA API call that launched it (a kernel,
copy, memset or graph launch, on the host); a span holds the operations
whose launch call began inside it. A run's readings (``readings()`` of
its entry) give the device trace (``trace``, ``tracer.DeviceTrace``),
whose profiler still holds the slice's events; they are read again here,
once a run.

Each metric returns None where there is nothing to read: a program
without the tracer, no spans of the name, or no trace.
"""

import bisect
import statistics

K2 = "flash_decode_kernel"
H2D = "Memcpy HtoD"
# the host calls that put work on the device (``cuda*`` and ``cu*`` API calls)
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")


def is_launch(name):
    return name.startswith("cu") and any(w in name for w in LAUNCH_WORDS)


def program_spans(r):
    """The spans the program recorded in the run, or None: ``(name,
    start_ns, end_ns, parent, root)`` each, in the order they opened."""
    if "program_spans" not in r:
        from ccvs_tpu_torch.utils import profiling

        read = getattr(profiling, "spans", None)  # a program before the tracer has none
        r["program_spans"] = (read() or None) if read is not None else None
    return r["program_spans"]


def kineto_records(trace):
    """``(name, on_device, start_ns, end_ns, correlation)`` of each device
    operation and each launch call of the traced slice."""
    from torch.autograd import DeviceType

    out = []
    for e in trace.prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        name = e.name()
        if on_device:
            if e.is_user_annotation():
                continue
        elif not is_launch(name):
            continue
        s = e.start_ns()
        out.append((name, on_device, s, s + e.duration_ns(), e.correlation_id()))
    return out


class Joined:
    """The program's spans and the slice's device operations and launch
    calls, each operation with the start of the call that launched it."""

    def __init__(self, spans, records):
        self.spans = [s for s in spans if s[2] is not None]
        launch_start = {c: s for _, dev, s, _, c in records if not dev}
        self.launches = sorted((s, t) for _, dev, s, t, _ in records if not dev)
        # (start, end, name, start of its launch call or None), by start
        self.ops = sorted((s, t, name, launch_start.get(c))
                          for name, dev, s, t, c in records if dev)

    def named(self, name):
        """The intervals of the spans ``name``, by start."""
        return sorted((s[1], s[2]) for s in self.spans if s[0] == name)

    def launched_in(self, name):
        """The device operations whose launch call began inside a span
        ``name``, grouped by span: ``[[(start, end, op name), ...], ...]``."""
        spans = self.named(name)
        starts = [s for s, _ in spans]
        groups = [[] for _ in spans]
        for s, t, op, at in self.ops:
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][1]:
                groups[i].append((s, t, op))
        return groups

    def launch_calls_in(self, name):
        """The number of launch calls that began and ended inside a span
        ``name``."""
        spans = self.named(name)
        starts = [s for s, _ in spans]
        n = 0
        for s, t in self.launches:
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and t <= spans[i][1]
        return n

    def busy_ns(self, lo, hi):
        """The union of the device operations' intervals inside ``[lo, hi]``."""
        return union_ns((max(s, lo), min(t, hi)) for s, t, _, _ in self.ops if s < hi and t > lo)


def union_ns(intervals):
    """The length of the union of ``(start, end)`` intervals."""
    busy, end = 0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            busy, end = busy + t - s, t
        elif t > end:
            busy, end = busy + t - end, t
    return busy


def joined(r):
    """The run's spans joined with its trace, made once and kept in ``r``;
    None without spans or a trace."""
    if "program_joined" not in r:
        spans, trace = program_spans(r), r.get("trace")
        ok = spans is not None and trace is not None and trace.kernels
        r["program_joined"] = Joined(spans, kineto_records(trace)) if ok else None
    return r["program_joined"]


# ---------------------------------------------------------------- metrics


def host_ms(r, name):
    """The median host duration of the spans ``name``, ms."""
    spans = program_spans(r)
    times = [(s[2] - s[1]) / 1e6 for s in spans or () if s[0] == name and s[2] is not None]
    return statistics.median(times) if times else None


def launches_per_step(r, step="tokens.step"):
    """The launch calls made inside the spans ``step`` over their number;
    None unless K2's operations launched inside them are the
    ``k2_launches`` the traffic's positions give (else the join has missed
    some)."""
    j = joined(r)
    if j is None or not j.named(step):
        return None
    k2 = sum(1 for ops in j.launched_in(step) for op in ops if K2 in op[2])
    if k2 != r.get("k2_launches"):
        return None
    return j.launch_calls_in(step) / len(j.named(step))


def idle_share_in(r, name):
    """The share of a span ``name``'s interval in which no device operation
    ran, %: from the span's start to the end of the last operation launched
    inside it; the median over the spans."""
    j = joined(r)
    if j is None:
        return None
    shares = []
    for (lo, _), ops in zip(j.named(name), j.launched_in(name)):
        if ops:
            hi = max(t for _, t, _ in ops)
            shares.append(100.0 * (1.0 - j.busy_ns(lo, hi) / (hi - lo)))
    return statistics.median(shares) if shares else None


def device_ms_in(r, name):
    """The union of the device intervals of the operations launched inside
    a span ``name``, ms; the median over the spans."""
    j = joined(r)
    if j is None:
        return None
    times = [union_ns((s, t) for s, t, _ in ops) / 1e6 for ops in j.launched_in(name) if ops]
    return statistics.median(times) if times else None


def copies_per_step(r, within=("train.encode", "train.step"), step="train.step"):
    """The host-to-device copies launched inside the spans ``within``, over
    the number of spans ``step``."""
    j = joined(r)
    if j is None or not j.named(step):
        return None
    n = sum(1 for name in within for ops in j.launched_in(name) for op in ops
            if op[2].startswith(H2D))
    return n / len(j.named(step))
