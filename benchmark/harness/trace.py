"""A bounded slice of a run under torch.profiler, reduced to what the
per-layer metrics and the result's ``device`` and ``breakdown`` read.

The slice is wrapped in a CPU span ``bench.slice``; the harness's own
spans (``bench.dispatch``, ``bench.resolve``, ...) name what the host
was doing.  The profiler also draws each span on the device's timeline
as a user annotation; those ranges are not device work and are left
out.  From the trace:

  * busy seconds: the union of the device's kernel, copy and set
    intervals inside the slice; the slice's wall seconds;
  * idle gaps: the device's idle intervals inside the slice, each named
    by the innermost harness span and the innermost host operation
    running at its start;
  * device time by operation name, and by kernel for the rooflines.

No Chrome trace is written.
"""

from __future__ import annotations

import dataclasses

SLICE = "bench.slice"


@dataclasses.dataclass
class Interval:
    name: str
    start: float         # seconds, the profiler's clock
    end: float
    device: bool


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: list      # [(name, seconds)], largest first
    idle_gaps: list       # [(name, seconds)], longest first
    kernels: dict         # name -> (seconds, count)

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_ms(self, key: str):
        """Mean device ms a launch of the kernels whose name contains
        ``key`` as a whole word, or None if none ran."""
        secs = count = 0
        for name, (s, n) in self.kernels.items():
            if _has_word(name, key):
                secs += s
                count += n
        return secs * 1e3 / count if count else None


def _has_word(name: str, key: str) -> bool:
    i = name.find(key)
    while i >= 0:
        before = name[i - 1] if i else " "
        after = name[i + len(key)] if i + len(key) < len(name) else " "
        if not (before.isalnum() or before == "_") and not (
                after.isalnum() or after == "_"):
            return True
        i = name.find(key, i + 1)
    return False


def union(spans) -> list:
    """Sorted, merged (start, end) pairs."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarise(intervals: list, top: int = 10) -> Summary:
    """Reduce a slice's intervals (one of them the ``bench.slice`` span)
    to a :class:`Summary`."""
    sl = next(i for i in intervals if not i.device and i.name == SLICE)
    lo, hi = sl.start, sl.end
    dev = [i for i in intervals if i.device and i.end > lo and i.start < hi]
    busy = union((max(i.start, lo), min(i.end, hi)) for i in dev)
    busy_s = sum(e - s for s, e in busy)
    kernels, ops = {}, {}
    for i in dev:
        s, n = kernels.get(i.name, (0.0, 0))
        kernels[i.name] = (s + i.end - i.start, n + 1)
        short = i.name[:96]
        ops[short] = ops.get(short, 0.0) + i.end - i.start
    gaps, t = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    host = sorted((i for i in intervals if not i.device),
                  key=lambda i: i.start)
    named, active, k = [], [], 0
    for s, e in gaps:                       # a sweep: gaps in time order
        while k < len(host) and host[k].start <= s:
            active.append(host[k])
            k += 1
        active = [i for i in active if i.end > s]
        own = sorted(active, key=lambda i: i.start)
        span = [i.name for i in own if i.name.startswith("bench.")]
        op = [i for i in own if not i.name.startswith("bench.")]
        inner = min(op, key=lambda i: i.end - i.start).name if op else ""
        label = (span[-1] if span else "host") + (f":{inner}" if inner
                                                   else "")
        named.append((label[:96], e - s))
    named.sort(key=lambda g: -g[1])
    return Summary(window_s=hi - lo, busy_s=busy_s,
                   device_ops=sorted(ops.items(), key=lambda o: -o[1])[:top],
                   idle_gaps=named[:top], kernels=kernels)


def profile(body) -> Summary:
    """Run body() under torch.profiler inside the ``bench.slice`` span,
    ending in a device synchronise, and summarise the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as prof_ctx

    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            body()
            torch.cuda.synchronize()
    intervals = []
    for e in prof.events():
        device = e.device_type == DeviceType.CUDA
        if device and (getattr(e, "is_user_annotation", False)
                       or e.name.startswith("bench.")):
            continue        # a span's range on the device's timeline
        tr = e.time_range
        intervals.append(Interval(e.name, tr.start * 1e-6, tr.end * 1e-6,
                                  device))
    return summarise(intervals)
