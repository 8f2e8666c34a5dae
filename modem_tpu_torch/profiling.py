"""Observability: spans and counters on the profiler's clock, a profiler
trace context and a per-stage wall timer.

Counterpart of ``modem_tpu/profiling.py``.  The pipelines already return
structured records (``DecodeResult``, the batch dicts); this module adds

  * :func:`span` and :func:`wait`, the program's own ranges, recorded
    exactly while ``torch.profiler`` records (``device_trace``, or any
    other profiler a caller opens) and free of allocation otherwise: a
    ``record_function`` range of the same name in the profiler's trace,
    on the clock of the kernels it launched, and a :class:`SpanRecord`
    in memory (:func:`spans`, :func:`clear_spans`);
  * the counters :data:`syncs` (the points at which the host thread
    waits for the card; every one goes through :func:`wait`) and
    :data:`osd_steps` (n = 255 for each ``fec.osd.osd_decode`` call on
    either device: the columns of its elimination, not those the card's
    kernel walks; the benchmark harness labels header feeds by it),
    always on, plain ints as the kernels' ``launches`` are;
  * :func:`device_trace`, a ``torch.profiler`` trace of a block written
    as a Chrome trace, and :class:`StageTimer`, a wall-clock stage timer
    that charges each stage the device work it queued.

``profile_card.py`` and ``chip_smoke.py`` keep their own timing (CUDA
events, ``cuda_ms``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._pytree import tree_leaves

syncs = 0        # host waits for the card, one a wait() (always counted)
osd_steps = 0    # 255 an fec.osd.osd_decode call, on either device

# the counters whose deltas a span records (the keys of SpanRecord.counts)
COUNTERS = ("syncs", "osd_steps", "sc_launches", "scl_launches",
            "osd_launches")

_records: list = []
_local = threading.local()            # the open spans of this thread
_ids = itertools.count(1)
_requests = itertools.count(1)
_NULL = contextlib.nullcontext()


def _counts() -> tuple:
    from .kernels.osd_eliminate import osd_eliminate
    from .kernels.sc_decode import sc_decode
    from .kernels.scl_decode import scl_decode
    return (syncs, osd_steps, sc_decode.launches, scl_decode.launches,
            osd_eliminate.launches)


@dataclasses.dataclass(eq=False)
class SpanRecord:
    """One span: its name, id, the id of the span open around it (None
    at the top), the request it belongs to (every span of one batch or
    one ``decode`` call shares it), host start and end
    (``time.perf_counter_ns``), whether it is a :func:`wait`, the deltas
    of :data:`COUNTERS` over it, and with ``device`` on the card its two
    timing events."""

    name: str
    id: int
    parent: int | None
    request: int
    start_ns: int = 0
    end_ns: int = 0
    wait: bool = False
    counts: dict = dataclasses.field(default_factory=dict)
    events: tuple | None = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> float | None:
        """Stream ms between the span's events, None without them.  Read
        it after the caller's synchronise: an event not yet reached
        raises."""
        if self.events is None:
            return None
        start, end = self.events
        return start.elapsed_time(end)


class _Span:
    __slots__ = ("name", "device", "request", "wait", "rec", "rf", "c0")

    def __init__(self, name, device, request, wait):
        self.name, self.device = name, device
        self.request, self.wait = request, wait

    def __enter__(self) -> SpanRecord:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        request = self.request
        if request is None:
            request = parent.request if parent else next(_requests)
        rec = self.rec = SpanRecord(self.name, next(_ids),
                                    parent.id if parent else None, request,
                                    wait=self.wait)
        _records.append(rec)
        stack.append(rec)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.c0 = _counts()
        if self.device is not None and self.device.type == "cuda":
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(torch.cuda.current_stream(self.device))
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> None:
        rec = self.rec
        rec.end_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(self.device))
        rec.counts = dict(zip(COUNTERS, (b - a for a, b in zip(
            self.c0, _counts()))))
        self.rf.__exit__(*exc)
        _local.stack.pop()


def tracing() -> bool:
    """True exactly while ``torch.profiler`` records: the module flag
    behind ``torch.autograd._profiler_enabled()``, cheaper to read."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, *, device=None, request: int | None = None):
    """A context manager around one stage of the program, recorded only
    while ``torch.profiler`` records (:func:`tracing`); otherwise one flag
    read and a shared null context.  On, it yields its
    :class:`SpanRecord` (None when off): a ``record_function`` range
    ``name`` in the profiler's trace, and a record in :func:`spans`.
    ``device``: the torch device whose current stream gets two timing
    events at the span's edges (a CUDA device; nothing on the CPU), read
    later by ``SpanRecord.device_ms``.  ``request``: the request id to
    join (a batch's resolve joins its dispatch); by default the enclosing
    span's, or a new one at the top."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, None if device is None else torch.device(device),
                 request, False)


def wait(name: str):
    """A point at which the host thread waits for the card (an event or
    stream synchronise, a copy to the host, a blocking upload of host
    data, ``.item()``, a ``nonzero``): adds one to :data:`syncs`, also
    when the same code runs on the CPU, and while tracing is a span
    marked as a wait."""
    global syncs
    syncs += 1
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, None, None, True)


def upload(name: str, data, device):
    """:func:`wait` for copying ``data`` to ``device`` where the copy
    blocks the host: ``data`` is not yet a tensor on that kind of device
    (host values, numpy arrays, CPU tensors bound for the card); a null
    context otherwise."""
    if (isinstance(data, torch.Tensor)
            and data.device.type == torch.device(device).type):
        return _NULL
    return wait(name)


def spans() -> list:
    """The spans recorded since the last :func:`clear_spans`, in the
    order they opened."""
    return list(_records)


def clear_spans() -> None:
    _records.clear()


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Trace the enclosed block with ``torch.profiler`` (CPU and CUDA
    activities on a card, the CPU alone with ``device="cpu"``) and write
    it into ``log_dir`` as ``trace_<pid>_<ns>.json``, a Chrome trace
    (chrome://tracing or Perfetto), also when the block raises.  Yields
    the profiler (``key_averages()`` for sums by operator)."""
    device = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device to trace: pass device='cpu' "
                               "to trace the host alone")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    clear_spans()
    try:
        with prof:
            try:
                yield prof
            finally:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
    finally:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Accumulates blocking wall-clock per named stage.

    Usage:
        timer = StageTimer()
        with timer("sync") as stage:
            stage.out = sync_fn(x)
    On exit the context synchronises the device of every CUDA tensor in
    ``stage.out`` (a tensor, or nested lists, tuples and dicts of them),
    so device work is charged to the stage that queued it and not to
    whichever later stage happens to wait first.  Host values (numpy
    arrays, numbers) and CPU tensors need no wait.
    """

    class _Stage:
        __slots__ = ("out",)

        def __init__(self):
            self.out = None

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        stage = self._Stage()
        with span(name):
            t0 = time.perf_counter()
            try:
                yield stage
            finally:
                for dev in {t.device for t in tree_leaves(stage.out)
                            if isinstance(t, torch.Tensor) and t.is_cuda}:
                    with wait(name + ".sync"):
                        torch.cuda.synchronize(dev)
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{k:24s} {self.totals[k] * 1e3:9.1f} ms "
                 f"({self.counts[k]}x)"
                 for k in sorted(self.totals, key=self.totals.get,
                                 reverse=True)]
        return "\n".join(lines)
