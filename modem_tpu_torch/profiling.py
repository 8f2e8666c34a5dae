"""Observability: a profiler trace context and a per-stage wall timer.

Counterpart of ``modem_tpu/profiling.py``.  The pipelines already return
structured records (``DecodeResult``, the batch dicts); this module adds
the two aids: a ``torch.profiler`` trace of a block, written as a Chrome
trace, and a wall-clock stage timer that charges each stage the device
work it queued.  ``profile_card.py`` and ``chip_smoke.py`` keep their
own timing (CUDA events, ``cuda_ms``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.utils._pytree import tree_leaves


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
        t0 = time.perf_counter()
        try:
            yield stage
        finally:
            for dev in {t.device for t in tree_leaves(stage.out)
                        if isinstance(t, torch.Tensor) and t.is_cuda}:
                torch.cuda.synchronize(dev)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{k:24s} {self.totals[k] * 1e3:9.1f} ms "
                 f"({self.counts[k]}x)"
                 for k in sorted(self.totals, key=self.totals.get,
                                 reverse=True)]
        return "\n".join(lines)
