"""What the per-layer metric readers see of a run, and the helpers they
share."""

from __future__ import annotations

import dataclasses
import statistics

import torch

from reference import modem as M
from reference.roofline import decoder_bound

from .trace import Summary


@dataclasses.dataclass
class Run:
    """A run as its per-layer metrics read it, after the traced slice:
    the cell, the program's object (``pipe``: the AdaptivePipeline or the
    Decoder) and pool, the harness's spans over the slice (name ->
    seconds), the window's counters, and the slice's trace (None off the
    card)."""

    cell: dict
    cfg: M.Config
    device: torch.device
    pipe: object
    pool: list
    spans: dict
    counters: dict
    trace: Summary | None = None


def mean_ms(run, span: str):
    """Mean host ms of a harness span over the traced slice."""
    values = run.spans.get(span) or []
    return statistics.fmean(values) * 1e3 if values else None


def roofline_pct(run, kernel: str, batch: int, lsz: int):
    """100 x the launch's least time over the kernel's mean device ms a
    launch in the traced slice; None where the slice ran no launch."""
    if run.trace is None:
        return None
    ms = run.trace.kernel_ms(kernel)
    if not ms:
        return None
    sched = M.Code(run.cfg.mode).schedule
    return 100.0 * decoder_bound(sched, batch, lsz)["bound_ms"] / ms
