"""The card's peak rates, timing by CUDA events (of calls as the host
issues them, or replayed from a CUDA graph), and the roofline bound that
chip_smoke.py and the probes state beside each kernel time."""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # f32 outside the tensor cores


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean milliseconds a call of fn over reps calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


GRAPH_CALLS = 1000      # calls of fn captured in one CUDA graph
GRAPH_REPLAYS = 3       # timed replays of it


def graph_ms(fn, launched=lambda: 0) -> tuple:
    """(mean milliseconds a call of fn on the device, launches the device
    ran): fn once eagerly (which loads what it launches), then
    :data:`GRAPH_CALLS` calls captured in one CUDA graph (the capture runs
    nothing), replayed once to warm up and :data:`GRAPH_REPLAYS` times
    between CUDA events, so that the host's dispatch does not pace the
    calls.  ``launched()`` reads the launch count of fn's kernel wrapper:
    the launches are what it counted in the eager call, plus what it
    counted while the capture recorded, once for each replay (0 if the
    capture recorded no launch).  fn must allocate nothing it keeps and
    must not synchronise."""
    n0 = launched()
    fn()
    torch.cuda.synchronize()
    n1 = launched()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    n2 = launched()
    graph.replay()
    ms = cuda_ms(graph.replay, GRAPH_REPLAYS) / GRAPH_CALLS
    return ms, (n1 - n0) + (n2 - n1) * (1 + GRAPH_REPLAYS)


def roofline(nbytes: float, operations: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = operations / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "operations": int(operations)}
