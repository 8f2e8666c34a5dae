"""The card's peak rates, timing by CUDA events, and the roofline bound
that chip_smoke.py and the probes state beside each kernel time."""

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


def roofline(nbytes: float, operations: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = operations / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "operations": int(operations)}
