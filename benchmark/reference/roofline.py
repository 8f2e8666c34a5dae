"""The least time the card could take for one polar-decoder launch,
from the launch's shapes alone, against the published peaks of one
NVIDIA H100 SXM (3.35 TB/s of HBM, 67 TFLOP/s f32 outside the tensor
cores, at its 700 W limit).

Bytes: LLRs in as f32, codewords out as u8 and path metrics out as f32,
each counted once.  Operations, from the frozen schedule of
``modem.build_schedule`` on the code's frozen set, per list lane and
frame: 4 an F column (two magnitudes, a min, a sign product), 2 a G
column, 1 a COMBINE column, 2 a leaf column (a magnitude or relu and a
sum); per frame at a fork, a top-L selection of N candidates costs N
comparisons: 2L at a REP leaf; at an exact RATE1 / SPC leaf each lane's
128 patterns over its 7 least reliable columns add only their set bits
(7 x 64 additions a lane) and the top L of the L x 128 candidates take
L x 128 comparisons.
"""

from __future__ import annotations

import numpy as np

from . import modem as M

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def decoder_bound(sched: M.Schedule, batch: int, lsz: int) -> dict:
    """{bound_ms, bound_by, bytes, operations} of one launch decoding
    ``batch`` frames at list size ``lsz`` (1: SC)."""
    width = sched.ops[:, M.C_WIDTH].astype(np.int64)
    kind = sched.ops[:, M.C_OP]
    lane_ops = (4 * int(width[kind == M.OP_F].sum())
                + 2 * int(width[kind == M.OP_G].sum())
                + int(width[kind == M.OP_COMBINE].sum())
                + 2 * int(width[kind >= M.OP_RATE0].sum()))
    fork_ops = 0
    if lsz > 1:
        fork_ops = int((kind == M.OP_REP).sum()) * 2 * lsz
        fork_ops += int(((kind == M.OP_RATE1) | (kind == M.OP_SPC)).sum()) * (
            lsz * 7 * 64 + lsz * 128)
    n = sched.code_len
    nbytes = batch * (4 * n + lsz * n + 4 * lsz)
    ops = batch * (lsz * lane_ops + fork_ops)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}
