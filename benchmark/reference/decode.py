"""The batch receiver end to end, plain PyTorch: recordings -> the
answer of each frame, as a batch decoder at list-8 sensitivity gives it.

Every frame is SC-decoded; a frame whose CRC-32 fails is list-decoded
(exact, list ``list_size``) and that result replaces the SC one
(decode.cc:530-555).  ``flips`` counts the payload bits whose channel
hard decision the chosen path overrules.
"""

from __future__ import annotations

import numpy as np
import torch

from .frontend import FrontEnd, identity
from .polar import crc_select, sc_decode, scl_decode

FRONT_BLOCK = 16      # recordings through the front end at a time
SC_BLOCK = 64         # frames SC-decoded at a time
LIST_BLOCK = 16       # frames list-decoded at a time


def decode_batch(fe: FrontEnd, x: torch.Tensor, list_size: int,
                 q=identity) -> dict:
    """Recordings [B, T] -> host dict ok, bits, p0, cfo_rad, snr, flips,
    sync_gate (numpy).  Runs in blocks of rows, so that any B fits."""
    code = fe.code
    sched = code.schedule
    parts = [fe(x[r0: r0 + FRONT_BLOCK], q)
             for r0 in range(0, x.shape[0], FRONT_BLOCK)]
    front = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    llrs = front["llrs"]
    sel = [crc_select(*sc_decode(llrs[r0: r0 + SC_BLOCK], sched, q), code)
           for r0 in range(0, x.shape[0], SC_BLOCK)]
    ok = torch.cat([s[0] for s in sel])
    bits = torch.cat([s[1] for s in sel])
    fails = torch.nonzero(~ok)[:, 0]
    for f0 in range(0, fails.numel(), LIST_BLOCK):
        group = fails[f0: f0 + LIST_BLOCK]
        ok8, bits8 = crc_select(*scl_decode(llrs[group], sched, list_size,
                                            q), code)
        ok[group] = ok8
        bits[group] = bits8
    data_idx = torch.as_tensor(code.info_idx[: code.mode.data_bits],
                               device=x.device)
    flips = ((llrs[:, data_idx] < 0) != bits.bool()).sum(dim=-1)
    host = dict(ok=ok, bits=bits, p0=front["p0"], cfo_rad=front["cfo_rad"],
                snr=front["snr"], flips=flips, sync_gate=front["sync_gate"])
    out = {k: v.cpu().numpy() for k, v in host.items()}
    out["p0"] = out["p0"].astype(np.int64)
    return out
