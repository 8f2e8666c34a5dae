"""The comparison that decides ``correct``: the program's answers against
the plain reference's on the same recordings.

A batch cell keeps, from every batch the window resolved, the rows drawn
from the seed for its pool batch; the reference decodes those
recordings once (front end, SC, CRC-32 select, list-8 on the CRC
failures) and every kept answer is compared with it:

  * ``frames_differ``: answers whose CRC verdict, timing (p0) or sync
    gate differ from the reference's, or whose payload bits differ where
    the reference's CRC passed; exact, limit 0;
  * ``snr_gap_db``: the widest gap of a row's SNR estimate (dB);
  * ``cfo_gap_rad``: the widest gap of the CFO estimate (rad/sample).

A number whose answers never came reads inf.  Each has its limit in the
cell's file, set from the readings that PERF.md gives.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import modem as M
from reference.decode import decode_batch
from reference.frontend import FrontEnd, identity

NUMBERS = ("frames_differ", "snr_gap_db", "cfo_gap_rad")


def reference_answers(cfg: M.Config, config: dict, recs, device,
                      q=identity) -> list:
    """The reference's host dict of each batch's kept recordings."""
    dec = config["decoder"]
    fe = FrontEnd(cfg, device, stride=dec["sync_stride"])
    got = decode_batch(fe, torch.cat(recs), dec["list_size"], q)
    out, r0 = [], 0
    for x in recs:
        out.append({k: v[r0: r0 + x.shape[0]] for k, v in got.items()})
        r0 += x.shape[0]
    return out


def compare(kept: dict, refs: list) -> dict:
    """The numbers of the module docstring over every kept answer."""
    differ, snr, cfo, seen = 0, 0.0, 0.0, 0
    for j, ref in enumerate(refs):
        for got in kept[j]:
            seen += 1
            ok = ref["ok"]
            bad = ((got["ok"] != ok) | (got["p0"] != ref["p0"])
                   | (got["sync_gate"] != ref["sync_gate"])
                   | (ok & (got["bits"] != ref["bits"]).any(axis=1)))
            differ += int(bad.sum())
            snr = max(snr, float(np.abs(got["snr"] - ref["snr"]).max()))
            cfo = max(cfo, float(np.abs(got["cfo_rad"]
                                        - ref["cfo_rad"]).max()))
    if not seen:
        return {k: math.inf for k in NUMBERS}
    return dict(frames_differ=differ, snr_gap_db=snr, cfo_gap_rad=cfo)


def batch_checks(cfg: M.Config, cell: dict, recs, kept: dict, device
                 ) -> dict:
    """{number: (value, limit)} for a batch cell."""
    with torch.no_grad():
        refs = reference_answers(cfg, cell["config"], recs, device)
    got = compare(kept, refs)
    return {k: (got[k], cell["limits"][k]) for k in NUMBERS
            if k in cell["limits"]}
