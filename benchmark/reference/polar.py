"""Polar decoding and the CRC-32 select, plain PyTorch on any device.

SC and the exact list-L SCL decoder walk the Fast-SSC row schedule of
``modem.build_schedule`` one row at a time, each row a few tensor ops
over the batch (and the list lanes) and the row's columns.  Leaves:
RATE0 (all zero, metric of the negative LLRs), REP (the cheaper of all
+1 and all -1), RATE1 (hard decisions), SPC (hard decisions, the least
reliable one flipped on odd parity).  The list decoder forks a RATE1 or
SPC leaf in one shot over every subset of its 7 least reliable columns
(the L best of the L x 128 candidates, lowest index first on ties) and
a REP leaf over its two words; lanes share their ancestors' buffers
through a lane map a depth.  ``q`` rounds each row's output (the
control's bfloat16); the identity for the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import modem as M
from .frontend import identity

BIG = 3.0e38
PAT7 = ((np.arange(128)[None, :] >> np.arange(7)[:, None]) & 1
        ).astype(np.float32)
SPAR7 = (PAT7.sum(axis=0) % 2).astype(np.float32)


def sc_decode(llrs: torch.Tensor, sched: M.Schedule, q=identity):
    """llrs [B, n] f32 -> (codewords [B, 1, n] uint8, metrics [B, 1])."""
    batch, n = llrs.shape
    dev = llrs.device
    llr = torch.zeros(batch, sched.sz_llr, device=dev)
    llr[:, :n] = llrs
    beta = torch.zeros(batch, sched.sz_beta, device=dev)
    pm = torch.zeros(batch, device=dev)
    rows = torch.arange(batch, device=dev)
    for row in sched.ops.tolist():
        op, w = row[M.C_OP], row[M.C_WIDTH]
        a = llr[:, row[M.C_SRC]: row[M.C_SRC] + w]
        if op in (M.OP_F, M.OP_G):
            b = llr[:, row[M.C_SRC2]: row[M.C_SRC2] + w]
            if op == M.OP_F:
                out = torch.sign(a) * torch.sign(b) * torch.minimum(
                    a.abs(), b.abs())
            else:
                out = b + beta[:, row[M.C_BSRC]: row[M.C_BSRC] + w] * a
            llr[:, row[M.C_DST]: row[M.C_DST] + w] = q(out)
            continue
        bdst = beta[:, row[M.C_BDST]: row[M.C_BDST] + w]
        if op == M.OP_COMBINE:
            bl = beta[:, row[M.C_BSRC]: row[M.C_BSRC] + w]
            br = beta[:, row[M.C_BSRC2]: row[M.C_BSRC2] + w]
            bdst.copy_(bl * br)
            beta[:, row[M.C_DST]: row[M.C_DST] + w] = br
        elif op == M.OP_RATE0:
            pm = q(pm + torch.relu(-a).sum(dim=1))
            bdst.fill_(1.0)
        elif op == M.OP_REP:
            m0 = torch.relu(-a).sum(dim=1)
            m1 = torch.relu(a).sum(dim=1)
            pm = q(pm + torch.minimum(m0, m1))
            bdst.copy_(torch.where(m1 < m0, -1.0, 1.0)[:, None].expand(-1, w))
        elif op == M.OP_RATE1:
            bdst.copy_(torch.where(a < 0, -1.0, 1.0))
        else:                                            # SPC
            hard = torch.where(a < 0, -1.0, 1.0)
            odd = (a < 0).sum(dim=1) % 2 == 1
            v0, i0 = a.abs().min(dim=1)
            pm = q(pm + torch.where(odd, v0, 0.0))
            hard[rows, i0] *= torch.where(odd, -1.0, 1.0)
            bdst.copy_(hard)
    cw = beta[:, sched.out_off: sched.out_off + n] < 0
    return cw.to(torch.uint8)[:, None, :], pm[:, None]


def _lanes(buf, lanes, off: int, w: int):
    return buf[:, :, off: off + w].gather(1, lanes[:, :, None].expand(-1, -1, w))


def _first(x, k: int):
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _oneshot(a, pm, spc: bool):
    """The exact fork of a RATE1 / SPC leaf: a [B, L, w] -> (betas
    [B, L, w], source lanes [B, L], metrics [B, L])."""
    batch, lsz, w = a.shape
    dev = a.device
    t, fl0 = (8, 1) if spc else (7, 0)
    mag = torch.full((batch, lsz, M.CHUNK), BIG, device=dev)
    mag[..., :w] = a.abs()
    vals, idxs = _first(mag, t)
    pat7 = torch.as_tensor(PAT7, device=dev)
    spar = torch.as_tensor(SPAR7, device=dev) > 0.5
    subs = torch.zeros(batch, lsz, 128, device=dev)
    for j in range(7):
        subs = subs + vals[..., fl0 + j, None] * pat7[j]
    cand = pm[..., None] + subs
    odd = None
    if spc:
        odd = (a < 0).sum(dim=-1) % 2 == 1
        cand = cand + torch.where(odd[..., None] ^ spar, vals[..., :1], 0.0)
    pm_new, order = _first(cand.reshape(batch, lsz * 128), lsz)
    src, pat = order // 128, order % 128
    b = torch.where(a < 0, -1.0, 1.0).gather(
        1, src[..., None].expand(-1, -1, w))
    idx_s = idxs.gather(1, src[..., None].expand(-1, -1, t))
    bits = pat7.T[pat]
    col = torch.arange(w, device=dev)
    flip = torch.zeros(batch, lsz, w, device=dev)
    for j in range(7):
        flip = flip + bits[..., j, None] * (col == idx_s[..., fl0 + j, None])
    if spc:
        i0 = odd.gather(1, src) ^ spar[pat]
        flip = flip + i0[..., None] * (col == idx_s[..., :1])
    return torch.where(flip > 0.5, -b, b), src, pm_new


def scl_decode(llrs: torch.Tensor, sched: M.Schedule, list_size: int,
               q=identity):
    """Exact list decode: llrs [B, n] -> (codewords [B, L, n] uint8,
    metrics [B, L])."""
    batch, n = llrs.shape
    lsz = list_size
    dev = llrs.device
    llr = torch.zeros(batch, lsz, sched.sz_llr, device=dev)
    llr[:, :, :n] = llrs[:, None, :]
    beta = torch.zeros(batch, lsz, sched.sz_beta, device=dev)
    ident = torch.arange(lsz, device=dev)
    refs = ident.repeat(batch, sched.n_depths, 1)
    brefs = ident.repeat(batch, 2 * sched.n_depths, 1)
    pm = torch.full((batch, lsz), BIG / 2, device=dev)
    pm[:, 0] = 0.0
    for row in sched.ops.tolist():
        op, d, w = row[M.C_OP], row[M.C_D], row[M.C_WIDTH]
        last = row[M.C_LAST] > 0
        if op in (M.OP_F, M.OP_G):
            a = _lanes(llr, refs[:, d], row[M.C_SRC], w)
            b = _lanes(llr, refs[:, d], row[M.C_SRC2], w)
            if op == M.OP_F:
                out = torch.sign(a) * torch.sign(b) * torch.minimum(
                    a.abs(), b.abs())
            else:
                out = b + _lanes(beta, brefs[:, row[M.C_SIDR]],
                                 row[M.C_BSRC], w) * a
            llr[:, :, row[M.C_DST]: row[M.C_DST] + w] = q(out)
            if last:
                refs[:, d + 1] = ident
            continue
        bdst = beta[:, :, row[M.C_BDST]: row[M.C_BDST] + w]
        src = None
        if op == M.OP_COMBINE:
            bl = _lanes(beta, brefs[:, row[M.C_SIDR]], row[M.C_BSRC], w)
            br = _lanes(beta, brefs[:, row[M.C_SIDR2]], row[M.C_BSRC2], w)
            bdst.copy_(bl * br)
            beta[:, :, row[M.C_DST]: row[M.C_DST] + w] = br
        else:
            a = _lanes(llr, refs[:, d], row[M.C_SRC], w)
            if op == M.OP_RATE0:
                pm = q(pm + torch.relu(-a).sum(dim=-1))
                bdst.fill_(1.0)
            elif op == M.OP_REP:
                m0 = torch.relu(-a).sum(dim=-1)
                m1 = torch.relu(a).sum(dim=-1)
                pm, order = _first(torch.cat([pm + m0, pm + m1], dim=1), lsz)
                pm = q(pm)
                src = order % lsz
                sign = torch.where(order >= lsz, -1.0, 1.0)
                bdst.copy_(sign[..., None].expand(-1, -1, w))
            else:
                b2, src, pm = _oneshot(a, pm, op == M.OP_SPC)
                pm = q(pm)
                bdst.copy_(b2)
        if src is not None:
            refs = refs.gather(2, src[:, None, :].expand_as(refs))
            brefs = brefs.gather(2, src[:, None, :].expand_as(brefs))
        if last:
            brefs[:, row[M.C_SIDW]] = ident
    cw = beta[:, :, sched.out_off: sched.out_off + n] < 0
    return cw.to(torch.uint8), pm


def crc_select(codewords, pm, code: M.Code):
    """Lowest-metric path whose CRC-32 holds (decode.cc:530-555):
    codewords [B, L, n], pm [B, L] -> (ok [B], data bits [B, data_bits])."""
    mode = code.mode
    idx = torch.as_tensor(code.info_idx[: mode.crc_bits],
                          device=codewords.device)
    info = codewords[..., idx]
    mat = torch.as_tensor(code.crc_matrix, dtype=torch.float64,
                          device=codewords.device)
    rem = torch.remainder(info.to(torch.float64) @ mat, 2.0)
    crc_ok = rem.sum(dim=-1) == 0
    best = torch.where(crc_ok, pm, math.inf).argmin(dim=-1)
    rows = torch.arange(info.shape[0], device=info.device)
    return crc_ok.any(dim=-1), info[rows, best, : mode.data_bits]
