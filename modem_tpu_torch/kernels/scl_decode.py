"""Successive-cancellation list (SCL) decoding of a polar code: the CUDA
kernel ``csrc/scl_decode.cu`` and its plain PyTorch version, in two modes.

Counterpart of ``modem_tpu/kernels/scl_pallas.make_pallas_decoder(
frozen, list_size, exact)`` and of the VM it is pinned against,
``modem_tpu/fec/scl_vm.make_decoder(frozen, list_size, exact)``.  Both
run the SPC-leaf schedule of :func:`fec.schedule.build_schedule` over L
list lanes:

- F, G and COMBINE read through per-depth lane maps ``refs`` and
  per-slot maps ``brefs`` and write lane-dense (Tal-Vardy lazy copy:
  a fork permutes the maps, never the buffers);
- RATE0 adds its penalty and writes +1;
- REP forks each lane into keep / flip and keeps the L best of 2L;
- ``exact=True`` (kernel B): RATE1 and SPC fork in one shot: every
  subset of a lane's 7 least reliable positions (SPC: the 8 least
  reliable, the first one taking the parity) is a candidate, and the L
  best of L x 128 survive;
- ``exact=False`` (kernel C, Fast-SSC-List): RATE1 forks in
  ``T_RATE1`` = 4 serial rounds over each lane's next least reliable
  position; SPC fixes the parity on the least reliable position and
  forks in 3 rounds on exclusive pair flips, at most one a path.

Selections order candidates by (path metric, index), lowest index first
on ties, as ``lax.top_k`` does.  Lane 0 starts live and the clones at
``BIG / 2``.  Outputs keep the JAX shapes: codewords [B, L, code_len]
uint8 read from the physical rows of the root slot, and path metrics
[B, L] f32 in lane order.

:func:`scl_decode` is the wrapper the pipeline calls.  A CUDA tensor
launches the kernel (or raises); a CPU tensor takes
:func:`scl_decode_reference`, which runs the same rows as a Python loop
vectorised over the batch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..fec.schedule import (C_BDST, C_BSRC, C_BSRC2, C_D, C_DST, C_LAST,
                            C_OP, C_SIDR, C_SIDR2, C_SIDW, C_SRC, C_SRC2,
                            C_WIDTH, CHUNK, OP_COMBINE, OP_F, OP_G,
                            OP_RATE0, OP_RATE1, OP_REP, OP_SPC, PAT7, SPAR7,
                            T_RATE1, Schedule)
from . import _build
from .sc_decode import ScPlan

BIG = 3.0e38          # invalid columns; clone lanes start at BIG / 2
LIST_SIZES = (2, 4, 8)
MAX_DEPTHS = 20       # kMaxDepths of the kernel: codes up to 2^19


def _lanes(buf: torch.Tensor, lanes: torch.Tensor, off: int, w: int):
    """buf [B, L, S] read at columns [off, off + w) through the lane map
    lanes [B, L] -> [B, L, w]."""
    idx = lanes[:, :, None].expand(-1, -1, w)
    return buf[:, :, off: off + w].gather(1, idx)


def _first(x: torch.Tensor, k: int):
    """The k smallest entries of x along the last axis, in (value,
    index) order: lowest index first on ties."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _oneshot(a: torch.Tensor, pm: torch.Tensor, spc: bool):
    """One-shot exact fork of a RATE1 (spc=False) or SPC leaf, as
    ``scl_vm.make_decoder._oneshot``: a [B, L, w] leaf LLRs per logical
    lane -> (betas of the new lanes [B, L, w], source lanes [B, L], new
    path metrics [B, L])."""
    batch, lsz, w = a.shape
    dev = a.device
    t, fl0 = (8, 1) if spc else (7, 0)
    mag = torch.full((batch, lsz, CHUNK), BIG, dtype=torch.float32,
                     device=dev)
    mag[..., :w] = a.abs()
    vals, idxs = _first(mag, t)                          # [B, L, t]
    pat7 = torch.as_tensor(PAT7, device=dev)             # [7, 128]
    spar = torch.as_tensor(SPAR7, device=dev) > 0.5      # [128]
    subs = torch.zeros(batch, lsz, 128, dtype=torch.float32, device=dev)
    for j in range(7):
        subs = subs + vals[..., fl0 + j, None] * pat7[j]
    cand = pm[..., None] + subs
    odd = None
    if spc:
        odd = (a < 0).sum(dim=-1) % 2 == 1               # [B, L]
        cand = cand + torch.where(odd[..., None] ^ spar, vals[..., :1],
                                  0.0)
    pm_new, order = _first(cand.reshape(batch, lsz * 128), lsz)
    src, pat = order // 128, order % 128
    b = torch.where(a < 0, -1.0, 1.0).gather(
        1, src[..., None].expand(-1, -1, w))
    idx_s = idxs.gather(1, src[..., None].expand(-1, -1, t))
    bits = pat7.T[pat]                                   # [B, L, 7]
    col = torch.arange(w, device=dev)
    flip = torch.zeros(batch, lsz, w, dtype=torch.float32, device=dev)
    for j in range(7):
        flip = flip + bits[..., j, None] * (col == idx_s[..., fl0 + j, None])
    if spc:
        i0 = odd.gather(1, src) ^ spar[pat]
        flip = flip + i0[..., None] * (col == idx_s[..., :1])
    return torch.where(flip > 0.5, -b, b), src, pm_new


def _rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x [B, L, ...] with lane l taken from lane perm[b, l]."""
    idx = perm.reshape(perm.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return x.gather(1, idx)


def _fast(a: torch.Tensor, pm: torch.Tensor, spc: bool):
    """Fast-SSC-List fork of a RATE1 (spc=False) or SPC leaf, as the
    fast branches of ``scl_vm.make_decoder``'s ``op_rate1`` and
    ``op_spc``: a [B, L, w] leaf LLRs per logical lane -> (betas of the
    new lanes [B, L, w], source lanes [B, L], new path metrics [B, L]).

    Each lane's ``T_RATE1`` least reliable columns are found once.
    RATE1: round r offers [pm | pm + vals[r]] and keeps the L best of 2L;
    a winner that took the flip negates its column idxs[r].  SPC: the
    parity is fixed on column i0 (pm += v0 on odd parity), then rounds
    r = 1..3 offer the pair flip {i0, i_r} at delta = v_r - v0 (odd) or
    v_r + v0 (even), BIG once a path has switched."""
    batch, lsz, w = a.shape
    dev = a.device
    mag = torch.full((batch, lsz, CHUNK), BIG, dtype=torch.float32,
                     device=dev)
    mag[..., :w] = a.abs()
    vals, idxs = _first(mag, T_RATE1)                    # [B, L, T]
    b = torch.where(a < 0, -1.0, 1.0)
    col = torch.arange(w, device=dev)
    src = torch.arange(lsz, device=dev).repeat(batch, 1)
    rounds = range(T_RATE1)
    if spc:
        odd = (a < 0).sum(dim=-1) % 2 == 1               # [B, L]
        switched = torch.zeros_like(odd)
        pm = pm + torch.where(odd, vals[..., 0], 0.0)
        b = torch.where((col == idxs[..., :1]) & odd[..., None], -b, b)
        rounds = range(1, T_RATE1)
    for r in rounds:
        if spc:
            v0 = vals[..., 0]
            delta = torch.where(odd, vals[..., r] - v0, vals[..., r] + v0)
            delta = torch.where(switched, BIG, delta)
        else:
            delta = vals[..., r]
        pm, order = _first(torch.cat([pm, pm + delta], dim=1), lsz)
        perm, flip = order % lsz, order >= lsz
        b, vals, idxs, src = (_rows(v, perm) for v in (b, vals, idxs, src))
        hit = col == idxs[..., r, None]
        if spc:
            odd, switched = _rows(odd, perm), _rows(switched, perm) | flip
            hit = hit | (col == idxs[..., :1])
        b = torch.where(hit & flip[..., None], -b, b)
    return b, src, pm


def scl_decode_reference(llrs: torch.Tensor, sched: Schedule,
                         list_size: int, exact: bool = True):
    """Plain PyTorch list decode: llrs [B, code_len] f32 on any device ->
    (codewords [B, L, code_len] uint8, path metrics [B, L] f32), with the
    exact one-shot leaves or (``exact=False``) the Fast-SSC-List ones.
    One loop step per schedule row, as the VM's ``step``."""
    batch, n = llrs.shape
    lsz = list_size
    dev = llrs.device
    llr = torch.zeros(batch, lsz, sched.sz_llr, dtype=torch.float32,
                      device=dev)
    llr[:, :, :n] = llrs[:, None, :]
    beta = torch.zeros(batch, lsz, sched.sz_beta, dtype=torch.float32,
                       device=dev)
    ident = torch.arange(lsz, device=dev)
    refs = ident.repeat(batch, sched.n_depths, 1)        # [B, depths, L]
    brefs = ident.repeat(batch, 2 * sched.n_depths, 1)   # [B, slots, L]
    pm = torch.full((batch, lsz), BIG / 2, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    for row in sched.ops.tolist():
        op, d, w = row[C_OP], row[C_D], row[C_WIDTH]
        last = row[C_LAST] > 0
        if op in (OP_F, OP_G):
            a = _lanes(llr, refs[:, d], row[C_SRC], w)
            b = _lanes(llr, refs[:, d], row[C_SRC2], w)
            if op == OP_F:
                out = (torch.sign(a) * torch.sign(b)
                       * torch.minimum(a.abs(), b.abs()))
            else:
                out = b + _lanes(beta, brefs[:, row[C_SIDR]], row[C_BSRC],
                                 w) * a
            llr[:, :, row[C_DST]: row[C_DST] + w] = out
            if last:
                refs[:, d + 1] = ident
            continue
        bdst = beta[:, :, row[C_BDST]: row[C_BDST] + w]
        src = None
        if op == OP_COMBINE:
            bl = _lanes(beta, brefs[:, row[C_SIDR]], row[C_BSRC], w)
            br = _lanes(beta, brefs[:, row[C_SIDR2]], row[C_BSRC2], w)
            bdst.copy_(bl * br)
            beta[:, :, row[C_DST]: row[C_DST] + w] = br
        else:
            a = _lanes(llr, refs[:, d], row[C_SRC], w)
            if op == OP_RATE0:
                pm = pm + torch.relu(-a).sum(dim=-1)
                bdst.fill_(1.0)
            elif op == OP_REP:
                m0 = torch.relu(-a).sum(dim=-1)          # cost of all +1
                m1 = torch.relu(a).sum(dim=-1)           # cost of all -1
                pm, order = _first(torch.cat([pm + m0, pm + m1], dim=1),
                                   lsz)
                src = order % lsz
                sign = torch.where(order >= lsz, -1.0, 1.0)
                bdst.copy_(sign[..., None].expand(-1, -1, w))
            elif op in (OP_RATE1, OP_SPC):
                leaf = _oneshot if exact else _fast
                b2, src, pm = leaf(a, pm, op == OP_SPC)
                bdst.copy_(b2)
            else:
                raise ValueError(f"unknown opcode {op}")
        if src is not None:
            refs = refs.gather(2, src[:, None, :].expand_as(refs))
            brefs = brefs.gather(2, src[:, None, :].expand_as(brefs))
        if last:
            brefs[:, row[C_SIDW]] = ident
    cw = beta[:, :, sched.out_off: sched.out_off + n] < 0
    return cw.to(torch.uint8), pm


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("scl_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scl_decode_launch.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p,
                                      p, p, p, i, p]
    lib.scl_decode_launch.restype = ctypes.c_int
    lib.scl_decode_error_string.argtypes = [ctypes.c_int]
    lib.scl_decode_error_string.restype = ctypes.c_char_p
    return lib


def scl_decode(llrs: torch.Tensor, plan: ScPlan, list_size: int,
               exact: bool = True):
    """List-decode a batch: llrs [B, code_len] contiguous f32 ->
    (codewords [B, L, code_len] uint8, path metrics [B, L] f32), L =
    ``list_size`` in {2, 4, 8}; ``exact`` picks kernel B (the exact
    one-shot leaves) or kernel C (Fast-SSC-List).

    On a CUDA tensor this launches the kernel on the current stream
    (counted in ``scl_decode.launches`` for B, ``scl_decode.
    fast_launches`` for C) and raises if the launch fails; on a CPU
    tensor it runs :func:`scl_decode_reference`."""
    sched = plan.sched
    if list_size not in LIST_SIZES:
        raise ValueError(f"list_size {list_size} not in {LIST_SIZES}")
    if llrs.dtype != torch.float32:
        raise TypeError(f"llrs must be float32, got {llrs.dtype}")
    if llrs.dim() != 2 or llrs.shape[1] != sched.code_len:
        raise ValueError(f"llrs shape {tuple(llrs.shape)}, want "
                         f"[batch, {sched.code_len}]")
    if not llrs.is_contiguous():
        raise ValueError("llrs must be contiguous")
    if sched.n_depths > MAX_DEPTHS:
        raise ValueError(f"code of {sched.n_depths} depths: the kernel "
                         f"holds at most {MAX_DEPTHS}")
    if llrs.device.type == "cpu":
        return scl_decode_reference(llrs, sched, list_size, exact)
    if llrs.device.type != "cuda":
        raise ValueError(f"scl_decode runs on cpu or cuda, not {llrs.device}")

    lib = _library()
    batch, n = llrs.shape
    dev = llrs.device
    llr_len = sched.sz_llr - sched.d0_len
    llr_scratch = torch.empty(batch, list_size, llr_len,
                              dtype=torch.float32, device=dev)
    beta_scratch = torch.empty(batch, list_size, sched.sz_beta,
                               dtype=torch.int8, device=dev)
    cw = torch.empty(batch, list_size, n, dtype=torch.uint8, device=dev)
    pm = torch.empty(batch, list_size, dtype=torch.float32, device=dev)
    table = plan.table(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.scl_decode_launch(
        llrs.data_ptr(), table.data_ptr(), sched.n_ops, n, sched.d0_len,
        llr_len, sched.sz_beta, sched.out_off, sched.n_depths, list_size,
        int(bool(exact)), llr_scratch.data_ptr(), beta_scratch.data_ptr(),
        cw.data_ptr(), pm.data_ptr(), batch, stream)
    if rc:
        raise RuntimeError("scl_decode kernel launch failed: "
                           + lib.scl_decode_error_string(rc).decode())
    if exact:
        scl_decode.launches += 1
    else:
        scl_decode.fast_launches += 1
    return cw, pm


scl_decode.launches = 0          # kernel B
scl_decode.fast_launches = 0     # kernel C
