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

:func:`make_decoder` is the counterpart of ``make_pallas_decoder`` with
its options (kernel C'): ``rank_select`` (every fork selection one rank
count), ``unroll`` (kernels/unroll.py), ``decompose_spc``,
``beta_compact`` (``beta_bf16``) and ``ops_override``.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np

import torch

from ..fec.schedule import (C_BDST, C_BSRC, C_BSRC2, C_D, C_DST, C_LAST,
                            C_OP, C_SIDR, C_SIDR2, C_SIDW, C_SRC, C_SRC2,
                            C_WIDTH, CHUNK, OP_COMBINE, OP_F, OP_G,
                            OP_RATE0, OP_RATE1, OP_REP, OP_SPC, PAT7, SPAR7,
                            T_RATE1, Schedule, scl_params)
from . import _build
from .sc_decode import (SMEM_BLOCK_MAX, SMEM_RESERVED, ScPlan, Tiers,
                        check_llrs, sc_decode, tiers_of)

BIG = 3.0e38          # invalid columns; clone lanes start at BIG / 2
LIST_SIZES = (2, 4, 8)
MAX_DEPTHS = 20       # kMaxDepths of the kernel: codes up to 2^19
# Shared memory of the tiered state: one block an SM (a frame's chain of
# rows is the latency; at the fallback batch of 16 most SMs idle anyway).
# A block's 227 KB less the kernel's static __shared__ (at most
# LIST_STATIC_SHARED, a static_assert in the .cu) and the system's 1 KB
# bound every lane's copy of the shared tier.
LIST_STATIC_SHARED = 8192
LIST_BUDGET = SMEM_BLOCK_MAX - LIST_STATIC_SHARED - SMEM_RESERVED
# The one-shot patterns that can reach a top 8 (scl_pallas.py:706-713):
# any other pattern has at least 8 strict dominators of lower code in its
# own lane (drop a flip, or move one to a more reliable column: an f32
# sum taken in order never grows), so it never wins, even on a tie.
LIVE_PATTERNS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 32, 64)


def list_tiers(sched: Schedule, list_size: int, beta_compact: bool = True,
               depth: int | None = None) -> Tiers:
    """The list kernels' tiers of ``sched``'s buffers at L =
    ``list_size``: the regions of depths >= ``Tiers.depth``, every lane's
    copy, in the block's shared memory, by default from the shallowest
    depth that fits :data:`LIST_BUDGET` (mode 6, int8 betas: L = 8 from
    depth 8, 221,184 bytes); ``depth`` forces another (see
    :func:`sc_decode.tiers_of`)."""
    return tiers_of(sched, beta_compact, depth, lanes=list_size,
                    budget=LIST_BUDGET, limit=LIST_BUDGET)


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


def rank_count(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """For each candidate i along the last axis, the number of candidates
    j before it in (value, index) order: v_j < v_i, or v_j == v_i and
    idx_j < idx_i.  Distinct indices make the ranks a permutation."""
    vj, vi = v[..., None, :], v[..., :, None]
    ij, ii = idx[..., None, :], idx[..., :, None]
    return ((vj < vi) | ((vj == vi) & (ij < ii))).sum(dim=-1)


def _rank_first(x: torch.Tensor, k: int, idx: torch.Tensor | None = None):
    """:func:`_first` by one rank count: the candidates of rank 0..k-1 of
    x along the last axis, as (values, indices); ``idx`` (default the
    positions) are the indices the order breaks ties by and returns."""
    n = x.shape[-1]
    pos = torch.arange(n, device=x.device)
    if idx is None:
        idx = pos.expand_as(x)
    rank = rank_count(x, idx)
    hit = rank[..., None, :] == torch.arange(k, device=x.device)[:, None]
    at = (hit * pos).sum(dim=-1)                 # one hit a rank
    return x.gather(-1, at), idx.gather(-1, at)


def _oneshot(a: torch.Tensor, pm: torch.Tensor, spc: bool,
             rank: bool = False):
    """One-shot exact fork of a RATE1 (spc=False) or SPC leaf, as
    ``scl_vm.make_decoder._oneshot``: a [B, L, w] leaf LLRs per logical
    lane -> (betas of the new lanes [B, L, w], source lanes [B, L], new
    path metrics [B, L]).  ``rank``: the top L by one rank count over
    the L x 13 :data:`LIVE_PATTERNS` candidates, as
    ``make_select_flat_rank``."""
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
    if rank:
        live = torch.as_tensor(LIVE_PATTERNS, device=dev)
        flat = (torch.arange(lsz, device=dev)[:, None] * 128
                + live).reshape(-1).expand(batch, -1)
        pm_new, order = _rank_first(cand[..., live].reshape(batch, -1), lsz,
                                    flat)
    else:
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


def _fast(a: torch.Tensor, pm: torch.Tensor, spc: bool, rank: bool = False):
    """Fast-SSC-List fork of a RATE1 (spc=False) or SPC leaf, as the
    fast branches of ``scl_vm.make_decoder``'s ``op_rate1`` and
    ``op_spc``: a [B, L, w] leaf LLRs per logical lane -> (betas of the
    new lanes [B, L, w], source lanes [B, L], new path metrics [B, L]).

    Each lane's ``T_RATE1`` least reliable columns are found once.
    RATE1: round r offers [pm | pm + vals[r]] and keeps the L best of 2L;
    a winner that took the flip negates its column idxs[r].  SPC: the
    parity is fixed on column i0 (pm += v0 on odd parity), then rounds
    r = 1..3 offer the pair flip {i0, i_r} at delta = v_r - v0 (odd) or
    v_r + v0 (even), BIG once a path has switched.  ``rank``: each
    round's best L by one rank count over the 2L."""
    batch, lsz, w = a.shape
    select = _rank_first if rank else _first
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
        pm, order = select(torch.cat([pm, pm + delta], dim=1), lsz)
        perm, flip = order % lsz, order >= lsz
        b, vals, idxs, src = (_rows(v, perm) for v in (b, vals, idxs, src))
        hit = col == idxs[..., r, None]
        if spc:
            odd, switched = _rows(odd, perm), _rows(switched, perm) | flip
            hit = hit | (col == idxs[..., :1])
        b = torch.where(hit & flip[..., None], -b, b)
    return b, src, pm


def scl_decode_reference(llrs: torch.Tensor, sched: Schedule,
                         list_size: int, exact: bool = True,
                         rank_select: bool = False):
    """Plain PyTorch list decode: llrs [B, code_len] f32 on any device ->
    (codewords [B, L, code_len] uint8, path metrics [B, L] f32), with the
    exact one-shot leaves or (``exact=False``) the Fast-SSC-List ones.
    One loop step per schedule row, as the VM's ``step``.
    ``rank_select``: every fork selection (REP, the fast rounds, the
    one-shot top L over the 13 live patterns) is one rank count, the
    path that pins ``rank_select=True``'s reduction; the result is the
    same."""
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
                select = _rank_first if rank_select else _first
                pm, order = select(torch.cat([pm + m0, pm + m1], dim=1), lsz)
                src = order % lsz
                sign = torch.where(order >= lsz, -1.0, 1.0)
                bdst.copy_(sign[..., None].expand(-1, -1, w))
            elif op in (OP_RATE1, OP_SPC):
                leaf = _oneshot if exact else _fast
                b2, src, pm = leaf(a, pm, op == OP_SPC, rank_select)
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


def check_table(sched: Schedule) -> None:
    """Raise ValueError unless every row of the schedule's table keeps its
    reads and writes inside the buffers the kernels allocate: opcodes
    0-6, widths 1..CHUNK, depths and slot ids inside the lane maps, LLR
    reads inside the channel LLRs or the scratch, LLR writes inside the
    scratch, partial sums inside theirs.  The TPU kernel faults on such
    a row; the port refuses it on the host, before any launch."""
    ops = np.asarray(sched.ops, dtype=np.int64)
    n, d0, sz_llr, sz_beta = (sched.code_len, sched.d0_len, sched.sz_llr,
                              sched.sz_beta)
    n_slots = 2 * sched.n_depths
    for i, row in enumerate(ops):
        op, d, w = int(row[C_OP]), int(row[C_D]), int(row[C_WIDTH])
        bad = []
        if not 0 <= op <= OP_SPC:
            bad.append(f"opcode {op}")
        if not 1 <= w <= CHUNK:
            bad.append(f"width {w}")
        if not 0 <= d < sched.n_depths - (op in (OP_F, OP_G)):
            bad.append(f"depth {d}")

        def llr_read(col):
            off = int(row[col])
            if not (0 <= off and off + w <= n
                    or d0 <= off and off + w <= sz_llr):
                bad.append(f"LLR read at {off}")

        def in_range(col, lo, hi, what):
            off = int(row[col])
            if not (lo <= off and off + w <= hi):
                bad.append(f"{what} at {off}")

        def slot(col):
            if not 0 <= int(row[col]) < n_slots:
                bad.append(f"slot id {int(row[col])}")

        if op in (OP_F, OP_G):
            llr_read(C_SRC)
            llr_read(C_SRC2)
            in_range(C_DST, d0, sz_llr, "LLR write")
            if op == OP_G:
                in_range(C_BSRC, 0, sz_beta, "beta read")
                slot(C_SIDR)
        elif op == OP_COMBINE:
            for col in (C_BSRC, C_BSRC2, C_BDST, C_DST):
                in_range(col, 0, sz_beta, "beta access")
            for col in (C_SIDR, C_SIDR2, C_SIDW):
                slot(col)
        elif OP_RATE0 <= op <= OP_SPC:
            llr_read(C_SRC)
            in_range(C_BDST, 0, sz_beta, "beta write")
            slot(C_SIDW)
        if bad:
            raise ValueError(f"schedule row {i} {row.tolist()}: "
                             + ", ".join(bad))


@functools.lru_cache(maxsize=None)
def _library(options: bool = False) -> ctypes.CDLL:
    """The default library (B and C, int8 betas) or, ``options``, the one
    built with -DSCL_DECODE_OPTIONS (rank selection, f32 betas)."""
    return bind(_build.load("scl_decode",
                            ("SCL_DECODE_OPTIONS",) if options else ()))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from csrc/scl_decode.cu
    on ``lib``; returns it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scl_decode_launch.argtypes = [p, p, i, i, i, i, i, i, i, i, i, i, i,
                                      i, i, p, p, p, p, i, p]
    lib.scl_decode_launch.restype = ctypes.c_int
    lib.scl_decode_occupancy.argtypes = [i, i, i, i, i, i,
                                         ctypes.POINTER(i)]
    lib.scl_decode_occupancy.restype = ctypes.c_int
    lib.scl_decode_error_string.argtypes = [ctypes.c_int]
    lib.scl_decode_error_string.restype = ctypes.c_char_p
    return lib


def variant_name(exact: bool, rank_select: bool = False,
                 beta_compact: bool = True, unroll: bool = False) -> str:
    """The key of a non-default instance in ``scl_decode.
    variant_launches``: "B" or "C", then "+rank", "+beta_f32", "+unroll"."""
    name = "B" if exact else "C"
    if rank_select and exact:
        name += "+rank"
    if not beta_compact:
        name += "+beta_f32"
    if unroll:
        name += "+unroll"
    return name


def scl_decode(llrs: torch.Tensor, plan: ScPlan, list_size: int,
               exact: bool = True, *, rank_select: bool = False,
               beta_compact: bool = True, unroll: bool = False,
               zero_scratch: bool = False):
    """List-decode a batch: llrs [B, code_len] contiguous f32 ->
    (codewords [B, L, code_len] uint8, path metrics [B, L] f32), L =
    ``list_size`` in {2, 4, 8}; ``exact`` picks kernel B (the exact
    one-shot leaves) or kernel C (Fast-SSC-List).

    Options, none of which changes the result: ``rank_select`` picks
    each lane's best L one-shot candidates by one rank count over the 13
    live patterns (kernel B; REP and C's fast rounds already rank in one
    pass, so there it runs the default code); ``beta_compact=False``
    keeps the partial sums in f32, not int8; ``unroll`` runs the kernel
    generated for this schedule (kernels/unroll.py; default instances
    only: no rank selection, int8 betas); ``zero_scratch`` zero-fills the
    global scratch first (an override table may read slots it never
    wrote; the kernel zeroes its shared tier itself).  The frame's state
    is split as :func:`list_tiers` says.

    On a CUDA tensor this launches the kernel on the current stream
    (counted in ``scl_decode.launches`` for the default B,
    ``scl_decode.fast_launches`` for the default C, and
    ``scl_decode.variant_launches[variant_name(...)]`` for the others)
    and raises if the launch fails; on a CPU tensor it runs
    :func:`scl_decode_reference` (with ``rank_select``)."""
    sched = plan.sched
    if list_size not in LIST_SIZES:
        raise ValueError(f"list_size {list_size} not in {LIST_SIZES}")
    check_llrs(llrs, sched, "scl_decode")
    if sched.n_depths > MAX_DEPTHS:
        raise ValueError(f"code of {sched.n_depths} depths: the kernel "
                         f"holds at most {MAX_DEPTHS}")
    rank = bool(rank_select and exact)
    if unroll and (rank or not beta_compact):
        raise ValueError("only the default instances (no rank selection, "
                         "int8 betas) are unrolled")
    tiers = list_tiers(sched, list_size, beta_compact)
    if llrs.device.type == "cpu":
        return scl_decode_reference(llrs, sched, list_size, exact, rank)

    batch, n = llrs.shape
    dev = llrs.device
    alloc = torch.zeros if zero_scratch else torch.empty
    llr_scratch = alloc(batch, list_size, tiers.g_llr_len,
                        dtype=torch.float32, device=dev)
    beta_scratch = alloc(batch, list_size, tiers.g_beta_len,
                         dtype=torch.int8 if beta_compact else torch.float32,
                         device=dev)
    cw = torch.empty(batch, list_size, n, dtype=torch.uint8, device=dev)
    pm = torch.empty(batch, list_size, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if unroll:
        from . import unroll as _unroll
        lib = _unroll.library(sched, list_size, bool(exact))
        rc = lib.unrolled_launch(llrs.data_ptr(), llr_scratch.data_ptr(),
                                 beta_scratch.data_ptr(), cw.data_ptr(),
                                 pm.data_ptr(), batch, stream)
        err = lib.unrolled_error_string
    else:
        lib = _library(rank or not beta_compact)
        rows = plan.list_rows(dev)
        rc = lib.scl_decode_launch(
            llrs.data_ptr(), rows.data_ptr(), sched.n_ops, n, sched.d0_len,
            tiers.llr_lo, tiers.beta_lo, tiers.s_llr_len, tiers.s_beta_len,
            sched.out_off, sched.n_depths, list_size, int(bool(exact)),
            int(rank), int(not beta_compact), llr_scratch.data_ptr(),
            beta_scratch.data_ptr(), cw.data_ptr(), pm.data_ptr(), batch,
            stream)
        err = lib.scl_decode_error_string
    if rc:
        raise RuntimeError("scl_decode kernel launch failed: "
                           + err(rc).decode())
    if unroll or rank or not beta_compact:
        scl_decode.variant_launches[variant_name(
            exact, rank, beta_compact, unroll)] += 1
    elif exact:
        scl_decode.launches += 1
    else:
        scl_decode.fast_launches += 1
    return cw, pm


def list_blocks_per_sm(tiers: Tiers, exact: bool = True) -> int:
    """The blocks of that list-kernel instance (L = ``tiers.lanes``, its
    beta type from ``tiers``, no rank selection) an SM holds at once with
    that shared tier (the CUDA occupancy calculator; needs the card)."""
    f32 = tiers.beta_bytes == 4
    lib = _library(f32)
    blocks = ctypes.c_int(0)
    rc = lib.scl_decode_occupancy(tiers.lanes, int(bool(exact)), 0,
                                  int(f32), tiers.s_llr_len,
                                  tiers.s_beta_len, ctypes.byref(blocks))
    if rc:
        raise RuntimeError("scl_decode occupancy query failed: "
                           + lib.scl_decode_error_string(rc).decode())
    return blocks.value


scl_decode.launches = 0          # kernel B
scl_decode.fast_launches = 0     # kernel C
scl_decode.variant_launches = collections.Counter()   # their C' options


def make_decoder(frozen: np.ndarray, list_size: int = 8, exact: bool = True,
                 *, unroll: bool = False, rank_select: bool = False,
                 decompose_spc: bool = False, beta_compact: bool = True,
                 ops_override=None, device="cuda"):
    """The polar list decoder of one frozen mask, with the options of
    ``modem_tpu.kernels.scl_pallas.make_pallas_decoder`` (scl_pallas.py:
    70-76).  Returns fn(llrs [B, code_len] f32) -> (codewords [B, L,
    code_len] uint8, path metrics [B, L] f32) on ``device`` (the card
    unless ``device="cpu"``, which runs the plain versions).
    ``list_size=1`` decodes with plain SC (kernel A), 2, 4 or 8 with the
    list decoder (B, or C with ``exact=False``).

    - ``decompose_spc`` (with ``exact``): the schedule with SPC nodes
      decomposed into subtrees, the VM's cross-check oracle.
    - ``rank_select``: the one-shot selection by one rank count (see
      :func:`scl_decode`); no effect at L = 1, where every selection has
      a closed form.
    - ``beta_compact``: the counterpart of ``beta_bf16``; the port's
      betas are int8 +/-1, so False means f32.  Same results.
    - ``unroll``: the schedule expanded into a kernel of its own
      (kernels/unroll.py), built at first use.
    - ``ops_override``: an instruction table [M, 14] in the port's own
      :func:`fec.schedule.build_schedule` format (not the TPU's
      retargeted 16 columns) run in place of the schedule, e.g. cycled
      copies of its rows for a per-class timing.  Every row is checked on
      the host (:func:`check_table`, ValueError), and its scratch starts
      from zeros, as the plain version's does.

    Left out: ``frames_per_cell`` (frames sharing one TPU grid cell; on
    the card a frame is a thread block, and several frames a block is a
    redesign of the kernels) and ``interpret`` (Pallas's debug mode; the
    plain version, on CPU tensors, is the port's)."""
    if list_size != 1 and list_size not in LIST_SIZES:
        raise ValueError(f"list_size {list_size} not in (1,) + "
                         f"{LIST_SIZES}")
    emit_spc = scl_params(list_size, exact, decompose_spc)[0]
    plan = ScPlan.from_frozen(frozen, emit_spc=emit_spc)
    override = ops_override is not None
    if override:
        plan = ScPlan(Schedule.from_table(np.asarray(ops_override),
                                          plan.sched.code_len))
        check_table(plan.sched)
    dev = torch.device(device)

    def decode(llrs):
        x = torch.as_tensor(llrs, dtype=torch.float32, device=dev)
        x = x.contiguous()
        if list_size == 1:
            return sc_decode(x, plan, beta_compact=beta_compact,
                             unroll=unroll, zero_scratch=override)
        return scl_decode(x, plan, list_size, exact,
                          rank_select=rank_select,
                          beta_compact=beta_compact, unroll=unroll,
                          zero_scratch=override)

    decode.plan = plan
    return decode
