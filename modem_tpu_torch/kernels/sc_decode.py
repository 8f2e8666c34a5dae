"""Plain successive-cancellation (SC) polar decoding: the CUDA kernel
``csrc/sc_decode.cu`` and its plain PyTorch version.

Counterpart of ``modem_tpu/kernels/scl_pallas.make_pallas_decoder(
frozen, list_size=1, exact=True)``: both run the raw schedule of
:func:`fec.schedule.build_schedule` (SPC leaves), and both return the
JAX shapes, codewords [B, 1, code_len] uint8 and path metrics [B, 1]
f32, so the CRC select downstream is the list decoder's.  Its options
(part of kernel C'): f32 partial sums (``beta_compact=False``, the
counterpart of ``beta_bf16=False``) and the schedule expanded into
straight-line code (``unroll=True``, kernels/unroll.py).

:func:`sc_decode` is the wrapper the pipeline calls.  A CUDA tensor
launches the kernel (or raises); a CPU tensor takes
:func:`sc_decode_reference`, which runs the same rows as a Python loop
vectorised over the batch.

The kernel's plan is made here, on the host, from the schedule: where a
frame's state lives (:func:`tiers_of`: depths from ``Tiers.depth`` on in
the block's shared memory, the rest in global scratch) and the packed row
stream (:func:`pack_rows`: 16 bytes a row, runs of narrow rows marked for
warp 0).  csrc/sc_decode.cu says why.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..fec.schedule import (C_BDST, C_BSRC, C_BSRC2, C_D, C_DST, C_LAST,
                            C_OP, C_SIDR, C_SIDR2, C_SIDW, C_SRC, C_SRC2,
                            C_WIDTH, CHUNK, OP_COMBINE, OP_F, OP_G,
                            OP_RATE0, OP_RATE1, OP_REP, OP_SPC, Schedule,
                            _regions, build_schedule)
from . import _build

# Shared memory of the tiered state.  Four blocks to an SM
# (__launch_bounds__(kThreads, 4)) run a 512-frame batch in one wave over
# the 132 SMs; each block's share of the SM's 228 KB, less the system's
# 1 KB a block and the kernel's static __shared__ (at most STATIC_SHARED,
# a static_assert in the .cu), bounds its shared tier.
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED = 1024
STATIC_SHARED = 2048
BLOCKS_PER_SM = 4
SHARED_BUDGET = (SMEM_PER_SM // BLOCKS_PER_SM - SMEM_RESERVED
                 - STATIC_SHARED)                   # 55,296 bytes
SMEM_BLOCK_MAX = 227 * 1024      # a block's most (a forced depth's limit)

# The packed row stream (csrc/sc_decode.cu PackedRow): six offsets of
# FIELD_BITS, the width, the opcode and RUN in two little-endian uint64.
FIELD_BITS = 18
PACKED_COLS = (C_SRC, C_SRC2, C_DST, C_BSRC, C_BSRC2, C_BDST)
NARROW = 32          # rows this wide or narrower can run on warp 0
RUN_MAX = 64         # the kernel stages a run's rows (kRunRows); RUN
                     # has 7 bits


@dataclasses.dataclass(frozen=True)
class Tiers:
    """Where kernel A keeps a frame's state: the LLR and beta regions of
    depths >= ``depth`` in the block's shared memory (LLR offsets from
    ``llr_lo``, beta offsets from ``beta_lo``: regions grow with depth, so
    each tier is one range), the depths below in global scratch, depth 0
    in the input."""

    depth: int
    d0_len: int
    llr_lo: int
    beta_lo: int
    s_llr_len: int       # shared LLR slots (f32), a lane
    s_beta_len: int      # shared beta slots, a lane
    beta_bytes: int      # 1 (int8) or 4 (f32)
    lanes: int = 1       # list lanes, each with its own copy of the tiers

    @property
    def g_llr_len(self) -> int:
        """Global LLR scratch a frame: offsets [d0_len, llr_lo)."""
        return self.llr_lo - self.d0_len

    @property
    def g_beta_len(self) -> int:
        """Global beta scratch a frame: offsets [0, beta_lo)."""
        return self.beta_lo

    @property
    def shared_bytes(self) -> int:
        return self.lanes * (4 * self.s_llr_len
                             + self.beta_bytes * self.s_beta_len)


def tiers_of(sched: Schedule, beta_compact: bool = True,
             depth: int | None = None, *, lanes: int = 1,
             budget: int = SHARED_BUDGET,
             limit: int = SMEM_BLOCK_MAX) -> Tiers:
    """The tiers of ``sched``'s buffers for ``lanes`` list lanes (kernel
    A: 1): by default the shallowest depth whose shared tier, every
    lane's copy, fits ``budget`` (``beta_compact``: int8 betas, else
    f32; A's default budget lets four blocks share an SM); ``depth``
    forces another, from 1 (all but the input in shared memory, if it
    fits ``limit``) to ``sched.n_depths`` (nothing)."""
    lofs, bslot, sz_llr, sz_beta = _regions(sched.code_len)
    n_depths = len(lofs)

    def at(d):
        llr_lo = lofs[d] if d < n_depths else sz_llr
        beta_lo = int(bslot[d, 0]) if d < n_depths else sz_beta
        return Tiers(d, sched.d0_len, llr_lo, beta_lo, sz_llr - llr_lo,
                     sz_beta - beta_lo, 1 if beta_compact else 4, lanes)

    if depth is None:
        return next(t for t in map(at, range(1, n_depths + 1))
                    if t.shared_bytes <= budget)
    if not 1 <= depth <= n_depths:
        raise ValueError(f"shared depth {depth} outside 1..{n_depths}")
    tiers = at(depth)
    if tiers.shared_bytes > limit:
        raise ValueError(f"shared depth {depth} needs {tiers.shared_bytes} "
                         f"bytes of shared memory, over {limit}")
    return tiers


def in_shared_tier(ops: np.ndarray, tiers: Tiers) -> np.ndarray:
    """Per row of the table [n, 14]: whether every slot it reads or writes
    lies in the shared tier of ``tiers`` (the kernel's in_shared: a row's
    offsets are where its ranges start, and the shared tier runs to the
    end of each buffer)."""
    ops = np.asarray(ops, dtype=np.int64)
    op = ops[:, C_OP]

    def llr(*cols):
        return np.logical_and.reduce([ops[:, c] >= tiers.llr_lo
                                      for c in cols])

    def beta(*cols):
        return np.logical_and.reduce([ops[:, c] >= tiers.beta_lo
                                      for c in cols])

    f = llr(C_SRC, C_SRC2, C_DST)
    return np.select([op == OP_F, op == OP_G, op == OP_COMBINE],
                     [f, f & beta(C_BSRC),
                      beta(C_BSRC, C_BSRC2, C_BDST, C_DST)],
                     llr(C_SRC) & beta(C_BDST))


def narrow_runs(ops: np.ndarray, tiers: Tiers) -> np.ndarray:
    """RUN of each row: at the first row of each stretch of consecutive
    rows at most :data:`NARROW` wide and wholly in the shared tier
    (:func:`in_shared_tier`; cut every :data:`RUN_MAX` rows), the
    stretch's length; 0 on every other row.  Warp 0 runs a stretch alone,
    through shared memory only; the kernel makes no decision about
    barriers."""
    ops = np.asarray(ops, dtype=np.int64)
    narrow = (ops[:, C_WIDTH] <= NARROW) & in_shared_tier(ops, tiers)
    run = np.zeros(len(ops), dtype=np.int64)
    i = 0
    while i < len(ops):
        j = i
        while j < len(ops) and narrow[j] and j - i < RUN_MAX:
            j += 1
        if j > i:
            run[i] = j - i
            i = j
        else:
            i += 1
    return run


def pack_rows(ops: np.ndarray, tiers: Tiers) -> np.ndarray:
    """The instruction table [n, 14] as kernel A's row stream with
    ``tiers``: int32 [n + 1, 4], row i the two little-endian uint64 ``SRC
    | SRC2 << 18 | DST << 36 | WIDTH << 54`` and ``BSRC | BSRC2 << 18 |
    BDST << 36 | OP << 54 | RUN << 57`` (:func:`narrow_runs`), then a
    zero row, which the kernel loads after the last and never runs.
    Raises ValueError on a value its field cannot hold."""
    ops = np.asarray(ops, dtype=np.int64)
    offs = ops[:, PACKED_COLS]
    if ((offs < 0) | (offs >= 1 << FIELD_BITS)).any():
        raise ValueError(f"a schedule offset outside [0, 2^{FIELD_BITS}): "
                         "the code is too long for kernel A's table")
    width, op = ops[:, C_WIDTH], ops[:, C_OP]
    if ((width < 1) | (width > CHUNK)).any() or ((op < 0) | (op > 7)).any():
        raise ValueError("a schedule width or opcode its field cannot hold")
    u = [np.uint64(v) for v in (18, 36, 54, 57)]
    cols = offs.astype(np.uint64)
    lo = (cols[:, 0] | cols[:, 1] << u[0] | cols[:, 2] << u[1]
          | width.astype(np.uint64) << u[2])
    hi = (cols[:, 3] | cols[:, 4] << u[0] | cols[:, 5] << u[1]
          | op.astype(np.uint64) << u[2]
          | narrow_runs(ops, tiers).astype(np.uint64) << u[3])
    out = np.zeros((len(ops) + 1, 2), dtype="<u8")
    out[:len(ops), 0] = lo
    out[:len(ops), 1] = hi
    return out.view("<i4")


# The list kernels' row stream (csrc/scl_decode.cu ListRow): 32 bytes a
# row, eight little-endian int32 words.
LIST_ROW_WORDS = 8
LIST_OFFSET_COLS = (C_SRC, C_SRC2, C_DST, C_BSRC, C_BSRC2, C_BDST)
def pack_list_rows(ops: np.ndarray) -> np.ndarray:
    """The instruction table [n, 14] as the list kernels' row stream:
    int32 [n + 1, 8], row i ``SRC, SRC2, DST, BSRC, BSRC2, BDST, OP | D
    << 3 | WIDTH << 8 | LAST << 18, SIDR | SIDR2 << 8 | SIDW << 16``,
    then a zero row, which the kernel loads after the last and never
    runs (SUB is not read).  Raises ValueError on a value its field
    cannot hold."""
    ops = np.asarray(ops, dtype=np.int64)
    op, d, w, last = (ops[:, c] for c in (C_OP, C_D, C_WIDTH, C_LAST))
    sids = ops[:, [C_SIDR, C_SIDR2, C_SIDW]]
    if (((op < 0) | (op > 7)).any() or ((d < 0) | (d > 31)).any()
            or ((w < 1) | (w > CHUNK)).any() or ((last < 0) | (last > 1)).any()
            or ((sids < 0) | (sids > 255)).any()
            or (ops[:, LIST_OFFSET_COLS] < 0).any()
            or (ops[:, LIST_OFFSET_COLS] >= 1 << 31).any()):
        raise ValueError("a schedule value the list kernels' row fields "
                         "cannot hold")
    out = np.zeros((len(ops) + 1, LIST_ROW_WORDS), dtype="<i4")
    out[:len(ops), :6] = ops[:, LIST_OFFSET_COLS]
    out[:len(ops), 6] = op | d << 3 | w << 8 | last << 18
    out[:len(ops), 7] = sids[:, 0] | sids[:, 1] << 8 | sids[:, 2] << 16
    return out


@dataclasses.dataclass
class ScPlan:
    """A schedule plus its packed tables on each device it ran on: kernel
    A's rows and the list kernels'."""

    sched: Schedule
    _packed: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_frozen(cls, frozen: np.ndarray, emit_spc: bool = True
                    ) -> "ScPlan":
        """The schedule of a frozen mask: SPC leaves, or with
        ``emit_spc=False`` SPC nodes decomposed into subtrees."""
        key = np.ascontiguousarray(frozen, dtype=np.uint8).tobytes()
        return cls(build_schedule(key, emit_spc=emit_spc))

    def list_rows(self, device: torch.device) -> torch.Tensor:
        """The list kernels' packed rows (:func:`pack_list_rows`) on
        ``device``."""
        if ("list_rows", device) not in self._packed:
            self._packed["list_rows", device] = torch.from_numpy(
                pack_list_rows(self.sched.ops)).to(device).contiguous()
        return self._packed["list_rows", device]

    def rows(self, device: torch.device, tiers: Tiers) -> torch.Tensor:
        """Kernel A's packed rows (:func:`pack_rows`) for ``tiers`` on
        ``device``."""
        key = ("rows", device, tiers.llr_lo, tiers.beta_lo)
        if key not in self._packed:
            self._packed[key] = torch.from_numpy(
                pack_rows(self.sched.ops, tiers)).to(device).contiguous()
        return self._packed[key]


def sc_decode_reference(llrs: torch.Tensor, sched: Schedule):
    """Plain PyTorch SC decode: llrs [B, code_len] f32 on any device ->
    (codewords [B, 1, code_len] uint8, path metrics [B, 1] f32).

    One loop step per schedule row, each a few tensor ops over the batch
    and the row's columns; the leaf rules are those of the kernel (see
    csrc/sc_decode.cu)."""
    batch, n = llrs.shape
    dev = llrs.device
    llr = torch.zeros(batch, sched.sz_llr, dtype=torch.float32, device=dev)
    llr[:, :n] = llrs
    beta = torch.zeros(batch, sched.sz_beta, dtype=torch.float32,
                       device=dev)
    pm = torch.zeros(batch, dtype=torch.float32, device=dev)
    rows = torch.arange(batch, device=dev)
    for row in sched.ops.tolist():
        op, w = row[C_OP], row[C_WIDTH]
        a = llr[:, row[C_SRC]: row[C_SRC] + w]
        if op in (OP_F, OP_G):
            b = llr[:, row[C_SRC2]: row[C_SRC2] + w]
            if op == OP_F:
                out = (torch.sign(a) * torch.sign(b)
                       * torch.minimum(a.abs(), b.abs()))
            else:
                out = b + beta[:, row[C_BSRC]: row[C_BSRC] + w] * a
            llr[:, row[C_DST]: row[C_DST] + w] = out
            continue
        bdst = beta[:, row[C_BDST]: row[C_BDST] + w]
        if op == OP_COMBINE:
            bl = beta[:, row[C_BSRC]: row[C_BSRC] + w]
            br = beta[:, row[C_BSRC2]: row[C_BSRC2] + w]
            bdst.copy_(bl * br)
            beta[:, row[C_DST]: row[C_DST] + w] = br
        elif op == OP_RATE0:
            pm += torch.relu(-a).sum(dim=1)
            bdst.fill_(1.0)
        elif op == OP_REP:
            m0 = torch.relu(-a).sum(dim=1)      # cost of all +1
            m1 = torch.relu(a).sum(dim=1)       # cost of all -1
            pm += torch.minimum(m0, m1)
            bdst.copy_(torch.where(m1 < m0, -1.0, 1.0)[:, None].expand(-1, w))
        elif op == OP_RATE1:
            bdst.copy_(torch.where(a < 0, -1.0, 1.0))
        elif op == OP_SPC:
            hard = torch.where(a < 0, -1.0, 1.0)
            odd = (a < 0).sum(dim=1) % 2 == 1
            v0, i0 = a.abs().min(dim=1)         # first minimum on ties
            pm += torch.where(odd, v0, 0.0)
            hard[rows, i0] *= torch.where(odd, -1.0, 1.0)
            bdst.copy_(hard)
        else:
            raise ValueError(f"unknown opcode {op}")
    cw = beta[:, sched.out_off: sched.out_off + n] < 0
    return cw.to(torch.uint8)[:, None, :], pm[:, None]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("sc_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sc_decode_launch.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p, p,
                                     p, p, i, p]
    lib.sc_decode_launch.restype = ctypes.c_int
    lib.sc_decode_occupancy.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.sc_decode_occupancy.restype = ctypes.c_int
    lib.sc_decode_error_string.argtypes = [ctypes.c_int]
    lib.sc_decode_error_string.restype = ctypes.c_char_p
    return lib


def blocks_per_sm(tiers: Tiers) -> int:
    """The blocks of kernel A an SM holds at once with that shared tier
    (the CUDA occupancy calculator; needs the card)."""
    lib = _library()
    blocks = ctypes.c_int(0)
    rc = lib.sc_decode_occupancy(tiers.s_llr_len, tiers.s_beta_len,
                                 int(tiers.beta_bytes == 4),
                                 ctypes.byref(blocks))
    if rc:
        raise RuntimeError("sc_decode occupancy query failed: "
                           + lib.sc_decode_error_string(rc).decode())
    return blocks.value


def check_llrs(llrs: torch.Tensor, sched: Schedule, name: str) -> None:
    """Raise on LLRs the kernels do not take."""
    if llrs.dtype != torch.float32:
        raise TypeError(f"llrs must be float32, got {llrs.dtype}")
    if llrs.dim() != 2 or llrs.shape[1] != sched.code_len:
        raise ValueError(f"llrs shape {tuple(llrs.shape)}, want "
                         f"[batch, {sched.code_len}]")
    if not llrs.is_contiguous():
        raise ValueError("llrs must be contiguous")
    if llrs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {llrs.device}")


def sc_decode(llrs: torch.Tensor, plan: ScPlan, *, beta_compact: bool = True,
              unroll: bool = False, zero_scratch: bool = False):
    """SC-decode a batch: llrs [B, code_len] contiguous f32 ->
    (codewords [B, 1, code_len] uint8, path metrics [B, 1] f32).

    ``beta_compact=False`` keeps the kernel's partial sums in f32 instead
    of int8, ``unroll=True`` runs the kernel generated for this schedule
    (kernels/unroll.py; int8 partial sums only), and ``zero_scratch``
    zero-fills the global scratch first (an override table may read slots
    it never wrote; the plain version starts from zeros, and the kernel
    zeroes its shared tier itself).  The results are the same either
    way.  The frame's state is split as :func:`tiers_of` says.

    On a CUDA tensor this launches the kernel on the current stream
    (counted in ``sc_decode.launches`` for the default instance,
    ``sc_decode.variant_launches[name]`` for the others) and raises if
    the launch fails; on a CPU tensor it runs :func:`sc_decode_reference`."""
    sched = plan.sched
    check_llrs(llrs, sched, "sc_decode")
    if unroll and not beta_compact:
        raise ValueError("only the int8-beta instance is unrolled")
    tiers = tiers_of(sched, beta_compact)
    if llrs.device.type == "cpu":
        return sc_decode_reference(llrs, sched)

    batch, n = llrs.shape
    dev = llrs.device
    alloc = torch.zeros if zero_scratch else torch.empty
    llr_scratch = alloc(batch, tiers.g_llr_len, dtype=torch.float32,
                        device=dev)
    beta_scratch = alloc(batch, tiers.g_beta_len,
                         dtype=torch.int8 if beta_compact else torch.float32,
                         device=dev)
    cw = torch.empty(batch, 1, n, dtype=torch.uint8, device=dev)
    pm = torch.empty(batch, 1, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if unroll:
        from . import unroll as _unroll
        lib = _unroll.library(sched, 1, True)
        rc = lib.unrolled_launch(llrs.data_ptr(), llr_scratch.data_ptr(),
                                 beta_scratch.data_ptr(), cw.data_ptr(),
                                 pm.data_ptr(), batch, stream)
        err = lib.unrolled_error_string
    else:
        lib = _library()
        rows = plan.rows(dev, tiers)
        rc = lib.sc_decode_launch(
            llrs.data_ptr(), rows.data_ptr(), sched.n_ops, n, sched.d0_len,
            tiers.llr_lo, tiers.beta_lo, tiers.s_llr_len, tiers.s_beta_len,
            sched.out_off, int(not beta_compact), llr_scratch.data_ptr(),
            beta_scratch.data_ptr(), cw.data_ptr(), pm.data_ptr(), batch,
            stream)
        err = lib.sc_decode_error_string
    if rc:
        raise RuntimeError("sc_decode kernel launch failed: "
                           + err(rc).decode())
    if unroll:
        sc_decode.variant_launches["unroll"] += 1
    elif not beta_compact:
        sc_decode.variant_launches["beta_f32"] += 1
    else:
        sc_decode.launches += 1
    return cw, pm


sc_decode.launches = 0                           # kernel A
sc_decode.variant_launches = collections.Counter()   # its C' options
