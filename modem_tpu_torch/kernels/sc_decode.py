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
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..fec.schedule import (C_BDST, C_BSRC, C_BSRC2, C_DST, C_OP, C_SRC,
                            C_SRC2, C_WIDTH, OP_COMBINE, OP_F, OP_G,
                            OP_RATE0, OP_RATE1, OP_REP, OP_SPC, Schedule,
                            build_schedule)
from . import _build


@dataclasses.dataclass
class ScPlan:
    """A schedule plus its instruction table on each device it ran on."""

    sched: Schedule
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_frozen(cls, frozen: np.ndarray, emit_spc: bool = True
                    ) -> "ScPlan":
        """The schedule of a frozen mask: SPC leaves, or with
        ``emit_spc=False`` SPC nodes decomposed into subtrees."""
        key = np.ascontiguousarray(frozen, dtype=np.uint8).tobytes()
        return cls(build_schedule(key, emit_spc=emit_spc))

    def table(self, device: torch.device) -> torch.Tensor:
        """int32 [n_ops, 14] instruction table on ``device``."""
        if device not in self._tables:
            self._tables[device] = torch.as_tensor(
                self.sched.ops, dtype=torch.int32, device=device).contiguous()
        return self._tables[device]


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
    lib.sc_decode_launch.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p, p,
                                     i, p]
    lib.sc_decode_launch.restype = ctypes.c_int
    lib.sc_decode_error_string.argtypes = [ctypes.c_int]
    lib.sc_decode_error_string.restype = ctypes.c_char_p
    return lib


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
    zero-fills the scratch first (an override table may read slots it
    never wrote; the plain version starts from zeros).  The results are
    the same either way.

    On a CUDA tensor this launches the kernel on the current stream
    (counted in ``sc_decode.launches`` for the default instance,
    ``sc_decode.variant_launches[name]`` for the others) and raises if
    the launch fails; on a CPU tensor it runs :func:`sc_decode_reference`."""
    sched = plan.sched
    check_llrs(llrs, sched, "sc_decode")
    if unroll and not beta_compact:
        raise ValueError("only the int8-beta instance is unrolled")
    if llrs.device.type == "cpu":
        return sc_decode_reference(llrs, sched)

    batch, n = llrs.shape
    dev = llrs.device
    llr_len = sched.sz_llr - sched.d0_len
    alloc = torch.zeros if zero_scratch else torch.empty
    llr_scratch = alloc(batch, llr_len, dtype=torch.float32, device=dev)
    beta_scratch = alloc(batch, sched.sz_beta,
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
        table = plan.table(dev)
        rc = lib.sc_decode_launch(
            llrs.data_ptr(), table.data_ptr(), sched.n_ops, n, sched.d0_len,
            llr_len, sched.sz_beta, sched.out_off, int(not beta_compact),
            llr_scratch.data_ptr(), beta_scratch.data_ptr(), cw.data_ptr(),
            pm.data_ptr(), batch, stream)
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
