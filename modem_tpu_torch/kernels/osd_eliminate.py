"""The OSD header's GF(2) elimination: the CUDA kernel
``csrc/osd_eliminate.cu`` and its plain version
:func:`osd_eliminate_reference`, which CPU tensors take.

Counterpart of the ``lax.scan`` over the 255 columns in
``modem_tpu/fec/osd.py:_rref_gf2`` (no ``pl.pallas_call``).  For each
header b, the [71, 255] generator ``g`` with its columns taken in the
header's reliability order ``perm[b]`` is reduced to row echelon form
over GF(2); the pivots are its first 71 independent columns.  A CUDA
tensor launches the kernel, one warp a header, or raises; a CPU tensor
runs the plain loop on ``g[:, perm].permute(1, 0, 2)``.  Both return the
same bytes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import profiling
from ..profiling import wait
from . import _build

K, N = 71, 255       # the BCH(255,71) generator's rows and columns


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("osd_eliminate")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.osd_eliminate_launch.argtypes = [p, p, p, p, i, p]
    lib.osd_eliminate_launch.restype = ctypes.c_int
    lib.osd_eliminate_error_string.argtypes = [ctypes.c_int]
    lib.osd_eliminate_error_string.restype = ctypes.c_char_p
    return lib


def osd_eliminate_reference(mat: torch.Tensor):
    """Plain PyTorch elimination: reduced row echelon form of a batch of
    [k, n] GF(2) matrices (uint8 0/1) on any device, by a loop over the n
    columns in order, so the pivots are the first k independent columns.
    Returns (reduced [B, k, n], pivot column per row [B, k]).  Adds n to
    ``profiling.osd_steps``; on the card each column's clear waits for it
    once (the host's 0 copied there)."""
    batch, k, n = mat.shape
    dev = mat.device
    m = mat.clone()
    rows = torch.arange(k, device=dev)
    bidx = torch.arange(batch, device=dev)
    rank = torch.zeros(batch, dtype=torch.int64, device=dev)
    pivots = torch.zeros(batch, k, dtype=torch.int64, device=dev)
    profiling.osd_steps += n
    for col in range(n):
        colv = m[:, :, col] > 0
        cand = torch.where(colv & (rows >= rank[:, None]), rows, k)
        prow = cand.min(dim=1).values
        do = (prow < k) & (rank < k)
        rk = rank.clamp(max=k - 1)
        pr = torch.where(do, prow, rk)         # no swap when nothing to do
        row_rank, row_piv = m[bidx, rk], m[bidx, pr]
        m[bidx, pr] = row_rank
        m[bidx, rk] = row_piv
        # clear the column in every other row
        elim = m[:, :, col].clone()
        with wait("osd.column"):
            elim[bidx, rk] = 0
        elim = elim * do[:, None]
        m ^= elim[:, :, None] & m[bidx, rk][:, None, :]
        pivots[bidx, rk] = torch.where(do, col, pivots[bidx, rk])
        rank = rank + do
    return m, pivots


def _check_inputs(g: torch.Tensor, perm: torch.Tensor) -> None:
    """Raise on inputs the kernel does not take."""
    if g.dtype != torch.uint8:
        raise TypeError(f"g must be uint8, got {g.dtype}")
    if perm.dtype != torch.int64:
        raise TypeError(f"perm must be int64, got {perm.dtype}")
    if tuple(g.shape) != (K, N) or perm.dim() != 2 or perm.shape[1] != N:
        raise ValueError(f"g shape {tuple(g.shape)} and perm shape "
                         f"{tuple(perm.shape)}: want ({K}, {N}) and "
                         f"[batch, {N}]")
    if g.device != perm.device:
        raise ValueError(f"g on {g.device} and perm on {perm.device}: "
                         "both must be on one device")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"osd_eliminate runs on cpu or cuda, not "
                         f"{g.device}")
    if not (g.is_contiguous() and perm.is_contiguous()):
        raise ValueError("g and perm must be contiguous")


def osd_eliminate(g: torch.Tensor, perm: torch.Tensor):
    """Eliminate ``g`` [71, 255] uint8 0/1 over GF(2) in each header's
    column order ``perm`` [B, 255] int64 (each row a permutation of
    0..254) -> (reduced matrices [B, 71, 255] uint8, pivot column of
    each row [B, 71] int64, 0 past the rank).

    On a CUDA tensor this launches the kernel on the current stream
    (counted in ``osd_eliminate.launches``; no host wait) and raises if
    the launch fails; on a CPU tensor it runs
    :func:`osd_eliminate_reference`.  Either way it adds n = 255 to
    ``profiling.osd_steps``: the columns of the problem, not those the
    kernel walks (it stops once the rank is 71)."""
    _check_inputs(g, perm)
    if g.device.type == "cpu":
        return osd_eliminate_reference(g[:, perm].permute(1, 0, 2))
    if g.data_ptr() % 16:
        g = g.clone()                # the kernel reads g 16 bytes a load
    batch = perm.shape[0]
    red = torch.empty(batch, K, N, dtype=torch.uint8, device=g.device)
    pivots = torch.empty(batch, K, dtype=torch.int64, device=g.device)
    lib = _library()
    rc = lib.osd_eliminate_launch(
        g.data_ptr(), perm.data_ptr(), red.data_ptr(), pivots.data_ptr(),
        batch, torch.cuda.current_stream(g.device).cuda_stream)
    if rc:
        raise RuntimeError("osd_eliminate kernel launch failed: "
                           + lib.osd_eliminate_error_string(rc).decode())
    osd_eliminate.launches += 1
    profiling.osd_steps += N
    return red, pivots


osd_eliminate.launches = 0
