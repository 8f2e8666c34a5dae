"""The modem's state, carried across from numpy arrays.

The modem has no learned weights.  What it carries are tables built
from its configuration: the polar code's frozen mask, the SC decoder's
instruction table, the CRC-32 check matrix, the MLS0 matched kernel of
the synchroniser, and the encoder's pilot and Schmidl-Cox spectra and
MLS1 header scrambler.  :func:`state_from_numpy` takes these as numpy
arrays (as the JAX package builds them, or as the port's own builders
do, :func:`build_state`) and makes the port's tensors from them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bits as B
from .fec.polar import PolarCode
from .fec.schedule import build_schedule
from .numerology import ModemConfig

ARRAYS = ("frozen", "schedule", "crc_matrix", "mls0_kernel", "pilot_fdom",
          "sc_fdom", "mls1_seq")


@dataclasses.dataclass(frozen=True)
class PipelineState:
    """Tensors on one device; a field is None where the caller gave no
    array.  Shapes: frozen uint8 [code_len]; schedule int32 [n_ops, 14];
    crc_matrix f32 [crc_bits, 32]; mls0_kernel complex64 [L];
    pilot_fdom and sc_fdom complex64 [symbol_len]; mls1_seq f32
    [mls1_len] (+/-1).  A receiver of every convention (``"auto"``)
    holds one row per convention: mls0_kernel [K, L], mls1_seq
    [K, mls1_len]."""

    frozen: torch.Tensor | None = None
    schedule: torch.Tensor | None = None
    crc_matrix: torch.Tensor | None = None
    mls0_kernel: torch.Tensor | None = None
    pilot_fdom: torch.Tensor | None = None
    sc_fdom: torch.Tensor | None = None
    mls1_seq: torch.Tensor | None = None


_DTYPES = {"frozen": torch.uint8, "schedule": torch.int32,
           "crc_matrix": torch.float32, "mls0_kernel": torch.complex64,
           "pilot_fdom": torch.complex64, "sc_fdom": torch.complex64,
           "mls1_seq": torch.float32}


def _complex(a: np.ndarray) -> np.ndarray:
    """complex array, or split-complex [..., 2] float -> complex64."""
    a = np.asarray(a)
    if not np.iscomplexobj(a):
        if a.shape[-1] != 2:
            raise ValueError(f"expected complex or [..., 2], got {a.shape}")
        a = a[..., 0] + 1j * a[..., 1]
    return a.astype(np.complex64)


def state_from_numpy(device="cpu", **arrays) -> PipelineState:
    """Make the port's state tensors from numpy arrays named as the
    fields of :class:`PipelineState`.

    ``mls0_kernel`` may be split-complex: the JAX synchroniser keeps its
    kernels as ``kerns`` [K, L, 2], one row per MLS convention, which
    passes whole (and its JAX ``Decoder._mls1_seqs`` [K, mls1_len] as
    ``mls1_seq``), or one row of it for a committed convention."""
    unknown = set(arrays) - set(ARRAYS)
    if unknown:
        raise TypeError(f"unknown state arrays {sorted(unknown)}")
    out = {}
    for name, value in arrays.items():
        if name in ("mls0_kernel", "pilot_fdom", "sc_fdom"):
            value = _complex(value)
        out[name] = torch.as_tensor(np.array(value),
                                    dtype=_DTYPES[name], device=device)
    return PipelineState(**out)


def build_state(cfg: ModemConfig, device="cpu") -> PipelineState:
    """The port's own builders for every array of ``cfg``'s state.  Under
    ``mls_convention="auto"`` (receive only) the MLS0 kernels and MLS1
    scramblers of every convention, and no transmit spectra."""
    # imported here: both modules take their default state from this one
    from .encoder import encoder_spectra
    from .sync import conventions, mls0_kernel

    mode = cfg.mode
    code = PolarCode(n=mode.cons_bits, k=mode.crc_bits,
                     order=mode.code_order)
    sched = build_schedule(code.frozen.tobytes(), emit_spc=True)
    if cfg.mls_convention == "auto":
        spectra = dict(mls1_seq=np.stack([
            B.mls_nrz(cfg.mls1_poly, cfg.mls1_len, convention=c)
            for c in conventions(cfg)]))
    else:
        spectra = encoder_spectra(cfg)
    return state_from_numpy(
        device=device, frozen=code.frozen, schedule=sched.ops,
        crc_matrix=B.crc32.check_matrix(mode.crc_bits).astype(np.float32),
        mls0_kernel=mls0_kernel(cfg), **spectra)
