"""Polar transform, systematic encoding and shortening, in PyTorch.

Counterpart of ``modem_tpu/fec/polar.py`` (reference call sites:
CODE::PolarSysEnc at encode.cc:48,302; shorten at encode.cc:180-186;
lengthen at decode.cc:245-253).  The mother code is natural-order
x = u F^{(x)m} over GF(2) with F = [[1,0],[1,1]]; since F^{(x)m} is an
involution mod 2, systematic encoding is encode -> clear the frozen
positions -> encode.  Shortening keeps every frozen position plus the
first ``k`` information positions; the dropped information tail is
pinned to bit 0 (a large known-bit LLR on the receive side).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .freezer import frozen_mask


def polar_transform_np(u: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`polar_transform`: x = u F^{(x)m} over GF(2),
    u [..., N] of 0/1."""
    x = np.asarray(u, dtype=np.uint8).copy()
    n = x.shape[-1]
    lead = x.shape[:-1]
    for s in range(n.bit_length() - 1):
        v = x.reshape(*lead, 1 << s, 2, n >> (s + 1))
        v[..., 0, :] ^= v[..., 1, :]
    return x


def polar_transform(u: torch.Tensor) -> torch.Tensor:
    """x = u F^{(x)m} over GF(2); u is [..., N] uint8 0/1, N a power of
    two.  Returns a new tensor (the butterflies run in place on a copy)."""
    x = u.clone()
    n = x.shape[-1]
    lead = x.shape[:-1]
    for s in range(n.bit_length() - 1):
        v = x.view(*lead, 1 << s, 2, n >> (s + 1))
        v[..., 0, :] ^= v[..., 1, :]
    return x


@dataclasses.dataclass(frozen=True, eq=False)
class PolarCode:
    """One shortened systematic polar code.  ``frozen`` defaults to the
    mask that :func:`freezer.frozen_mask` designs for (n, k, order)."""

    n: int            # shortened (transmitted) length, e.g. 64800
    k: int            # payload + crc bits carried, e.g. 43072
    order: int        # mother code log2 length
    frozen: np.ndarray = None

    def __post_init__(self):
        mask = (frozen_mask(self.n, self.k, self.order)
                if self.frozen is None
                else np.asarray(self.frozen, dtype=np.uint8))
        if mask.shape != (self.code_len,):
            raise ValueError(f"frozen mask shape {mask.shape}, "
                             f"want ({self.code_len},)")
        object.__setattr__(self, "frozen", mask)
        object.__setattr__(self, "_on_device", {})

    @property
    def code_len(self) -> int:
        return 1 << self.order

    @property
    def mesg_bits(self) -> int:
        """Info positions of the mother code (incl. the shortened tail)."""
        return self.k + self.code_len - self.n

    @functools.cached_property
    def info_idx(self) -> np.ndarray:
        """Mother-code positions of the mesg_bits info bits, ascending."""
        return np.nonzero(self.frozen == 0)[0].astype(np.int64)

    @functools.cached_property
    def kept_idx(self) -> np.ndarray:
        """Mother-code positions transmitted after shortening, ascending
        (encode.cc:180-186: all frozen positions plus the first k
        information positions)."""
        kept = np.union1d(np.nonzero(self.frozen)[0], self.info_idx[: self.k])
        if len(kept) != self.n:
            raise ValueError(f"{len(kept)} kept positions, want {self.n}")
        return kept.astype(np.int64)

    @functools.cached_property
    def shortened_idx(self) -> np.ndarray:
        """Dropped mother-code positions (known bit 0)."""
        return self.info_idx[self.k:]

    def _index(self, name: str, device) -> torch.Tensor:
        """Host index/mask array ``name`` as a tensor on ``device``,
        copied there once."""
        key = (name, torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(getattr(self, name),
                                                   device=device)
        return self._on_device[key]

    def encode_systematic(self, mesg_bits: torch.Tensor) -> torch.Tensor:
        """[..., mesg_bits] uint8 info bits -> [..., code_len] codeword
        with the info bits verbatim at ``info_idx``."""
        u = torch.zeros(mesg_bits.shape[:-1] + (self.code_len,),
                        dtype=torch.uint8, device=mesg_bits.device)
        u[..., self._index("info_idx", mesg_bits.device)] = mesg_bits.to(
            torch.uint8)
        x = polar_transform(u)
        x *= self._index("info_mask", mesg_bits.device)
        return polar_transform(x)

    @functools.cached_property
    def info_mask(self) -> np.ndarray:
        return (1 - self.frozen).astype(np.uint8)

    def shorten(self, codeword: torch.Tensor) -> torch.Tensor:
        return codeword[..., self._index("kept_idx", codeword.device)]

    def lengthen(self, llrs: torch.Tensor,
                 known_llr: float = 9000.0) -> torch.Tensor:
        """Scatter received LLRs back to mother-code positions; shortened
        positions get the known-bit-0 LLR (decode.cc:245-253)."""
        out = torch.full(llrs.shape[:-1] + (self.code_len,), known_llr,
                         dtype=llrs.dtype, device=llrs.device)
        out[..., self._index("kept_idx", llrs.device)] = llrs
        return out

    # -- numpy twins (host tables and tests) --------------------------------

    def encode_systematic_np(self, mesg_bits: np.ndarray) -> np.ndarray:
        """Numpy twin of :meth:`encode_systematic`."""
        u = np.zeros(mesg_bits.shape[:-1] + (self.code_len,), dtype=np.uint8)
        u[..., self.info_idx] = mesg_bits
        x = polar_transform_np(u)
        x[..., np.nonzero(self.frozen)[0]] = 0
        return polar_transform_np(x)

    def shorten_np(self, codeword: np.ndarray) -> np.ndarray:
        return codeword[..., self.kept_idx]

    def lengthen_np(self, llrs: np.ndarray,
                    known_llr: float = 9000.0) -> np.ndarray:
        """Numpy twin of :meth:`lengthen`."""
        out = np.full(llrs.shape[:-1] + (self.code_len,), known_llr,
                      dtype=llrs.dtype)
        out[..., self.kept_idx] = llrs
        return out

    def extract_info_np(self, codeword: np.ndarray) -> np.ndarray:
        """Codeword -> the k payload+crc bits (systematic positions)."""
        return codeword[..., self.info_idx[: self.k]]


@functools.lru_cache(maxsize=None)
def wire_code(n: int, k: int = 43072, order: int = 16) -> PolarCode:
    return PolarCode(n=n, k=k, order=order)
