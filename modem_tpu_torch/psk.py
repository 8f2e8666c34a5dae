"""PSK constellations on complex tensors: map / phase / hard / soft.

Counterpart of ``modem_tpu/psk.py`` (reference: psk.hh:9-141).  Bit
groups are [..., BITS] in the +/-1 NRZ domain, symbols complex64.
Layout quirks kept from the reference:

  * QPSK is Gray (I = b0, Q = b1), scaled 1/sqrt(2) (psk.hh:84-87);
  * 8PSK uses the axis-swap layout: b1 signs I, b2 signs Q, b0 selects
    whether |I| = cos(pi/8) or sin(pi/8) (psk.hh:132-139);
  * soft bits scale by DIST * precision (psk.hh:28-29).  The int8
    saturation of the reference's integral code types is not on the
    port's path.
"""

from __future__ import annotations

import numpy as np
import torch

RCP_SQRT_2 = 0.70710678118654752440
COS_PI_8 = 0.92387953251128675613
SIN_PI_8 = 0.38268343236508977173

DIST = {1: 2.0, 2: 2.0 * RCP_SQRT_2, 3: 2.0 * SIN_PI_8}  # keyed by BITS


def _check(mod_bits: int) -> None:
    if mod_bits not in (1, 2, 3):
        raise ValueError(f"unsupported mod_bits {mod_bits}")


def mod_map(mod_bits: int, bits: torch.Tensor) -> torch.Tensor:
    """+/-1 bit groups [..., BITS] (f32) -> complex64 symbols [...]."""
    _check(mod_bits)
    if mod_bits == 1:
        return torch.complex(bits[..., 0], torch.zeros_like(bits[..., 0]))
    if mod_bits == 2:
        return torch.complex(RCP_SQRT_2 * bits[..., 0],
                             RCP_SQRT_2 * bits[..., 1])
    swap = bits[..., 0] < 0
    re = torch.where(swap, SIN_PI_8, COS_PI_8) * bits[..., 1]
    im = torch.where(swap, COS_PI_8, SIN_PI_8) * bits[..., 2]
    return torch.complex(re, im)


def mod_phase(mod_bits: int, bits: torch.Tensor) -> torch.Tensor:
    """Constellation phase angle of each symbol (the encoder's
    differential chain accumulates phases, exact for unit modulus)."""
    sym = mod_map(mod_bits, bits)
    return torch.atan2(sym.imag, sym.real)


def mod_hard(mod_bits: int, sym: torch.Tensor) -> torch.Tensor:
    """Complex symbols [...] -> hard +/-1 bit groups [..., BITS] f32."""
    _check(mod_bits)
    re, im = sym.real, sym.imag
    sgn_re = torch.where(re < 0, -1.0, 1.0)
    sgn_im = torch.where(im < 0, -1.0, 1.0)
    if mod_bits == 1:
        return sgn_re[..., None]
    if mod_bits == 2:
        return torch.stack([sgn_re, sgn_im], dim=-1)
    b0 = torch.where(re.abs() < im.abs(), -1.0, 1.0)
    return torch.stack([b0, sgn_re, sgn_im], dim=-1)


def mod_soft(mod_bits: int, sym: torch.Tensor,
             precision: torch.Tensor) -> torch.Tensor:
    """Complex symbols [...] -> soft bits [..., BITS] f32, scaled by
    DIST * precision (precision broadcasts against the symbols)."""
    _check(mod_bits)
    re, im = sym.real, sym.imag
    scale = DIST[mod_bits] * precision

    def q(v):
        return v * scale

    if mod_bits == 1:
        return q(re)[..., None]
    if mod_bits == 2:
        return torch.stack([q(re), q(im)], dim=-1)
    b0 = q(RCP_SQRT_2 * (re.abs() - im.abs()))
    return torch.stack([b0, q(re), q(im)], dim=-1)


def mod_map_np(mod_bits: int, bits: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`mod_map` in complex128 (for host tables)."""
    bits = np.asarray(bits, dtype=np.float64)
    if mod_bits == 1:
        return bits[..., 0].astype(np.complex128)
    if mod_bits == 2:
        return RCP_SQRT_2 * (bits[..., 0] + 1j * bits[..., 1])
    swap = bits[..., 0] < 0
    re = np.where(swap, SIN_PI_8, COS_PI_8) * bits[..., 1]
    im = np.where(swap, COS_PI_8, SIN_PI_8) * bits[..., 2]
    return re + 1j * im
