"""OFDM symbol synthesis and differential demodulation, complex tensors.

Counterpart of ``modem_tpu/ofdm.py`` (reference: encode.cc:80-131,
decode.cc:62-70).  A whole frame's symbols synthesise in one batched
IFFT; the guard crossfade, the only cross-symbol dependency, is a
one-symbol shift.  Conventions kept from the reference:

  * improve_papr (encode.cc:80-100): 4x zero-padded oversample, clip
    |re| and |im| to 1, refilter, keep only originally-occupied bins;
  * symbol IFFT scaled 1/sqrt(8 N) for 3 dB headroom (encode.cc:109);
  * guard = raised-cosine crossfade between the previous symbol's head
    and the current symbol's tail (encode.cc:110-114, 127-130).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import fft


def bin_index(carrier, n: int) -> np.ndarray:
    """Negative-frequency-aware bin mapping (encode.cc:68-71)."""
    return (np.asarray(carrier) + n) % n


def abs2(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 as re^2 + im^2 (f32)."""
    return x.real ** 2 + x.imag ** 2


def demod_or_erase(curr: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Differential demod with erasures (decode.cc:62-70): curr/prev, or
    0 where |prev|^2 == 0 or |curr/prev|^2 > 4 (NaNs erase too, via the
    negated comparisons).  The division is by the real |prev|^2, one
    component at a time."""
    num = curr * prev.conj()
    den = abs2(prev)
    d = den.clamp(min=1e-30)
    cons = torch.complex(num.real / d, num.imag / d)
    ok = (den > 0) & (abs2(cons) <= 4.0)
    return torch.where(ok, cons, torch.zeros((), dtype=cons.dtype,
                                             device=cons.device))


def improve_papr(fdom: torch.Tensor) -> torch.Tensor:
    """Batched 4x-oversampled clip-and-filter of spectra [..., N].
    Bins that were exactly zero stay zero."""
    n = fdom.shape[-1]
    zeros = fdom.new_zeros(fdom.shape[:-1] + (3 * n,))
    # fdom4[bin4(i)] = fdom[bin(i)] for i in [-N/2, N/2)
    fdom4 = torch.cat([fdom[..., : n // 2], zeros, fdom[..., n // 2:]],
                      dim=-1)
    tdom4 = fft.bwd(fdom4) / math.sqrt(4.0 * n)
    amp = torch.maximum(tdom4.real.abs(), tdom4.imag.abs())
    clip = amp > 1.0
    tdom4 = torch.where(
        clip, torch.complex(tdom4.real / amp, tdom4.imag / amp), tdom4)
    spec = fft.fwd(tdom4) / math.sqrt(4.0 * n)
    clipped = torch.cat([spec[..., : n // 2], spec[..., 3 * n + n // 2:]],
                        dim=-1)
    return torch.where(abs2(fdom) > 0, clipped,
                       torch.zeros((), dtype=fdom.dtype, device=fdom.device))


def synthesize(fdom: torch.Tensor, guard_len: int, papr_mask=None):
    """Spectra [..., n_sym, N] -> (waveform [..., n_sym*(G+N)] complex,
    papr [..., n_sym, 2]).

    Applies PAPR reduction where ``papr_mask`` (bool [n_sym]) is true
    (the Schmidl-Cox symbol skips it, encode.cc:153), synthesises all
    symbols with one batched IFFT and emits [guard | symbol] rows with
    the raised-cosine crossfade; the first guard fades in from silence.
    """
    wave, papr, _head = synthesize_carry(fdom, guard_len, papr_mask)
    return wave, papr


def synthesize_carry(fdom: torch.Tensor, guard_len: int, papr_mask=None,
                     prev_head: torch.Tensor | None = None):
    """:func:`synthesize` with the crossfade state explicit.

    ``prev_head``: [..., guard_len] head of the symbol before fdom[..., 0,
    :] (None: silence, a transmission's start).  Returns (wave, papr,
    last head), the last head being that of fdom's last symbol: passed
    to the next call, it lets a long transmission synthesise in chunks
    with the same samples (the crossfade is the only cross-symbol
    dependency).
    """
    n = fdom.shape[-1]
    shaped = improve_papr(fdom)
    if papr_mask is not None:
        mask = torch.as_tensor(papr_mask, device=fdom.device)[:, None]
        shaped = torch.where(mask, shaped, fdom)
    tdom = fft.bwd(shaped) / math.sqrt(8.0 * n)

    x = torch.arange(guard_len, device=fdom.device) / (guard_len - 1)
    w = 0.5 * (1.0 - torch.cos(math.pi * x))
    heads = tdom[..., :guard_len]
    tails = tdom[..., n - guard_len:]
    first = (torch.zeros_like(heads[..., :1, :]) if prev_head is None
             else prev_head[..., None, :])
    prev_heads = torch.cat([first, heads[..., :-1, :]], dim=-2)
    guards = prev_heads * (1.0 - w) + tails * w

    # per-symbol per-axis PAPR (encode.cc:115-126), as metrics
    power = torch.stack([tdom.real ** 2, tdom.imag ** 2], dim=-1)
    papr = n * power.amax(dim=-2) / power.sum(dim=-2).clamp(min=1e-30)

    wave = torch.cat([guards, tdom], dim=-1)
    return wave.reshape(*wave.shape[:-2], -1), papr, heads[..., -1, :]
