"""Schmidl-Cox synchronisation over batches of whole recordings.

Counterpart of the batch-path half of ``modem_tpu/sync.py`` (reference:
SchmidlCox, decode.cc:37-153): the coarse timing metric over a whole
recording (at full rate or on a stride grid) and the fine stage at one
candidate (fractional-CFO mixdown, L-point FFT, adjacent-bin
differential, circular correlation against the MLS0 kernel).  The
Schmitt-trigger scan, chunked long-recording pass and streaming wait
for later work.  Recordings are complex [B, T] tensors; positions are in
recording coordinates, ``p0`` pointing at the first payload sample of
the Schmidl-Cox symbol (decode.cc:84-152).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import bits as B
from . import fft, ofdm
from .numerology import ModemConfig


def window_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """y[..., n] = sum(x[..., n-w+1 .. n]) over the last axis, same
    length, as f32.

    A float64 cumulative-sum difference: its cancellation error is
    eps64 times the running total, far below f32 resolution even over
    minutes of audio, so the sums do not drift (the reference's
    recursive SMA does not either, decode.cc:45-47; a plain f32 cumsum
    would).
    """
    c = torch.cumsum(x.to(torch.float64), dim=-1)
    y = c.clone()
    y[..., w:] -= c[..., :-w]
    return y.to(torch.float32)


def mls0_kernel(cfg: ModemConfig) -> np.ndarray:
    """Matched kernel conj(FFT(seq)) / L over L = symbol_len / 2 bins
    from the receive-side MLS0 layout (decode.cc:236-244, 76-83), as the
    JAX package builds it: complex64 [L]."""
    L = cfg.symbol_len // 2
    rx_off = -(cfg.mls0_len - 1)
    bins = (np.arange(cfg.mls0_len) + rx_off // 2 + L) % L
    seq = np.zeros(L, dtype=np.complex64)
    seq[bins] = B.mls_nrz(cfg.mls0_poly, cfg.mls0_len,
                          convention=cfg.mls_convention)
    return (np.conj(np.fft.fft(seq)) / L).astype(np.complex64)


def slice_windows(x: torch.Tensor, start: torch.Tensor,
                  length: int) -> torch.Tensor:
    """x[b, start[b] : start[b] + length] for every row b, with the start
    clamped so the window lies inside the recording (lax.dynamic_slice
    semantics).  One gather from a strided view, no index tensor of the
    window's size."""
    start = start.clamp(0, x.shape[-1] - length)
    rows = torch.arange(x.shape[0], device=x.device)
    return x.unfold(-1, length, 1)[rows, start]


class Synchronizer:
    """Per-config Schmidl-Cox detector (operates at L = symbol_len / 2).

    ``kernel``: the MLS0 matched kernel (complex64 [L]); by default
    built by :func:`mls0_kernel`."""

    def __init__(self, cfg: ModemConfig, device="cpu",
                 kernel: torch.Tensor | None = None):
        self.cfg = cfg
        self.L = cfg.symbol_len // 2
        self.match_len = cfg.guard_len | 1
        self.match_del = (self.match_len - 1) // 2
        self.thr_lo = 0.17 * self.match_len   # decode.cc:76
        self.thr_hi = 0.19 * self.match_len
        if kernel is None:
            kernel = torch.from_numpy(mls0_kernel(cfg))
        self.kernel = kernel.to(device=device, dtype=torch.complex64)

    def _products(self, x: torch.Tensor):
        """Correlation products x[v+L] * conj(x[v+2L]) and powers
        |x[v+2L]|^2 for every lag v."""
        L = self.L
        b = x[..., 2 * L:]
        a = x[..., L: L + b.shape[-1]]
        return a * b.conj(), ofdm.abs2(b)

    def _timing(self, p_re, p_im, power, match_len: int):
        r = torch.clamp(0.5 * power, min=1e-4 * self.L)
        return window_sum((p_re ** 2 + p_im ** 2) / (r * r), match_len)

    def _metrics_parts(self, x: torch.Tensor):
        """x: [B, T] complex -> (timing, p_re, p_im), each [B, T - 2L]
        f32: timing[n] belongs to a S&C symbol whose payload starts at
        n - match_del (before the fine correction), and the phase there
        is atan2(p_im, p_re)[n]."""
        prod, pb = self._products(x)
        p_re = window_sum(prod.real, self.L)
        p_im = window_sum(prod.imag, self.L)
        power = window_sum(pb, 2 * self.L)
        return self._timing(p_re, p_im, power, self.match_len), p_re, p_im

    def stride_ok(self, stride: int) -> bool:
        """Whether the strided metric keeps the P/R window sums and the
        phase-readout position exact at this numerology (L, 2L and
        match_del divisible by the stride)."""
        return (stride > 1 and self.L % stride == 0
                and self.match_del % stride == 0
                and self.match_len >= stride)

    def _metrics_parts_strided(self, x: torch.Tensor, stride: int):
        """The timing metric evaluated every ``stride`` samples (entry m
        is full-rate index m*stride + stride - 1).  The correlation and
        power windows end on stride multiples, so p_re/p_im/power there
        are the full-rate values; only the match filter (an SMA over
        match_len ratios, decode.cc:90) becomes stride * the sum of
        match_len // stride strided ratios.  The fine stage's
        |pos_err| <= guard/2 correction absorbs the coarse grid."""
        S = stride
        prod, pb = self._products(x)
        t8 = prod.shape[-1] // S
        rb = prod[..., : t8 * S].reshape(*prod.shape[:-1], t8, S).sum(-1)
        pbb = pb[..., : t8 * S].reshape(*pb.shape[:-1], t8, S).sum(-1)
        p_re = window_sum(rb.real, self.L // S)
        p_im = window_sum(rb.imag, self.L // S)
        power = window_sum(pbb, 2 * self.L // S)
        timing = S * self._timing(p_re, p_im, power, self.match_len // S)
        return timing, p_re, p_im

    def _fine_stage(self, window: torch.Tensor, frac_cfo: torch.Tensor):
        """window: [B, L] samples x[p0+L : p0+2L] (second half of the S&C
        symbol), frac_cfo: [B].  Returns (shift, pos_err, peak, next,
        angle), each [B] (decode.cc:110-146)."""
        L = self.L
        idx = torch.arange(L, dtype=torch.float32, device=window.device)
        arg = frac_cfo[:, None] * idx
        spec = fft.fwd(window * torch.complex(torch.cos(arg), torch.sin(arg)))
        cons = ofdm.demod_or_erase(spec, torch.roll(spec, 1, dims=-1))
        corr = fft.bwd(fft.fwd(cons) * self.kernel)
        pwr = ofdm.abs2(corr)
        shift = pwr.argmax(dim=-1)
        peak = pwr.gather(-1, shift[:, None])[:, 0]
        nxt = pwr.scatter(-1, shift[:, None], -math.inf).amax(dim=-1)
        c = corr.gather(-1, shift[:, None])[:, 0]
        ang = torch.atan2(c.imag, c.real)
        pos_err = torch.round(ang * L / (2.0 * math.pi)).to(torch.int64)
        return shift, pos_err, peak, nxt, ang
