"""The batch receiver's front end, plain PyTorch on any device:
single-frame recordings [B, T] -> channel LLRs of the mother code and
each frame's sync readings (decode.cc:37-153, 456-523).

  1. coarse sync: the Schmidl-Cox timing metric on a stride-S grid
     (correlation and power window sums end on stride multiples, the
     match filter summed over match_len // S strided ratios) and its
     argmax; the fractional CFO from the correlation's phase there;
  2. fine sync at the argmax: fractional-CFO mixdown of the second half
     of the S&C symbol, an L-point FFT, adjacent-bin differential,
     circular correlation against the MLS0 kernel: integer CFO, timing
     correction and the peak / next-peak gate;
  3. demod: pilot + payload windows, CFO mixdown, FFT, differential
     demod with erasures, per-row Theil-Sen derotation over the disjoint
     pairs (i, i + n/2), cumulative-SNR soft demap, lengthening to the
     mother code (shortened positions get the known-bit LLR 9000).

``q`` rounds what each stage hands on: the identity for the reference,
a rounding to bfloat16 for the lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import modem as M
from .encoder import COS_PI_8, RCP_SQRT_2, SIN_PI_8, bwd, fwd

DIST = {2: 2.0 * RCP_SQRT_2, 3: 2.0 * SIN_PI_8}


def identity(x):
    return x


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """x with every real component rounded to bfloat16 (kept in x's
    dtype): the control's storage precision between stages."""
    if x.is_complex():
        return torch.complex(to_bf16(x.real), to_bf16(x.imag))
    if not x.is_floating_point():
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def window_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """Sum of the last w samples at every index (f64 running sums)."""
    c = torch.cumsum(x.to(torch.float64), dim=-1)
    y = c.clone()
    y[..., w:] -= c[..., :-w]
    return y.to(torch.float32)


def abs2(x):
    return x.real ** 2 + x.imag ** 2


def slice_windows(x: torch.Tensor, start: torch.Tensor, length: int):
    start = start.clamp(0, x.shape[-1] - length)
    idx = start[:, None] + torch.arange(length, device=x.device)
    return x.gather(1, idx)


def demod_or_erase(curr, prev):
    """curr / prev, 0 where |prev|^2 == 0 or the ratio's |.|^2 > 4."""
    num = curr * prev.conj()
    den = abs2(prev)
    d = den.clamp(min=1e-30)
    cons = torch.complex(num.real / d, num.imag / d)
    ok = (den > 0) & (abs2(cons) <= 4.0)
    return torch.where(ok, cons, torch.zeros_like(cons))


def psk_hard(mod_bits: int, sym):
    """Hard decision as the nearest constellation point, complex."""
    re, im = sym.real, sym.imag
    sr = torch.where(re < 0, -1.0, 1.0)
    si = torch.where(im < 0, -1.0, 1.0)
    if mod_bits == 2:
        return torch.complex(RCP_SQRT_2 * sr, RCP_SQRT_2 * si)
    swap = re.abs() < im.abs()
    return torch.complex(torch.where(swap, SIN_PI_8, COS_PI_8) * sr,
                         torch.where(swap, COS_PI_8, SIN_PI_8) * si)


def psk_soft(mod_bits: int, sym, precision):
    scale = DIST[mod_bits] * precision
    re, im = sym.real * scale, sym.imag * scale
    if mod_bits == 2:
        return torch.stack([re, im], dim=-1)
    b0 = RCP_SQRT_2 * (sym.real.abs() - sym.imag.abs()) * scale
    return torch.stack([b0, re, im], dim=-1)


def median_upper(v):
    return torch.sort(v, dim=-1).values[..., v.shape[-1] // 2]


class FrontEnd:
    """One configuration's receiver constants on ``device``."""

    def __init__(self, cfg: M.Config, device, stride: int = 8):
        self.cfg = cfg
        self.device = torch.device(device)
        self.L = L = cfg.symbol_len // 2
        self.match_len = cfg.guard_len | 1
        self.match_del = (self.match_len - 1) // 2
        self.thr_hi = 0.19 * self.match_len
        ok = (stride > 1 and L % stride == 0
              and self.match_del % stride == 0 and self.match_len >= stride)
        self.stride = stride if ok else 1
        seq = np.zeros(L, np.complex128)
        seq[(np.arange(M.MLS0_LEN) + (-(M.MLS0_LEN - 1)) // 2 + L) % L] = (
            M.nrz(M.mls_bits(M.MLS0_POLY, M.MLS0_LEN)))
        self.kernel = torch.as_tensor(
            (np.conj(np.fft.fft(seq)) / L).astype(np.complex64),
            device=self.device)
        mode = cfg.mode
        self.code = M.Code(mode)
        code_off = -mode.cons_cols // 2
        self.code_off = code_off
        self.bins = torch.as_tensor(M.bin_index(
            np.arange(code_off, code_off + mode.cons_cols),
            cfg.symbol_len), device=self.device)
        self.kept = torch.as_tensor(self.code.kept_idx, device=self.device)

    def coarse(self, x, q):
        """Strided timing metric and its argmax -> (p0, frac CFO,
        multiframe) [B]."""
        L, S = self.L, self.stride
        b = x[:, 2 * L:]
        a = x[:, L: L + b.shape[-1]]
        prod, pb = q(a * b.conj()), q(abs2(b))
        t = prod.shape[-1] // S
        rb = prod[:, : t * S].reshape(-1, t, S).sum(-1)
        pbb = pb[:, : t * S].reshape(-1, t, S).sum(-1)
        p_re = window_sum(rb.real, L // S)
        p_im = window_sum(rb.imag, L // S)
        power = window_sum(pbb, 2 * L // S)
        r = torch.clamp(0.5 * power, min=1e-4 * L)
        timing = S * window_sum((p_re ** 2 + p_im ** 2) / (r * r),
                                self.match_len // S)
        timing = q(timing)
        m_max = timing.argmax(dim=-1)
        n_max = m_max * S + (S - 1)
        p0 = n_max - self.match_del
        i = (m_max - self.match_del // S).clamp(min=0)[:, None]
        fc = torch.atan2(p_im.gather(-1, i), p_re.gather(-1, i))[:, 0] / L
        idx = torch.arange(timing.shape[-1], device=x.device) * S + (S - 1)
        sg = self.cfg.extended_len
        inside = ((idx >= (n_max - 2 * sg)[:, None])
                  & (idx <= (n_max + self.cfg.frame_samples)[:, None]))
        extra = timing.masked_fill(inside, -math.inf).amax(dim=-1)
        return p0, q(fc), extra > self.thr_hi

    def fine(self, window, frac_cfo, q):
        """-> (integer shift, timing error, peak, next peak) [B]."""
        L = self.L
        arg = frac_cfo[:, None] * torch.arange(L, dtype=torch.float32,
                                               device=window.device)
        spec = q(fwd(window * torch.polar(torch.ones_like(arg), arg)))
        cons = q(demod_or_erase(spec, torch.roll(spec, 1, dims=-1)))
        corr = q(bwd(fwd(cons) * self.kernel))
        pwr = abs2(corr)
        shift = pwr.argmax(dim=-1)
        peak = pwr.gather(-1, shift[:, None])[:, 0]
        nxt = pwr.scatter(-1, shift[:, None], -math.inf).amax(dim=-1)
        c = corr.gather(-1, shift[:, None])[:, 0]
        pos_err = torch.round(torch.atan2(c.imag, c.real) * L
                              / (2.0 * math.pi)).to(torch.int64)
        return shift, pos_err, peak, nxt

    def __call__(self, x: torch.Tensor, q=identity) -> dict:
        """Recordings [B, T] complex64 -> dict llrs [B, code_len], p0,
        cfo_rad, snr [B, rows], sync_gate, multiframe."""
        cfg = self.cfg
        mode = cfg.mode
        s, g = cfg.symbol_len, cfg.guard_len
        rows = mode.cons_rows
        L = self.L
        x = q(x)
        batch = x.shape[0]
        p0, fc, multiframe = self.coarse(x, q)
        shift, pos_err, peak, nxt = self.fine(
            slice_windows(x, p0 + L, L), fc, q)
        p0 = p0 - pos_err
        cfo = shift.to(torch.float32) * (2.0 * math.pi / L) - fc
        cfo = q(torch.where(cfo >= math.pi, cfo - 2.0 * math.pi, cfo))
        flat = slice_windows(x, p0 + 2 * (s + g), rows * (s + g) + s)
        head = flat[:, : rows * (s + g)].reshape(batch, rows, s + g)[..., :s]
        windows = torch.cat([head, flat[:, None, rows * (s + g):]], dim=1)
        w = torch.arange(rows + 1, dtype=torch.float32,
                         device=x.device)[:, None]
        k = torch.arange(s, dtype=torch.float32, device=x.device)[None, :]
        phase = -cfo[:, None, None] * (s + w * (s + g) + k)
        spec = q(fwd(q(windows * torch.polar(torch.ones_like(phase),
                                             phase))))
        car = spec[..., self.bins]
        cons = q(demod_or_erase(car[:, 1:], car[:, :-1]))
        cons = q(self.derotate(cons))
        llrs, snr = self.demap(cons, q)
        full = torch.full((batch, mode.code_len), 9000.0,
                          dtype=torch.float32, device=x.device)
        full[:, self.kept] = llrs.reshape(batch, -1)
        return dict(llrs=full, p0=p0, cfo_rad=cfo, snr=snr,
                    sync_gate=peak > 4.0 * nxt, multiframe=multiframe)

    def derotate(self, cons):
        """Per-row Theil-Sen phase fit over the disjoint pairs, removed."""
        cols = cons.shape[-1]
        x = (torch.arange(cols, device=cons.device)
             + self.code_off).to(torch.float32)
        ref = psk_hard(self.cfg.mode.mod_bits, cons)
        err = torch.atan2(cons.imag * ref.real - cons.real * ref.imag,
                          cons.real * ref.real + cons.imag * ref.imag)
        h = cols // 2
        slope = median_upper((err[..., h: 2 * h] - err[..., :h])
                             / (x[h: 2 * h] - x[:h]))
        yint = median_upper(err - slope[..., None] * x)
        theta = -(slope[..., None] * x + yint[..., None])
        return cons * torch.polar(torch.ones_like(theta), theta)

    def demap(self, cons, q):
        """Cumulative-SNR soft demap: row r's precision is the signal
        over the noise power summed over rows 0..r."""
        mod_bits = self.cfg.mode.mod_bits
        ref = psk_hard(mod_bits, cons)
        sp = torch.cumsum(abs2(ref).sum(dim=-1), dim=-1)
        npow = torch.cumsum(abs2(cons - ref).sum(dim=-1), dim=-1)
        precision = q(sp / npow.clamp(min=1e-12))
        llrs = q(psk_soft(mod_bits, cons, precision[..., None]))
        return llrs, 10.0 * torch.log10(precision)
