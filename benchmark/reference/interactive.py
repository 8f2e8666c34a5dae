"""The interactive receiver, plain PyTorch and numpy: one recording ->
the first frame whose header validates, decoded (decode.cc:161-557).

  1. front end of a mono recording: DC block (the causal mean over
     2 (symbol + guard) samples), then a Blackman-windowed FIR Hilbert
     transformer of ``filter_len`` taps with the real path delayed to
     match;
  2. the Schmidl-Cox scan over the whole recording: the full-rate timing
     metric, the Schmitt trigger (thresholds 0.17 and 0.19 x match_len),
     on each falling edge the first maximum of the run it ends and the
     correlation's phase match_del samples before it; the fine stage and
     its gates (peak > 4 next, |timing error| <= guard / 2); at most 32
     falling edges;
  3. the header of the first passing candidate: CFO mixdown, FFT, MLS1
     descramble, bin-differential soft bits rounded to [-128, 127],
     order-4 OSD, CRC-16, mode and call sign;
  4. the payload: per-row FFT with the CFO phase continued from the
     header symbol, differential demod, all-pairs Theil-Sen derotation,
     cumulative-SNR demap, lengthening; the exact list-8 decode; the
     first path in path-metric order whose CRC-32 holds.

``q`` rounds what each stage hands on (the bfloat16 control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import modem as M
from .encoder import fwd
from .frontend import (FrontEnd, abs2, demod_or_erase, identity,
                       median_upper, psk_hard, window_sum)
from .osd import osd_decode
from .polar import scl_decode

MAX_EDGES = 32


def filter_len(rate: int) -> int:
    return (((21 * rate) // 8000) & ~3) | 1


def analytic(x: torch.Tensor, rate: int) -> torch.Tensor:
    """DC block and Hilbert of a real mono recording [T] -> complex64."""
    cfg_ext = (1280 * rate) // 8000 * 9 // 8
    win = 2 * cfg_ext
    s = window_sum(x, win)
    cnt = torch.arange(1, x.shape[-1] + 1, device=x.device).clamp(max=win)
    x = x - s / cnt
    taps = filter_len(rate)
    m = np.arange(taps) - (taps - 1) // 2
    h = np.zeros(taps)
    odd = m % 2 != 0
    h[odd] = 2.0 / (np.pi * m[odd])
    h = torch.as_tensor((h * np.blackman(taps)).astype(np.float32),
                        device=x.device)
    d = (taps - 1) // 2
    xp = torch.cat([x.new_zeros(taps - 1), x])
    im = xp.unfold(0, taps, 1) @ h.flip(0)
    re = torch.cat([x.new_zeros(d), x])[: x.shape[0]]
    return torch.complex(re, im)


def schmitt_events(t: np.ndarray, ph: np.ndarray, lo: float, hi: float,
                   match_del: int, max_edges: int) -> list:
    """The Schmitt trigger over the timing metric ``t`` (on above ``hi``,
    off below ``lo`` or at NaN, else as before; off before the first
    sample) and, at each of its first ``max_edges`` falling edges, the
    first maximum of the run it ends and the phase ``match_del`` samples
    before that (index 0 at the start): [(edge, n_max, phase)].

    No per-sample loop: the state at n is on exactly when the last
    sample up to n above ``hi`` comes after the last one below ``lo``;
    the k-th falling edge ends the run of the k-th rising edge."""
    idx = np.arange(t.shape[0])
    last_hi = np.maximum.accumulate(np.where(t > hi, idx, -1))
    last_lo = np.maximum.accumulate(np.where(~(t >= lo), idx, -1))
    on = last_hi > last_lo
    before = np.concatenate([[False], on[:-1]])
    rises = np.flatnonzero(on & ~before)
    falls = np.flatnonzero(before & ~on)[:max_edges]
    out = []
    for r, f in zip(rises, falls):
        n_max = int(r + np.argmax(t[r:f]))
        out.append((int(f), n_max, float(ph[max(n_max - match_del, 0)])))
    return out


class Receiver:
    """The interactive decoder of one rate on ``device``."""

    def __init__(self, rate: int, list_size: int, device):
        self.rate = rate
        self.list_size = list_size
        self.device = torch.device(device)
        # the synchroniser and header use the receive layout (freq_off 0)
        self.sync = FrontEnd(M.Config(rate, M.MODES[6], 0), device, 1)
        cfg = self.sync.cfg
        n = cfg.symbol_len
        off = -(M.MLS1_LEN // 2)
        self.hdr_bins = torch.as_tensor(M.bin_index(
            np.arange(M.MLS1_LEN) + off, n), device=self.device)
        self.hdr_prev = torch.as_tensor(M.bin_index(
            np.arange(M.MLS1_LEN) + off - 1, n), device=self.device)
        seq = torch.as_tensor(M.nrz(M.mls_bits(M.MLS1_POLY, M.MLS1_LEN)),
                              dtype=torch.float32, device=self.device)
        self.mls1 = seq
        self.mls1_prev = torch.cat([seq.new_ones(1), seq[:-1]])

    # -- the scan ---------------------------------------------------------
    def metric(self, x: torch.Tensor, q):
        """The full-rate timing metric t[n] and the correlation's phase
        at every n, host numpy (f32)."""
        fe = self.sync
        L = fe.L
        b = x[2 * L:]
        a = x[L: L + b.shape[0]]
        prod, pb = q(a * b.conj()), q(abs2(b))
        p_re = window_sum(prod.real, L)
        p_im = window_sum(prod.imag, L)
        power = window_sum(pb, 2 * L)
        r = torch.clamp(0.5 * power, min=1e-4 * L)
        t = q(window_sum((p_re ** 2 + p_im ** 2) / (r * r), fe.match_len))
        ph = torch.atan2(p_im, p_re)
        return t.cpu().numpy(), ph.cpu().numpy()

    def events(self, x: torch.Tensor, q, max_edges: int = MAX_EDGES):
        """(edge, n_max, phase) of the first ``max_edges`` falling
        edges."""
        fe = self.sync
        t, ph = self.metric(x, q)
        return schmitt_events(t, ph, 0.17 * fe.match_len,
                              0.19 * fe.match_len, fe.match_del, max_edges)

    def candidates(self, x: torch.Tensor, q, max_edges: int = MAX_EDGES):
        """Candidates in time order: (ok, p0, cfo_rad)."""
        fe, cfg = self.sync, self.sync.cfg
        L = fe.L
        found = []
        for edge, n_max, ph in self.events(x, q, max_edges):
            index_max = min(edge - 1 - n_max + fe.match_del,
                            L + cfg.guard_len + fe.match_del)
            found.append(((edge - 1) - index_max, ph / L))
        if not found:
            return []
        starts = torch.tensor([p0 + L for p0, _ in found], device=x.device)
        idx = starts[:, None] + torch.arange(L, device=x.device)
        inside = (idx >= 0) & (idx < x.shape[0])
        wins = torch.where(inside, x[idx.clamp(0, x.shape[0] - 1)],
                           torch.zeros((), dtype=x.dtype, device=x.device))
        fcs = torch.tensor([fc for _, fc in found], dtype=torch.float32,
                           device=x.device)
        shift, err, peak, nxt = fe.fine(wins, fcs, q)
        out = []
        for i, (p0, fc) in enumerate(found):
            e = int(err[i])
            ok = bool(peak[i] > 4.0 * nxt[i]) and abs(e) <= cfg.guard_len // 2
            cfo = float(shift[i]) * 2.0 * math.pi / L - fc
            if cfo >= math.pi:
                cfo -= 2.0 * math.pi
            out.append((ok, p0 - e, cfo))
        return out

    # -- the header -------------------------------------------------------
    def header(self, x: torch.Tensor, p0: int, cfo: float, q):
        """-> (mode, call) or None."""
        cfg = self.sync.cfg
        s, g = cfg.symbol_len, cfg.guard_len
        lo = p0 + s + g
        if lo < 0 or lo + s > x.shape[0]:
            return None
        arg = -cfo * torch.arange(s, dtype=torch.float32, device=x.device)
        spec = q(fwd(x[lo: lo + s] * torch.polar(torch.ones_like(arg), arg)))
        cons = demod_or_erase(spec[self.hdr_bins] * self.mls1,
                              spec[self.hdr_prev] * self.mls1_prev)
        soft = torch.clamp(torch.round(127.0 * q(cons.real)), -128, 127)
        data, unique = osd_decode(soft[None])
        if not bool(unique[0]):
            return None
        bits = data[0].cpu().numpy().astype(np.int64)
        md = int((bits[:55] << np.arange(55)).sum())
        cs = int((bits[55:71] << np.arange(16)).sum())
        if M.crc_bits(M.CRC16_POLY, [(md << 9 >> i) & 1
                                     for i in range(64)]) != cs:
            return None
        mode, call = md & 255, md >> 8
        if mode not in M.MODES or call == 0 or call >= 37 ** 9:
            return None
        return mode, call

    # -- the payload ------------------------------------------------------
    def demod(self, x: torch.Tensor, p0: int, cfo: float, mode: int, q):
        """-> (LLRs [code_len], snr [rows], mean slope, mean intercept)
        or None when the frame runs past the recording."""
        cfg = M.Config(self.rate, M.MODES[mode], 0)
        md = cfg.mode
        s, g = cfg.symbol_len, cfg.guard_len
        rows = md.cons_rows
        q0 = p0 + 2 * (s + g)
        if q0 < 0 or q0 + rows * (s + g) + s > x.shape[0]:
            return None
        flat = x[q0: q0 + (rows + 1) * (s + g)]
        flat = torch.nn.functional.pad(flat, (0, (rows + 1) * (s + g)
                                              - flat.shape[0]))
        win = flat.reshape(rows + 1, s + g)[:, :s]
        w = torch.arange(rows + 1, dtype=torch.float32,
                         device=x.device)[:, None]
        k = torch.arange(s, dtype=torch.float32, device=x.device)[None, :]
        phase = -torch.tensor(cfo, dtype=torch.float32,
                              device=x.device) * (s + w * (s + g) + k)
        spec = q(fwd(win * torch.polar(torch.ones_like(phase), phase)))
        code_off = -md.cons_cols // 2
        bins = torch.as_tensor(M.bin_index(
            np.arange(code_off, code_off + md.cons_cols), s),
            device=x.device)
        car = spec[:, bins]
        cons = q(demod_or_erase(car[1:], car[:-1]))
        xs = (torch.arange(md.cons_cols, device=x.device)
              + code_off).to(torch.float32)
        ref = psk_hard(md.mod_bits, cons)
        err = torch.atan2(cons.imag * ref.real - cons.real * ref.imag,
                          cons.real * ref.real + cons.imag * ref.imag)
        i, j = torch.triu_indices(md.cons_cols, md.cons_cols, offset=1,
                                  device=x.device)
        slope = median_upper((err[..., j] - err[..., i]) / (xs[j] - xs[i]))
        yint = median_upper(err - slope[..., None] * xs)
        theta = -(slope[..., None] * xs + yint[..., None])
        cons = q(cons * torch.polar(torch.ones_like(theta), theta))
        fe = FrontEnd(cfg, x.device)
        llrs, snr = fe.demap(cons, q)
        full = torch.full((md.code_len,), 9000.0, device=x.device)
        full[fe.kept] = llrs.reshape(-1)
        return full, snr, float(slope.mean()), float(yint.mean())

    def decode(self, samples: np.ndarray, q=identity):
        """A real mono recording -> (the frame's answer dict, or None)
        and the LLRs its list decode needs: the list decode itself runs
        batched over many recordings in :meth:`finish`."""
        x = q(analytic(torch.as_tensor(samples, dtype=torch.float32,
                                       device=self.device), self.rate))
        for ok, p0, cfo in self.candidates(x, q):
            if not ok:
                continue
            hdr = self.header(x, p0, cfo, q)
            if hdr is None:
                continue
            mode, call = hdr
            got = self.demod(x, p0, cfo, mode, q)
            ans = dict(mode=mode, call=call, symbol_pos=p0,
                       cfo_hz=cfo * self.rate / (2 * math.pi))
            if got is None:
                return ans, None
            full, snr, slope, yint = got
            cfg = M.Config(self.rate, M.MODES[mode], 0)
            s, g = cfg.symbol_len, cfg.guard_len
            ans.update(snr=snr.cpu().numpy(),
                       sfo_ppm=-slope * s / (s + g) / (2 * math.pi) * 1e6,
                       cfo_hz=(cfo + yint / (s + g)) * self.rate
                       / (2 * math.pi))
            return ans, full
        return None, None

    def finish(self, answers: list, llrs: list, q=identity) -> list:
        """List-decode every answer's LLRs (one mode's frames at a time,
        16 a call) and add payload bits, flips and ok."""
        by_mode = {}
        for i, (a, f) in enumerate(zip(answers, llrs)):
            if a is not None and f is not None:
                by_mode.setdefault(a["mode"], []).append(i)
        for mode, idx in by_mode.items():
            code = M.Code(M.MODES[mode])
            md = code.mode
            crc_idx = torch.as_tensor(code.info_idx[: md.crc_bits],
                                      device=self.device)
            mat = torch.as_tensor(code.crc_matrix, dtype=torch.float64,
                                  device=self.device)
            for b0 in range(0, len(idx), 16):
                part = idx[b0: b0 + 16]
                full = torch.stack([llrs[i] for i in part])
                cands, pm = scl_decode(full, code.schedule, self.list_size,
                                       q)
                for r, i in enumerate(part):
                    order = torch.argsort(pm[r], stable=True)
                    info = cands[r, order][:, crc_idx]
                    passing = (torch.remainder(info.double() @ mat, 2.0)
                               .sum(dim=1) == 0).cpu().numpy()
                    a = answers[i]
                    a["ok"] = bool(passing.any())
                    if a["ok"]:
                        mesg = info[int(np.argmax(passing)), : md.data_bits]
                        recv = full[r, crc_idx[: md.data_bits]] < 0
                        a["flips"] = int((recv != mesg.bool()).sum())
                        a["bits"] = mesg.cpu().numpy()
        return answers
