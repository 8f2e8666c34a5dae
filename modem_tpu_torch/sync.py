"""Schmidl-Cox synchronisation: batches of framed recordings, and the
chunked scan of a whole recording of unknown framing.

Counterpart of ``modem_tpu/sync.py`` (reference: SchmidlCox,
decode.cc:37-153): the coarse timing metric over a recording (at full
rate or on a stride grid), the fine stage at one candidate
(fractional-CFO mixdown, L-point FFT, adjacent-bin differential,
circular correlation against the MLS0 kernel), and :meth:`Synchronizer.
scan`, which walks a whole recording chunk by chunk with the Schmitt
trigger and the per-region argmax carried across chunks.  Recordings are
complex tensors; positions are in recording coordinates, ``p0`` pointing
at the first payload sample of the Schmidl-Cox symbol (decode.cc:84-152).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import bits as B
from . import fft, ofdm
from .numerology import ModemConfig

_BLK = 512       # chunk starts and contexts are multiples of this block


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


def schmitt_falling(timing: torch.Tensor, lo: float, hi: float,
                    carry=None):
    """Hysteresis trigger state and falling edges over the last axis.

    s[n] = (t[n] > hi) | (t[n] >= lo & s[n-1]) (decode.cc:49-50, 93-94),
    with s[-1] = ``carry`` (a bool or 0-d bool tensor; default False) so
    a recording can be walked in chunks.  Without a scan: s[n] holds iff
    the last index <= n with t > hi comes after the last index <= n with
    t < lo, the carry counting as a t > hi at index -1; both last
    indices are running maxima (``cummax``).  Returns (state, falling
    edge), bool, the shape of ``timing``."""
    n = timing.shape[-1]
    dev = timing.device
    idx = torch.arange(n, device=dev)
    carry = torch.as_tensor(bool(carry) if carry is None else carry,
                            device=dev)
    a = timing > hi
    below = ~(timing >= lo)           # NaN resets, as in the recurrence
    last_a = torch.where(a, idx, torch.where(carry, -1, -2)).cummax(-1)[0]
    last_b = torch.where(below, idx, -2).cummax(-1)[0]
    s = last_a > last_b
    prev = torch.cat([carry.expand(s.shape[:-1] + (1,)), s[..., :-1]], -1)
    return s, prev & ~s


def segmented_argmax(v: torch.Tensor, seg_start: torch.Tensor):
    """Maximum and first index attaining it over each segment of a 1-D
    ``v``: segment 0 runs from index 0 to the first true ``seg_start``
    (exclusive; empty if seg_start[0]), segment i from the i-th start.
    Returns (segment id of each index [n], max [n + 1], first index of
    the max [n + 1]; -inf and n for an empty segment).  Ties keep the
    earliest index (np.argmax semantics)."""
    n = v.shape[0]
    seg = torch.cumsum(seg_start.to(torch.int64), 0)
    vmax = torch.full((n + 1,), -math.inf, dtype=v.dtype, device=v.device)
    vmax = vmax.scatter_reduce(0, seg, v, "amax")
    idx = torch.arange(n, device=v.device)
    at = torch.where(v == vmax[seg], idx, n)
    first = torch.full((n + 1,), n, dtype=idx.dtype, device=v.device)
    return seg, vmax, first.scatter_reduce(0, seg, at, "amin")


@dataclasses.dataclass
class SyncCandidate:
    """One Schmidl-Cox detection after the fine stage and the gates."""

    p0: int           # recording index of the S&C symbol payload start
    frac_cfo: float   # fractional CFO estimate, rad/sample
    cfo_rad: float    # full CFO estimate (integer + fractional)
    ok: bool          # passed uniqueness + timing-error gates
    peak_ratio: float
    conv: int = 0     # MLS convention index (one convention: 0)
    # the gate-passing hypotheses (conv, p0, cfo_rad, peak_ratio): the
    # candidate's own when ok, else empty
    alts: tuple = ()


def as_recording(x, device) -> torch.Tensor:
    """A recording as complex64 [T] on ``device``: complex numpy or torch,
    or split-complex [T, 2] float."""
    x = torch.as_tensor(x)
    if not x.is_complex():
        if x.dim() != 2 or x.shape[-1] != 2:
            raise ValueError(f"recording of shape {tuple(x.shape)}: want "
                             "[T] complex or [T, 2] float")
        x = torch.complex(x[..., 0].float(), x[..., 1].float())
    if x.dim() != 1:
        raise ValueError(f"recording must be [T], got {tuple(x.shape)}")
    return x.to(device=device, dtype=torch.complex64)


class Synchronizer:
    """Per-config Schmidl-Cox detector (operates at L = symbol_len / 2).

    ``kernel``: the MLS0 matched kernel (complex64 [L]); by default
    built by :func:`mls0_kernel`."""

    def __init__(self, cfg: ModemConfig, device="cuda",
                 kernel: torch.Tensor | None = None):
        self.cfg = cfg
        self.L = cfg.symbol_len // 2
        self.match_len = cfg.guard_len | 1
        self.match_del = (self.match_len - 1) // 2
        self.thr_lo = 0.17 * self.match_len   # decode.cc:76
        self.thr_hi = 0.19 * self.match_len
        if kernel is None:
            kernel = torch.from_numpy(mls0_kernel(cfg))
        self.device = torch.device(device)
        self.kernel = kernel.to(device=device, dtype=torch.complex64)

    def _products(self, x: torch.Tensor, valid_from: int = 0):
        """Correlation products x[v+L] * conj(x[v+2L]) and powers
        |x[v+2L]|^2 for every lag v, zero at lags below ``valid_from``
        (a chunk whose left context is zero padding: the whole-recording
        pass sums no products there)."""
        L = self.L
        b = x[..., 2 * L:]
        a = x[..., L: L + b.shape[-1]]
        prod, pb = a * b.conj(), ofdm.abs2(b)
        if valid_from:
            prod[..., :valid_from] = 0
            pb[..., :valid_from] = 0
        return prod, pb

    def _timing(self, p_re, p_im, power, match_len: int):
        r = torch.clamp(0.5 * power, min=1e-4 * self.L)
        return window_sum((p_re ** 2 + p_im ** 2) / (r * r), match_len)

    def _metrics_parts(self, x: torch.Tensor, valid_from: int = 0):
        """x: [..., T] complex -> (timing, p_re, p_im), each [..., T - 2L]
        f32: timing[n] belongs to a S&C symbol whose payload starts at
        n - match_del (before the fine correction), and the phase there
        is atan2(p_im, p_re)[n]."""
        prod, pb = self._products(x, valid_from)
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

    # -- the whole-recording scan -------------------------------------------
    # scan() walks the recording CHUNK_SMALL samples at a time by default,
    # so device memory stays O(chunk) whatever the recording's length.
    CHUNK_SMALL = 1 << 17

    def _metrics(self, x: torch.Tensor, valid_from: int = 0):
        """(timing, phase) of a recording [T]: see _metrics_parts."""
        timing, p_re, p_im = self._metrics_parts(x, valid_from)
        return timing, torch.atan2(p_im, p_re)

    def _context(self, chunk_samples: int):
        """(chunk length, left context): both multiples of the 512-sample
        block, the context covering the longest window chain (2L +
        match_len), and a chunk never shorter than its context."""
        ctx = -(-(2 * self.L + self.match_len) // _BLK) * _BLK
        c = max(-(-int(chunk_samples) // _BLK) * _BLK, ctx)
        return c, ctx

    def _chunk_events(self, x, n0: int, c: int, ctx: int, state, best):
        """One chunk of the device scan: outputs [n0, n0 + c) with a left
        context of ``ctx`` samples (zero padding before the recording,
        whose products are masked).  ``state``: the Schmitt state before
        n0; ``best``: (value, index, phase) of the collect region open at
        n0.  Returns (edges [k] chunk-relative, n_max [k], phase [k],
        state, best) with the carries for the next chunk, all tensors."""
        L, md, dev = self.L, self.match_del, self.device
        lo = n0 - ctx
        seg = x[max(lo, 0): n0 + c + 2 * L]
        seg = torch.nn.functional.pad(
            seg, (max(0, -lo), ctx + c + 2 * L - max(0, -lo) - seg.shape[0]))
        t, p = self._metrics(seg, valid_from=ctx if n0 == 0 else 0)
        t_c = t[ctx: ctx + c]
        # the phase read at n - match_del; clamped to index 0 at the
        # recording start, as the JAX package's host walk reads it
        psh_c = p[ctx - md: ctx + c - md].clone()
        if n0 == 0:
            psh_c[:md] = p[ctx]
        s, f = schmitt_falling(t_c, self.thr_lo, self.thr_hi, state)
        prev_s = torch.cat([state.reshape(1), s[:-1]])
        # collect regions: a segment starts wherever the state was off
        # before; segment 0 continues the region open at n0
        seg_id, vmax, first = segmented_argmax(
            torch.where(s, t_c, -math.inf), ~prev_s)
        at = first.clamp(max=c - 1)
        idx, ph = n0 + first, psh_c[at]
        cv, ci, cp = best
        # the carried region keeps its (earlier) index unless the chunk's
        # part of it is strictly larger
        keep = ~(vmax[0] > cv)
        vmax[0] = torch.where(keep, cv, vmax[0])
        idx[0] = torch.where(keep, ci, idx[0])
        ph[0] = torch.where(keep, cp, ph[0])
        edges = torch.nonzero(f)[:, 0]
        e_seg = seg_id[edges]
        last = seg_id[-1]
        return (edges, idx[e_seg], ph[e_seg], s[-1],
                (vmax[last], idx[last], ph[last]))

    def _events_device(self, x: torch.Tensor, chunk_samples: int,
                       max_edges: int):
        """(edge, n_max, phase[n_max - match_del]) for the first
        ``max_edges`` falling edges, walking the recording chunk by chunk
        on its device with the Schmitt state and the running argmax
        carried across chunk boundaries; one small host copy a chunk."""
        n_out = x.shape[0] - 2 * self.L
        if n_out <= 0:
            return []
        c, ctx = self._context(chunk_samples)
        dev = self.device
        state = torch.tensor(False, device=dev)
        best = (torch.tensor(-math.inf, device=dev),
                torch.tensor(0, device=dev),
                torch.tensor(0.0, device=dev))
        events = []
        for n0 in range(0, n_out, c):
            edges, nmax, ph, state, best = self._chunk_events(
                x, n0, c, ctx, state, best)
            if edges.numel():
                host = torch.stack([edges + n0, nmax]).cpu().numpy()
                phs = ph.cpu().numpy()
                for e, nm, q in zip(host[0], host[1], phs):
                    if e < n_out:
                        events.append((int(e), int(nm), float(q)))
            if len(events) >= max_edges:
                break
        return events[:max_edges]

    def scan(self, x, max_candidates: int = 8, chunk_samples=None):
        """Find the Schmidl-Cox preambles of a whole recording ([T]
        complex, or [T, 2] float) on the synchroniser's device.

        Returns SyncCandidates in time order with the reference's gates
        applied (peak > 4*next, |pos_err| <= guard/2; decode.cc:140-145),
        stopping after ``max_candidates`` that pass.  A margin of 4x as
        many raw falling edges is examined, so spurious noise edges do
        not take the slots of later frames.  The recording is walked in
        chunks of ``chunk_samples`` (default CHUNK_SMALL) samples, so
        device memory stays O(chunk); its events equal the JAX
        package's host walk (``scan(host=True)``) event for event."""
        x = as_recording(x, self.device)
        raw = self._events_device(x, chunk_samples or self.CHUNK_SMALL,
                                  4 * max_candidates)
        events = self.assemble_events(raw)
        if not events:
            return []
        wins = torch.stack([self._window(x, p0) for p0, _ in events])
        out = []
        for cand in self.fine_candidates(wins, events):
            out.append(cand)
            if sum(c.ok for c in out) >= max_candidates:
                break
        return out

    def assemble_events(self, raw) -> list:
        """(edge, n_max, phase) triples -> (p0, frac_cfo) events: the
        peak-to-symbol-start mapping with the collect-region cap
        (decode.cc:99-114)."""
        L, cfg = self.L, self.cfg
        events = []
        for edge, n_max, ph in raw:
            index_max = min(edge - 1 - n_max + self.match_del,
                            L + cfg.guard_len + self.match_del)
            events.append(((edge - 1) - index_max, ph / L))
        return events

    def fine_candidates(self, wins: torch.Tensor, events) -> list:
        """The fine timing / integer-CFO stage and the reference's gates
        (decode.cc:110-146) for windows wins[i] = x[p0_i + L : p0_i + 2L];
        one SyncCandidate per event, in one host copy."""
        L, cfg = self.L, self.cfg
        fcs = torch.tensor([fc for _, fc in events], dtype=torch.float32,
                           device=wins.device)
        shift, pos_err, peak, nxt, _ = self._fine_stage(wins, fcs)
        ints = torch.stack([shift, pos_err]).cpu().numpy()
        floats = torch.stack([peak, nxt]).cpu().numpy()
        out = []
        for i, (p0, fc) in enumerate(events):
            sh, err = int(ints[0, i]), int(ints[1, i])
            pk, nx = floats[0, i], floats[1, i]
            ok = bool(pk > 4.0 * nx) and abs(err) <= cfg.guard_len // 2
            cfo = float(sh) * 2.0 * np.pi / L - fc
            if cfo >= np.pi:
                cfo -= 2.0 * np.pi
            ratio = float(pk / max(nx, 1e-30))
            alt = (0, int(p0) - err, cfo, ratio)
            out.append(SyncCandidate(p0=alt[1], frac_cfo=fc, cfo_rad=cfo,
                                     ok=ok, peak_ratio=ratio,
                                     alts=(alt,) if ok else ()))
        return out

    def _window(self, x: torch.Tensor, p0: int) -> torch.Tensor:
        """x[p0 + L : p0 + 2L], zero where it leaves the recording."""
        L = self.L
        lo = p0 + L
        out = x.new_zeros(L)
        seg = x[max(lo, 0): max(lo + L, 0)]
        off = max(0, -lo)
        out[off: off + seg.shape[0]] = seg
        return out
