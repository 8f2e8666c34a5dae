"""Schmidl-Cox synchronisation: batches of framed recordings, and the
chunked scan of a whole recording of unknown framing.

Counterpart of ``modem_tpu/sync.py`` (reference: SchmidlCox,
decode.cc:37-153): the coarse timing metric over a recording (at full
rate or on a stride grid), the fine stage at one candidate
(fractional-CFO mixdown, L-point FFT, adjacent-bin differential,
circular correlation against the MLS0 kernel of each LFSR convention
the receiver accepts), and :meth:`Synchronizer.scan`, which walks a whole
recording chunk by chunk with the Schmitt trigger and the per-region
argmax carried across chunks on the device, reading a round of chunks'
first edges back at once (on the card each chunk past the first a
replay of one CUDA graph).  Recordings are complex tensors, or
``ingest.PcmRecording`` wire-dtype samples whose front end runs inside
the chunk loop; positions are in recording coordinates, ``p0`` pointing
at the first payload sample of the Schmidl-Cox symbol (decode.cc:84-152).
With ``Synchronizer.mesh`` set (``parallel.sharded_sync``) the scan's
chunks shard over the ranks of a ``torch.distributed`` group, the
carries composed from per-chunk summaries, with the same events.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import bits as B
from . import fft, ofdm
from .profiling import upload, wait
from .mesh import all_gather_rows
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


def conventions(cfg: ModemConfig) -> tuple:
    """The LFSR conventions a receiver of ``cfg`` matches: all of
    B.MLS_CONVENTIONS under "auto", else the committed one."""
    if cfg.mls_convention == "auto":
        return B.MLS_CONVENTIONS
    return (cfg.mls_convention,)


def mls0_kernel(cfg: ModemConfig) -> np.ndarray:
    """Matched kernel conj(FFT(seq)) / L over L = symbol_len / 2 bins
    from the receive-side MLS0 layout (decode.cc:236-244, 76-83), as the
    JAX package builds it: complex64 [L] for a committed convention,
    [K, L] (one row per convention of :func:`conventions`) under
    "auto"."""
    L = cfg.symbol_len // 2
    rx_off = -(cfg.mls0_len - 1)
    bins = (np.arange(cfg.mls0_len) + rx_off // 2 + L) % L
    kerns = []
    for conv in conventions(cfg):
        seq = np.zeros(L, dtype=np.complex64)
        seq[bins] = B.mls_nrz(cfg.mls0_poly, cfg.mls0_len, convention=conv)
        kerns.append(np.conj(np.fft.fft(seq)) / L)
    kerns = np.stack(kerns).astype(np.complex64)
    return kerns if cfg.mls_convention == "auto" else kerns[0]


def slice_windows(x: torch.Tensor, start: torch.Tensor,
                  length: int) -> torch.Tensor:
    """x[b, start[b] : start[b] + length] for every row b, with the start
    clamped so the window lies inside the recording (lax.dynamic_slice
    semantics).  One gather from a strided view, no index tensor of the
    window's size."""
    start = start.clamp(0, x.shape[-1] - length)
    rows = torch.arange(x.shape[0], device=x.device)
    return x.unfold(-1, length, 1)[rows, start]


def last_true(mask: torch.Tensor, fill) -> torch.Tensor:
    """For every n, the largest index i <= n with mask[..., i] over the
    last axis, or ``fill`` (an int or 0-d tensor) where there is none:
    a running maximum of the true indices without a scan with indices
    (torch's cummax runs ~2.8 ms over 2^20 elements on an H100).  The
    k-th true index lands in slot k of a table by a scatter, and the
    count of trues up to n reads it back."""
    n = mask.shape[-1]
    count = torch.cumsum(mask, -1)
    idx = torch.arange(n, device=mask.device).expand(mask.shape)
    table = torch.empty(mask.shape[:-1] + (n + 1,), dtype=torch.int64,
                        device=mask.device)
    # every false index writes slot 0, which the fill then overwrites
    table.scatter_(-1, torch.where(mask, count, 0), idx)
    if isinstance(fill, torch.Tensor):
        table[..., 0] = fill
    else:
        table[..., 0].fill_(fill)       # a kernel argument, no host copy
    return table.gather(-1, count)


def cut_span(x: torch.Tensor, lo: int, length: int, fill) -> torch.Tensor:
    """x[lo : lo + length] along the first axis of x ([T] or [T, C]),
    ``fill`` where the span leaves x, cut with host ints: a view of x
    where the span lies inside it, else a filled copy; no index tensor
    and no host copy."""
    a, b = max(lo, 0), min(lo + length, x.shape[0])
    if (a, b) == (lo, lo + length):
        return x[a:b]
    out = x.new_full((length,) + tuple(x.shape[1:]), fill)
    if b > a:
        out[a - lo: b - lo] = x[a:b]
    return out


def gather_windows(x: torch.Tensor, starts: torch.Tensor, length: int,
                   fill) -> torch.Tensor:
    """x[starts[i] : starts[i] + length] along the first axis of x ([T]
    or [T, C]) for every i, ``fill`` where a window leaves x: [n,
    length] or [n, length, C]."""
    idx = starts[:, None] + torch.arange(length, device=x.device)
    inside = (idx >= 0) & (idx < x.shape[0])
    got = x[idx.clamp(0, max(x.shape[0] - 1, 0))]
    inside = inside.reshape(inside.shape + (1,) * (got.dim() - 2))
    return torch.where(inside, got, torch.full_like(got, fill))


def schmitt_falling(timing: torch.Tensor, lo: float, hi: float,
                    carry=None):
    """Hysteresis trigger state and falling edges over the last axis.

    s[n] = (t[n] > hi) | (t[n] >= lo & s[n-1]) (decode.cc:49-50, 93-94),
    with s[-1] = ``carry`` (a bool or 0-d bool tensor; default False) so
    a recording can be walked in chunks.  Without a scan: s[n] holds iff
    the last index <= n with t > hi comes after the last index <= n with
    t < lo, the carry counting as a t > hi at index -1 (both last
    indices by :func:`last_true`).  Returns (state, falling edge), bool,
    the shape of ``timing``."""
    dev = timing.device
    carry = torch.as_tensor(bool(carry) if carry is None else carry,
                            device=dev)
    a = timing > hi
    below = ~(timing >= lo)           # NaN resets, as in the recurrence
    last_a = last_true(a, torch.where(carry, -1, -2))
    last_b = last_true(below, -2)
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


def continue_region(regions, best) -> None:
    """Merge the collect region open before a chunk, ``best`` = (value,
    index, phase), into region 0 of the chunk's regions
    (:meth:`Synchronizer._chunk_regions`), in place: the carried region
    keeps its (earlier) index unless the chunk's part of it is strictly
    larger."""
    _s, _f, _seg, vmax, idx, ph = regions
    cv, ci, cp = best
    keep = ~(vmax[0] > cv)
    vmax[0] = torch.where(keep, cv, vmax[0])
    idx[0] = torch.where(keep, ci, idx[0])
    ph[0] = torch.where(keep, cp, ph[0])


def _region_tail(regions) -> torch.Tensor:
    """A chunk's summary for the sharded scan, f64 [5]: the state it ends
    in, and its last collect region's max, index and phase, and whether a
    region starts in the chunk (else the last region is region 0, which
    continues the one open before it)."""
    s, _f, seg_id, vmax, idx, ph = regions
    last = seg_id[-1]
    return torch.stack([s[-1].double(), vmax[last].double(),
                        idx[last].double(), ph[last].double(),
                        (last > 0).double()])


def _first_edges(regions, k: int) -> torch.Tensor:
    """The first ``k`` falling edges of a chunk as f64 [k, 3] rows (edge,
    n_max, phase), chunk-relative edges in time order, -1 rows past the
    last edge; no host copy (:func:`_edge_events` reads them).  The j-th
    edge lands in slot j - 1 of a table by a scatter (the rest in a
    spare slot k), a fixed-shape pass where a top-k selection over the
    chunk would sort it."""
    _s, f, seg_id, _vmax, idx, ph = regions
    c = f.shape[0]
    count = torch.cumsum(f, 0)
    slot = torch.where(f & (count <= k), count - 1, k)
    e = torch.full((k + 1,), c, dtype=torch.int64, device=f.device)
    e = e.scatter(0, slot, torch.arange(c, device=f.device))[:k]
    seg = seg_id[e.clamp(max=c - 1)]
    return torch.stack([torch.where(e < c, e, -1).double(),
                        idx[seg].double(), ph[seg].double()], dim=1)


def _edge_events(n0: int, rows, n_out: int) -> list:
    """A chunk's :func:`_first_edges` rows on the host -> (edge, n_max,
    phase) events with absolute edges before ``n_out``."""
    return [(int(n0 + e), int(nm), float(ph))
            for e, nm, ph in rows if 0 <= e and n0 + e < n_out]


@dataclasses.dataclass
class SyncCandidate:
    """One Schmidl-Cox detection after the fine stage and the gates."""

    p0: int           # recording index of the S&C symbol payload start
    frac_cfo: float   # fractional CFO estimate, rad/sample
    cfo_rad: float    # full CFO estimate (integer + fractional)
    ok: bool          # passed uniqueness + timing-error gates
    peak_ratio: float
    conv: int = 0     # index into Synchronizer.conventions of the
    #                   hypothesis the fields above hold
    # the gate-passing convention hypotheses (conv, p0, cfo_rad,
    # peak_ratio), peak ratio descending; under "auto" the header stage
    # commits the first whose OSD and CRC-16 validate (accept()): the
    # conventions emit phases of one m-sequence, so a wrong kernel can
    # pass the sync gates too (see Synchronizer._fine_stage_all)
    alts: tuple = ()

    def accept(self, alt) -> None:
        """Commit a header-validated hypothesis into the fields."""
        self.conv, self.p0, self.cfo_rad, self.peak_ratio = alt
        self.alts = (alt,)


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


def layout(x) -> tuple:
    """(bits, channels) of a recording for the front end: (None, 1) for
    analytic samples (a tensor, or a StreamBuffer of ``bits`` None)."""
    if isinstance(x, torch.Tensor):
        return None, 1
    return x.bits, x.channels


class _ChunkGraph:
    """The scan's chunk body past the recording start (n0 > 0: the
    chunk's metrics mask nothing) as one CUDA graph, for one (layout,
    chunk, context, first edges): the chunk's raw samples, n0 and the
    carry are static inputs that :meth:`step` fills before each replay,
    so a chunk costs the host a dozen launches, not the body's ~130
    operations.  The same kernels on the same shapes as the eager body:
    the same events."""

    def __init__(self, sync: Synchronizer, key: tuple, raw: torch.Tensor):
        lay, c, ctx, k = key
        dev = raw.device
        self.raw = torch.empty(raw.shape, dtype=raw.dtype, device=dev)
        self.raw.copy_(raw)
        self.n0 = torch.full((), c, dtype=torch.int64, device=dev)
        self.carry = sync.scan_start()
        lo = ctx + sync._lead(lay)

        def body():
            seg = sync._front(lay, self.raw, self.n0 - lo,
                              ctx + c + 2 * sync.L)
            t_c, psh_c = sync._metrics_at(seg, False, c, ctx)
            return sync._chunk_finish(t_c, psh_c, self.n0, self.carry, k)

        here = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            body()              # cuBLAS and the allocator warm, off-graph
        here.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with wait("sync.graph"):    # the capture synchronises the card
            with torch.cuda.graph(self.graph, stream=side):
                self.out = body()

    def step(self, raw: torch.Tensor, n0: int, carry):
        """One chunk: ``raw`` its samples, (firsts, carry) out as
        :meth:`Synchronizer._chunk_body` returns them, copies the next
        replay does not overwrite."""
        self.raw.copy_(raw)
        self.n0.fill_(n0)
        for dst, src in zip((self.carry[0],) + self.carry[1],
                            (carry[0],) + tuple(carry[1])):
            dst.copy_(src)
        self.graph.replay()
        firsts, (s, best) = self.out
        return firsts.clone(), (s.clone(), tuple(b.clone() for b in best))


class Synchronizer:
    """Per-config Schmidl-Cox detector (operates at L = symbol_len / 2).

    ``kernel``: the MLS0 matched kernels, complex64 [L] or [K, L], one
    row per convention of :func:`conventions` (K = 3 under "auto"); by
    default built by :func:`mls0_kernel`.  Kept as [K, L]."""

    def __init__(self, cfg: ModemConfig, device="cuda",
                 kernel: torch.Tensor | None = None):
        self.cfg = cfg
        self.L = cfg.symbol_len // 2
        self.match_len = cfg.guard_len | 1
        self.match_del = (self.match_len - 1) // 2
        self.thr_lo = 0.17 * self.match_len   # decode.cc:76
        self.thr_hi = 0.19 * self.match_len
        self.conventions = conventions(cfg)
        if kernel is None:
            kernel = torch.from_numpy(mls0_kernel(cfg))
        self.device = torch.device(device)
        kernel = kernel.to(device=device, dtype=torch.complex64)
        self.kernel = kernel.reshape(-1, self.L)
        if self.kernel.shape[0] != len(self.conventions):
            raise ValueError(f"{self.kernel.shape[0]} MLS0 kernels for "
                             f"conventions {self.conventions}")
        # the mono front end of PCM input (decode.cc:294-301)
        self.dc_window = 2 * cfg.extended_len
        self.taps = cfg.filter_len
        from .ingest import front_lead
        self.front_lead = front_lead(self.dc_window, self.taps)
        self.last_chunks = 0    # chunks the last scan walked
        self.last_rank_chunks = 0   # of them, the ones this rank computed
        self.last_rounds = 0    # its rounds, one host read each
        self._graphs: dict = {}     # _ChunkGraph by (layout, c, ctx, k)
        # a mesh.Mesh shards the scan's chunk axis over its ranks
        # (parallel.sharded_sync); None walks every chunk here
        self.mesh = None

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

    def _fine_stage_all(self, window: torch.Tensor,
                        frac_cfo: torch.Tensor):
        """window: [B, L] samples x[p0+L : p0+2L] (second half of the S&C
        symbol), frac_cfo: [B].  Returns (shift, pos_err, peak, next,
        angle), each [B, K]: decode.cc:110-146 once per matched kernel.

        Peak dominance alone cannot tell the conventions apart: they emit
        rotations of one m-sequence (or of its reversal), and a rotation
        by d aliases into a strong peak at an integer CFO off by 2d bins
        that can pass the peak > 4*next gate.  The caller keeps every
        gate-passing convention as a hypothesis for the header stage."""
        L = self.L
        idx = torch.arange(L, dtype=torch.float32, device=window.device)
        arg = frac_cfo[:, None] * idx
        spec = fft.fwd(window * torch.complex(torch.cos(arg), torch.sin(arg)))
        cons = ofdm.demod_or_erase(spec, torch.roll(spec, 1, dims=-1))
        corr = fft.bwd(fft.fwd(cons)[:, None, :] * self.kernel)  # [B, K, L]
        pwr = ofdm.abs2(corr)
        shift = pwr.argmax(dim=-1)
        at = shift[..., None]
        peak = pwr.gather(-1, at)[..., 0]
        nxt = pwr.scatter(-1, at, -math.inf).amax(dim=-1)
        c = corr.gather(-1, at)[..., 0]
        ang = torch.atan2(c.imag, c.real)
        pos_err = torch.round(ang * L / (2.0 * math.pi)).to(torch.int64)
        return shift, pos_err, peak, nxt, ang

    def _fine_stage(self, window: torch.Tensor, frac_cfo: torch.Tensor):
        """:meth:`_fine_stage_all` against the first kernel: each output
        [B] (a committed convention has only that one)."""
        return tuple(v[:, 0] for v in self._fine_stage_all(window, frac_cfo))

    # -- the whole-recording scan -------------------------------------------
    # scan() walks the recording CHUNK_SMALL samples at a time, or
    # CHUNK_LARGE above CHUNK_AUTO_THRESHOLD samples, so device memory
    # stays O(chunk) whatever the recording's length; the events are the
    # same at any chunk size.
    CHUNK_SMALL = 1 << 17
    CHUNK_LARGE = 1 << 20
    CHUNK_AUTO_THRESHOLD = 1 << 21

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

    def recording(self, x):
        """A PcmRecording or a stream's StreamBuffer as it is, anything
        else through :func:`as_recording` onto the synchroniser's
        device."""
        from .ingest import PcmRecording, StreamBuffer
        if isinstance(x, (PcmRecording, StreamBuffer)):
            return x
        return as_recording(x, self.device)

    def windows(self, x, starts, out_len: int) -> torch.Tensor:
        """Analytic windows [n, out_len], window i covering absolute
        samples [starts[i], starts[i] + out_len) of ``x``, zero outside
        the recording: cut from an analytic recording [T] on the device;
        or from the samples of a PcmRecording (its device copy) or of a
        stream's StreamBuffer (cut on the host, only the windows copied)
        in wire dtype, the span outside the recording read as quantised
        silence, and run through the front end on the device: mono
        windows with ``front_lead`` raw samples of left context for the
        DC block and the Hilbert filter, whose DC count clamps at the
        absolute recording start.  A StreamBuffer of analytic samples
        (``bits`` None) gives its windows as they are."""
        if isinstance(x, torch.Tensor):
            with upload("sync.starts", starts, self.device):
                starts = torch.as_tensor(starts, dtype=torch.int64,
                                         device=self.device)
            return gather_windows(x, starts, out_len, 0)
        if x.bits is None:
            return x.raw_windows(starts, out_len, self.device)
        starts = torch.as_tensor(starts, dtype=torch.int64)
        lead = self._lead(layout(x))
        raw = x.raw_windows(starts - lead, lead + out_len, self.device)
        abs0 = None
        if lead:
            with upload("sync.starts", starts, self.device):
                abs0 = (starts - lead).to(self.device)
        return self._front(layout(x), raw, abs0, out_len)

    def _lead(self, lay) -> int:
        """Raw samples ahead of an analytic window's first for input of
        :func:`layout` ``lay``: ``front_lead`` for mono PCM, else 0."""
        bits, channels = lay
        return self.front_lead if bits is not None and channels == 1 else 0

    def _front(self, lay, raw: torch.Tensor, abs0, out_len: int):
        """Samples of input of :func:`layout` ``lay`` -> analytic [...,
        out_len]: mono PCM ``raw`` [..., front_lead + out_len] whose first
        sample is absolute index ``abs0`` (an int, or a device tensor of
        the leading shape) through the DC block and the Hilbert filter,
        stereo I/Q dequantised, analytic samples as they are."""
        from . import ingest
        bits, channels = lay
        if bits is None:
            return raw
        if channels == 1:
            return ingest.analytic_chunk(raw, abs0, self.front_lead, out_len,
                                         bits, self.dc_window, self.taps)
        iq = ingest.dequant(raw, bits)
        return torch.complex(iq[..., 0], iq[..., 1])

    def _raw_segment(self, x, n0: int, c: int, ctx: int) -> torch.Tensor:
        """A chunk's samples before the front end: absolute [n0 - ctx -
        lead, n0 + c + 2L) (:meth:`_lead`), zero or quantised silence
        outside the recording, cut with host ints: sliced from an
        analytic recording or a PcmRecording's device copy
        (:func:`cut_span`), or copied from a StreamBuffer as one window."""
        lead = self._lead(layout(x))
        lo, n = n0 - ctx - lead, lead + ctx + c + 2 * self.L
        if isinstance(x, torch.Tensor):
            return cut_span(x, lo, n, 0)
        return x.segment(lo, n, self.device)

    def _segment(self, x, n0: int, c: int, ctx: int) -> torch.Tensor:
        """The analytic samples [n0 - ctx, n0 + c + 2L) of a chunk, zero
        outside the recording, as :meth:`windows` cuts them but from host
        ints (:meth:`_raw_segment`)."""
        lay = layout(x)
        return self._front(lay, self._raw_segment(x, n0, c, ctx),
                           n0 - ctx - self._lead(lay), ctx + c + 2 * self.L)

    def _chunk_metrics(self, x, n0: int, c: int, ctx: int):
        """The carry-free part of one chunk of the scan: (timing, the
        phase read at n - match_del), each [c], of outputs [n0, n0 + c)
        with a left context of ``ctx`` samples (zero padding before the
        recording, whose products are masked)."""
        return self._metrics_at(self._segment(x, n0, c, ctx), n0 == 0, c,
                                ctx)

    def _metrics_at(self, seg: torch.Tensor, first: bool, c: int, ctx: int):
        """:meth:`_chunk_metrics` of a chunk's analytic segment; ``first``:
        the chunk starts the recording."""
        md = self.match_del
        t, p = self._metrics(seg, valid_from=ctx if first else 0)
        # the phase read at n - match_del; clamped to index 0 at the
        # recording start, as the JAX package's host walk reads it
        psh_c = p[ctx - md: ctx + c - md].clone()
        if first:
            psh_c[:md] = p[ctx]
        return t[ctx: ctx + c], psh_c

    def _chunk_regions(self, t_c, psh_c, n0: int, state):
        """A chunk's Schmitt trigger and collect regions given the state
        before n0 (a 0-d bool tensor): (state [c], falling edges [c],
        region id of each output [c], and a region's max, index of its
        first max and phase there, each [c + 1]).  A region starts
        wherever the state was off before; region 0 continues the one
        open at n0, before :func:`continue_region` merges the carry."""
        s, f = schmitt_falling(t_c, self.thr_lo, self.thr_hi, state)
        prev_s = torch.cat([state.reshape(1), s[:-1]])
        seg_id, vmax, first = segmented_argmax(
            torch.where(s, t_c, -math.inf), ~prev_s)
        at = first.clamp(max=t_c.shape[0] - 1)
        return s, f, seg_id, vmax, n0 + first, psh_c[at]

    def _chunk_body(self, x, n0: int, c: int, ctx: int, carry, k: int):
        """One chunk of the scan, device work only: outputs [n0, n0 + c)
        with ``carry`` = (Schmitt state, (value, index, phase) of the
        collect region open at n0), device tensors.  Returns the chunk's
        first ``k`` falling edges (:func:`_first_edges`) and the carry for
        the next chunk.  On the card a chunk past the recording start
        replays the body's CUDA graph (:class:`_ChunkGraph`)."""
        if n0 and self.device.type == "cuda":
            key = (layout(x), c, ctx, k)
            graph = self._graphs.get(key)
            raw = self._raw_segment(x, n0, c, ctx)
            if graph is None:
                graph = self._graphs[key] = _ChunkGraph(self, key, raw)
            return graph.step(raw, n0, carry)
        t_c, psh_c = self._chunk_metrics(x, n0, c, ctx)
        return self._chunk_finish(t_c, psh_c, n0, carry, k)

    def _chunk_finish(self, t_c, psh_c, n0, carry, k: int):
        """The carry-dependent part of a chunk (:meth:`_chunk_body`) from
        its metrics; ``n0`` an int or a 0-d device tensor.  The carry for
        the next chunk is read from the chunk's last region by
        ``index_select`` (a 0-d tensor index would read it on the host)."""
        state, best = carry
        regions = self._chunk_regions(t_c, psh_c, n0, state)
        continue_region(regions, best)
        s, _f, seg_id, vmax, idx, ph = regions
        last = seg_id[-1:]
        best = tuple(v.index_select(0, last)[0] for v in (vmax, idx, ph))
        return _first_edges(regions, k), (s[-1], best)

    def scan_start(self):
        """The scan's carries at the recording start: (Schmitt state, (value,
        index, phase) of the open collect region), device tensors filled
        on the device."""
        carry = [torch.full((), v, device=self.device)
                 for v in (False, -math.inf, 0, 0.0)]
        return carry[0], tuple(carry[1:])

    def chunk_step(self, x, n0: int, c: int, ctx: int, carry, n_out: int,
                   max_edges: int | None = None):
        """One chunk of the scan, for a caller that must know each chunk's
        events before the next (a stream): outputs [n0, n0 + c) of ``x``
        (analytic [T], a PcmRecording, or a StreamBuffer whose samples
        start at an absolute origin; ``n0`` is absolute) with ``carry``
        from :meth:`scan_start` or the chunk before, (c, ctx) from
        :meth:`_context`.  Returns ((edge, n_max, phase) of the first
        ``max_edges`` falling edges of the chunk, edge < n_out, in one
        small host copy; the carry for the next chunk)."""
        k = c if max_edges is None else min(max_edges, c)
        firsts, carry = self._chunk_body(x, n0, c, ctx, carry, k)
        with wait("sync.events"):
            rows = firsts.cpu().numpy()
        return _edge_events(n0, rows, n_out), carry

    # the walk goes in rounds of up to this many chunks, one host read a
    # round; the sharded walk rounds it up to a multiple of the mesh's
    # size (the JAX package's super-batch)
    MAX_CHUNKS_PER_ROUND = 16

    def _events_device(self, x, chunk_samples: int, max_edges: int):
        """(edge, n_max, phase[n_max - match_del]) for the first
        ``max_edges`` falling edges, walking the recording (analytic [T]
        or a PcmRecording) chunk by chunk on the synchroniser's device
        with the Schmitt state and the running argmax carried across
        chunk boundaries on the device (:meth:`_chunk_body`); with
        ``mesh`` set, the chunks shard over its ranks
        (:meth:`_events_sharded`).  The walk goes in rounds of
        MAX_CHUNKS_PER_ROUND chunks whose first edges come back in one
        host read (a ``sync.round`` wait), and stops after the round that
        brings ``max_edges`` events: an edge among the recording's first
        ``max_edges`` is among its chunk's first.  Sets ``last_chunks``
        to the number of chunks walked, ``last_rank_chunks`` to the
        number this rank computed, and ``last_rounds`` to the rounds."""
        if self.mesh is not None:
            return self._events_sharded(x, chunk_samples, max_edges)
        n_out = x.shape[0] - 2 * self.L
        self.last_chunks = self.last_rounds = 0
        if n_out <= 0:
            return []
        c, ctx = self._context(chunk_samples)
        k = min(max_edges, c)
        n0s = range(0, n_out, c)
        carry = self.scan_start()
        events = []
        for g0 in range(0, len(n0s), self.MAX_CHUNKS_PER_ROUND):
            if len(events) >= max_edges:
                break
            walk = n0s[g0: g0 + self.MAX_CHUNKS_PER_ROUND]
            firsts = []
            for n0 in walk:
                got, carry = self._chunk_body(x, n0, c, ctx, carry, k)
                firsts.append(got)
            with wait("sync.round"):
                rows = torch.stack(firsts).cpu().numpy()
            for n0, r in zip(walk, rows):
                events += _edge_events(n0, r, n_out)
            self.last_chunks += len(walk)
            self.last_rounds += 1
        self.last_rank_chunks = self.last_chunks
        return events[:max_edges]

    def _events_sharded(self, x, chunk_samples: int, max_edges: int):
        """:meth:`_events_device` with the chunk axis sharded over the
        ranks of ``self.mesh`` (context parallelism; the JAX package's
        mesh-sharded super-batches).  The walk goes in rounds of m chunks,
        m a multiple of the mesh's size n, and rank r takes the round's
        chunks [r m/n, (r + 1) m/n).  In each round a rank

        1. computes each of its chunks' metrics once, with no carry, and
           its regions under either Schmitt state before it; a chunk's
           summary under each is the state it ends in (s0[-1] or s0[-1] |
           ball[-1], the JAX package's Schmitt pair) and the tail of its
           last collect region, (value, index, phase, whether a region
           starts in the chunk): the operands of JAX's _seg_argmax_op;
        2. gathers every rank's summaries, ten numbers a chunk;
        3. composes, on the host as every rank does, the carries of the
           round's chunks in order from the carry into the round: a tail
           replaces the carried region where a region starts in its chunk
           or its value is strictly larger (the earlier index wins a tie,
           as :func:`continue_region` keeps it);
        4. finishes its chunks from the kept regions of their true state,
           region 0 merged with their true carried region, no metric
           computed again;
        5. gathers the first ``max_edges`` edges of every chunk as (edge,
           n_max, phase).

        Every rank stops after the same round, once ``max_edges`` events
        are in, deciding on gathered data: ranks that disagreed on the
        number of rounds would hang in a collective.  The last round's
        pad chunks carry the n_out sentinel and the identity summary.  The
        events equal the single-device walk's: an edge among the
        recording's first ``max_edges`` is among its chunk's first."""
        mesh, dev = self.mesh, self.device
        n_out = x.shape[0] - 2 * self.L
        self.last_chunks = self.last_rank_chunks = self.last_rounds = 0
        if n_out <= 0:
            return []
        c, ctx = self._context(chunk_samples)
        n_chunks = -(-n_out // c)
        k = min(max_edges, c)
        f64 = dict(dtype=torch.float64, device=dev)
        # a pad chunk passes both carries through and has no edge
        identity = torch.tensor([0, -math.inf, 0, 0, 0,
                                 1, -math.inf, 0, 0, 0], **f64)
        no_edges = torch.full((k, 3), -1.0, **f64)
        state, best = False, (-math.inf, 0, 0.0)
        events = []
        g0 = 0
        while g0 < n_chunks and len(events) < max_edges:
            m = min(self.MAX_CHUNKS_PER_ROUND, n_chunks - g0)
            m = -(-m // mesh.size) * mesh.size
            n0s = [min((g0 + j) * c, n_out) for j in range(m)]
            per = m // mesh.size
            mine = range(mesh.rank * per, (mesh.rank + 1) * per)
            kept, tails = [], []
            for j in mine:
                if n0s[j] == n_out:
                    kept.append(None)
                    tails.append(identity)
                    continue
                t_c, psh_c = self._chunk_metrics(x, n0s[j], c, ctx)
                hyp = [self._chunk_regions(t_c, psh_c, n0s[j],
                                           torch.tensor(h, device=dev))
                       for h in (False, True)]
                kept.append(hyp)
                tails.append(torch.cat([_region_tail(r) for r in hyp]))
                self.last_rank_chunks += 1
            carries = []
            for row in all_gather_rows(torch.stack(tails), mesh).cpu().numpy():
                carries.append((state, best))
                s_out, v, i, p, starts = row[5:] if state else row[:5]
                if starts or v > best[0]:
                    best = (v, i, p)
                state = bool(s_out)
            firsts = []
            for j, hyp in zip(mine, kept):
                if hyp is None:
                    firsts.append(no_edges)
                    continue
                st, (v, i, p) = carries[j]
                regions = hyp[int(st)]
                continue_region(regions, (
                    torch.tensor(v, dtype=torch.float32, device=dev),
                    torch.tensor(int(i), device=dev),
                    torch.tensor(p, dtype=torch.float32, device=dev)))
                firsts.append(_first_edges(regions, k))
            got = all_gather_rows(torch.stack(firsts), mesh).cpu().numpy()
            for n0, rows in zip(n0s, got):
                events += _edge_events(n0, rows, n_out)
            self.last_chunks += sum(n0 < n_out for n0 in n0s)
            self.last_rounds += 1
            g0 += m
        return events[:max_edges]

    def scan(self, x, max_candidates: int = 8, chunk_samples=None):
        """Find the Schmidl-Cox preambles of a whole recording ([T]
        complex, or [T, 2] float) on the synchroniser's device.

        Returns SyncCandidates in time order with the reference's gates
        applied (peak > 4*next, |pos_err| <= guard/2; decode.cc:140-145),
        stopping after ``max_candidates`` that pass.  A margin of 4x as
        many raw falling edges is examined, so spurious noise edges do
        not take the slots of later frames.  The recording is walked in
        chunks of ``chunk_samples`` samples (default CHUNK_SMALL, or
        CHUNK_LARGE past CHUNK_AUTO_THRESHOLD), so device memory stays
        O(chunk); its events equal the JAX package's host walk
        (``scan(host=True)``) event for event."""
        x = self.recording(x)
        if chunk_samples is None:
            chunk_samples = (self.CHUNK_SMALL
                             if x.shape[0] <= self.CHUNK_AUTO_THRESHOLD
                             else self.CHUNK_LARGE)
        raw = self._events_device(x, chunk_samples, 4 * max_candidates)
        events = self.assemble_events(raw)
        if not events:
            return []
        wins = self.windows(x, [p0 + self.L for p0, _ in events], self.L)
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
        one SyncCandidate per event, in one host copy.  Each convention's
        kernel is gated on its own; the passing ones become the
        candidate's ``alts``, peak ratio descending (ties keep the
        convention order), and the best of them (of all, when none
        passes) fills its fields."""
        L, cfg = self.L, self.cfg
        with wait("sync.fine"):
            fcs = torch.tensor([fc for _, fc in events], dtype=torch.float32,
                               device=wins.device)
        shift, pos_err, peak, nxt, _ = self._fine_stage_all(wins, fcs)
        with wait("sync.fine"):
            ints = torch.stack([shift, pos_err]).cpu().numpy()  # [2, n, K]
        with wait("sync.fine"):
            floats = torch.stack([peak, nxt]).cpu().numpy()
        out = []
        for i, (p0, fc) in enumerate(events):
            alts = []
            for k in range(len(self.conventions)):
                sh, err = int(ints[0, i, k]), int(ints[1, i, k])
                pk, nx = floats[0, i, k], floats[1, i, k]
                ok = bool(pk > 4.0 * nx) and abs(err) <= cfg.guard_len // 2
                cfo = float(sh) * 2.0 * np.pi / L - fc
                if cfo >= np.pi:
                    cfo -= 2.0 * np.pi
                ratio = float(pk / max(nx, 1e-30))
                alts.append((ok, ratio, (k, int(p0) - err, cfo, ratio)))
            alts.sort(key=lambda a: -a[1])
            passing = tuple(a[2] for a in alts if a[0])
            best = passing[0] if passing else alts[0][2]
            out.append(SyncCandidate(
                p0=best[1], frac_cfo=fc, cfo_rad=best[2], ok=bool(passing),
                peak_ratio=best[3], conv=best[0], alts=passing))
        return out
