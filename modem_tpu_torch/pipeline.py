"""Batched serving decode: recordings -> payload bits, one device.

Counterpart of ``modem_tpu/pipeline.py``: :class:`BatchPipeline` decodes
a batch of recordings with a known (rate, mode), one frame each, through

  1. coarse sync: the Schmidl-Cox timing metric on a stride grid and its
     argmax (no Schmitt scan: a batch job knows its framing);
  2. fine sync: integer CFO and timing correction at the argmax;
  3. demod: payload windows, CFO mixdown, FFT, differential demod,
     Theil-Sen derotation, soft demap, lengthening to the mother code;
  4. polar decode: plain SC with the CUDA kernel kernels/sc_decode.py at
     ``list_size=1``, the list decoder kernels/scl_decode.py at
     ``list_size`` 2, 4 or 8 (exact, or Fast-SSC-List with
     ``scl_exact=False``);
  5. CRC-32 check over each path and the lowest-metric passing path
     (decode.cc:530-555).

:class:`AdaptivePipeline` is the serving path: every frame through SC,
and only the frames whose CRC fails again through the list decoder, so
its results equal ``BatchPipeline(list_size=8)``'s (with the same
``scl_exact``) on any batch.  Tensors stay on ``device`` (the card by
default; ``device="cpu"`` runs the kernels' plain versions) from the
recordings to the packed result.

Both also decode every frame of one long recording
(``decode_recording``: the chunked Schmitt scan, then one window per
preamble, all decoded as one batch), and :func:`decode_recording_auto`
decodes a recording of frames of any mode (and, under
``mls_convention="auto"``, any LFSR convention): one scan, one batch of
headers, then one windowed decode per (mode, convention) group.  A
recording may be an ``ingest.PcmRecording`` in wire dtype, whose front
end runs on the device.  The interactive ``decoder.Decoder`` decodes
its payload through a BatchPipeline too, a batch of one frame at a
known position (:meth:`BatchPipeline.demod_at`).
"""

from __future__ import annotations

import contextlib
import functools
import math
import time

import numpy as np
import torch

from . import bits as B
from . import fft, ofdm, track
from .fec.polar import PolarCode
from .fec.schedule import Schedule
from .kernels import unroll
from .kernels.sc_decode import ScPlan, sc_decode
from .kernels.scl_decode import LIST_SIZES, scl_decode
from .numerology import MODES, ModemConfig
from .profiling import span, upload, wait
from .state import build_state
from .sync import Synchronizer, slice_windows

# default for scl_unroll=None: whether the polar decoders run the kernel
# generated for the schedule (kernels/unroll.py: every row straight-line
# code, no table, no opcode dispatch) instead of the interpreter
SCL_UNROLL_DEFAULT = False


def as_recordings(recordings, device) -> torch.Tensor:
    """[B, T] complex (numpy or torch) or [B, T, 2] split-complex float
    -> complex64 [B, T] tensor on ``device``."""
    x = torch.as_tensor(recordings)
    if not x.is_complex():
        if x.shape[-1] != 2:
            raise ValueError(f"recordings of shape {tuple(x.shape)}: want "
                             "[B, T] complex or [B, T, 2] float")
        x = torch.complex(x[..., 0].float(), x[..., 1].float())
    if x.dim() != 2:
        raise ValueError(f"recordings must be a batch [B, T], got "
                         f"{tuple(x.shape)}")
    with upload("pipeline.upload", recordings, device):
        return x.to(device=device, dtype=torch.complex64)


class BatchPipeline:
    """Batched decoder for one (rate, mode) on one device.

    list_size: 1 decodes with plain SC, 2, 4 or 8 with the list decoder:
    ``scl_exact=True`` the exact one (the one-shot RATE1/SPC
    enumeration, kernel B), ``scl_exact=False`` the Fast-SSC-List
    approximation (kernel C).
    ``state``: a :class:`state.PipelineState` holding ``frozen``,
    ``schedule``, ``crc_matrix`` and ``mls0_kernel`` (default:
    :func:`state.build_state`).  sync_stride: evaluate the coarse timing
    metric every N samples where the numerology divides cleanly
    (Synchronizer.stride_ok), else at full rate.  scl_unroll: True runs
    the polar kernel the list size picks (A, B or C) as generated for
    this schedule (kernels/unroll.py, built at first use), None follows
    :data:`SCL_UNROLL_DEFAULT`; the result is the same, and the plain CPU
    path has no unroll.  True raises ValueError on a schedule longer
    than ``unroll.MAX_ROWS`` (every wire-size mode): no such build has
    been seen to end, and the wire-size one ran out of host memory.
    estimator: the Theil-Sen variant of the demod, "disjoint" or
    "all_pairs"; None for the module default ``track.ESTIMATOR``."""

    def __init__(self, rate: int, oper_mode: int, list_size: int = 8,
                 mode_spec=None, symbol_len_override=None,
                 scl_exact: bool = True, mls_convention: str = "galois",
                 sync_stride: int = 8, device="cuda", state=None,
                 scl_unroll: bool | None = None,
                 estimator: str | None = None):
        if list_size != 1 and list_size not in LIST_SIZES:
            raise NotImplementedError(
                f"the port decodes with list_size 1 or {LIST_SIZES}")
        if estimator is not None and estimator not in track.ESTIMATORS:
            raise ValueError(f"unknown Theil-Sen estimator {estimator!r}")
        if mls_convention == "auto":
            raise ValueError(
                "BatchPipeline needs a committed mls_convention (the "
                "batch path knows its framing); decode_recording_auto and "
                "Decoder detect it")
        mode = mode_spec if mode_spec is not None else MODES[oper_mode]
        self.cfg = cfg = ModemConfig(
            rate=rate, mode=mode, freq_off=0,
            symbol_len_override=symbol_len_override,
            mls_convention=mls_convention)
        self.device = torch.device(device)
        if state is None:
            state = build_state(cfg, self.device)
        self.state = state
        self.list_size = list_size
        self.scl_exact = scl_exact
        self.estimator = estimator
        self.scl_unroll = (SCL_UNROLL_DEFAULT if scl_unroll is None
                           else bool(scl_unroll))
        frozen = state.frozen.cpu().numpy()
        self.code = PolarCode(n=mode.cons_bits, k=mode.crc_bits,
                              order=mode.code_order, frozen=frozen)
        self.plan = ScPlan(Schedule.from_table(state.schedule.cpu().numpy(),
                                               self.code.code_len))
        if self.scl_unroll:
            unroll.check_rows(self.plan.sched)
        self.crc_mat = state.crc_matrix.to(self.device)
        self.sync = Synchronizer(cfg, self.device, state.mls0_kernel)
        self.sync_stride = (sync_stride
                            if self.sync.stride_ok(sync_stride) else 1)
        s = cfg.symbol_len
        code_off = -mode.cons_cols // 2
        self._code_off = code_off
        self._bins = torch.as_tensor(
            ofdm.bin_index(np.arange(code_off, code_off + mode.cons_cols), s),
            device=self.device)
        self._crc_idx = torch.as_tensor(self.code.info_idx[: mode.crc_bits],
                                        device=self.device)
        self._data_idx = self._crc_idx[: mode.data_bits]

    # -- stages ------------------------------------------------------------
    def _sync_argmax(self, x: torch.Tensor):
        """Single-candidate coarse sync: global timing argmax per
        recording -> (p0, fractional CFO, multiframe flag), each [B].

        ``multiframe`` guards the one-frame-per-recording contract: a
        timing sample above the Schmitt upper threshold outside the
        committed frame's span marks a second frame.  With a stride the
        argmax lands within one stride of the full-rate peak; the phase
        readout index stays exact because match_del is a stride
        multiple."""
        s = self.sync
        S = self.sync_stride
        if S > 1:
            timing, p_re, p_im = s._metrics_parts_strided(x, S)
        else:
            timing, p_re, p_im = s._metrics_parts(x)
        m_max = timing.argmax(dim=-1)
        n_max = m_max * S + (S - 1)
        p0 = n_max - s.match_del
        i = (m_max - s.match_del // S).clamp(min=0)[:, None]
        fc = torch.atan2(p_im.gather(-1, i), p_re.gather(-1, i))[:, 0] / s.L
        idx = (torch.arange(timing.shape[-1], device=x.device) * S
               + (S - 1))
        sg = self.cfg.symbol_len + self.cfg.guard_len
        inside = ((idx >= (n_max - 2 * sg)[:, None])
                  & (idx <= (n_max + self.cfg.frame_samples)[:, None]))
        extra = timing.masked_fill(inside, -math.inf).amax(dim=-1)
        return p0, fc, extra > s.thr_hi

    def demod(self, recordings) -> dict:
        """The front end: recordings [B, T] -> dict of channel LLRs
        [B, code_len] (lengthened) and the per-frame sync metrics.
        Counterpart of the JAX ``_demod_one``, over the whole batch."""
        x = as_recordings(recordings, self.device)
        L = self.sync.L
        p0, fc, multiframe = self._sync_argmax(x)
        window = slice_windows(x, p0 + L, L)
        shift, pos_err, peak, nxt, _ = self.sync._fine_stage(window, fc)
        p0 = p0 - pos_err
        cfo = shift.to(torch.float32) * (2.0 * math.pi / L) - fc
        cfo = torch.where(cfo >= math.pi, cfo - 2.0 * math.pi, cfo)

        full, snr, _slope, _yint = self.demod_at(x, p0, cfo)
        return dict(llrs=full, p0=p0, cfo_rad=cfo, snr=snr,
                    sync_gate=peak > 4.0 * nxt, multiframe=multiframe)

    def demod_at(self, x: torch.Tensor, p0: torch.Tensor,
                 cfo_rad: torch.Tensor):
        """The payload half of :meth:`demod`, for frames whose preamble
        position and CFO are known: x [B, T] complex64, p0 [B] int64,
        cfo_rad [B] f32, all on the device -> (LLRs [B, code_len]
        lengthened, snr [B, rows], each frame's mean Theil-Sen slope [B]
        and intercept [B])."""
        cfg = self.cfg
        mode = cfg.mode
        s, g = cfg.symbol_len, cfg.guard_len
        rows = mode.cons_rows
        batch = x.shape[0]
        # payload windows: pilot + rows (decode.cc:456-470), one
        # contiguous slice per recording, rows cut by a reshape
        flat = slice_windows(x, p0 + 2 * (s + g), rows * (s + g) + s)
        head = flat[:, : rows * (s + g)].reshape(batch, rows, s + g)[..., :s]
        windows = torch.cat([head, flat[:, None, rows * (s + g):]], dim=1)
        w = torch.arange(rows + 1, dtype=torch.float32,
                         device=x.device)[:, None]
        k = torch.arange(s, dtype=torch.float32, device=x.device)[None, :]
        # the oscillator phase continues from the metadata symbol
        # (advanced S there), through every guard (decode.cc:458-470)
        phase = -cfo_rad[:, None, None] * (s + w * (s + g) + k)
        spec = fft.fwd(windows * torch.complex(torch.cos(phase),
                                               torch.sin(phase)))
        carriers = spec[..., self._bins]
        cons = ofdm.demod_or_erase(carriers[:, 1:], carriers[:, :-1])
        cons, slope, yint = track.derotate_rows(cons, self._code_off,
                                                mode.mod_bits, self.estimator)
        llrs, snr = track.soft_llrs(cons, mode.mod_bits)
        full = self.code.lengthen(llrs.reshape(batch, -1))
        return full.contiguous(), snr, slope, yint

    def _fec_select(self, front: dict) -> dict:
        """Polar decode + CRC-32 path select on a demodulated batch
        (decode.cc:530-555, batched)."""
        mode = self.cfg.mode
        if self.list_size == 1:
            codewords, pm = sc_decode(front["llrs"], self.plan,
                                      unroll=self.scl_unroll)
        else:
            codewords, pm = scl_decode(front["llrs"], self.plan,
                                       self.list_size, self.scl_exact,
                                       unroll=self.scl_unroll)  # [B, L, n]
        info = codewords[..., self._crc_idx]                 # [B, L, k]
        rem = torch.remainder(info.to(torch.float32) @ self.crc_mat, 2.0)
        crc_ok = rem.sum(dim=-1) == 0                        # [B, L]
        best = torch.where(crc_ok, pm, math.inf).argmin(dim=-1)
        rows = torch.arange(info.shape[0], device=info.device)
        bits = info[rows, best, : mode.data_bits]
        received = front["llrs"][:, self._data_idx] < 0
        flips = (received != bits.bool()).sum(dim=-1)
        return dict(ok=crc_ok.any(dim=-1), bits=bits, p0=front["p0"],
                    cfo_rad=front["cfo_rad"], snr=front["snr"],
                    flips=flips, sync_gate=front["sync_gate"],
                    multiframe=front["multiframe"])

    # -- public ------------------------------------------------------------
    def decode_batch(self, recordings) -> dict:
        """recordings: [B, T] complex or [B, T, 2] float -> result dict
        of tensors on the pipeline's device: ok, bits [B, data_bits],
        p0, cfo_rad, snr [B, rows], flips, sync_gate, multiframe."""
        return self._fec_select(self.demod(recordings))

    def frame_windows(self, x, max_frames: int = 64):
        """Scan a recording (analytic, or an ``ingest.PcmRecording``) and
        cut one window per detected frame: :meth:`windows_at` at the
        positions of the candidates that pass the sync gates."""
        x = self.sync.recording(x)
        cands = [c for c in self.sync.scan(x, max_candidates=max_frames)
                 if c.ok]
        return self.windows_at(x, [c.p0 for c in cands])

    def windows_at(self, x, positions):
        """One frame window per preamble position p0: samples
        [p0 - (2s + g), p0 + frame_samples + g // 2) of ``x`` (analytic,
        or a PcmRecording through the device front end), zero outside
        the recording.  Returns (windows [n, w] complex64 on the device,
        positions int64 [n]).

        The lead 2s + g holds the pilot symbol before the S&C: the
        timing metric's peak needs L + match_len samples of window-sum
        history, and a lead of s + g leaves L + g, one sample short at
        8 kHz (g = 160 < match_len = 161).  The window runs through the
        frame's last payload sample, stopping before the next frame's
        preamble, so the batch path's global argmax sees one preamble;
        the g // 2 past it covers a p0 that the fine stage resolves up
        to g / 2 late (|pos_err| <= g / 2, decode.cc:143-145), which
        would otherwise clamp the payload slice."""
        cfg = self.cfg
        s, g = cfg.symbol_len, cfg.guard_len
        w = cfg.frame_samples + 2 * s + g // 2
        pos = np.asarray([int(p) for p in positions], dtype=np.int64)
        return self.sync.windows(self.sync.recording(x), pos - (2 * s + g),
                                 w), pos

    def decode_windows(self, wins) -> dict:
        """Decode pre-cut frame windows [n, w] as one batch (the JAX
        package pads the batch for its kernel's cell size; every frame
        decodes on its own here, so the n results are the same)."""
        return self.decode_batch(wins)

    def decode_recording(self, x, max_frames: int = 64):
        """Find and decode every frame of one long recording: the
        Schmitt-trigger scan locates the preambles (decode.cc:390-448),
        then all frames decode as one batch.  Returns (the
        :meth:`decode_batch` dict, or None when no frame was found;
        positions [n_frames])."""
        wins, pos = self.frame_windows(x, max_frames)
        if not len(pos):
            return None, pos
        return self.decode_windows(wins), pos

    def payload_bytes(self, result, i: int) -> bytes:
        bits = result["bits"][i]
        if isinstance(bits, torch.Tensor):
            bits = bits.cpu().numpy()
        return B.scramble(B.bits_to_bytes_le(bits))

    def pack(self, res: dict):
        """Pack the result on the device into one int32 block [B, 5 +
        rows + words] (floats bitcast, bits 32 to a word, little-endian)
        so that :meth:`unpack` copies it to the host in one transfer.
        Returns (block, snr columns, bit count)."""
        bits = res["bits"].to(torch.uint8)
        batch, nb = bits.shape
        nw = -(-nb // 32)
        padded = torch.nn.functional.pad(bits, (0, nw * 32 - nb))
        weights = (1 << torch.arange(8, device=bits.device)).to(torch.uint8)
        octets = (padded.reshape(batch, nw * 4, 8) * weights).sum(
            dim=-1, dtype=torch.uint8)
        cols = [res["ok"].to(torch.int32)[:, None],
                res["flips"].to(torch.int32)[:, None],
                res["p0"].to(torch.int32)[:, None],
                res["sync_gate"].to(torch.int32)[:, None],
                res["cfo_rad"].to(torch.float32)[:, None].view(torch.int32),
                res["snr"].to(torch.float32).contiguous().view(torch.int32),
                octets.view(torch.int32)]
        return torch.cat(cols, dim=1), res["snr"].shape[1], nb

    @staticmethod
    def unpack(handle) -> dict:
        """Copy a :meth:`pack` block to the host and unpack it into the
        result dict of numpy arrays."""
        packed, snr_cols, nb = handle
        packed = packed.cpu().numpy()     # a host tensor stays in place
        off = 5 + snr_cols
        words = np.ascontiguousarray(packed[:, off:])
        bits = np.unpackbits(words.view(np.uint8), axis=1,
                             bitorder="little")[:, :nb]
        return dict(
            ok=packed[:, 0].astype(bool),
            flips=packed[:, 1].copy(),
            p0=packed[:, 2].copy(),
            sync_gate=packed[:, 3].astype(bool),
            cfo_rad=np.ascontiguousarray(packed[:, 4]).view(np.float32),
            snr=np.ascontiguousarray(packed[:, 5: off]).view(np.float32),
            bits=bits)

    def fetch(self, res: dict) -> dict:
        """The result dict as host numpy arrays, in one transfer."""
        block, snr_cols, nb = self.pack(res)
        with wait("pipeline.fetch"):
            block = block.cpu()
        return self.unpack((block, snr_cols, nb))


class Handle(tuple):
    """What :meth:`AdaptivePipeline.decode_batch_async` returns: the tuple
    (front end dict, packed block, event) that :meth:`AdaptivePipeline.
    resolve` takes, carrying the batch's request id (None when the batch
    was dispatched untraced)."""

    def __new__(cls, parts, request):
        self = super().__new__(cls, parts)
        self.request = request
        return self


class AdaptivePipeline:
    """CRC-gated adaptive decode: plain SC first, the list decoder only
    on failure (counterpart of ``modem_tpu.pipeline.AdaptivePipeline``).

    Every frame decodes with the SC kernel; the frames whose CRC-32
    fails decode again, in groups of ``fallback_batch``, with the
    list-``list_size`` kernel (exact, or Fast-SSC-List with
    ``scl_exact=False`` in ``kw``), and their result replaces the SC one
    verbatim.  So every result key equals ``BatchPipeline(list_size=
    list_size)``'s, except on a frame whose greedy SC path passes its CRC
    but falls out of the list.  The two sub-pipelines share one
    :class:`state.PipelineState`; ``scl_unroll`` in ``kw`` applies to
    both kernels.

    ``decode_batch`` returns the host dict of :meth:`BatchPipeline.
    fetch` (the CRC gate is a host decision); the pair
    :meth:`decode_batch_async` / :meth:`resolve` lets a serving loop
    dispatch the next batch before this one's gate and fetch."""

    def __init__(self, rate: int, oper_mode: int, list_size: int = 8,
                 fallback_batch: int = 16, device="cuda", state=None, **kw):
        self.sc = BatchPipeline(rate, oper_mode, list_size=1, device=device,
                                state=state, **kw)
        self.scl = BatchPipeline(rate, oper_mode, list_size=list_size,
                                 device=device, state=self.sc.state, **kw)
        self.cfg = self.sc.cfg
        self.code = self.sc.code
        self.fallback_batch = fallback_batch
        self.last_fallbacks = 0     # frames escalated by the last resolve

    def decode_batch_async(self, recordings):
        """Dispatch the front end, the SC back end and the result pack,
        then the copy of the packed block to pinned host memory, all on
        the current stream; returns a handle for :meth:`resolve`.
        Nothing here waits for the device (unless the recordings are on
        the host: their upload does).  The handle unpacks as (front end
        dict, packed block, event); its ``request`` is the id its spans
        share while tracing (:mod:`profiling`)."""
        with span("pipeline.dispatch") as rec:
            with span("pipeline.demod", device=self.sc.device):
                front = self.sc.demod(recordings)
            with span("pipeline.sc"):
                res = self.sc._fec_select(front)
            with span("pipeline.pack"):
                block, snr_cols, nb = self.sc.pack(res)
                event = None
                if block.is_cuda:
                    host = torch.empty(block.shape, dtype=block.dtype,
                                       pin_memory=True)
                    host.copy_(block, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                    block = host
        return Handle((front, (block, snr_cols, nb), event),
                      None if rec is None else rec.request)

    def resolve(self, handle) -> dict:
        """Wait for this batch's packed result (its event, not the whole
        stream: a batch dispatched since runs on), gate on CRC, and
        re-decode the failing frames with the list decoder (kernel B, or
        C with ``scl_exact=False``); returns
        the merged host dict (the :meth:`BatchPipeline.fetch` keys)."""
        front, packed, event = handle
        with span("pipeline.resolve", request=getattr(handle, "request",
                                                      None)):
            if event is not None:
                with wait("pipeline.wait"):
                    event.synchronize()
            with span("pipeline.unpack"):
                host = self.sc.unpack(packed)
            fails = np.flatnonzero(~host["ok"])
            self.last_fallbacks = int(fails.size)
            bf = self.fallback_batch
            for g0 in range(0, fails.size, bf):
                with span("pipeline.escalate"):
                    group = fails[g0: g0 + bf]
                    idx = np.full(bf, group[0], dtype=np.int64)  # pad: repeat
                    idx[: group.size] = group
                    with wait("pipeline.upload"):
                        idx = torch.as_tensor(idx, device=self.sc.device)
                    sub = {k: v.index_select(0, idx)
                           for k, v in front.items()}
                    h2 = self.scl.fetch(self.scl._fec_select(sub))
                    for k in host:
                        host[k][group] = h2[k][: group.size]
        return host

    def decode_batch(self, recordings) -> dict:
        return self.resolve(self.decode_batch_async(recordings))

    def fetch(self, res: dict) -> dict:
        """Identity: :meth:`decode_batch` already returns the host dict,
        so a BatchPipeline serving loop runs unchanged."""
        return res

    def payload_bytes(self, result, i: int) -> bytes:
        return self.sc.payload_bytes(result, i)

    # window cutting is the SC sub-pipeline's (the same configuration)
    def frame_windows(self, x, max_frames: int = 64):
        return self.sc.frame_windows(x, max_frames)

    def windows_at(self, x, positions):
        return self.sc.windows_at(x, positions)

    def decode_windows(self, wins) -> dict:
        """Decode pre-cut frame windows adaptively: the host dict."""
        return self.decode_batch(wins)

    def decode_recording(self, x, max_frames: int = 64):
        """Find and decode every frame of one long recording, adaptively
        (the analogue of :meth:`BatchPipeline.decode_recording`)."""
        wins, pos = self.frame_windows(x, max_frames)
        if not len(pos):
            return None, pos
        return self.decode_windows(wins), pos


@functools.lru_cache(maxsize=None)
def cached_pipeline(rate: int, oper_mode: int, list_size: int = 8,
                    mls_convention: str = "galois", device: str = "cuda",
                    scl_unroll: bool | None = None) -> BatchPipeline:
    return BatchPipeline(rate, oper_mode, list_size,
                         mls_convention=mls_convention, device=device,
                         scl_unroll=scl_unroll)


@functools.lru_cache(maxsize=None)
def cached_adaptive_pipeline(rate: int, oper_mode: int, list_size: int = 8,
                             mls_convention: str = "galois",
                             device: str = "cuda",
                             scl_unroll: bool | None = None
                             ) -> AdaptivePipeline:
    return AdaptivePipeline(rate, oper_mode, list_size,
                            mls_convention=mls_convention, device=device,
                            scl_unroll=scl_unroll)


def decode_recording_auto(x, rate: int, channels: int = 2,
                          max_frames: int = 64,
                          mls_convention: str = "galois",
                          adaptive: bool = False, device: str = "cuda",
                          stats: dict | None = None) -> list:
    """Decode every frame of a recording of any mode, with the reference
    decoder's semantics on the serving path: each frame's mode and call
    sign come from its BCH(255,71) + OSD header (decode.cc:398-446), the
    frames group by mode (and, under ``mls_convention="auto"``, by the
    detected LFSR convention), and each group decodes as one batch.

    ``x``: complex [T], [T, 2] float I/Q, real mono [T] with
    ``channels == 1``, or an ``ingest.PcmRecording`` (wire dtype to the
    device once, the front end there).  ``adaptive``: each group through
    :class:`AdaptivePipeline` (SC kernel A on every frame, the list
    decoder on the CRC failures) instead of the list decoder
    (:class:`BatchPipeline`, kernel B) on every frame; the results are
    the same on anything either decodes.  ``stats``: a dict that gets
    the wall milliseconds of the stages (``scan_ms``, ``headers_ms``,
    ``windows_ms``, ``payload_ms``, each ending in a device
    synchronise), the scan's chunk count (``chunks``) and its rounds,
    one host read each (``rounds``).  The stages
    are the spans ``decode_all.scan``, ``.headers``, ``.windows`` and
    ``.payload`` of one request (:mod:`profiling`).

    Returns a time-ordered list of one dict a preamble that passed the
    sync gates: {pos, mode, call_sign, ok, payload, flips, snr, status},
    status "ok" or "payload decoding error."; a preamble whose header
    failed has mode None and the reference's rejection text."""
    from .decoder import cached_decoder
    from .ingest import PcmRecording

    dec = cached_decoder(rate, mls_convention=mls_convention, device=device)
    request = None

    @contextlib.contextmanager
    def stage(key: str):
        """The span ``decode_all.<key>``; with ``stats``, its wall ms as
        ``<key>_ms``, ending in a device synchronise."""
        nonlocal request
        with span("decode_all." + key, request=request) as rec:
            request = None if rec is None else rec.request
            t0 = time.perf_counter()
            yield
            if stats is not None:
                if dec.device.type == "cuda":
                    with wait("decode_all.sync"):
                        torch.cuda.synchronize(dec.device)
                stats[key + "_ms"] = (time.perf_counter() - t0) * 1e3

    with stage("scan"):
        if not isinstance(x, PcmRecording):
            x = dec.frontend(x, channels)
        cands = [c for c in dec.sync.scan(x, max_candidates=max_frames)
                 if c.ok]
    if stats is not None:
        stats["chunks"] = dec.sync.last_chunks
        stats["rounds"] = dec.sync.last_rounds
    frames = []          # (pos, mode, call, convention)
    rejects = []
    with stage("headers"):
        for c, (hdr, status) in zip(cands,
                                    dec.decode_headers_batch(x, cands)):
            if hdr is None:
                rejects.append(rejected(c.p0, status))
                continue
            oper_mode, call = hdr
            frames.append((c.p0, oper_mode, B.base37_decode(call).lstrip(),
                           dec.sync.conventions[c.conv]))
    factory = cached_adaptive_pipeline if adaptive else cached_pipeline
    with stage("windows"):
        cut = cut_groups(x, frames, factory, rate, device)
    with stage("payload"):
        out = decode_groups(cut)
    out.extend(rejects)
    out.sort(key=lambda f: f["pos"])
    return out


def rejected(pos, status: str, mode=None, call_sign: str = "") -> dict:
    """The answer dict of a frame that was not decoded: its header
    failed (``mode`` None), or its payload window leaves the recording."""
    return dict(pos=int(pos), mode=mode, call_sign=call_sign, ok=False,
                payload=b"", flips=None, snr=None, status=status)


def cut_groups(x, frames, factory, rate: int, device) -> list:
    """Frames with decoded headers, (pos, mode, call sign, convention)
    each, grouped by (mode, convention): each group's windows cut from
    ``x`` by the group's pipeline ``factory(rate, mode,
    mls_convention=conv, device=device)``.  Returns [(pipeline, the
    group's frames, windows)]."""
    groups: dict[tuple, list] = {}
    for f in frames:
        groups.setdefault((f[1], f[3]), []).append(f)
    cut = []
    for (mode, conv), group in groups.items():
        pipe = factory(rate, mode, mls_convention=conv, device=device)
        wins, _ = pipe.windows_at(x, [f[0] for f in group])
        cut.append((pipe, group, wins))
    return cut


def decode_groups(cut) -> list:
    """Decode each group of :func:`cut_groups` as one batch and fetch it:
    one answer dict a frame {pos, mode, call_sign, ok, payload, flips,
    snr, status}, status "ok" or "payload decoding error.", in group
    order."""
    out = []
    for pipe, group, wins in cut:
        res = pipe.fetch(pipe.decode_windows(wins))
        for j, (pos, mode, call, _conv) in enumerate(group):
            ok = bool(res["ok"][j])
            out.append(dict(pos=int(pos), mode=mode, call_sign=call, ok=ok,
                            payload=pipe.payload_bytes(res, j),
                            flips=int(res["flips"][j]),
                            snr=np.asarray(res["snr"][j]),
                            status="ok" if ok else "payload decoding error."))
    return out
