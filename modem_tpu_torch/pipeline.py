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
"""

from __future__ import annotations

import functools
import math

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
    been seen to end, and the wire-size one ran out of host memory."""

    def __init__(self, rate: int, oper_mode: int, list_size: int = 8,
                 mode_spec=None, symbol_len_override=None,
                 scl_exact: bool = True, mls_convention: str = "galois",
                 sync_stride: int = 8, device="cuda", state=None,
                 scl_unroll: bool | None = None):
        if list_size != 1 and list_size not in LIST_SIZES:
            raise NotImplementedError(
                f"the port decodes with list_size 1 or {LIST_SIZES}")
        if mls_convention == "auto":
            raise ValueError(
                "BatchPipeline needs a committed mls_convention (the "
                "batch path knows its framing)")
        if mls_convention != "galois":
            raise NotImplementedError(
                "the port's pipeline carries the 'galois' convention only")
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
        cfg = self.cfg
        mode = cfg.mode
        s, g = cfg.symbol_len, cfg.guard_len
        rows = mode.cons_rows
        L = self.sync.L
        batch = x.shape[0]

        p0, fc, multiframe = self._sync_argmax(x)
        window = slice_windows(x, p0 + L, L)
        shift, pos_err, peak, nxt, _ = self.sync._fine_stage(window, fc)
        p0 = p0 - pos_err
        cfo = shift.to(torch.float32) * (2.0 * math.pi / L) - fc
        cfo = torch.where(cfo >= math.pi, cfo - 2.0 * math.pi, cfo)

        # payload windows: pilot + rows (decode.cc:456-470), one
        # contiguous slice per recording, rows cut by a reshape
        flat = slice_windows(x, p0 + 2 * (s + g), rows * (s + g) + s)
        head = flat[:, : rows * (s + g)].reshape(batch, rows, s + g)[..., :s]
        windows = torch.cat([head, flat[:, None, rows * (s + g):]], dim=1)
        w = torch.arange(rows + 1, dtype=torch.float32,
                         device=x.device)[:, None]
        k = torch.arange(s, dtype=torch.float32, device=x.device)[None, :]
        phase = -cfo[:, None, None] * (s + w * (s + g) + k)
        spec = fft.fwd(windows * torch.complex(torch.cos(phase),
                                               torch.sin(phase)))
        carriers = spec[..., self._bins]
        cons = ofdm.demod_or_erase(carriers[:, 1:], carriers[:, :-1])
        cons, _slope, _yint = track.derotate_rows(cons, self._code_off,
                                                  mode.mod_bits)
        llrs, snr = track.soft_llrs(cons, mode.mod_bits)
        full = self.code.lengthen(llrs.reshape(batch, -1))
        return dict(llrs=full.contiguous(), p0=p0, cfo_rad=cfo, snr=snr,
                    sync_gate=peak > 4.0 * nxt, multiframe=multiframe)

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
        return self.unpack(self.pack(res))


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
        Nothing here waits for the device."""
        front = self.sc.demod(recordings)
        block, snr_cols, nb = self.sc.pack(self.sc._fec_select(front))
        event = None
        if block.is_cuda:
            host = torch.empty(block.shape, dtype=block.dtype,
                               pin_memory=True)
            host.copy_(block, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            block = host
        return front, (block, snr_cols, nb), event

    def resolve(self, handle) -> dict:
        """Wait for this batch's packed result (its event, not the whole
        stream: a batch dispatched since runs on), gate on CRC, and
        re-decode the failing frames with the list decoder (kernel B, or
        C with ``scl_exact=False``); returns
        the merged host dict (the :meth:`BatchPipeline.fetch` keys)."""
        front, packed, event = handle
        if event is not None:
            event.synchronize()
        host = self.sc.unpack(packed)
        fails = np.flatnonzero(~host["ok"])
        self.last_fallbacks = int(fails.size)
        bf = self.fallback_batch
        for g0 in range(0, fails.size, bf):
            group = fails[g0: g0 + bf]
            idx = np.full(bf, group[0], dtype=np.int64)  # pad: repeat
            idx[: group.size] = group
            idx = torch.as_tensor(idx, device=self.sc.device)
            sub = {k: v.index_select(0, idx) for k, v in front.items()}
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
