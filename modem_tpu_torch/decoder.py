"""Interactive decode: one recording -> the payload of its first frame.

Counterpart of ``modem_tpu/decoder.py`` (reference: the Decoder of
decode.cc:161-557 and its command line, decode.cc:559-620).  The stages
run as tensor passes over the whole recording on the decoder's device,
orchestrated from the host:

  1. front end (:func:`dsp.frontend`): DC block and Hilbert for a mono
     recording, I/Q passthrough otherwise;
  2. sync (:meth:`sync.Synchronizer.scan`): the chunked Schmidl-Cox scan
     with the reference's gates -> candidates in time order;
  3. header (:meth:`Decoder.decode_headers_batch`, one candidate a call
     here, every candidate at once in ``pipeline.decode_recording_auto``
     and the stream): CFO mixdown, FFT of the metadata symbol, MLS1
     descramble, bin-differential soft bits, order-4 OSD
     (:func:`fec.osd.osd_decode`), CRC-16 -> mode and call sign;
  4. payload, through the mode's ``pipeline.BatchPipeline`` (a batch of
     one): its ``demod_at`` (per-row FFT demod with the continuous CFO
     phase, differential constellation, all-pairs Theil-Sen
     derotation, cumulative-SNR soft demap, lengthening), then its
     ``_fec_select`` (the list decoder, kernel B, or kernel C with
     ``scl_exact=False``; the CRC-32 select, the bit-flip count) and the
     descramble.

The receiver's carrier layout is offset-free (code_off = -cols/2,
mls1_off = -127; decode.cc:183-186,454): the coarse CFO estimate absorbs
the transmit frequency offset.  With a ``log`` stream the decoder writes
the reference binary's stderr transcript line for line.

With ``mls_convention="auto"`` the synchroniser correlates against the
MLS0 kernel of every LFSR convention, keeps each gate-passing one as a
hypothesis, and the header stage commits the first whose OSD and CRC-16
validate, descrambling with that convention's MLS1 sequence.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from . import bits as B
from . import dsp, fft, ofdm, track
from .fec.osd import osd_decode
from .numerology import MAX_CALL_SIGN, MODES, SUPPORTED_RATES, ModemConfig
from .pipeline import LIST_SIZES, BatchPipeline
from .profiling import span, wait
from .state import build_state
from .sync import SyncCandidate, Synchronizer

# hypotheses per OSD call of decode_headers_batch: the OSD's scores take
# ~100 MB a block
HEADER_BATCH = 128


@dataclasses.dataclass
class DecodeResult:
    ok: bool
    payload: Optional[bytes] = None
    oper_mode: int = -1
    call_sign: str = ""
    symbol_pos: int = -1
    cfo_hz: float = 0.0
    sfo_ppm: float = 0.0
    snr_db: Optional[np.ndarray] = None
    bit_flips: int = -1
    status: str = ""
    # True when the final ``status`` text was already written to the
    # transcript log
    status_emitted: bool = False


class _Header(tuple):
    """A (header, status) pair of :meth:`Decoder.decode_headers_batch`,
    carrying in ``lines`` the transcript lines that validating it
    emitted ("oper mode: ...", "call sign: ..."), in order."""

    def __new__(cls, header, status, lines: list):
        self = super().__new__(cls, (header, status))
        self.lines = lines
        return self


class Decoder:
    """Per-rate interactive decoder on one device.

    ``list_size``: 2, 4 or 8 for the list decoder.  ``scl_exact``: the
    exact list decoder (kernel B, default) or the Fast-SSC-List one
    (kernel C).  ``estimator``: the Theil-Sen variant, the reference's
    exact "all_pairs" by default.  ``mls_convention``: "galois",
    "fibonacci", "msb", or "auto" to accept any of them (see the module
    note)."""

    def __init__(self, rate: int, list_size: int = 8,
                 scl_exact: bool = True, estimator: str = "all_pairs",
                 mls_convention: str = "galois", device="cuda"):
        if rate not in SUPPORTED_RATES:
            raise ValueError(f"unsupported sample rate {rate}")
        if list_size not in LIST_SIZES:
            raise NotImplementedError(
                f"the list decoder takes list_size {LIST_SIZES}")
        if estimator not in track.ESTIMATORS:
            raise ValueError(f"unknown Theil-Sen estimator {estimator!r}")
        self.rate = rate
        self.list_size = list_size
        self.scl_exact = scl_exact
        self.estimator = estimator
        self.device = torch.device(device)
        # the mode does not touch the front-end, sync or header stages
        self.cfg = ModemConfig(rate=rate, mode=MODES[6], freq_off=0,
                               mls_convention=mls_convention)
        state = build_state(self.cfg, self.device)
        self.sync = Synchronizer(self.cfg, self.device, state.mls0_kernel)
        cfg = self.cfg
        n = cfg.symbol_len
        off = -(cfg.mls1_len // 2)
        self._hdr_bins = torch.as_tensor(
            ofdm.bin_index(np.arange(cfg.mls1_len) + off, n),
            device=self.device)
        self._hdr_prev = torch.as_tensor(
            ofdm.bin_index(np.arange(cfg.mls1_len) + off - 1, n),
            device=self.device)
        # one MLS1 descrambler per convention of the synchroniser [K, 255]
        seq = state.mls1_seq.to(self.device).reshape(-1, cfg.mls1_len)
        self._mls1 = seq
        # the i-1 carrier is descrambled by seq[i-1] for i > 0; position
        # -1 is the unscrambled amplitude reference (encode.cc:169)
        self._mls1_prev = torch.cat([seq.new_ones(seq.shape[0], 1),
                                     seq[:, :-1]], dim=1)
        self._pipes: dict[int, BatchPipeline] = {}

    # ------------------------------------------------------------------
    # header stage (decode.cc:398-446)
    # ------------------------------------------------------------------
    def _header_soft(self, windows: torch.Tensor, cfo_rad: torch.Tensor,
                     conv: torch.Tensor | None = None):
        """windows: [B, N] complex samples of the metadata symbol,
        cfo_rad: [B] f32, conv: [B] index of each window's convention
        (default 0) -> soft bits [B, 255], f32 integers in [-128, 127]
        (decode.cc:406-416)."""
        n = self.cfg.symbol_len
        idx = torch.arange(n, dtype=torch.float32, device=windows.device)
        arg = -cfo_rad[:, None] * idx
        spec = fft.fwd(windows * torch.complex(torch.cos(arg),
                                               torch.sin(arg)))
        if conv is None:
            conv = torch.zeros(windows.shape[0], dtype=torch.int64,
                               device=windows.device)
        carriers = spec[:, self._hdr_bins] * self._mls1[conv]
        prev = spec[:, self._hdr_prev] * self._mls1_prev[conv]
        cons = ofdm.demod_or_erase(carriers, prev)
        return torch.clamp(torch.round(127.0 * cons.real), -128, 127)

    @staticmethod
    def _validate_header(data: np.ndarray, emit=lambda s: None):
        """71 decoded header bits -> ((mode, call), status), emitting the
        reference's stderr lines in its order: "oper mode" as soon as the
        mode validates, before the call sign check (decode.cc:422-446)."""
        md = 0
        for i in range(55):
            md |= int(data[i]) << i
        cs = 0
        for i in range(16):
            cs |= int(data[55 + i]) << i
        if B.crc16.over_value(md << 9, 64) != cs:
            return None, "header CRC error."
        oper_mode = md & 255
        if oper_mode not in MODES:
            return None, f"operation mode {oper_mode} unsupported."
        emit(f"oper mode: {oper_mode}")
        call = md >> 8
        if call == 0 or call >= MAX_CALL_SIGN:
            return None, "call sign unsupported."
        emit(f"call sign: {B.base37_decode(call).lstrip()}")
        return (oper_mode, call), "ok"

    def decode_headers_batch(self, x, cands) -> list:
        """Demod, OSD and CRC-16 for every hypothesis of every candidate
        in one batch (the header stage of decode-all; decode.cc:398-446
        over all detected preambles).

        ``x``: an analytic recording (complex [T] or [T, 2] float) or an
        ``ingest.PcmRecording``, whose header windows then run the front
        end on the device.  Returns a list aligned with ``cands`` of
        (header, status): header is (oper_mode, call) or None, status
        the reference's text ("OSD error.", "header CRC error.", ...) or
        "past recording end" for a window leaving the recording.  A
        candidate commits its first validating hypothesis (accept());
        one whose hypotheses all fail reports its best-ranked one's
        status.  Each pair carries in ``lines`` the transcript lines of
        the hypothesis it reports (:class:`_Header`)."""
        cfg = self.cfg
        s, g = cfg.symbol_len, cfg.guard_len
        if not cands:
            return []
        x = self.sync.recording(x)
        hyps = []          # (cand index, alt, window inside, start)
        for i, c in enumerate(cands):
            for alt in c.alts or ((c.conv, c.p0, c.cfo_rad,
                                   c.peak_ratio),):
                lo = alt[1] + s + g
                inside = lo >= 0 and lo + s <= x.shape[0]
                hyps.append((i, alt, inside, lo if inside else 0))
        dev = self.device
        blocks = []
        for h0 in range(0, len(hyps), HEADER_BATCH):
            part = hyps[h0: h0 + HEADER_BATCH]
            starts = torch.tensor([h[3] for h in part])
            with wait("decoder.upload"):
                cfos = torch.tensor([h[1][2] if h[2] else 0.0
                                     for h in part],
                                    dtype=torch.float32, device=dev)
            with wait("decoder.upload"):
                convs = torch.tensor([h[1][0] if h[2] else 0 for h in part],
                                     device=dev)
            wins = self.sync.windows(x, starts, s)
            data, unique = osd_decode(self._header_soft(wins, cfos, convs))
            blocks.append(torch.cat([unique[:, None].to(torch.uint8), data],
                                    dim=1))
        with wait("decoder.fetch"):
            host = torch.cat(blocks).cpu().numpy()   # one copy
        out: list = [None] * len(cands)
        for j, (i, alt, inside, _lo) in enumerate(hyps):
            if out[i] is not None and out[i][0] is not None:
                continue                    # already committed
            lines: list[str] = []
            if not inside:
                res = (None, "past recording end")
            elif not host[j, 0]:
                res = (None, "OSD error.")   # decode.cc:417-418
            else:
                res = self._validate_header(host[j, 1:], lines.append)
            res = _Header(*res, lines)
            if res[0] is not None:
                cands[i].accept(alt)
                out[i] = res
            elif out[i] is None:
                out[i] = res    # the best-ranked hypothesis's failure
        return out

    # ------------------------------------------------------------------
    # payload stage (decode.cc:453-555)
    # ------------------------------------------------------------------
    def pipeline(self, oper_mode: int) -> BatchPipeline:
        """The mode's payload pipeline (this decoder's list size, kernel
        and Theil-Sen estimator), built at first use."""
        pipe = self._pipes.get(oper_mode)
        if pipe is None:
            pipe = self._pipes[oper_mode] = BatchPipeline(
                self.rate, oper_mode, self.list_size,
                scl_exact=self.scl_exact, estimator=self.estimator,
                device=self.device)
        return pipe

    def _decode_payload(self, x: torch.Tensor, cand: SyncCandidate,
                        oper_mode: int):
        """Demod, list decode and select one frame through the mode's
        pipeline, a batch of one: a dict of payload (None when no path
        passes its CRC-32), flips, snr, sfo_ppm and cfo_hz, or None when
        the frame runs past the recording."""
        pipe = self.pipeline(oper_mode)
        cfg = pipe.cfg
        s, g = cfg.symbol_len, cfg.guard_len
        dev = self.device
        with span("decoder.demod"):
            q0 = cand.p0 + 2 * (s + g)              # pilot symbol start
            if q0 < 0 or q0 + cfg.mode.cons_rows * (s + g) + s > x.shape[0]:
                return None
            with wait("decoder.upload"):
                p0 = torch.tensor([cand.p0], device=dev)
            with wait("decoder.upload"):
                cfo = torch.tensor([cand.cfo_rad], dtype=torch.float32,
                                   device=dev)
            full, snr, slope, yint = pipe.demod_at(x[None], p0, cfo)
        with span("decoder.list"):
            gate = torch.ones(1, dtype=torch.bool, device=dev)
            res = pipe._fec_select(dict(llrs=full, p0=p0, cfo_rad=cfo,
                                        snr=snr, sync_gate=gate,
                                        multiframe=~gate))
            block, snr_cols, nb = pipe.pack(res)
            fit = torch.stack([slope, yint], dim=1).view(torch.int32)
            with wait("decoder.fetch"):          # one copy
                host = torch.cat([block, fit], dim=1).cpu()
        got = pipe.unpack((host[:, :-2], snr_cols, nb))
        slope, yint = host[0, -2:].view(torch.float32)
        cfo_fine = cand.cfo_rad + float(yint) / (s + g)
        ok = bool(got["ok"][0])
        return dict(payload=pipe.payload_bytes(got, 0) if ok else None,
                    flips=int(got["flips"][0]), snr=got["snr"][0],
                    sfo_ppm=float(-slope * s / (s + g) / (2 * np.pi) * 1e6),
                    cfo_hz=cfo_fine * self.rate / (2 * np.pi))

    def frontend(self, samples, channels: int = 1) -> torch.Tensor:
        """Recording samples -> complex64 analytic recording [T] on the
        decoder's device (:func:`dsp.frontend`)."""
        cfg = self.cfg
        return dsp.frontend(samples, channels, 2 * cfg.extended_len,
                            cfg.filter_len, self.device)

    # ------------------------------------------------------------------
    # public API (decode.cc:559-620 semantics)
    # ------------------------------------------------------------------
    def decode(self, samples, channels: int = 1, skip: int = 0,
               log=None) -> DecodeResult:
        """samples: [T] real mono, or complex [T] / [T, 2] analytic.

        ``skip``: frames with a valid header to pass over before the one
        decoded.  ``log``: optional text stream; the decoder then writes
        the reference binary's stderr transcript line for line (sync
        position and coarse CFO decode.cc:400-401, header statuses
        :417-446, demod dots :463-478, sfo/cfo :502-503, Es/N0 :506-523,
        bit flips :555).
        """
        emit = ((lambda m: print(m, file=log, flush=True))
                if log is not None else (lambda m: None))
        with span("decoder.decode"):
            with span("decoder.frontend"):
                x = self.frontend(samples, channels)
            with span("decoder.scan"):
                cands = self.sync.scan(x)
            result = DecodeResult(ok=False, status="no preamble found")
            for cand in cands:
                if not cand.ok:
                    continue
                with span("decoder.header"):
                    got = self.decode_headers_batch(x, [cand])[0]
                hdr, status = got
                if status == "past recording end":     # decode-all's text
                    status = "header window out of range"
                emit(f"symbol pos: {cand.p0}")
                emit(f"coarse cfo: "
                     f"{cand.cfo_rad * self.rate / (2 * np.pi):.6g} Hz ")
                for line in got.lines:
                    emit(line)
                result.status = status
                if hdr is None:
                    emit(status)
                    result.status_emitted = log is not None
                    continue
                if skip > 0:
                    skip -= 1
                    result.status = "ran out of frames while skipping"
                    result.status_emitted = False
                    continue
                oper_mode, call = hdr
                result.oper_mode = oper_mode
                result.call_sign = B.base37_decode(call).lstrip()
                result.symbol_pos = cand.p0
                result.cfo_hz = cand.cfo_rad * self.rate / (2 * np.pi)
                rows = MODES[oper_mode].cons_rows
                pay = self._decode_payload(x, cand, oper_mode)
                emit("demod " + "." * rows + " done")
                if pay is not None:
                    # the reference prints these ahead of the decode outcome
                    # (decode.cc:502-523 before :543)
                    emit(f"coarse sfo: {pay['sfo_ppm']:.6g} ppm")
                    emit(f"finer cfo: {pay['cfo_hz']:.6g} Hz ")
                    emit("Es/N0 (dB): "
                         + " ".join(f"{v:.6g}" for v in pay["snr"]))
                if pay is None or pay["payload"] is None:
                    result.status = "payload decoding error."
                    emit(result.status)
                    result.status_emitted = log is not None
                    if pay is not None:
                        result.snr_db = pay["snr"]
                        result.sfo_ppm = pay["sfo_ppm"]
                        result.cfo_hz = pay["cfo_hz"]
                    return result
                emit(f"bit flips: {pay['flips']}")
                result.ok = True
                result.payload = pay["payload"]
                result.bit_flips = pay["flips"]
                result.snr_db = pay["snr"]
                result.sfo_ppm = pay["sfo_ppm"]
                result.cfo_hz = pay["cfo_hz"]
                result.status = "ok"
                return result
            return result


@functools.lru_cache(maxsize=None)
def cached_decoder(rate: int, list_size: int = 8,
                   mls_convention: str = "galois",
                   device: str = "cuda") -> Decoder:
    return Decoder(rate, list_size, mls_convention=mls_convention,
                   device=device)
