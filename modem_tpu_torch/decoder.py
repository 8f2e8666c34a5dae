"""Interactive decode: one recording -> the payload of its first frame.

Counterpart of ``modem_tpu/decoder.py`` (reference: the Decoder of
decode.cc:161-557 and its command line, decode.cc:559-620).  The stages
run as tensor passes over the whole recording on the decoder's device,
orchestrated from the host:

  1. front end (:func:`dsp.frontend`): DC block and Hilbert for a mono
     recording, I/Q passthrough otherwise;
  2. sync (:meth:`sync.Synchronizer.scan`): the chunked Schmidl-Cox scan
     with the reference's gates -> candidates in time order;
  3. header, per candidate: CFO mixdown, FFT of the metadata symbol, MLS1
     descramble, bin-differential soft bits, order-4 OSD
     (:func:`fec.osd.osd_decode`), CRC-16 -> mode and call sign; or for
     every candidate at once (:meth:`Decoder.decode_headers_batch`, the
     header stage of ``pipeline.decode_recording_auto``);
  4. payload: per-row FFT demod with the continuous CFO phase,
     differential constellation, all-pairs Theil-Sen derotation,
     cumulative-SNR soft demap, lengthening;
  5. list decode (:func:`kernels.scl_decode.scl_decode`: kernel B, or
     kernel C with ``scl_exact=False``; the numpy oracle with
     ``device_scl=False``), then the CRC-32 select in path-metric
     order, the bit-flip count and the descramble.

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
from .fec.polar import PolarCode
from .fec.schedule import Schedule
from .fec.scl_np import scl_decode_np
from .kernels.sc_decode import ScPlan
from .kernels.scl_decode import LIST_SIZES, scl_decode
from .numerology import MAX_CALL_SIGN, MODES, SUPPORTED_RATES, ModemConfig
from .profiling import span, wait
from .state import build_state
from .sync import SyncCandidate, Synchronizer

# hypotheses per OSD call of decode_headers_batch: the OSD's scores take
# ~100 MB a block, and its 255-step elimination costs per call
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


def _rx_config(rate: int, oper_mode: int) -> ModemConfig:
    """Receiver-side config: offset-free carrier layout."""
    return ModemConfig(rate=rate, mode=MODES[oper_mode], freq_off=0)


@dataclasses.dataclass
class _Payload:
    """Per-mode receive tables on the decoder's device."""

    cfg: ModemConfig
    code: PolarCode
    plan: ScPlan
    crc_mat: torch.Tensor       # f32 [crc_bits, 32]
    bins: torch.Tensor          # payload carrier bins [cols]
    crc_idx: torch.Tensor       # codeword positions of the crc_bits


class Decoder:
    """Per-rate interactive decoder on one device.

    ``list_size``: 2, 4 or 8 for the device list decoder (any with
    ``device_scl=False``).  ``scl_exact``: the exact list decoder
    (kernel B, default) or the Fast-SSC-List one (kernel C).
    ``device_scl``: "auto" or True decodes on the device, False with the
    numpy bit-by-bit oracle (minutes at wire size).  ``estimator``: the
    Theil-Sen variant, the reference's exact "all_pairs" by default.
    ``mls_convention``: "galois", "fibonacci", "msb", or "auto" to accept
    any of them (see the module note)."""

    def __init__(self, rate: int, list_size: int = 8, device_scl="auto",
                 scl_exact: bool = True, estimator: str = "all_pairs",
                 mls_convention: str = "galois", device="cuda"):
        if rate not in SUPPORTED_RATES:
            raise ValueError(f"unsupported sample rate {rate}")
        if device_scl == "auto":
            device_scl = True
        if device_scl and list_size not in LIST_SIZES:
            raise NotImplementedError(
                f"the device list decoder takes list_size {LIST_SIZES}")
        if estimator not in track.ESTIMATORS:
            raise ValueError(f"unknown Theil-Sen estimator {estimator!r}")
        self.rate = rate
        self.list_size = list_size
        self.scl_exact = scl_exact
        self.device_scl = device_scl
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
        self._payload: dict[int, _Payload] = {}

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

    def _decode_header(self, x: torch.Tensor, cand: SyncCandidate,
                       emit=lambda s: None):
        """Demodulate, OSD-decode and validate the metadata symbol of one
        candidate: ((mode, call) or None, status).  Walks the candidate's
        convention hypotheses (one for a committed convention) and
        commits the first whose header validates (cand.accept); a
        candidate none of whose hypotheses validates reports, and emits
        the lines of, its best-ranked one, as a single-kernel receiver
        would (decode.cc:417-446)."""
        cfg = self.cfg
        s, g = cfg.symbol_len, cfg.guard_len
        alts = cand.alts or ((cand.conv, cand.p0, cand.cfo_rad,
                              cand.peak_ratio),)
        first = None
        for alt in alts:
            conv, p0, cfo_rad, _ratio = alt
            pend: list[str] = []
            if p0 + s + g < 0 or p0 + 2 * s + g > x.shape[0]:
                fail = (None, "header window out of range")
            else:
                lo = p0 + s + g
                with wait("decoder.upload"):
                    cfo_t = torch.tensor([cfo_rad], dtype=torch.float32,
                                         device=x.device)
                with wait("decoder.upload"):
                    conv_t = torch.tensor([conv], device=x.device)
                soft = self._header_soft(x[None, lo: lo + s], cfo_t, conv_t)
                data, unique = osd_decode(soft)
                with wait("decoder.fetch"):
                    host = torch.cat([unique.to(torch.uint8),
                                      data[0]]).cpu().numpy()
                if not host[0]:
                    fail = (None, "OSD error.")
                else:
                    hdr, status = self._validate_header(host[1:],
                                                        pend.append)
                    if hdr is not None:
                        cand.accept(alt)
                        for line in pend:
                            emit(line)
                        return hdr, status
                    fail = (None, status)
            if first is None:
                first = (fail, pend)
        fail, pend = first
        for line in pend:
            emit(line)
        return fail

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
        status."""
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
            if not inside:
                res = (None, "past recording end")
            elif not host[j, 0]:
                res = (None, "OSD error.")   # decode.cc:417-418
            else:
                res = self._validate_header(host[j, 1:])
            if res[0] is not None:
                cands[i].accept(alt)
                out[i] = res
            elif out[i] is None:
                out[i] = res    # the best-ranked hypothesis's failure
        return out

    # ------------------------------------------------------------------
    # payload stage (decode.cc:453-529)
    # ------------------------------------------------------------------
    def _tables(self, oper_mode: int) -> _Payload:
        tab = self._payload.get(oper_mode)
        if tab is None:
            cfg = _rx_config(self.rate, oper_mode)
            mode = cfg.mode
            state = build_state(cfg, self.device)
            code = PolarCode(n=mode.cons_bits, k=mode.crc_bits,
                             order=mode.code_order,
                             frozen=state.frozen.cpu().numpy())
            plan = ScPlan(Schedule.from_table(state.schedule.cpu().numpy(),
                                              code.code_len))
            code_off = -mode.cons_cols // 2
            bins = ofdm.bin_index(
                np.arange(code_off, code_off + mode.cons_cols),
                cfg.symbol_len)
            tab = _Payload(
                cfg=cfg, code=code, plan=plan,
                crc_mat=state.crc_matrix.to(self.device),
                bins=torch.as_tensor(bins, device=self.device),
                crc_idx=torch.as_tensor(code.info_idx[: mode.crc_bits],
                                        device=self.device))
            self._payload[oper_mode] = tab
        return tab

    def _demod(self, x: torch.Tensor, cand: SyncCandidate, oper_mode: int):
        """Payload rows of one frame -> (lengthened LLRs [1, code_len] f32,
        snr [rows], slope, yint), or None when the frame runs past the
        recording."""
        tab = self._tables(oper_mode)
        cfg, mode = tab.cfg, tab.cfg.mode
        s, g = cfg.symbol_len, cfg.guard_len
        rows = mode.cons_rows
        q0 = cand.p0 + 2 * (s + g)              # pilot symbol start
        if q0 < 0 or q0 + rows * (s + g) + s > x.shape[0]:
            return None
        # pilot + rows windows (decode.cc:456-470), cut by a reshape
        flat = x[q0: q0 + (rows + 1) * (s + g)]
        if flat.shape[0] < (rows + 1) * (s + g):
            flat = torch.nn.functional.pad(
                flat, (0, (rows + 1) * (s + g) - flat.shape[0]))
        windows = flat.reshape(rows + 1, s + g)[:, :s]
        dev = x.device
        w = torch.arange(rows + 1, dtype=torch.float32, device=dev)[:, None]
        k = torch.arange(s, dtype=torch.float32, device=dev)[None, :]
        with wait("decoder.upload"):
            cfo = torch.tensor(cand.cfo_rad, dtype=torch.float32,
                               device=dev)
        # the oscillator phase continues from the metadata symbol
        # (advanced S there), through every guard (decode.cc:458-470)
        phase = -cfo * (s + w * (s + g) + k)
        spec = fft.fwd(windows * torch.complex(torch.cos(phase),
                                               torch.sin(phase)))
        carriers = spec[:, tab.bins]
        cons = ofdm.demod_or_erase(carriers[1:], carriers[:-1])
        cons, slope, yint = track.derotate_rows(
            cons, -mode.cons_cols // 2, mode.mod_bits, self.estimator)
        llrs, snr = track.soft_llrs(cons, mode.mod_bits)
        full = tab.code.lengthen(llrs.reshape(1, -1)).contiguous()
        return full, snr, slope, yint

    def _list_select(self, full: torch.Tensor, oper_mode: int):
        """List-decode the lengthened LLRs [1, code_len] and take the
        first path in path-metric order (stable) whose CRC-32 passes
        (decode.cc:530-555).  Returns (payload bytes, bit flips), or
        (None, None) when no path passes."""
        tab = self._tables(oper_mode)
        mode = tab.cfg.mode
        if self.device_scl:
            cands, pm = scl_decode(full, tab.plan, self.list_size,
                                   self.scl_exact)
            order = torch.argsort(pm[0], stable=True)
            cands = cands[0, order]
        else:
            got, _pm = scl_decode_np(full[0].cpu().numpy().astype(np.float64),
                                     tab.code.frozen, self.list_size)
            cands = torch.as_tensor(got, device=full.device)
        info = cands[:, tab.crc_idx]                     # [L, crc_bits]
        # the CRC is linear with init 0: crc(bits) = bits @ M mod 2 (the
        # sums, at most crc_bits terms of 0/1, are exact in f32)
        rem = torch.remainder(info.to(torch.float32) @ tab.crc_mat, 2.0)
        with wait("decoder.fetch"):
            passing = (rem.sum(dim=1) == 0).cpu().numpy()
        if not passing.any():
            return None, None
        mesg = info[int(np.argmax(passing)), : mode.data_bits]
        received = full[0, tab.crc_idx[: mode.data_bits]] < 0
        with wait("decoder.fetch"):
            flips = int((received != mesg.bool()).sum())
        with wait("decoder.fetch"):
            mesg = mesg.cpu().numpy()
        payload = B.scramble(B.bits_to_bytes_le(mesg))
        return payload, flips

    def _decode_payload(self, x: torch.Tensor, cand: SyncCandidate,
                        oper_mode: int):
        """Demod, list decode and select one frame: a dict of payload
        (None on failure), flips, snr, sfo_ppm and cfo_hz, or None when
        the frame runs past the recording."""
        with span("decoder.demod"):
            got = self._demod(x, cand, oper_mode)
        if got is None:
            return None
        full, snr, slope, yint = got
        cfg = self._tables(oper_mode).cfg
        s, g = cfg.symbol_len, cfg.guard_len
        with span("decoder.list"):
            payload, flips = self._list_select(full, oper_mode)
        with wait("decoder.fetch"):
            sfo_ppm = float(-slope * s / (s + g) / (2 * np.pi) * 1e6)
        with wait("decoder.fetch"):
            cfo_fine = cand.cfo_rad + float(yint) / (s + g)
        with wait("decoder.fetch"):
            snr = snr.cpu().numpy()
        return dict(payload=payload, flips=flips, snr=snr, sfo_ppm=sfo_ppm,
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
                pend: list[str] = []
                with span("decoder.header"):
                    hdr, status = self._decode_header(x, cand, pend.append)
                emit(f"symbol pos: {cand.p0}")
                emit(f"coarse cfo: "
                     f"{cand.cfo_rad * self.rate / (2 * np.pi):.6g} Hz ")
                for line in pend:
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
