"""Encode path: payload bytes -> OFDM waveforms on one device.

Counterpart of ``modem_tpu/encoder.py`` (reference: Encoder,
encode.cc:27-318).  :meth:`Encoder.encode` builds one continuous
transmission [pilot | {S&C | meta | pilot | payload rows} per payload |
flush] (encode.cc:288-313); :meth:`Encoder.encode_batch` makes every
payload its own single-frame recording, the shape a batched serving
decoder consumes.  A frame's symbols synthesise in one batched IFFT pass
(ofdm.synthesize).  The time-differential PSK accumulation across
payload rows (encode.cc:304-308) is a cumulative sum of phases over the
row axis, exact for unit-modulus PSK factors.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import bits as B
from . import ofdm, psk
from .fec import bch
from .fec.polar import PolarCode
from .numerology import MLS2_POLY, ModemConfig
from .state import build_state


def _fold(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sums over axis 1, added strictly left to
    right (torch.cumsum accumulates in another precision)."""
    out = x.clone()
    for i in range(1, x.shape[1]):
        out[:, i] += out[:, i - 1]
    return out


def blocked_cumsum(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """f32 cumulative sum over axis 1 of [B, N, C], in the order of the
    JAX package's ``jnp.cumsum`` on CPU: XLA rewrites the cumulative sum
    into left-to-right sums within blocks of 16, plus the scanned block
    totals.  Summing in the same order keeps the port's accumulated
    phases bit-equal to the reference encoder's, and so its waveform
    inside the pinned fingerprint's tolerance."""
    batch, n, cols = x.shape
    nb = -(-n // block)
    padded = torch.nn.functional.pad(x, (0, 0, 0, nb * block - n))
    inner = _fold(padded.reshape(batch * nb, block, cols)).reshape(
        batch, nb, block, cols)
    if nb > 1:
        totals = inner[:, :, -1]
        scanned = (blocked_cumsum(totals, block) if nb > block
                   else _fold(totals))
        inner[:, 1:] += scanned[:, :-1, None]
    return inner.reshape(batch, nb * block, cols)[:, :n]


def encoder_spectra(cfg: ModemConfig) -> dict:
    """The encoder's constant spectra as numpy arrays, built as the JAX
    Encoder builds them: pilot block (encode.cc:132-141), Schmidl-Cox
    preamble (encode.cc:142-154) and the MLS1 header scrambler
    (encode.cc:165-177)."""
    mode = cfg.mode
    n = cfg.symbol_len
    conv = cfg.mls_convention
    code_fac = float(np.sqrt(n / mode.cons_cols))
    pilot = np.zeros(n, dtype=np.complex64)
    cols_bins = ofdm.bin_index(
        np.arange(cfg.code_off, cfg.code_off + mode.cons_cols), n)
    pilot[cols_bins] = code_fac * B.mls_nrz(MLS2_POLY, mode.cons_cols,
                                            convention=conv)
    mls0_fac = np.sqrt(2.0 * n / cfg.mls0_len)
    sc = np.zeros(n, dtype=np.complex64)
    sc[ofdm.bin_index(cfg.mls0_off - 2, n)] = mls0_fac
    seq0 = B.mls_nrz(cfg.mls0_poly, cfg.mls0_len, convention=conv)
    even_bins = ofdm.bin_index(2 * np.arange(cfg.mls0_len) + cfg.mls0_off, n)
    # cumulative differential over the even bins, seeded by the
    # reference-amplitude carrier two bins below
    sc[even_bins] = mls0_fac * np.cumprod(seq0)
    mls1 = B.mls_nrz(cfg.mls1_poly, cfg.mls1_len, convention=conv)
    return dict(pilot_fdom=pilot, sc_fdom=sc, mls1_seq=mls1)


class Encoder:
    """Per-config constants on ``device``; :meth:`encode` and
    :meth:`encode_batch` encode.

    ``state``: a :class:`state.PipelineState` holding ``frozen``,
    ``pilot_fdom``, ``sc_fdom`` and ``mls1_seq`` (default:
    :func:`state.build_state`).
    """

    def __init__(self, cfg: ModemConfig, device="cuda", state=None):
        cfg.validate()
        if cfg.mls_convention == "auto":
            raise ValueError("mls_convention='auto' is receive-only; "
                             "a transmitter must commit to one")
        self.cfg = cfg
        self.device = torch.device(device)
        mode = cfg.mode
        n = cfg.symbol_len
        if state is None:
            state = build_state(cfg, self.device)
        self.code = PolarCode(n=mode.cons_bits, k=mode.crc_bits,
                              order=mode.code_order,
                              frozen=state.frozen.cpu().numpy())
        self.code_fac = float(np.sqrt(n / mode.cons_cols))
        self.cols_bins = torch.as_tensor(ofdm.bin_index(
            np.arange(cfg.code_off, cfg.code_off + mode.cons_cols), n),
            device=self.device)
        self.pilot_fdom = state.pilot_fdom.to(self.device)
        self.sc_fdom = state.sc_fdom.to(self.device)
        # pilot carrier phases: 0 or pi (the +/-1 MLS2 signs)
        self.pilot_phase = torch.where(
            self.pilot_fdom[self.cols_bins].real > 0, 0.0, math.pi)
        self.mls1_seq = state.mls1_seq.cpu().numpy().astype(np.float64)
        self.mls1_fac = float(np.sqrt(n / cfg.mls1_len))

    def meta_fdom(self, call_sign: int) -> np.ndarray:
        """Metadata symbol spectrum (encode.cc:155-179), host numpy."""
        cfg = self.cfg
        md = (call_sign << 8) | cfg.mode.oper_mode
        hdr = np.array([(md >> i) & 1 for i in range(55)], dtype=np.uint8)
        cs = B.crc16.over_value(md << 9, 64)
        cs_bits = np.array([(cs >> i) & 1 for i in range(16)],
                           dtype=np.uint8)
        data71 = np.concatenate([hdr, cs_bits])
        nrz = B.nrz(np.concatenate([data71, bch.encode(data71)])).astype(
            np.float64)
        # differential encode seeded by the reference-amplitude carrier
        # at mls1_off - 1, then MLS1 scrambling (encode.cc:169-177)
        diff = self.mls1_fac * np.cumprod(nrz)
        fdom = np.zeros(cfg.symbol_len, dtype=np.complex64)
        fdom[ofdm.bin_index(cfg.mls1_off - 1, cfg.symbol_len)] = \
            self.mls1_fac
        bins = ofdm.bin_index(np.arange(cfg.mls1_len) + cfg.mls1_off,
                              cfg.symbol_len)
        fdom[bins] = diff * self.mls1_seq
        return fdom

    def mesg_bits(self, payload: bytes) -> np.ndarray:
        """Payload framing (encode.cc:293-301): payload bits, CRC-32,
        and the shortened tail pinned to 0."""
        mode = self.cfg.mode
        if len(payload) != mode.data_bytes:
            raise ValueError(f"payload of {len(payload)} bytes, mode "
                             f"takes {mode.data_bytes}")
        crc = B.crc32.over_bytes(payload)
        mesg = np.zeros(mode.mesg_bits, dtype=np.uint8)
        mesg[: mode.data_bits] = B.bytes_to_bits_le(payload)
        mesg[mode.data_bits: mode.crc_bits] = [(crc >> i) & 1
                                               for i in range(32)]
        return mesg

    def _frame_rows(self, mesg: torch.Tensor, meta: torch.Tensor):
        """mesg [B, mesg_bits] uint8, meta [B, N] complex -> symbol
        spectra [B, frame_symbols, N] of one frame per row."""
        cfg = self.cfg
        mode = cfg.mode
        batch = mesg.shape[0]
        n = cfg.symbol_len
        short = self.code.shorten(self.code.encode_systematic(mesg))
        grouped = short.reshape(batch, mode.cons_rows, mode.cons_cols,
                                mode.mod_bits)
        theta = psk.mod_phase(mode.mod_bits,
                              1.0 - 2.0 * grouped.to(torch.float32))
        # time-differential accumulation seeded by the pilot
        # (encode.cc:304-308), exact in the phase domain
        phase = self.pilot_phase + blocked_cumsum(theta)
        carriers = torch.complex(self.code_fac * torch.cos(phase),
                                 self.code_fac * torch.sin(phase))
        rows = torch.zeros(batch, mode.cons_rows, n, dtype=torch.complex64,
                           device=mesg.device)
        rows[:, :, self.cols_bins] = carriers
        return torch.cat([self.sc_fdom.expand(batch, 1, n), meta[:, None],
                          self.pilot_fdom.expand(batch, 1, n), rows], dim=1)

    def _encode_traced(self, mesg: torch.Tensor, meta: torch.Tensor):
        """[pilot | frame | flush] per row -> (waveforms [B, T] complex64,
        papr [B, n_sym, 2])."""
        rows = self._frame_rows(mesg, meta)
        batch, _, n = rows.shape
        fdom = torch.cat([self.pilot_fdom.expand(batch, 1, n), rows,
                          rows.new_zeros(batch, 1, n)], dim=1)
        papr_mask = np.ones(fdom.shape[1], dtype=bool)
        papr_mask[1] = False                   # the S&C symbol (encode.cc:153)
        return ofdm.synthesize(fdom, self.cfg.guard_len, papr_mask)

    # frames synthesised together by encode(): bounds the device memory of
    # the 4x-oversampled PAPR pass whatever the number of payloads
    ENCODE_CHUNK_FRAMES = 8

    def encode(self, payloads, call_sign: int, scramble: bool = True):
        """Payloads -> one continuous transmission: (complex64 waveform
        [T] as numpy, papr [n_sym, 2] as numpy).

        ``payloads``: bytes (one frame) or a list of bytes.  The waveform
        is the leading pilot, the frames and the flush symbol; the 1 s
        silence pads of a WAV file are the writer's (encode.cc:423,441).
        Frames synthesise ENCODE_CHUNK_FRAMES at a time with the guard
        crossfade's head carried between chunks, so the samples do not
        depend on the chunking."""
        if isinstance(payloads, (bytes, bytearray)):
            payloads = [bytes(payloads)]
        if scramble:
            payloads = [B.scramble(p) for p in payloads]
        cfg = self.cfg
        n, g = cfg.symbol_len, cfg.guard_len
        mesg = torch.as_tensor(np.stack([self.mesg_bits(p) for p in payloads]),
                               device=self.device)
        meta = torch.as_tensor(self.meta_fdom(call_sign), device=self.device)
        wave, papr, head = ofdm.synthesize_carry(self.pilot_fdom[None], g)
        waves, paprs = [wave], [papr]
        step = self.ENCODE_CHUNK_FRAMES
        for f0 in range(0, len(payloads), step):
            part = mesg[f0: f0 + step]
            rows = self._frame_rows(part, meta.expand(len(part), -1))
            papr_mask = np.ones(rows.shape[0] * rows.shape[1], dtype=bool)
            papr_mask[::cfg.frame_symbols] = False   # the S&C symbols
            wave, papr, head = ofdm.synthesize_carry(
                rows.reshape(-1, n), g, papr_mask, head)
            waves.append(wave)
            paprs.append(papr)
        wave, papr, _ = ofdm.synthesize_carry(               # flush symbol
            self.pilot_fdom.new_zeros(1, n), g, None, head)
        waves.append(wave)
        paprs.append(papr)
        return (torch.cat(waves).cpu().numpy(),
                torch.cat(paprs).cpu().numpy())

    def encode_batch(self, payloads, call_sign: int, scramble: bool = True,
                     pcm_bits: int = 0):
        """Batch of independent single-frame recordings.

        Returns (waveforms, papr [B, n_sym, 2] f32) on the encoder's
        device: complex64 [B, T] with ``pcm_bits=0``, or with
        ``pcm_bits=16`` int16 [B, T, 2] (I, Q) quantised there as the
        WAV writer quantises (round half to even, clip).  The 1 s silence
        pads of a WAV file are the caller's."""
        if pcm_bits not in (0, 16):
            raise ValueError(f"pcm_bits must be 0 or 16, got {pcm_bits}")
        if scramble:
            payloads = [B.scramble(p) for p in payloads]
        mesg = torch.as_tensor(np.stack([self.mesg_bits(p) for p in payloads]),
                               device=self.device)
        meta = torch.as_tensor(self.meta_fdom(call_sign),
                               device=self.device)
        wave, papr = self._encode_traced(mesg, meta.expand(len(payloads), -1))
        if pcm_bits == 16:
            iq = torch.stack([wave.real, wave.imag], dim=-1)
            wave = torch.clamp(torch.round(iq * 32767.0), -32768,
                               32767).to(torch.int16)
        return wave, papr


@functools.lru_cache(maxsize=None)
def cached_encoder(cfg: ModemConfig, device: str = "cuda") -> Encoder:
    return Encoder(cfg, device=device)
