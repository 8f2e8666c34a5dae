"""The transmitter, plain PyTorch on any device: payload bits -> one
single-frame OFDM recording a row (encode.cc:27-318).

A frozen copy of the wire format's encoder for the benchmark's input
makers: the frame is [pilot | Schmidl-Cox | metadata | pilot | payload
rows | flush], each symbol PAPR-clipped by a 4x oversampled clip and
refilter (the Schmidl-Cox symbol excepted), the guards a raised-cosine
crossfade.  Payload rows are 8PSK or QPSK, time-differential against the
pilot.  Every row may carry its own call sign.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import modem as M

RCP_SQRT_2 = 0.70710678118654752440
COS_PI_8 = 0.92387953251128675613
SIN_PI_8 = 0.38268343236508977173


def polar_transform(u: torch.Tensor) -> torch.Tensor:
    """x = u F^{(x)m} over GF(2), u [..., N] uint8."""
    x = u.clone()
    n = x.shape[-1]
    lead = x.shape[:-1]
    for s in range(n.bit_length() - 1):
        v = x.view(*lead, 1 << s, 2, n >> (s + 1))
        v[..., 0, :] ^= v[..., 1, :]
    return x


def psk_phase(mod_bits: int, nrz_bits: torch.Tensor) -> torch.Tensor:
    """Phase of the PSK symbol of +/-1 bit groups [..., mod_bits]
    (psk.hh: QPSK Gray, 8PSK in the axis-swap layout)."""
    if mod_bits == 2:
        re, im = RCP_SQRT_2 * nrz_bits[..., 0], RCP_SQRT_2 * nrz_bits[..., 1]
    else:
        swap = nrz_bits[..., 0] < 0
        re = torch.where(swap, SIN_PI_8, COS_PI_8) * nrz_bits[..., 1]
        im = torch.where(swap, COS_PI_8, SIN_PI_8) * nrz_bits[..., 2]
    return torch.atan2(im, re)


def fwd(x):
    return torch.fft.fft(x, dim=-1, norm="backward")


def bwd(x):
    return torch.fft.ifft(x, dim=-1, norm="forward")


def improve_papr(fdom: torch.Tensor) -> torch.Tensor:
    """4x-oversampled clip of |re| and |im| to 1 and refilter, keeping
    only the occupied bins (encode.cc:80-100)."""
    n = fdom.shape[-1]
    zeros = fdom.new_zeros(fdom.shape[:-1] + (3 * n,))
    t4 = bwd(torch.cat([fdom[..., : n // 2], zeros, fdom[..., n // 2:]],
                       dim=-1)) / math.sqrt(4.0 * n)
    amp = torch.maximum(t4.real.abs(), t4.imag.abs())
    t4 = torch.where(amp > 1.0, t4 / amp.clamp(min=1.0), t4)
    spec = fwd(t4) / math.sqrt(4.0 * n)
    out = torch.cat([spec[..., : n // 2], spec[..., 3 * n + n // 2:]], -1)
    return torch.where(fdom.abs() > 0, out, torch.zeros_like(out))


def synthesize(fdom: torch.Tensor, guard_len: int, papr_mask) -> torch.Tensor:
    """Spectra [B, n_sym, N] -> waveform [B, n_sym * (G + N)]."""
    n = fdom.shape[-1]
    mask = torch.as_tensor(papr_mask, device=fdom.device)[:, None]
    tdom = bwd(torch.where(mask, improve_papr(fdom), fdom)) / math.sqrt(8.0 * n)
    x = torch.arange(guard_len, device=fdom.device) / (guard_len - 1)
    w = 0.5 * (1.0 - torch.cos(math.pi * x))
    heads, tails = tdom[..., :guard_len], tdom[..., n - guard_len:]
    prev = torch.cat([torch.zeros_like(heads[:, :1]), heads[:, :-1]], dim=1)
    wave = torch.cat([prev * (1.0 - w) + tails * w, tdom], dim=-1)
    return wave.reshape(wave.shape[0], -1)


class Encoder:
    """One configuration's constant spectra on ``device``."""

    def __init__(self, cfg: M.Config, device):
        self.cfg = cfg
        self.device = torch.device(device)
        mode = cfg.mode
        n = cfg.symbol_len
        self.code = M.Code(mode)
        self.code_fac = math.sqrt(n / mode.cons_cols)
        cols = M.bin_index(np.arange(cfg.code_off,
                                     cfg.code_off + mode.cons_cols), n)
        pilot = np.zeros(n, np.complex64)
        pilot[cols] = self.code_fac * M.nrz(M.mls_bits(M.MLS2_POLY,
                                                       mode.cons_cols))
        fac0 = math.sqrt(2.0 * n / M.MLS0_LEN)
        sc = np.zeros(n, np.complex64)
        sc[M.bin_index(cfg.mls0_off - 2, n)] = fac0
        sc[M.bin_index(2 * np.arange(M.MLS0_LEN) + cfg.mls0_off, n)] = (
            fac0 * np.cumprod(M.nrz(M.mls_bits(M.MLS0_POLY, M.MLS0_LEN))))
        self.cols = torch.as_tensor(cols, device=self.device)
        self.pilot = torch.as_tensor(pilot, device=self.device)
        self.sc = torch.as_tensor(sc, device=self.device)
        self.pilot_phase = torch.where(self.pilot[self.cols].real > 0, 0.0,
                                       math.pi)
        dev = self.device
        self.info_idx = torch.as_tensor(self.code.info_idx, device=dev)
        self.kept_idx = torch.as_tensor(self.code.kept_idx, device=dev)
        self.info_mask = torch.as_tensor(1 - self.code.frozen, device=dev)
        self.crc32 = torch.as_tensor(
            M.crc_matrix(M.CRC32_POLY, 32, mode.data_bits),
            dtype=torch.float32, device=dev)

    def meta(self, calls: np.ndarray) -> torch.Tensor:
        """Metadata symbol spectra [B, N] of call signs [B] (base37
        ints): 55 header bits, CRC-16, BCH(255, 71), differential and
        MLS1-scrambled (encode.cc:155-179)."""
        cfg = self.cfg
        n = cfg.symbol_len
        md = (np.asarray(calls, np.int64) << 8) | cfg.mode.oper_mode
        hdr = (md[:, None] >> np.arange(55)) & 1
        shifted = np.concatenate([np.zeros((len(md), 9), np.int64), hdr,
                                  ], axis=1)            # md << 9, 64 bits
        cs = shifted @ _crc16_matrix() % 2
        data71 = np.concatenate([hdr, cs], axis=1)
        word = np.concatenate([data71, data71 @ _bch_matrix() % 2], axis=1)
        fac1 = math.sqrt(n / M.MLS1_LEN)
        diff = fac1 * np.cumprod(M.nrz(word), axis=1)
        fdom = np.zeros((len(md), n), np.complex64)
        fdom[:, M.bin_index(cfg.mls1_off - 1, n)] = fac1
        fdom[:, M.bin_index(np.arange(M.MLS1_LEN) + cfg.mls1_off, n)] = (
            diff * M.nrz(M.mls_bits(M.MLS1_POLY, M.MLS1_LEN)))
        return torch.as_tensor(fdom, device=self.device)

    def encode(self, data_bits: torch.Tensor, calls: np.ndarray
               ) -> torch.Tensor:
        """Scrambled payload bits [B, data_bits] uint8 on the device, call
        signs [B] -> complex128-free waveforms [B, T] complex64: leading
        pilot, the frame, the flush symbol."""
        cfg = self.cfg
        mode = cfg.mode
        batch = data_bits.shape[0]
        n = cfg.symbol_len
        dev = self.device
        crc = (data_bits.to(torch.float32) @ self.crc32).remainder(2.0)
        mesg = torch.zeros(batch, mode.mesg_bits, dtype=torch.uint8,
                           device=dev)
        mesg[:, : mode.data_bits] = data_bits
        mesg[:, mode.data_bits: mode.crc_bits] = crc.to(torch.uint8)
        u = torch.zeros(batch, mode.code_len, dtype=torch.uint8, device=dev)
        u[:, self.info_idx] = mesg
        x = polar_transform(polar_transform(u) * self.info_mask)
        short = x[:, self.kept_idx].reshape(batch, mode.cons_rows,
                                            mode.cons_cols, mode.mod_bits)
        theta = psk_phase(mode.mod_bits, 1.0 - 2.0 * short.to(torch.float64))
        phase = self.pilot_phase.double() + torch.cumsum(theta, dim=1)
        rows = torch.zeros(batch, mode.cons_rows, n, dtype=torch.complex64,
                           device=dev)
        rows[:, :, self.cols] = torch.polar(
            torch.full_like(phase, self.code_fac), phase).to(torch.complex64)
        pil = self.pilot.expand(batch, 1, n)
        fdom = torch.cat([pil, self.sc.expand(batch, 1, n),
                          self.meta(calls)[:, None], pil, rows,
                          rows.new_zeros(batch, 1, n)], dim=1)
        papr_mask = np.ones(fdom.shape[1], dtype=bool)
        papr_mask[1] = False                    # the Schmidl-Cox symbol
        return synthesize(fdom, cfg.guard_len, papr_mask)


@functools.lru_cache(maxsize=None)
def _crc16_matrix() -> np.ndarray:
    return M.crc_matrix(M.CRC16_POLY, 16, 64).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _bch_matrix() -> np.ndarray:
    return np.stack([M.bch_parity(np.eye(71, dtype=np.uint8)[i])
                     for i in range(71)]).astype(np.int64)
