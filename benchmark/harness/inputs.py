"""The one generator of the benchmark's traffic: recordings made from the
run's seed by the frozen encoder and channel under ``reference/``, as a
traffic mix's parameters say.

Parameters of a batch mix (``benchmark/traffic/<mix>.json``, a cell's
file may override any):

  * ``batch``: recordings a batch; ``pool``: distinct batches made in
    set-up and cycled through the window;
  * ``pad_s``: seconds of silence either side of each frame;
  * ``channel``: null for a clean recording, or the demonstration
    chain's settings ``{"awgn_db", "cfo_hz", "sfo_ppm", "spread"}``.

(``loop``, ``check_rows`` and ``trace_batches`` are the loop's: see
``harness.batch``; an interactive mix's, ``harness.interactive``.)
Each recording is quantised to 16-bit I/Q as a 2-channel WAV holds it
(round half to even, clip) and handed over as complex64 / 32767.  Every
recording carries its own payload and call sign.  Payloads,
call signs and noise come from generators on the device seeded from
``--seed``: the same seed gives the same recordings.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import channel as C
from reference import modem as M
from reference.encoder import Encoder

from .common import seed_for

ENCODE_ROWS = 64          # recordings encoded (and impaired) at a time


def pcm16(x: torch.Tensor) -> torch.Tensor:
    """Samples as 16-bit PCM holds them, scaled back to [-1, 1]."""
    return torch.clamp(torch.round(x * 32767.0), -32768, 32767) / 32767.0


def payload_bits(nbytes: int, batch: int, gen, device) -> torch.Tensor:
    """Scrambled payload bits [batch, 8 nbytes] uint8 of random payloads:
    the bits the decoder returns for them."""
    raw = torch.randint(0, 256, (batch, nbytes), generator=gen,
                        device=device, dtype=torch.uint8)
    key = torch.as_tensor(M.xorshift32_bytes(nbytes), device=device)
    byte = (raw ^ key).to(torch.int32)
    bits = (byte[..., None] >> torch.arange(8, device=device)) & 1
    return bits.reshape(batch, -1).to(torch.uint8)


def recordings(cfg: M.Config, params: dict, bits: torch.Tensor,
               calls: np.ndarray, gen) -> torch.Tensor:
    """One batch of single-frame recordings [B, T] complex64."""
    enc = Encoder(cfg, bits.device)
    pad = int(round(params["pad_s"] * cfg.rate))
    chan = params.get("channel")
    out = []
    for r0 in range(0, bits.shape[0], ENCODE_ROWS):
        wave = enc.encode(bits[r0: r0 + ENCODE_ROWS],
                          calls[r0: r0 + ENCODE_ROWS])
        wave = torch.nn.functional.pad(wave, (pad, pad))
        if chan:
            wave = C.chain(wave, cfg.rate, chan["awgn_db"], gen,
                           cfo_hz=chan["cfo_hz"], sfo_ppm=chan["sfo_ppm"],
                           spread=chan["spread"])
        out.append(torch.complex(pcm16(wave.real), pcm16(wave.imag)))
    return torch.cat(out)


def batch_pool(cfg: M.Config, params: dict, seed: int, device):
    """The pool of a batch mix: (recordings, one [B, T] complex64 tensor
    a batch on ``device``; the sent bits of each, uint8 [B, data_bits] on
    the host)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_for(seed, "inputs"))
    pool, sent = [], []
    for _ in range(params["pool"]):
        bits = payload_bits(cfg.mode.data_bytes, params["batch"], gen, device)
        calls = torch.randint(0, 37 ** 9, (params["batch"],), generator=gen,
                              device=device).cpu().numpy()
        pool.append(recordings(cfg, params, bits, calls, gen))
        sent.append(bits.cpu().numpy())
    return pool, sent
