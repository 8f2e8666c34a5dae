"""The recording decoder, plain PyTorch and numpy: a whole mono 16-bit
recording -> every frame whose preamble passes the sync gates, as a
decoder of whole recordings reports them (decode.cc:161-557 at every
preamble; the payloads of each mode decoded as one batch).

  1. front end: dequantisation (x / 32767, as a WAV reader reads 16-bit
     PCM), then the DC block and Hilbert transformer of
     :func:`interactive.analytic` over the whole recording;
  2. scan: the full-rate timing metric, the Schmitt trigger's first
     4 x ``max_frames`` falling edges (:func:`interactive.schmitt_events`),
     the fine stage and its gates; the candidates that pass, in time
     order, at most ``max_frames``;
  3. header of each passing candidate (:meth:`Receiver.header`: OSD,
     CRC-16, mode and call sign); a candidate whose header fails is
     reported with mode None;
  4. payload: the frames of one mode cut as windows [p0 - (2s + g), p0 +
     frame_samples + g // 2) of the analytic recording, zero outside it,
     and decoded as one batch by :func:`decode.decode_batch` (its own
     sync inside each window, demod, SC, list-``list_size`` on the CRC-32
     failures).

``q`` rounds what each stage hands on (the bfloat16 control).
"""

from __future__ import annotations

import numpy as np
import torch

from . import modem as M
from .decode import decode_batch
from .frontend import FrontEnd, identity
from .interactive import Receiver, analytic


def frame_windows(x: torch.Tensor, cfg: M.Config, positions) -> torch.Tensor:
    """Windows [n, frame_samples + 2s + g // 2] of ``x`` before and over
    the frames whose S&C payload starts at ``positions``, zero outside."""
    s, g = cfg.symbol_len, cfg.guard_len
    w = cfg.frame_samples + 2 * s + g // 2
    starts = torch.as_tensor(positions, dtype=torch.int64,
                             device=x.device) - (2 * s + g)
    idx = starts[:, None] + torch.arange(w, device=x.device)
    inside = (idx >= 0) & (idx < x.shape[0])
    got = x[idx.clamp(0, x.shape[0] - 1)]
    return torch.where(inside, got, torch.zeros_like(got))


def decode_recording(pcm: np.ndarray, rate: int, list_size: int,
                     sync_stride: int, device, q=identity,
                     max_frames: int = 64) -> list:
    """Mono int16 samples [T] -> one dict a passing preamble, in time
    order: pos, mode (None where the header failed), call (int, 0 where
    it failed), ok, and where the payload was decoded bits, flips and
    snr [rows]."""
    x = torch.as_tensor(np.asarray(pcm), device=device).to(torch.float32)
    x = q(analytic(x / 32767.0, rate))
    rx = Receiver(rate, list_size, device)
    passing = [(p0, cfo) for ok, p0, cfo in rx.candidates(
        x, q, 4 * max_frames) if ok][:max_frames]
    frames = []
    for p0, cfo in passing:
        hdr = rx.header(x, p0, cfo, q)
        mode, call = hdr if hdr is not None else (None, 0)
        frames.append(dict(pos=int(p0), mode=mode, call=call, ok=False))
    for mode in sorted({f["mode"] for f in frames} - {None}):
        mine = [f for f in frames if f["mode"] == mode]
        cfg = M.Config(rate, M.MODES[mode], 0)
        got = decode_batch(FrontEnd(cfg, device, stride=sync_stride),
                           frame_windows(x, cfg, [f["pos"] for f in mine]),
                           list_size, q)
        for i, f in enumerate(mine):
            f.update(ok=bool(got["ok"][i]), bits=got["bits"][i],
                     flips=int(got["flips"][i]), snr=got["snr"][i])
    return frames
