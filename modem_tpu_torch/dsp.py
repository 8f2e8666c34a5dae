"""Decoder front-end DSP: DC blocking and the Hilbert analytic signal.

Counterpart of ``modem_tpu/dsp.py`` (reference: DSP::BlockDC and
DSP::Hilbert at decode.cc:192-193, 298-299): a mono recording passes
through a DC-blocking high-pass and an FIR Hilbert transformer to become
the complex analytic signal the synchroniser reads.  Whole-recording
tensor ops (the reference streams sample by sample).

The Hilbert filter is a type-III odd-length FIR of ``filter_len`` taps
(decode.cc:172): the ideal response h[m] = 2 / (pi m) for odd m under a
Blackman window, with a matching (taps - 1) / 2 sample delay on the real
path.  The window is the JAX package's default; it touches only the mono
path's sensitivity, not the wire format.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .profiling import upload, wait
from .sync import as_recording, window_sum


def block_dc(x: torch.Tensor, window: int) -> torch.Tensor:
    """x - causal sliding mean over ``window`` samples (decode.cc:386),
    with the drift-free window sum of :func:`sync.window_sum`."""
    s = window_sum(x.to(torch.float32), window)
    cnt = torch.arange(1, x.shape[-1] + 1, device=x.device).clamp(max=window)
    return x - s / cnt


@functools.lru_cache(maxsize=None)
def hilbert_taps(taps: int) -> np.ndarray:
    """Blackman-windowed ideal Hilbert response, f32 [taps]."""
    m = np.arange(taps) - (taps - 1) // 2
    h = np.zeros(taps)
    odd = m % 2 != 0
    h[odd] = 2.0 / (np.pi * m[odd])
    return (h * np.blackman(taps)).astype(np.float32)


def analytic(x: torch.Tensor, taps: int) -> torch.Tensor:
    """Real [T] -> complex64 analytic [T]: the real part delayed by the
    filter's group delay, the imaginary part im[n] = sum_k h[k] x[n-k]
    (zeros before the recording), as a product of the sliding windows
    with the reversed taps in f32 (no convolution library, whose f32
    path may run in TF32)."""
    with wait("frontend.taps"):
        h = torch.from_numpy(hilbert_taps(taps)).to(x.device)
    d = (taps - 1) // 2
    xp = torch.cat([x.new_zeros(taps - 1), x])
    im = xp.unfold(0, taps, 1) @ h.flip(0)
    re = torch.cat([x.new_zeros(d), x])[: x.shape[0]]
    return torch.complex(re, im)


def frontend(samples, channels: int, dc_window: int, taps: int,
             device="cuda") -> torch.Tensor:
    """Recording samples -> complex64 analytic recording [T] on
    ``device`` (decode.cc:294-301).  Real samples with channels == 1: DC
    block, then Hilbert, of [T] (or the first column of [T, C]);
    otherwise the I/Q pair [T, 2], or a complex [T], passes through."""
    with upload("frontend.upload", samples, device):
        x = torch.as_tensor(samples, device=device)
    if channels == 1 and not x.is_complex():
        if x.dim() == 2:
            x = x[:, 0]
        return analytic(block_dc(x.to(torch.float32), dc_window), taps)
    return as_recording(x, device)
