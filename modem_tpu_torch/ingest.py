"""PCM ingest: quantised WAV samples -> analytic signal on the device.

Counterpart of ``modem_tpu/ingest.py`` (reference: decode.cc:294-301,
which dequantises each sample on the host, then runs BlockDC and the
Hilbert filter for mono input).  A :class:`PcmRecording` keeps the
samples in their wire dtype (int16 or uint8); they go to the device once
(:meth:`PcmRecording.on`), and the dequantise, DC block and Hilbert
front end runs there chunk by chunk inside the synchroniser's scan
(``sync.Synchronizer.scan``) and on the header and frame windows, so no
whole-recording analytic array is made.

Chunk exactness: a chunk carries ``front_lead`` raw samples of left
context (at least dc_window + taps, rounded up to the scan's 512-sample
block), so every DC mean and Hilbert sum covers the same samples as a
pass over the whole recording, and the DC count is clamped against the
absolute recording index.  The host spec is
:meth:`PcmRecording.analytic_np`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import dsp
from .profiling import upload, wait
from .sync import _BLK, cut_span, gather_windows, window_sum


@dataclasses.dataclass(eq=False)
class PcmRecording:
    """Raw PCM samples in wire dtype (decode.cc:294-301 ingest).

    data: [T] mono or [T, 2] stereo, numpy or torch; int16 (bits=16) or
    uint8 (bits=8)."""

    data: np.ndarray | torch.Tensor
    bits: int
    rate: int

    def __post_init__(self):
        if self.bits not in (8, 16):
            raise ValueError(f"unsupported bit depth {self.bits}")
        want = {8: (np.uint8, torch.uint8), 16: (np.int16, torch.int16)}[
            self.bits]
        if self.data.dtype not in want:
            raise ValueError(f"bits={self.bits} requires dtype "
                             f"{want[0].__name__}, got {self.data.dtype}")
        self._device_copy: dict = {}

    def __getstate__(self):
        """Pickled without its device copies: a process sent the
        recording (a rank) makes its own."""
        return {**self.__dict__, "_device_copy": {}}

    @property
    def channels(self) -> int:
        return 1 if self.data.ndim == 1 else self.data.shape[1]

    @property
    def n_samples(self) -> int:
        return self.data.shape[0]

    @property
    def shape(self) -> tuple:
        """The samples' shape: [T] or [T, 2], T leading as for an
        analytic recording."""
        return tuple(self.data.shape)

    @property
    def fill(self) -> int:
        """Quantised silence: 128 for uint8, 0 for int16."""
        return 128 if self.bits == 8 else 0

    def on(self, device) -> torch.Tensor:
        """The samples as a wire-dtype tensor on ``device``, copied there
        once and kept (the recording is treated as immutable)."""
        device = torch.device(device)
        key = str(device)
        t = self._device_copy.get(key)
        if t is None:
            data = self.data
            if isinstance(data, np.ndarray):
                if not data.flags.writeable:
                    data = data.copy()
                data = torch.from_numpy(np.ascontiguousarray(data))
            with upload("ingest.upload", data, device):
                t = data.to(device)
            self._device_copy[key] = t
        return t

    def raw_windows(self, starts, length: int, device) -> torch.Tensor:
        """Wire-dtype windows [n, length] (or [n, length, 2]), window i
        covering samples [starts[i], starts[i] + length), quantised
        silence outside the recording, cut from the device copy."""
        with upload("sync.starts", starts, device):
            starts = torch.as_tensor(starts, dtype=torch.int64,
                                     device=device)
        return gather_windows(self.on(device), starts, length, self.fill)

    def segment(self, lo: int, length: int, device) -> torch.Tensor:
        """Wire-dtype samples [lo, lo + length), quantised silence
        outside the recording, sliced from the device copy with host ints
        (a view where the span lies inside the recording)."""
        return cut_span(self.on(device), lo, length, self.fill)

    def dequant_np(self) -> np.ndarray:
        """Host dequantisation (wav._dequantize semantics)."""
        data = np.asarray(self.data)
        if self.bits == 8:
            return (data.astype(np.float32) - 128.0) / 127.0
        return data.astype(np.float32) / 32767.0

    def analytic_np(self, dc_window: int, taps: int) -> np.ndarray:
        """Host-numpy spec front end -> [T, 2] f32 split-complex.

        Mono: dequantise, DC block (sliding mean, f64 accumulation), FIR
        Hilbert with a (taps-1)//2 real-path delay.  Stereo: dequantise."""
        x = self.dequant_np()
        if self.channels == 2:
            return np.ascontiguousarray(x)
        x = x.reshape(-1)
        c = np.cumsum(np.concatenate([[0.0], x]).astype(np.float64))
        n = x.shape[0]
        idx = np.arange(n)
        lo = np.maximum(idx - dc_window + 1, 0)
        cnt = np.minimum(idx + 1, dc_window)
        y = (x - (c[idx + 1] - c[lo]) / cnt).astype(np.float32)
        h = dsp.hilbert_taps(taps)
        d = (taps - 1) // 2
        yp = np.concatenate([np.zeros(taps - 1, np.float32), y])
        im = np.convolve(yp, h, mode="valid")[:n].astype(np.float32)
        re = np.concatenate([np.zeros(d, np.float32), y])[:n]
        return np.stack([re, im], axis=-1)


class StreamBuffer:
    """The samples of a stream received so far, on the host.

    Holds absolute samples [origin, end) in wire dtype (``bits`` 8 or 16;
    [n] mono or [n, 2] stereo) or, with ``bits=None``, as a complex64
    analytic signal [n].  It stands where a recording does for
    ``sync.Synchronizer`` (``windows``, the chunked scan) and the decode
    stages: ``shape[0]`` is the absolute end of what has been received,
    and each window is cut on the host and copied to the device alone,
    so the bytes copied grow with the windows, not with the buffer.
    Positions before 0 and from ``end`` on read as silence (quantised
    silence for PCM); positions in [0, origin) have been retired by
    :meth:`retire`, and reading them raises."""

    def __init__(self, bits: int | None, channels: int):
        if bits not in (None, 8, 16):
            raise ValueError(f"unsupported bit depth {bits}")
        self.bits = bits
        self.channels = channels
        if bits is None:
            self.data = np.zeros(0, np.complex64)
        else:
            dt = np.int16 if bits == 16 else np.uint8
            self.data = np.zeros((0,) if channels == 1 else (0, channels), dt)
        self.origin = 0

    @property
    def end(self) -> int:
        return self.origin + self.data.shape[0]

    @property
    def shape(self) -> tuple:
        return (self.end,) + self.data.shape[1:]

    @property
    def fill(self) -> int:
        """Silence: 128 for uint8, else 0."""
        return 128 if self.bits == 8 else 0

    def append(self, x: np.ndarray) -> None:
        self.data = np.concatenate([self.data, x.astype(self.data.dtype)])

    def retire(self, low: int) -> None:
        """Drop the samples before absolute index ``low``."""
        cut = low - self.origin
        if cut > 0:
            self.data = self.data[cut:].copy()
            self.origin += cut

    def raw_windows(self, starts, length: int, device) -> torch.Tensor:
        """Windows [n, length] (or [n, length, 2]) of absolute samples
        [starts[i], starts[i] + length), silence outside [0, end), as
        one tensor on ``device`` in the buffer's dtype."""
        starts = np.asarray(starts, dtype=np.int64).reshape(-1)
        out = np.full((len(starts), length) + self.data.shape[1:], self.fill,
                      self.data.dtype)
        for i, s0 in enumerate(starts.tolist()):
            a, b = max(s0, 0), min(s0 + length, self.end)
            if b <= a:
                continue
            if a < self.origin:
                raise RuntimeError(f"samples [{a}, {self.origin}) of the "
                                   "stream were retired")
            out[i, a - s0: b - s0] = self.data[a - self.origin: b - self.origin]
        with upload("stream.windows", out, device):
            return torch.from_numpy(out).to(device)

    def segment(self, lo: int, length: int, device) -> torch.Tensor:
        """Samples [lo, lo + length) as :meth:`raw_windows` gives one
        window: cut on the host and copied to ``device``."""
        return self.raw_windows([lo], length, device)[0]


def front_lead(dc_window: int, taps: int) -> int:
    """Raw left-context samples a mono chunk needs ahead of its first
    analytic output, rounded up to the 512-sample block so chunk starts
    keep their absolute block alignment."""
    return -(-(dc_window + taps) // _BLK) * _BLK


def dequant(raw: torch.Tensor, bits: int) -> torch.Tensor:
    """Dequantisation bit for bit as wav._dequantize: (x - 128) / 127
    for uint8, x / 32767 for int16, in f32."""
    if bits == 8:
        return (raw.to(torch.float32) - 128.0) / 127.0
    return raw.to(torch.float32) / 32767.0


@functools.lru_cache(maxsize=None)
def reversed_taps(taps: int, device: torch.device) -> torch.Tensor:
    """The Hilbert taps (dsp.hilbert_taps) reversed, f32 [taps] on
    ``device``: copied there once and kept."""
    with wait("frontend.taps"):
        h = torch.from_numpy(dsp.hilbert_taps(taps)).to(device)
    return h.flip(0)


def analytic_chunk(raw: torch.Tensor, abs0, lead: int, out_len: int,
                   bits: int, dc_window: int, taps: int) -> torch.Tensor:
    """Mono PCM chunks [..., N] -> complex64 analytic [..., out_len].

    Row r's first raw sample sits at absolute recording index abs0[r]
    (an int, or a tensor of the leading shape on raw's device; negative
    where the caller padded the span before the recording with
    quantised silence), and output j is absolute index abs0 + lead + j.
    ``lead`` must cover the DC window and the Hilbert taps
    (:func:`front_lead`).  The DC count clamps against the true
    recording start (the sliding mean over min(n + 1, dc_window)
    samples, decode.cc:386)."""
    x = dequant(raw, bits)
    s = window_sum(x, dc_window)
    n = x.shape[-1]
    if isinstance(abs0, torch.Tensor):
        absi = abs0[..., None] + torch.arange(n, device=raw.device)
    else:                               # no host value copied to the card
        absi = torch.arange(int(abs0), int(abs0) + n, device=raw.device)
    cnt = (absi + 1).clamp(1, dc_window).to(torch.float32)
    y = x - s / cnt
    h = reversed_taps(taps, raw.device)
    d = (taps - 1) // 2
    # im[n] = sum_k h[k] y[n - k] for n = lead + j
    span = y[..., lead - (taps - 1): lead + out_len]
    im = span.unfold(-1, taps, 1) @ h
    re = y[..., lead - d: lead - d + out_len]
    return torch.complex(re, im)
