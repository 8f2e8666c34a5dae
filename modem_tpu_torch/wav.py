"""WAV sample I/O on the host.

Counterpart of ``modem_tpu/wav.py`` (reference: DSP::ReadWAV/WriteWAV,
wav.hh; call sites encode.cc:422-441, decode.cc:576-581): RIFF PCM,
8-bit unsigned or 16-bit signed little-endian, 1 (real) or 2 (analytic
I/Q) channels.  Values are floats in [-1, 1]; complex samples write as
(real, imag) pairs with two channels and keep only the real part in
mono.  Regular files go through the native codec (``native.py``: file
IO, RIFF framing, quantisation in f32 with ties away from zero), as in
the JAX package; pipes and stdin stream through the numpy codec here
(:func:`_quantize` rounds in f64 with ties to even), which is also the
plain version of the native one.  :func:`read_wav_raw` keeps the samples
in wire dtype as an ``ingest.PcmRecording``, whose dequantisation and
front end run on the device.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from . import native


@dataclasses.dataclass
class WavData:
    rate: int
    channels: int
    bits: int
    samples: np.ndarray  # [frames, channels] float32 in [-1, 1]

    @property
    def analytic(self) -> np.ndarray:
        """Complex view: mono -> real signal, stereo -> I + jQ."""
        if self.channels == 1:
            return self.samples[:, 0].astype(np.complex64)
        return (self.samples[:, 0] + 1j * self.samples[:, 1]).astype(
            np.complex64)


def _quantize(samples: np.ndarray, bits: int) -> bytes:
    if bits == 8:
        q = np.clip(np.rint(samples * 127.0), -128, 127) + 128
        return q.astype(np.uint8).tobytes()
    if bits == 16:
        q = np.clip(np.rint(samples * 32767.0), -32768, 32767)
        return q.astype("<i2").tobytes()
    raise ValueError(f"unsupported bit depth {bits}")


def _dequantize(raw: bytes, bits: int) -> np.ndarray:
    if bits == 8:
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 127.0
    if bits == 16:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32767.0
    raise ValueError(f"unsupported bit depth {bits}")


def write_wav(path: str, samples: np.ndarray, rate: int, bits: int = 16,
              channels: int = 1) -> None:
    """samples: [frames] float or complex, or [frames, channels] float.

    A regular file (or a new path) is written by the native codec; what
    it refuses (a bit depth other than 8 and 16, a path it cannot open)
    and pipes go through the numpy writer, which raises as the JAX
    package's does."""
    samples = np.asarray(samples)
    if np.iscomplexobj(samples):
        pair = np.stack([samples.real, samples.imag], axis=-1)
        samples = pair[:, :channels] if channels <= 2 else pair
    if samples.ndim == 1:
        samples = samples[:, None]
    if samples.shape[1] < channels:
        samples = np.repeat(samples, channels, axis=1)
    samples = samples[:, :channels]
    if (not os.path.exists(path) or os.path.isfile(path)) and \
            native.wav_write(path, samples, rate, channels, bits):
        return
    payload = _quantize(samples.reshape(-1).astype(np.float64), bits)
    block = channels * bits // 8
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(payload), b"WAVE",
        b"fmt ", 16, 1, channels, rate, rate * block, block, bits,
        b"data", len(payload))
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(payload)


def _chunks(path: str):
    """(audio format, channels, rate, bits, data bytes) of a RIFF/WAVE
    file."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(blob):
        cid = blob[pos:pos + 4]
        size = struct.unpack("<I", blob[pos + 4:pos + 8])[0]
        body = blob[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError("missing fmt/data chunk")
    audio_fmt, channels, rate, _, _, bits = fmt
    if audio_fmt != 1:
        raise ValueError("only PCM WAV supported")
    return channels, rate, bits, data


def read_wav_raw(path: str):
    """Read a PCM WAV keeping the samples in wire dtype (int16 or
    uint8): an ``ingest.PcmRecording`` ([T] mono, [T, 2] stereo).  None
    for a path that is not a regular file, or a format the raw path does
    not cover (other bit depths or channel counts: use read_wav)."""
    if not os.path.isfile(path):
        return None
    from .ingest import PcmRecording
    channels, rate, bits, data = _chunks(path)
    if bits not in (8, 16) or channels not in (1, 2):
        return None
    dt = np.dtype("<i2") if bits == 16 else np.uint8
    flat = np.frombuffer(data, dtype=dt)
    frames = len(flat) // channels
    samples = flat[: frames * channels]
    if channels == 2:
        samples = samples.reshape(frames, 2)
    return PcmRecording(data=np.ascontiguousarray(samples), bits=bits,
                        rate=rate)


def read_wav(path: str) -> WavData:
    """A regular file is read by the native codec (which seeks); stdin
    and pipes, and files it does not parse, by the numpy parser, which
    raises on what it cannot read either."""
    got = native.wav_read(path) if os.path.isfile(path) else None
    if got is None:
        channels, rate, bits, data = _chunks(path)
        flat = _dequantize(data, bits)
    else:
        rate, channels, bits, flat = got
    frames = len(flat) // channels
    return WavData(rate=rate, channels=channels, bits=bits,
                   samples=flat[: frames * channels].reshape(frames,
                                                             channels))
