"""ctypes bindings of the native host runtime (csrc/modem_host.cc).

Counterpart of ``modem_tpu/native.py``, with its function names and
signatures.  The byte-level framing hot path runs in C++ as the
reference's host code does: ``bits.scramble`` and ``Crc.update_bytes``
call it, and ``wav.write_wav`` / ``wav.read_wav`` use its RIFF codec
(file IO and quantisation) on regular files.  The bit-packing entry
points mirror numpy's pack/unpackbits: nothing in the port calls them,
but they are the "bit packing twins" of the codec's public surface
(docs/API.md, "Sample I/O").  ``available()`` has no counterpart: the
port has no fallback for it to choose, so nothing asks.

The library is built with the host C++ compiler at first use into
``build/modem_tpu_torch/`` (``kernels/_build.load_host``).  Unlike the
JAX package, the port has no numpy fallback: where the library cannot
be built, every entry point raises ``RuntimeError`` with the compiler's
output.  The numpy bodies stay as the plain versions (``bits.scramble_np``,
``Crc.update_bytes_np``, ``wav._quantize``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .bits import XORSHIFT32_SEED
from .kernels import _build

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


@functools.cache
def library() -> ctypes.CDLL:
    """The built runtime with every signature declared (built at first
    use; RuntimeError if it cannot be)."""
    lib = _build.load_host("modem_host")
    lib.modem_scramble.argtypes = [_u8p, ctypes.c_int64, ctypes.c_uint32]
    lib.modem_scramble.restype = None
    lib.modem_crc_table.argtypes = [ctypes.c_uint32, _u32p]
    lib.modem_crc_table.restype = None
    lib.modem_crc_bytes.argtypes = [_u32p, _u8p, ctypes.c_int64,
                                    ctypes.c_uint32]
    lib.modem_crc_bytes.restype = ctypes.c_uint32
    for name in ("modem_bytes_to_bits_le", "modem_bits_to_bytes_le"):
        getattr(lib, name).argtypes = [_u8p, ctypes.c_int64, _u8p]
        getattr(lib, name).restype = None
    lib.modem_wav_info.argtypes = [ctypes.c_char_p, _i32p, _i32p, _i32p]
    lib.modem_wav_info.restype = ctypes.c_int64
    lib.modem_wav_read.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int64]
    lib.modem_wav_read.restype = ctypes.c_int64
    lib.modem_wav_write.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int64,
                                    ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_int32]
    lib.modem_wav_write.restype = ctypes.c_int64
    return lib


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)


def scramble(data: bytes, seed: int = XORSHIFT32_SEED) -> bytes:
    buf = np.frombuffer(bytes(data), dtype=np.uint8).copy()
    library().modem_scramble(_u8(buf), len(buf), seed)
    return buf.tobytes()


@functools.cache
def _crc_table(poly: int) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    library().modem_crc_table(poly, table.ctypes.data_as(_u32p))
    table.flags.writeable = False
    return table


def crc_bytes(poly: int, data: bytes, reg: int = 0) -> int:
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    return int(library().modem_crc_bytes(
        _crc_table(poly).ctypes.data_as(_u32p), _u8(buf), len(buf), reg))


def bytes_to_bits_le(data: bytes) -> np.ndarray:
    src = np.frombuffer(bytes(data), dtype=np.uint8)
    out = np.empty(8 * len(src), dtype=np.uint8)
    library().modem_bytes_to_bits_le(_u8(src), len(src), _u8(out))
    return out


def bits_to_bytes_le(bits: np.ndarray) -> bytes:
    src = np.ascontiguousarray(bits, dtype=np.uint8)
    out = np.zeros((len(src) + 7) // 8, dtype=np.uint8)
    library().modem_bits_to_bytes_le(_u8(src), len(src), _u8(out))
    return out.tobytes()


def wav_read(path: str):
    """Native RIFF read: (rate, channels, bits, flat f32 values), or None
    for a file the codec does not parse (not RIFF/WAVE PCM, or a bit
    depth other than 8 and 16)."""
    lib = library()
    rate, channels, bits = (ctypes.c_int32() for _ in range(3))
    n = lib.modem_wav_info(path.encode(), ctypes.byref(rate),
                           ctypes.byref(channels), ctypes.byref(bits))
    if n < 0:
        return None
    out = np.zeros(n, dtype=np.float32)
    if lib.modem_wav_read(path.encode(), out.ctypes.data_as(_f32p), n) != n:
        return None
    return rate.value, channels.value, bits.value, out


def wav_write(path: str, samples: np.ndarray, rate: int, channels: int,
              bits: int) -> bool:
    """Native RIFF write of flat interleaved values, quantised in f32;
    False where the codec refuses (a bit depth other than 8 and 16, a
    path it cannot open)."""
    flat = np.ascontiguousarray(samples, dtype=np.float32).reshape(-1)
    return library().modem_wav_write(
        path.encode(), flat.ctypes.data_as(_f32p), len(flat), rate,
        channels, bits) == 0
