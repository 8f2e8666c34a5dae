"""Host-side bit plumbing: packing, scrambler, CRC, MLS, base37 (numpy).

Counterpart of ``modem_tpu/bits.py`` without its ctypes fast paths.
These primitives define the wire format (reference: bitman.hh,
xorshift.hh, crc.hh, mls.hh):

  * payload bits are little-endian within each byte (encode.cc:294,
    decode.cc:553);
  * CRCs are reflected (LSB-first), init 0, no final XOR
    (decode.cc:533-541 checks ``crc(data || crc) == 0``);
  * the byte scrambler is Marsaglia xorshift32 seeded 2463534242, low
    byte XORed onto the payload (encode.cc:417-419 == decode.cc:613-615).
"""

from __future__ import annotations

import functools

import numpy as np

from .numerology import CRC16_POLY, CRC32_POLY


def bytes_to_bits_le(data: bytes | np.ndarray) -> np.ndarray:
    """Bit i of the stream = bit (i % 8), LSB-first, of byte (i // 8)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    return np.unpackbits(arr, bitorder="little")


def bits_to_bytes_le(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, dtype=np.uint8),
                       bitorder="little").tobytes()


def nrz(bits: np.ndarray) -> np.ndarray:
    """bit 0 -> +1, bit 1 -> -1 (encode.cc:76-78)."""
    return (1 - 2 * np.asarray(bits, dtype=np.int32)).astype(np.int32)


XORSHIFT32_SEED = 2463534242


@functools.lru_cache(maxsize=8)
def xorshift32_bytes(count: int, seed: int = XORSHIFT32_SEED) -> np.ndarray:
    """Low byte of each successive Marsaglia xorshift32 state."""
    out = np.empty(count, dtype=np.uint8)
    y = seed & 0xFFFFFFFF
    for i in range(count):
        y ^= (y << 13) & 0xFFFFFFFF
        y ^= y >> 17
        y ^= (y << 5) & 0xFFFFFFFF
        out[i] = y & 0xFF
    out.flags.writeable = False
    return out


def scramble(data: bytes | np.ndarray) -> bytes:
    """XOR the payload with the xorshift32 keystream (self-inverse)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    return (arr ^ xorshift32_bytes(len(arr))).tobytes()


class Crc:
    """Bit-serial reflected CRC over an arbitrary-width register.

    ``poly`` is in the reference's (already reflected) notation: the
    register shifts right, feedback taps = poly when the outgoing LSB XOR
    the input bit is 1 (CODE::CRC at encode.cc:161, 296-299;
    decode.cc:429, 533-541).
    """

    def __init__(self, poly: int, width: int):
        self.poly = poly
        self.width = width
        self.mask = (1 << width) - 1
        table = np.empty(256, dtype=np.uint64)
        for byte in range(256):
            reg = byte
            for _ in range(8):
                reg = (reg >> 1) ^ (poly if reg & 1 else 0)
            table[byte] = reg
        self._table = table

    def update_bits(self, reg: int, bits: np.ndarray) -> int:
        for b in np.asarray(bits, dtype=np.uint8):
            reg = (reg >> 1) ^ (self.poly if (reg ^ int(b)) & 1 else 0)
        return reg & self.mask

    def update_bytes(self, reg: int, data: bytes | np.ndarray) -> int:
        for byte in np.frombuffer(bytes(data), dtype=np.uint8):
            reg = int(self._table[(reg ^ int(byte)) & 0xFF]) ^ (reg >> 8)
        return reg & self.mask

    def over_bytes(self, data: bytes | np.ndarray) -> int:
        return self.update_bytes(0, data)

    def over_value(self, value: int, nbits: int = 64) -> int:
        """Clock an integer in LSB-first (crc0(md << 9), encode.cc:161)."""
        bits = np.array([(value >> i) & 1 for i in range(nbits)],
                        dtype=np.uint8)
        return self.update_bits(0, bits)

    def check_matrix(self, nbits: int) -> np.ndarray:
        """[nbits, width] GF(2) matrix M with crc(bits) = bits @ M (mod 2).

        The CRC is linear over GF(2) with init 0: input bit i contributes
        the register of a unit impulse followed by (nbits - 1 - i) zero
        bits, built here from the last bit backwards.
        """
        regs = np.empty(nbits, dtype=np.uint64)
        cur = self.poly            # CRC of the single bit '1'
        for i in range(nbits - 1, -1, -1):
            regs[i] = cur
            cur = (cur >> 1) ^ (self.poly if cur & 1 else 0)
        shifts = np.arange(self.width, dtype=np.uint64)
        return ((regs[:, None] >> shifts[None, :]) & 1).astype(np.uint8)


crc16 = Crc(CRC16_POLY, 16)
crc32 = Crc(CRC32_POLY, 32)


def mls_bits(poly: int, count: int, seed: int = 1,
             convention: str = "galois") -> np.ndarray:
    """LFSR m-sequence over the primitive polynomial ``poly`` (bit i =
    coefficient of x^i), register seeded ``seed``, one bit per step.

    Only the "galois" convention (right-shift Galois, output = LSB
    before the shift, feedback XORs ``poly >> 1`` when the output bit is
    1) is carried by the port so far.
    """
    if convention != "galois":
        raise NotImplementedError(
            f"MLS convention {convention!r}: the port carries 'galois' only")
    deg = poly.bit_length() - 1
    mask = (1 << deg) - 1
    reg = seed & mask
    taps = (poly >> 1) & mask
    out = np.empty(count, dtype=np.uint8)
    for i in range(count):
        bit = reg & 1
        out[i] = bit
        reg >>= 1
        if bit:
            reg ^= taps
    return out


def mls_nrz(poly: int, count: int, seed: int = 1,
            convention: str = "galois") -> np.ndarray:
    return nrz(mls_bits(poly, count, seed, convention))


def base37_encode(text: str) -> int:
    """Callsign -> base37 integer (encode.cc:320-335); -1 if invalid."""
    acc = 0
    for c in text:
        acc *= 37
        if "0" <= c <= "9":
            acc += ord(c) - ord("0") + 1
        elif "a" <= c <= "z":
            acc += ord(c) - ord("a") + 11
        elif "A" <= c <= "Z":
            acc += ord(c) - ord("A") + 11
        elif c != " ":
            return -1
    return acc
