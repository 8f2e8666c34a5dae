"""The modem's wire format, host numpy: numerology, bit plumbing, the
polar code's frozen set and encoder geometry, and the SC decoder's row
schedule.

A frozen, plain copy kept under the benchmark so that the reference and
the input makers depend on nothing of the program under test.  The wire
format is aicodix/modem's (encode.cc, decode.cc); the schedule is the
Fast-SSC row table (RATE0 / REP / RATE1 / SPC leaves, at most CHUNK
columns a row) that both the reference's decoders and the roofline
counts walk.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# payload geometry and sequences (encode.cc:33-40)
DATA_BITS = 43040
CRC_BITS = DATA_BITS + 32
MLS0_LEN, MLS0_POLY = 127, 0b10001001
MLS1_LEN, MLS1_POLY = 255, 0b100101011
MLS2_POLY = 0b100101010001
CRC16_POLY, CRC32_POLY = 0xA8F4, 0xD419CC15


@dataclasses.dataclass(frozen=True)
class Mode:
    """One operating mode (encode.cc:199-266)."""

    oper_mode: int
    cons_cols: int
    mod_bits: int
    code_order: int
    cons_bits: int
    mesg_bits: int
    crc_bits: int
    data_bits: int

    @property
    def code_len(self) -> int:
        return 1 << self.code_order

    @property
    def cons_rows(self) -> int:
        return self.cons_bits // self.mod_bits // self.cons_cols

    @property
    def data_bytes(self) -> int:
        return self.data_bits // 8


def _wire(oper_mode, cols, mod_bits, cons_bits, mesg_bits) -> Mode:
    return Mode(oper_mode, cols, mod_bits, 16, cons_bits, mesg_bits,
                CRC_BITS, DATA_BITS)


MODES = {
    6: _wire(6, 432, 3, 64800, 43808), 7: _wire(7, 400, 3, 64800, 43808),
    8: _wire(8, 400, 2, 64800, 43808), 9: _wire(9, 360, 2, 64800, 43808),
    10: _wire(10, 512, 3, 64512, 44096), 11: _wire(11, 384, 3, 64512, 44096),
    12: _wire(12, 384, 2, 64512, 44096), 13: _wire(13, 256, 2, 64512, 44096),
}


def toy_mode(code_order: int, cons_cols: int, mod_bits: int, shorten: int,
             data_bits: int) -> Mode:
    """A reduced mode for CPU tests, with the wire format's relations."""
    cons_bits = (1 << code_order) - shorten
    return Mode(0, cons_cols, mod_bits, code_order, cons_bits,
                data_bits + 32 + shorten, data_bits + 32, data_bits)


@dataclasses.dataclass(frozen=True)
class Config:
    """Numerology of one (rate, mode) pair (encode.cc:31-32, 283-313)."""

    rate: int
    mode: Mode
    freq_off: int = 2000
    symbol_len_override: int | None = None

    @property
    def symbol_len(self) -> int:
        return self.symbol_len_override or (1280 * self.rate) // 8000

    @property
    def guard_len(self) -> int:
        return self.symbol_len // 8

    @property
    def extended_len(self) -> int:
        return self.symbol_len + self.guard_len

    @property
    def offset_bin(self) -> int:
        return (self.freq_off * self.symbol_len) // self.rate

    @property
    def code_off(self) -> int:
        return self.offset_bin - self.mode.cons_cols // 2

    @property
    def mls0_off(self) -> int:
        return self.offset_bin - MLS0_LEN + 1

    @property
    def mls1_off(self) -> int:
        return self.offset_bin - MLS1_LEN // 2

    @property
    def frame_symbols(self) -> int:
        return 3 + self.mode.cons_rows

    @property
    def frame_samples(self) -> int:
        return self.frame_symbols * self.extended_len


def config_of(spec: dict) -> Config:
    """A Config from a configuration file's ``modem`` block: rate, mode
    (a wire mode number, or a dict of toy_mode's arguments), freq_off,
    and optionally symbol_len (a toy numerology)."""
    mode = spec["mode"]
    mode = MODES[mode] if isinstance(mode, int) else toy_mode(**mode)
    return Config(spec["rate"], mode, spec.get("freq_off", 2000),
                  spec.get("symbol_len"))


def bin_index(carrier, n: int) -> np.ndarray:
    return (np.asarray(carrier) + n) % n


# -- bits (bitman.hh, xorshift.hh, crc.hh, mls.hh) ---------------------------

def nrz(bits) -> np.ndarray:
    return 1 - 2 * np.asarray(bits, dtype=np.int32)


@functools.lru_cache(maxsize=4)
def xorshift32_bytes(count: int) -> np.ndarray:
    """Low byte of each Marsaglia xorshift32 state, seed 2463534242."""
    out = np.empty(count, dtype=np.uint8)
    y = 2463534242
    for i in range(count):
        y ^= (y << 13) & 0xFFFFFFFF
        y ^= y >> 17
        y ^= (y << 5) & 0xFFFFFFFF
        out[i] = y & 0xFF
    return out


def scramble(data: np.ndarray) -> np.ndarray:
    """XOR payload bytes [..., n] with the xorshift32 keystream."""
    data = np.asarray(data, dtype=np.uint8)
    return data ^ xorshift32_bytes(data.shape[-1])


def crc_bits(poly: int, bits) -> int:
    """Reflected CRC, init 0, no final XOR, bits clocked LSB-first."""
    reg = 0
    for b in np.asarray(bits, dtype=np.uint8):
        reg = (reg >> 1) ^ (poly if (reg ^ int(b)) & 1 else 0)
    return reg


def crc_matrix(poly: int, width: int, nbits: int) -> np.ndarray:
    """[nbits, width] GF(2) matrix M with crc(bits) = bits @ M mod 2."""
    regs = np.empty(nbits, dtype=np.uint64)
    cur = poly
    for i in range(nbits - 1, -1, -1):
        regs[i] = cur
        cur = (cur >> 1) ^ (poly if cur & 1 else 0)
    return ((regs[:, None] >> np.arange(width, dtype=np.uint64)) & 1
            ).astype(np.uint8)


def mls_bits(poly: int, count: int) -> np.ndarray:
    """Galois LFSR m-sequence, seed 1, output the LSB before the shift."""
    deg = poly.bit_length() - 1
    mask = (1 << deg) - 1
    taps = (poly >> 1) & mask
    reg = 1
    out = np.empty(count, dtype=np.uint8)
    for i in range(count):
        bit = reg & 1
        out[i] = bit
        reg >>= 1
        if bit:
            reg ^= taps
    return out


# BCH(255, 71) of the metadata symbol (encode.cc:272-278)
BCH_MIN_POLYS = (
    0b100011101, 0b101110111, 0b111110011, 0b101101001,
    0b110111101, 0b111100111, 0b100101011, 0b111010111,
    0b000010011, 0b101100101, 0b110001011, 0b101100011,
    0b100011011, 0b100111111, 0b110001101, 0b100101101,
    0b101011111, 0b111111001, 0b111000011, 0b100111001,
    0b110101001, 0b000011111, 0b110000111, 0b110110001)


@functools.lru_cache(maxsize=None)
def _bch_generator() -> np.ndarray:
    g = np.array([1], dtype=np.uint8)
    for p in BCH_MIN_POLYS:
        g = np.convolve(g, [(p >> i) & 1 for i in range(p.bit_length())]) & 1
    return g.astype(np.uint8)[::-1]


def bch_parity(data71: np.ndarray) -> np.ndarray:
    """71 data bits -> 184 parity bits (systematic cyclic encoding)."""
    g = _bch_generator()
    reg = np.concatenate([np.asarray(data71, np.uint8),
                          np.zeros(184, np.uint8)])
    for i in range(71):
        if reg[i]:
            reg[i:i + 185] ^= g
    return reg[71:]


# -- the polar code (freezer.cc:14-39, encode.cc:180-186) ---------------------

@functools.lru_cache(maxsize=None)
def frozen_mask(n: int, k: int, order: int) -> np.ndarray:
    """BEC-polarisation frozen set, design SNR lifted 1.59175 dB; the
    mother code keeps k + 2**order - n information positions."""
    code_len = 1 << order
    erasure = np.longdouble(n - k) / np.longdouble(n)
    snr = 10.0 * np.log10(float(-np.log(erasure))) + 1.59175
    z = np.array([np.exp(np.longdouble(-(10.0 ** (snr / 10.0))))],
                 dtype=np.longdouble)
    for _ in range(order):
        z = np.stack([2 * z - z * z, z * z], axis=-1).reshape(-1)
    frozen = np.zeros(code_len, dtype=np.uint8)
    frozen[np.argsort(z, kind="stable")[k + code_len - n:]] = 1
    frozen.flags.writeable = False
    return frozen


@dataclasses.dataclass(frozen=True, eq=False)
class Code:
    """The shortened systematic polar code of one mode."""

    mode: Mode

    @functools.cached_property
    def frozen(self) -> np.ndarray:
        m = self.mode
        return frozen_mask(m.cons_bits, m.crc_bits, m.code_order)

    @functools.cached_property
    def info_idx(self) -> np.ndarray:
        return np.nonzero(self.frozen == 0)[0]

    @functools.cached_property
    def kept_idx(self) -> np.ndarray:
        """Transmitted positions: every frozen one and the first k
        information positions."""
        return np.union1d(np.nonzero(self.frozen)[0],
                          self.info_idx[: self.mode.crc_bits])

    @functools.cached_property
    def schedule(self) -> "Schedule":
        return build_schedule(self.frozen.tobytes())

    @functools.cached_property
    def crc_matrix(self) -> np.ndarray:
        return crc_matrix(CRC32_POLY, 32, self.mode.crc_bits)


# -- the Fast-SSC row schedule ----------------------------------------------

CHUNK = 512
OP_F, OP_G, OP_COMBINE, OP_RATE0, OP_REP, OP_RATE1, OP_SPC = range(7)
(C_OP, C_D, C_SRC, C_SRC2, C_DST, C_BSRC, C_BSRC2, C_BDST, C_SIDR,
 C_SIDR2, C_SIDW, C_WIDTH, C_LAST) = range(13)


@dataclasses.dataclass
class Schedule:
    ops: np.ndarray        # [n_ops, 13] int64
    sz_llr: int
    sz_beta: int
    n_depths: int
    code_len: int
    out_off: int


def _regions(n: int):
    depths = n.bit_length()
    lofs, pos = [], 0
    for d in range(depths):
        lofs.append(pos)
        pos += max(n >> d, CHUNK)
    sz_llr = pos
    bslot = np.zeros((depths, 2), dtype=np.int64)
    pos = 0
    for d in range(depths):
        alloc = max(n >> d, CHUNK)
        bslot[d] = (pos, pos + (alloc if d else 0))
        pos += 2 * alloc if d else alloc
    return lofs, bslot, sz_llr, pos


@functools.lru_cache(maxsize=None)
def build_schedule(frozen_key: bytes) -> Schedule:
    """The SC tree of a frozen mask pruned into RATE0 / REP / RATE1 / SPC
    leaves of at most CHUNK columns, as rows of at most CHUNK columns."""
    frozen = np.frombuffer(frozen_key, dtype=np.uint8)
    n = len(frozen)
    lofs, bslot, sz_llr, sz_beta = _regions(n)
    cols = dict(src=C_SRC, src2=C_SRC2, dst=C_DST, bsrc=C_BSRC,
                bsrc2=C_BSRC2, bdst=C_BDST, sidr=C_SIDR, sidr2=C_SIDR2,
                sidw=C_SIDW)
    ops = []

    def emit(op, d, w, **kw):
        chunks = max(1, -(-w // CHUNK))
        for j in range(chunks):
            row = [0] * 13
            row[C_OP], row[C_D] = op, d
            row[C_WIDTH] = min(CHUNK, w - j * CHUNK)
            row[C_LAST] = int(j == chunks - 1)
            for key, val in kw.items():
                row[cols[key]] = val + (0 if key.startswith("sid")
                                        else j * CHUNK)
            ops.append(row)

    def walk(lo, hi, d, side):
        w = hi - lo
        fz = frozen[lo:hi]
        s = int(fz.sum())
        own = int(bslot[d, side])
        if w <= CHUNK:
            leaf = (OP_RATE0 if s == w else OP_RATE1 if s == 0
                    else OP_REP if s == w - 1 and fz[-1] == 0
                    else OP_SPC if s == 1 and fz[0] == 1 else None)
            if leaf is not None:
                emit(leaf, d, w, src=lofs[d], bdst=own, sidw=2 * d + side)
                return
        h = w // 2
        emit(OP_F, d, h, src=lofs[d], src2=lofs[d] + h, dst=lofs[d + 1])
        walk(lo, lo + h, d + 1, 0)
        emit(OP_G, d, h, src=lofs[d], src2=lofs[d] + h, dst=lofs[d + 1],
             bsrc=int(bslot[d + 1, 0]), sidr=2 * (d + 1))
        walk(lo + h, hi, d + 1, 1)
        emit(OP_COMBINE, d, h, bsrc=int(bslot[d + 1, 0]),
             bsrc2=int(bslot[d + 1, 1]), bdst=own, dst=own + h,
             sidr=2 * (d + 1), sidr2=2 * (d + 1) + 1, sidw=2 * d + side)

    walk(0, n, 0, 0)
    return Schedule(np.array(ops, dtype=np.int64), sz_llr, sz_beta,
                    n.bit_length(), n, int(bslot[0, 0]))


_B37 = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def base37_text(value: int) -> str:
    """A call sign's base37 integer -> its text, leading spaces dropped."""
    chars = []
    for _ in range(9):
        chars.append(_B37[value % 37])
        value //= 37
    return "".join(reversed(chars)).lstrip()


def payload_bytes(bits: np.ndarray) -> bytes:
    """Decoded (scrambled) payload bits -> the payload bytes sent."""
    return scramble(np.packbits(np.asarray(bits, np.uint8),
                                bitorder="little")).tobytes()
