"""OFDM numerology and operating-mode tables (numpy/dataclasses only).

Counterpart of ``modem_tpu/numerology.py`` (reference: encode.cc:31-40,
197-270; decode.cc:171-189, 302-374).  One :class:`ModemConfig` per
(rate, mode) pair; every tensor shape of the port derives from it.
Besides the eight wire-format modes (6..13) the tables carry reduced
"toy" numerologies for fast CPU tests (:func:`toy_mode`,
:func:`toy_config`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

SUPPORTED_RATES = (8000, 16000, 44100, 48000)

# Payload geometry (encode.cc:33-35): fixed for every wire-format mode.
DATA_BITS = 43040
DATA_BYTES = DATA_BITS // 8
CRC_BITS = DATA_BITS + 32

# Synchronisation / header sequences (encode.cc:36-40).
MLS0_LEN = 127
MLS0_POLY = 0b10001001          # x^7 + x^3 + 1
MLS1_LEN = 255
MLS1_POLY = 0b100101011         # x^8 + x^5 + x^3 + x + 1
MLS2_POLY = 0b100101010001      # pilot scrambler, 11-bit register

# CRC polynomials (encode.cc:272: crc0(0xA8F4), crc1(0xD419CC15)).
CRC16_POLY = 0xA8F4
CRC32_POLY = 0xD419CC15

# Callsign alphabet bound: base37^9 (encode.cc:358).
MAX_CALL_SIGN = 37 ** 9

# Occupied bandwidth per mode in Hz (encode.cc:364-387).
BANDWIDTH = {6: 2700, 7: 2500, 8: 2500, 9: 2250, 10: 3200, 11: 2400,
             12: 2400, 13: 1600}


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """One operating mode (rows of the table at encode.cc:199-266)."""

    oper_mode: int
    cons_cols: int       # payload carriers per OFDM symbol
    mod_bits: int        # 2 = QPSK, 3 = 8PSK
    code_order: int      # log2 of the mother polar code length
    cons_bits: int       # transmitted code bits after shortening
    mesg_bits: int       # info bits of the mother code (incl. shortened tail)
    crc_bits: int        # payload bits + CRC32 (first crc_bits info bits used)
    data_bits: int       # raw payload bits

    @property
    def code_len(self) -> int:
        return 1 << self.code_order

    @property
    def cons_cnt(self) -> int:
        return self.cons_bits // self.mod_bits

    @property
    def cons_rows(self) -> int:
        return self.cons_cnt // self.cons_cols

    @property
    def data_bytes(self) -> int:
        return self.data_bits // 8

    @property
    def frozen_key(self) -> Tuple[int, int]:
        """(shortened length N, payload+crc bits K) naming the frozen set."""
        return (self.cons_bits, self.crc_bits)


def _wire_mode(oper_mode: int, cons_cols: int, mod_bits: int,
               cons_bits: int, mesg_bits: int) -> ModeSpec:
    return ModeSpec(oper_mode=oper_mode, cons_cols=cons_cols,
                    mod_bits=mod_bits, code_order=16, cons_bits=cons_bits,
                    mesg_bits=mesg_bits, crc_bits=CRC_BITS,
                    data_bits=DATA_BITS)


# Mode table: encode.cc:199-266 == decode.cc:304-371.
MODES = {
    6:  _wire_mode(6, 432, 3, 64800, 43808),
    7:  _wire_mode(7, 400, 3, 64800, 43808),
    8:  _wire_mode(8, 400, 2, 64800, 43808),
    9:  _wire_mode(9, 360, 2, 64800, 43808),
    10: _wire_mode(10, 512, 3, 64512, 44096),
    11: _wire_mode(11, 384, 3, 64512, 44096),
    12: _wire_mode(12, 384, 2, 64512, 44096),
    13: _wire_mode(13, 256, 2, 64512, 44096),
}


@dataclasses.dataclass(frozen=True)
class ModemConfig:
    """Static numerology for one (sample rate, mode) pair."""

    rate: int
    mode: ModeSpec
    freq_off: int = 2000
    # Toy-numerology overrides (None => wire format).
    symbol_len_override: int | None = None
    mls0_len: int = MLS0_LEN
    mls0_poly: int = MLS0_POLY
    mls1_len: int = MLS1_LEN
    mls1_poly: int = MLS1_POLY
    # LFSR convention for MLS0/MLS1/MLS2 ("galois", "fibonacci", "msb";
    # "auto" detects it on receive): part of the wire format.  The
    # port's pipeline and encoder take "galois" so far.
    mls_convention: str = "galois"

    # -- OFDM numerology (encode.cc:31-32) ---------------------------------
    @property
    def symbol_len(self) -> int:
        if self.symbol_len_override is not None:
            return self.symbol_len_override
        return (1280 * self.rate) // 8000

    @property
    def guard_len(self) -> int:
        return self.symbol_len // 8

    @property
    def extended_len(self) -> int:
        return self.symbol_len + self.guard_len

    @property
    def filter_len(self) -> int:
        """Hilbert FIR length (decode.cc:172)."""
        return (((21 * self.rate) // 8000) & ~3) | 1

    # -- carrier placement (encode.cc:283-286) -----------------------------
    @property
    def offset_bin(self) -> int:
        return (self.freq_off * self.symbol_len) // self.rate

    @property
    def code_off(self) -> int:
        return self.offset_bin - self.mode.cons_cols // 2

    @property
    def mls0_off(self) -> int:
        return self.offset_bin - self.mls0_len + 1

    @property
    def mls1_off(self) -> int:
        return self.offset_bin - self.mls1_len // 2

    # -- frame geometry (encode.cc:288-313) --------------------------------
    @property
    def frame_symbols(self) -> int:
        """Symbols per frame: schmidl_cox + metadata + pilot + payload rows."""
        return 3 + self.mode.cons_rows

    @property
    def frame_samples(self) -> int:
        return self.frame_symbols * self.extended_len

    # -- decoder scan geometry (decode.cc:188-189) -------------------------
    @property
    def buffer_len(self) -> int:
        return 6 * self.extended_len

    @property
    def search_pos(self) -> int:
        return self.buffer_len - 4 * self.extended_len

    def validate(self, channels: int | None = None) -> None:
        """Wire-format validation in encode.cc's check order and texts:
        the band/mono condition first (encode.cc:389-392), then
        divisibility (encode.cc:394-397)."""
        if self.rate not in SUPPORTED_RATES:
            raise ValueError("Unsupported sample rate")  # encode.cc:438
        if self.mls_convention not in ("galois", "fibonacci", "msb",
                                       "auto"):
            raise ValueError(
                f"unknown MLS convention {self.mls_convention!r}")
        if (1280 * self.rate) % 8000:
            raise ValueError("symbol length must be integral")
        bw = BANDWIDTH.get(self.mode.oper_mode)
        if bw is not None:
            lo = bw // 2 - self.rate // 2
            hi = self.rate // 2 - bw // 2
            if ((channels == 1 and self.freq_off < bw // 2)
                    or self.freq_off < lo or self.freq_off > hi):
                # encode.cc:389
                raise ValueError("Unsupported frequency offset")
            if self.freq_off % 50:
                # encode.cc:394
                raise ValueError("Frequency offset must be divisible by 50")


def make_config(rate: int, oper_mode: int, freq_off: int = 2000,
                channels: int = 1) -> ModemConfig:
    """Build and validate a wire-format config (encode.cc CLI semantics)."""
    if oper_mode not in MODES:
        raise ValueError(f"unsupported operation mode {oper_mode}")
    cfg = ModemConfig(rate=rate, mode=MODES[oper_mode], freq_off=freq_off)
    cfg.validate(channels)
    return cfg


@functools.lru_cache(maxsize=None)
def toy_mode(code_order: int = 10, cons_cols: int = 32, mod_bits: int = 2,
             shorten: int = 64, data_bits: int = 448) -> ModeSpec:
    """A reduced mode for fast tests.

    Mirrors the wire-format relationships: mother code 2**code_order,
    shortened by `shorten` code bits, payload data_bits + CRC32 info bits,
    cons_bits divisible by mod_bits * cons_cols.
    """
    code_len = 1 << code_order
    cons_bits = code_len - shorten
    crc_bits = data_bits + 32
    mesg_bits = crc_bits + shorten
    if cons_bits % (mod_bits * cons_cols):
        raise ValueError("cons_bits must tile into rows of cons_cols symbols")
    if mesg_bits > code_len:
        raise ValueError("too many info bits")
    return ModeSpec(oper_mode=0, cons_cols=cons_cols, mod_bits=mod_bits,
                    code_order=code_order, cons_bits=cons_bits,
                    mesg_bits=mesg_bits, crc_bits=crc_bits,
                    data_bits=data_bits)


@functools.lru_cache(maxsize=None)
def toy_config() -> ModemConfig:
    """256-bin symbols, order-10 polar code, QPSK, 15 payload rows.

    Small enough for CPU tests; structurally the wire format (the real
    MLS preambles still fit in 256 bins).  Same numerology as
    ``modem_tpu.parallel.toy_config``.
    """
    mode = toy_mode(code_order=10, cons_cols=32, mod_bits=2,
                    shorten=64, data_bits=448)
    return ModemConfig(rate=8000, mode=mode, freq_off=0,
                       symbol_len_override=256)
