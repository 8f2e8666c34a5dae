"""BCH(255,71) systematic encoder and generator matrix for the 71-bit
metadata block, numpy.

Counterpart of ``modem_tpu/fec/bch.py`` (reference:
CODE::BoseChaudhuriHocquenghemEncoder<255,71> from 24 minimal
polynomials at encode.cc:272-278, and the systematic generator matrix of
the OSD header decoder, decode.cc:378-384).  Codeword layout on air:
bits 0..70 = data, 71..254 = parity (encode.cc:170-173).
"""

from __future__ import annotations

import functools

import numpy as np

# encode.cc:272-278 — minimal polynomials whose product is the degree-184
# generator of the (255, 71) BCH code.
MIN_POLYS = (
    0b100011101, 0b101110111, 0b111110011, 0b101101001,
    0b110111101, 0b111100111, 0b100101011, 0b111010111,
    0b000010011, 0b101100101, 0b110001011, 0b101100011,
    0b100011011, 0b100111111, 0b110001101, 0b100101101,
    0b101011111, 0b111111001, 0b111000011, 0b100111001,
    0b110101001, 0b000011111, 0b110000111, 0b110110001)

N, K = 255, 71


@functools.cache
def generator_poly() -> np.ndarray:
    """GF(2) product of the minimal polynomials, lowest degree first."""
    g = np.array([1], dtype=np.uint8)
    for p in MIN_POLYS:
        coeffs = np.array([(p >> i) & 1 for i in range(p.bit_length())],
                          dtype=np.uint8)
        g = np.convolve(g, coeffs) & 1
    if len(g) != N - K + 1:
        raise AssertionError(f"generator degree {len(g) - 1}")
    return g.astype(np.uint8)


def encode(data_bits: np.ndarray) -> np.ndarray:
    """71 data bits -> 184 parity bits (systematic cyclic encoding).

    Codeword bit i is the coefficient of x^(254-i); parity is the
    remainder of d(x) * x^184 modulo the generator.
    """
    data_bits = np.asarray(data_bits, dtype=np.uint8)
    if data_bits.shape[-1] != K:
        raise ValueError(f"expected {K} data bits, got {data_bits.shape}")
    g = generator_poly()[::-1]  # highest degree first
    reg = np.concatenate([data_bits, np.zeros(N - K, dtype=np.uint8)])
    for i in range(K):
        if reg[i]:
            reg[i:i + (N - K + 1)] ^= g
    return reg[K:]


@functools.cache
def generator_matrix() -> np.ndarray:
    """Systematic [K, N] generator matrix, row i = encode(unit_i)."""
    g = np.zeros((K, N), dtype=np.uint8)
    for i in range(K):
        u = np.zeros(K, dtype=np.uint8)
        u[i] = 1
        g[i, :K] = u
        g[i, K:] = encode(u)
    g.flags.writeable = False
    return g


def is_codeword(bits: np.ndarray) -> bool:
    """Divisibility of the codeword polynomial by the generator."""
    g = generator_poly()[::-1]
    reg = np.asarray(bits, dtype=np.uint8).copy()
    for i in range(K):
        if reg[i]:
            reg[i:i + (N - K + 1)] ^= g
    return not reg.any()
