"""Polar code construction (frozen-set design), numpy.

Counterpart of ``modem_tpu/fec/freezer.py`` (reference: freezer.cc:14-39
driving CODE::PolarCodeConst0<16>), with the same algorithm: the
binary-erasure-channel polarization recursion, where a
channel with erasure probability z splits into a degraded copy 2z - z^2
(even index) and an upgraded copy z^2 (odd index); the indices with the
largest erasure probability are frozen.  The design probability follows
freezer.cc:17-23: p_design = (N-K)/N lifted by a 1.59175 dB SNR margin.
"""

from __future__ import annotations

import functools

import numpy as np


def bec_erasure_profile(p: float, order: int) -> np.ndarray:
    """Erasure probability of every polarized channel, natural SC index."""
    z = np.array([p], dtype=np.longdouble)
    for _ in range(order):
        z = np.stack([2 * z - z * z, z * z], axis=-1).reshape(-1)
    return z


def design_probability(n: int, k: int) -> np.longdouble:
    """freezer.cc:17-23: design SNR + 1.59175 dB margin -> erasure prob."""
    erasure = np.longdouble(n - k) / np.longdouble(n)
    design_snr = 10.0 * np.log10(float(-np.log(erasure)))
    better_snr = design_snr + 1.59175
    return np.exp(np.longdouble(-(10.0 ** (better_snr / 10.0))))


@functools.lru_cache(maxsize=None)
def frozen_mask(n: int, k: int, order: int = 16) -> np.ndarray:
    """Frozen-bit mask (uint8[2**order], 1 = frozen, read-only) for the
    code shortened to ``n`` carrying ``k`` payload+crc bits; the mother
    code keeps k + 2**order - n information positions (freezer.cc:25)."""
    code_len = 1 << order
    k_info = k + code_len - n
    z = bec_erasure_profile(design_probability(n, k), order)
    best_first = np.argsort(z, kind="stable")
    frozen = np.zeros(code_len, dtype=np.uint8)
    frozen[best_first[k_info:]] = 1
    frozen.flags.writeable = False
    return frozen


def mask_to_words(mask: np.ndarray) -> np.ndarray:
    """Pack a frozen mask into uint32 words, bit i -> word i // 32 bit
    i % 32 (the layout of the reference's tables, encode.cc:184)."""
    return np.packbits(mask, bitorder="little").view(np.uint32)


def words_to_mask(words: np.ndarray) -> np.ndarray:
    """Inverse of :func:`mask_to_words`: uint8 bits [32 * len(words)]."""
    return np.unpackbits(np.asarray(words, dtype=np.uint32).view(np.uint8),
                         bitorder="little")


def cached_frozen_mask(n: int, k: int, order: int = 16) -> np.ndarray:
    """The JAX package's name for the mask it caches on disk, where its
    construction took seconds at order 16; here :func:`frozen_mask`
    takes ~15 ms at order 16 and is kept for the process."""
    return frozen_mask(n, k, order)
