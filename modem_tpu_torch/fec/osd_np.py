"""Serial numpy order-4 OSD: the correctness oracle for fec/osd.py.

Counterpart of ``modem_tpu/fec/osd_np.py``.  It mirrors
CODE::OrderedStatisticsDecoder<255,71,4> (osd.hh; used at
decode.cc:199,417) the way scl_np mirrors the list decoder: an
exhaustive enumeration of all sum(C(71,w), w<=4) = 972,198 error
patterns over the most reliable basis, scored by correlation
discrepancy in exact arithmetic (the soft inputs are integers), with the
reference's uniqueness rule: the decode is ``unique`` iff exactly one
candidate of weight <= 4 attains the minimum discrepancy (it "returns
false when the best two candidates tie").  tests/test_torch_host.py
holds it to the JAX original and the port's batched ``osd.osd_decode``
to it: pivot choice, the canonical split and tie handling all agree.
"""

from __future__ import annotations

import itertools

import numpy as np

from . import bch


def _rref_gf2_np(mat: np.ndarray, k: int):
    """Numpy twin of osd._rref_gf2: column scan most reliable first,
    pivot = first unused row with a 1; returns (reduced, pivots)."""
    m = mat.astype(np.uint8).copy()
    n = m.shape[1]
    rank = 0
    pivots = np.zeros(k, dtype=np.int64)
    for col in range(n):
        if rank >= k:
            break
        rows = np.nonzero(m[rank:, col])[0]
        if len(rows) == 0:
            continue
        pr = rank + rows[0]
        if pr != rank:
            m[[rank, pr]] = m[[pr, rank]]
        elim = m[:, col].copy()
        elim[rank] = 0
        m ^= elim[:, None] & m[rank][None, :]
        pivots[rank] = col
        rank += 1
    return m, pivots


def osd_decode_np(soft: np.ndarray, genmat: np.ndarray | None = None,
                  order: int = 4, chunk: int = 65536):
    """Exhaustive order-``order`` OSD of one [255] int8-ish soft block.

    Returns (data_bits [71] uint8, unique bool) with identical output
    conventions to fec.osd.osd_decode.
    """
    if genmat is None:
        genmat = bch.generator_matrix()
    k, n = genmat.shape
    soft = np.asarray(soft, dtype=np.float64)

    perm = np.argsort(-np.abs(soft), kind="stable")
    g_perm = genmat.astype(np.uint8)[:, perm]
    s = soft[perm]
    hard = (s < 0).astype(np.uint8)

    g_red, pivots = _rref_gf2_np(g_perm, k)
    c0 = (hard[pivots] @ g_red) % 2

    # flipping codeword bit i costs t[i] (signed toward the hard
    # decision of the BASE codeword)
    t = (1.0 - 2.0 * c0) * s

    best = 0.0                          # the empty pattern
    best_pat: tuple[int, ...] = ()
    n_best = 1
    # enumerate weights 1..order in index chunks; D(pattern) is the
    # dot of the XORed codeword-domain rows with t
    for w in range(1, order + 1):
        combos = itertools.combinations(range(k), w)
        while True:
            idx = np.array(list(itertools.islice(combos, chunk)),
                           dtype=np.int64)
            if idx.size == 0:
                break
            u = g_red[idx[:, 0]]
            for j in range(1, w):
                u = u ^ g_red[idx[:, j]]
            d = u.astype(np.float64) @ t
            mn = d.min()
            if mn < best:
                best = mn
                best_pat = tuple(idx[int(d.argmin())])
                n_best = int((d == mn).sum())
            elif mn == best:
                n_best += int((d == mn).sum())
    unique = n_best == 1
    c_best = c0.copy()
    for i in best_pat:
        c_best ^= g_red[i]
    inv = np.zeros(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    return c_best[inv][:k].astype(np.uint8), bool(unique)
