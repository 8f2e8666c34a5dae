"""Reference successive-cancellation list (SCL) decoder in numpy.

Counterpart of ``modem_tpu/fec/scl_np.py``: host-side, exact
(leaf-by-leaf) min-sum SCL with LLR-based path metrics
(Balatsoukas-Stimming et al.), the bit-by-bit oracle of the list
kernels.  Semantics mirror CODE::PolarListDecoder (decode.cc:201,530):
min-sum f/g updates, fork at every information bit, prune to list size
by metric; the output is the re-encoded codeword per surviving path.

Conventions: LLR > 0 favours bit 0; bits are 0/1; path metric penalty is
|llr| whenever a decision disagrees with the LLR sign.  At the 2^16 wire
size it takes minutes: an oracle, on no decode path.
"""

from __future__ import annotations

import sys

import numpy as np


def _f(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """min-sum check-node update."""
    return np.sign(a) * np.sign(b) * np.minimum(np.abs(a), np.abs(b))


def _g(a: np.ndarray, b: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """variable-node update given left-child re-encoded bits."""
    return b + (1.0 - 2.0 * bits) * a


def _relu(x: np.ndarray) -> np.ndarray:
    return np.maximum(x, 0.0)


def scl_decode_np(llr: np.ndarray, frozen: np.ndarray, list_size: int = 8):
    """Decode one codeword.

    llr: [code_len] channel LLRs of the mother code (after lengthening);
    frozen: [code_len] uint8 mask, 1 = frozen; list_size: surviving
    paths L.  Returns (codewords [L, code_len] uint8, path metrics [L])
    sorted by metric.
    """
    llr = np.asarray(llr, dtype=np.float64)
    n = llr.shape[-1]
    L = list_size
    pm = np.full(L, np.inf)
    pm[0] = 0.0
    alpha0 = np.broadcast_to(llr, (L, n)).copy()

    def node(alpha: np.ndarray, pm: np.ndarray, fz: np.ndarray):
        w = alpha.shape[1]
        if w == 1:
            a = alpha[:, 0]
            if fz[0]:
                return np.zeros((L, 1), np.uint8), pm + _relu(-a), None
            pm_cand = np.concatenate([pm + _relu(-a), pm + _relu(a)])
            order = np.argsort(pm_cand, kind="stable")[:L]
            perm = order % L
            bits = (order // L).astype(np.uint8)
            return bits[:, None], pm_cand[order], perm
        h = w // 2
        beta_l, pm, perm_l = node(_f(alpha[:, :h], alpha[:, h:]), pm,
                                  fz[:h])
        if perm_l is not None:
            alpha = alpha[perm_l]
        beta_r, pm, perm_r = node(
            _g(alpha[:, :h], alpha[:, h:], beta_l), pm, fz[h:])
        if perm_r is not None:
            beta_l = beta_l[perm_r]
        beta = np.concatenate([beta_l ^ beta_r, beta_r], axis=1)
        if perm_l is None:
            perm = perm_r
        elif perm_r is None:
            perm = perm_l
        else:
            perm = perm_l[perm_r]
        return beta, pm, perm

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        beta, pm, _ = node(alpha0, pm, np.asarray(frozen, dtype=np.uint8))
    finally:
        sys.setrecursionlimit(old)
    order = np.argsort(pm, kind="stable")
    return beta[order], pm[order]
