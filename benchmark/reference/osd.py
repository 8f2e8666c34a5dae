"""Order-4 ordered-statistics decoding of the BCH(255, 71) header,
plain PyTorch (CODE::OrderedStatisticsDecoder<255,71,4>, decode.cc:199,
417).

The soft values are sorted by reliability (stable) and the generator is
Gauss-eliminated over GF(2) in that column order, so the basis is
systematic in the 71 most reliable independent positions.  Every flip
pattern of weight <= 4 over the basis bits is the XOR of two half
patterns of weight <= 2; its correlation discrepancy is D(A) + D(B) -
2 (U_A * U_B) . t, one entry of a product of the half patterns'
codeword rows.  The first minimum over the canonical splits wins, and
``unique`` says whether it is the only one.  Soft inputs are integers in
[-128, 127], so the scores are integers and ties are meaningful.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import modem as M

K, N = 71, 255
BIG = 3.4e38


@functools.lru_cache(maxsize=None)
def generator() -> np.ndarray:
    """Systematic [71, 255] generator: row i is unit i and its parity."""
    eye = np.eye(K, dtype=np.uint8)
    return np.stack([np.concatenate([eye[i], M.bch_parity(eye[i])])
                     for i in range(K)])


@functools.lru_cache(maxsize=None)
def halves():
    """Half patterns (empty, singles, pairs) as support [P, 2] and the
    [P, P] mask of the one split that counts each pattern once."""
    pats = ([()] + [(i,) for i in range(K)]
            + [(i, j) for i in range(K) for j in range(i + 1, K)])
    sup = np.full((len(pats), 2), -1, dtype=np.int64)
    for p, s in enumerate(pats):
        sup[p, : len(s)] = s
    w = np.array([len(s) for s in pats])
    lo = np.where(sup[:, 0] >= 0, sup[:, 0], K + 1)
    hi = sup.max(axis=1)
    wa, wb = w[:, None], w[None, :]
    valid = (((wa == 0) & (wb <= 2)) | ((wa == 1) & (wb == 2))
             | ((wa == 2) & (wb == 2))) & (hi[:, None] < lo[None, :])
    valid[0, 0] = True
    return sup, valid


def rref(m: torch.Tensor):
    """Reduced row echelon form of [B, k, n] GF(2) matrices by a scan
    over the columns in order -> (reduced, pivot column of each row)."""
    batch, k, n = m.shape
    m = m.clone()
    dev = m.device
    rows = torch.arange(k, device=dev)
    b = torch.arange(batch, device=dev)
    rank = torch.zeros(batch, dtype=torch.int64, device=dev)
    piv = torch.zeros(batch, k, dtype=torch.int64, device=dev)
    for col in range(n):
        cand = torch.where((m[:, :, col] > 0) & (rows >= rank[:, None]),
                           rows, k)
        prow = cand.min(dim=1).values
        do = (prow < k) & (rank < k)
        rk = rank.clamp(max=k - 1)
        pr = torch.where(do, prow, rk)
        a, c = m[b, rk], m[b, pr]
        m[b, pr] = a
        m[b, rk] = c
        elim = m[:, :, col].clone()
        elim[b, rk] = 0
        elim = elim * do[:, None]
        m ^= elim[:, :, None] & m[b, rk][:, None, :]
        piv[b, rk] = torch.where(do, col, piv[b, rk])
        rank = rank + do
    return m, piv


def osd_decode(soft: torch.Tensor):
    """soft [B, 255] -> (data bits [B, 71] uint8, unique [B] bool)."""
    dev = soft.device
    soft = soft.to(torch.float64)
    batch = soft.shape[0]
    g = torch.as_tensor(generator(), device=dev)
    perm = torch.argsort(-soft.abs(), dim=1, stable=True)
    g_perm = g[:, perm].permute(1, 0, 2)
    s_perm = soft.gather(1, perm)
    hard = (s_perm < 0).to(torch.uint8)
    g_red, piv = rref(g_perm)
    c0 = (hard.gather(1, piv)[:, None, :].double() @ g_red.double()
          ).remainder(2.0)[:, 0].to(torch.uint8)
    t = (1.0 - 2.0 * c0.double()) * s_perm
    sup_np, valid_np = halves()
    sup = torch.as_tensor(sup_np, device=dev)
    p = sup.shape[0]
    rows = g_red[:, sup.clamp(min=0)] * (sup >= 0)[None, :, :, None]
    u = (rows[:, :, 0] ^ rows[:, :, 1]).double()
    d = (u @ t[:, :, None])[..., 0]
    cross = u @ (u * t[:, None, :]).transpose(1, 2)
    scores = d[:, :, None] + d[:, None, :] - 2.0 * cross
    flat = torch.where(torch.as_tensor(valid_np, device=dev), scores,
                       BIG).reshape(batch, p * p)
    best = flat.argmin(dim=1)
    unique = (flat == flat.gather(1, best[:, None])).sum(dim=1) == 1
    a, bb = best // p, best % p
    bi = torch.arange(batch, device=dev)
    c = c0 ^ u[bi, a].to(torch.uint8) ^ u[bi, bb].to(torch.uint8)
    word = torch.empty_like(c).scatter_(1, perm, c)
    return word[:, :K], unique
