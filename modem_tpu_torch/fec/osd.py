"""Ordered-statistics decoding of the BCH(255,71) header code, batched.

Counterpart of ``modem_tpu/fec/osd.py`` (reference:
CODE::OrderedStatisticsDecoder<255,71,4>, decode.cc:199,417).  The
reference enumerates the ~971k error patterns of weight <= 4 one by one;
here, for each block of a leading batch axis:

  * sort the 255 soft values by reliability (stable) and Gaussian-
    eliminate the generator matrix over GF(2) in that column order, so
    the basis is systematic in the 71 most reliable independent
    positions (a 255-step column scan: one kernel launch on the card,
    the plain loop on the CPU; ``kernels.osd_eliminate``);
  * every flip pattern of weight <= 4 over the basis bits is the XOR of
    two half patterns A, B of weight <= 2.  With U = [0; singles; pairs]
    the codeword-domain flip rows [2557, 255] and t the signed soft
    vector of the base codeword, the correlation discrepancy of A xor B
    is D(A) + D(B) - 2 (U_A * U_B) . t, so every score is one entry of
    a [2557, 255] x [255, 2557] product;
  * duplicate representations are masked to one canonical split, the
    first minimum wins and ``unique`` says whether it is the only one.

Soft inputs are rounded integers in [-128, 127] (decode.cc:412-416), so
the scores are integers and ties are meaningful.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.osd_eliminate import osd_eliminate
from ..profiling import span, wait
from . import bch

_BIG = 3.4e38    # masked (non-canonical) score


@functools.cache
def _pattern_support(k: int = bch.K):
    """Half patterns: the empty one, k singles, k(k-1)/2 pairs, as their
    support [P, 2] (-1 padded) and weight [P]."""
    pats = ([()] + [(i,) for i in range(k)]
            + [(i, j) for i in range(k) for j in range(i + 1, k)])
    sup = np.full((len(pats), 2), -1, dtype=np.int64)
    for p, s in enumerate(pats):
        sup[p, : len(s)] = s
    return sup, np.array([len(s) for s in pats], dtype=np.int64)


@functools.cache
def _canonical_mask(k: int = bch.K) -> np.ndarray:
    """[P, P] bool: the one split (A, B) that counts each pattern of
    weight <= 4 exactly once (weight 0-2: empty x any; 3: single x pair;
    4: pair x pair; A's support wholly before B's)."""
    sup, weights = _pattern_support(k)
    lo = np.where(sup[:, 0] >= 0, sup[:, 0], k + 1)
    hi = sup.max(axis=1)                       # -1 for the empty pattern
    wa, wb = weights[:, None], weights[None, :]
    valid = (((wa == 0) & (wb <= 2)) | ((wa == 1) & (wb == 2))
             | ((wa == 2) & (wb == 2))) & (hi[:, None] < lo[None, :])
    valid[0, 0] = True
    return valid


def _gf2_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a @ b) mod 2 for 0/1 matrices: the sums (at most 255) are exact in
    f32."""
    return torch.remainder(a.float() @ b.float(), 2.0).to(torch.uint8)


def osd_decode(soft, genmat: np.ndarray | None = None, order: int = 4):
    """Order-4 OSD of a batch of received header blocks.

    soft: [..., 255] integer-valued soft bits (positive = bit 0), any
    numeric dtype, on the device to decode on.  genmat: the [71, 255]
    systematic generator matrix (default BCH(255,71)).  order: the
    search order; only the reference's 4 is implemented (ValueError on
    another).  Returns (data bits [..., 71] uint8, unique [...] bool):
    the decoded information bits and whether the best candidate is the
    only minimiser.
    """
    if order != 4:
        raise ValueError(f"OSD order {order}: only the reference's "
                         "order-4 search is implemented")
    if genmat is None:
        genmat = bch.generator_matrix()
    soft = torch.as_tensor(soft)
    dev = soft.device
    lead = soft.shape[:-1]
    soft = soft.reshape(-1, soft.shape[-1]).to(torch.float32)
    batch = soft.shape[0]
    k, n = genmat.shape
    with wait("osd.upload"):
        g = torch.tensor(np.asarray(genmat, dtype=np.uint8), device=dev)

    with span("osd.eliminate"):
        # reliability order, most reliable first; ties keep column order
        perm = torch.argsort(-soft.abs(), dim=1, stable=True)
        soft_perm = soft.gather(1, perm)
        hard = (soft_perm < 0).to(torch.uint8)
        # g[:, perm] reduced: one launch on the card, the loop on the CPU
        g_red, pivots = osd_eliminate(g, perm)

    with span("osd.score"):
        c0 = _gf2_matmul(hard.gather(1, pivots)[:, None, :], g_red)[:, 0]
        # flipping codeword bit i costs t_i
        t = (1.0 - 2.0 * c0.float()) * soft_perm         # [B, n]

        sup_np, _ = _pattern_support(k)
        with wait("osd.upload"):
            sup = torch.as_tensor(sup_np, device=dev)
        p = sup.shape[0]
        rows = g_red[:, sup.clamp(min=0)] * (sup >= 0)[None, :, :, None]
        u = (rows[:, :, 0] ^ rows[:, :, 1]).float()      # [B, P, n]
        # Exact in f32 and in TF32 alike: u is 0/1 and t holds integers
        # of magnitude <= 128, so every product is an integer of <= 8
        # bits and every sum (<= 255 terms, |sum| <= 32,640) is exact in
        # f32.
        d_single = (u @ t[:, :, None])[..., 0]           # [B, P]
        cross = u @ (u * t[:, None, :]).transpose(1, 2)  # [B, P, P]
        scores = d_single[:, :, None] + d_single[:, None, :] - 2.0 * cross
        with wait("osd.upload"):
            valid = torch.as_tensor(_canonical_mask(k), device=dev)
        flat = torch.where(valid, scores, _BIG).reshape(batch, p * p)
        best = flat.argmin(dim=1)          # the first minimum, as jnp
        best_score = flat.gather(1, best[:, None])
        unique = (flat == best_score).sum(dim=1) == 1
        a, b = best // p, best % p
        bidx = torch.arange(batch, device=dev)
        c_best = (c0 ^ u[bidx, a].to(torch.uint8)
                  ^ u[bidx, b].to(torch.uint8))
        # undo the reliability order; the systematic prefix is the data
        codeword = torch.empty_like(c_best).scatter_(1, perm, c_best)
    return (codeword[:, :k].reshape(lead + (k,)), unique.reshape(lead))
