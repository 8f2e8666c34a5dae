"""Channel tracking: Theil-Sen phase regression and SNR estimation.

Counterpart of ``modem_tpu/track.py`` (reference: DSP::TheilSenEstimator
at decode.cc:195, 488-494, and the per-row Es/N0 loop at
decode.cc:505-523), batched over any leading axes.  Two Theil-Sen
estimators, as in JAX: the O(n) disjoint-pairs one (the default, which
the batch pipeline uses) and the reference's exact all-pairs one (the
interactive decoder's).
"""

from __future__ import annotations

import torch

from . import psk


def _median_upper(v: torch.Tensor) -> torch.Tensor:
    """sort(v)[count // 2] over the last axis: the UPPER middle for an
    even count (std::nth_element-style, as the JAX ``_median_lower``).
    torch.median would return the lower middle."""
    return torch.sort(v, dim=-1).values[..., v.shape[-1] // 2]


def theil_sen(x: torch.Tensor, y: torch.Tensor):
    """Robust line fit over the last axis: median slope over the disjoint
    pairs (i, i + n/2) and median intercept.  x: [cols], y: [..., cols].
    Returns (slope, yint), each [...]."""
    cols = x.shape[-1]
    h = cols // 2
    slopes = (y[..., h: 2 * h] - y[..., :h]) / (x[h: 2 * h] - x[:h])
    slope = _median_upper(slopes)
    yint = _median_upper(y - slope[..., None] * x)
    return slope, yint


def theil_sen_all_pairs(x: torch.Tensor, y: torch.Tensor):
    """The reference's exact Theil-Sen (DSP::TheilSenEstimator,
    decode.cc:488-494): the median of all n(n-1)/2 pairwise slopes
    (index count // 2 of the sorted slopes), then the median residual.
    x: [cols], y: [..., cols].  Returns (slope, yint), each [...]."""
    cols = x.shape[-1]
    i, j = torch.triu_indices(cols, cols, offset=1, device=y.device)
    slopes = (y[..., j] - y[..., i]) / (x[j] - x[i])
    slope = _median_upper(slopes)
    yint = _median_upper(y - slope[..., None] * x)
    return slope, yint


ESTIMATORS = {"disjoint": theil_sen, "all_pairs": theil_sen_all_pairs}
# the estimator of derotate_rows(estimator=None), as the JAX package's
# module default
ESTIMATOR = "disjoint"


def derotate_rows(cons: torch.Tensor, code_off: int, mod_bits: int,
                  estimator: str | None = None):
    """Per-row Theil-Sen phase regression and derotation
    (decode.cc:479-504).  cons: [..., rows, cols] complex differential
    constellation points; ``estimator`` "disjoint" or "all_pairs", None
    for :data:`ESTIMATOR`.
    Returns (derotated cons, mean slope, mean intercept), the means over
    the rows axis."""
    cols = cons.shape[-1]
    x = (torch.arange(cols, device=cons.device) + code_off).to(
        torch.float32)
    ref = psk.mod_map(mod_bits, psk.mod_hard(mod_bits, cons))
    # phase error of each point vs its hard decision
    err = torch.atan2(cons.imag * ref.real - cons.real * ref.imag,
                      cons.real * ref.real + cons.imag * ref.imag)
    slopes, yints = ESTIMATORS[ESTIMATOR if estimator is None
                               else estimator](x, err)
    theta = -(slopes[..., None] * x + yints[..., None])
    out = cons * torch.complex(torch.cos(theta), torch.sin(theta))
    return out, slopes.mean(dim=-1), yints.mean(dim=-1)


def soft_llrs(cons: torch.Tensor, mod_bits: int):
    """Cumulative-SNR soft demap (decode.cc:505-523).

    The reference accumulates signal and noise power ACROSS rows, so row
    r uses precision = sum(sp[0..r]) / sum(np[0..r]).  cons: [..., rows,
    cols].  Returns (llrs [..., rows, cols, mod_bits], snr_db [..., rows]).
    """
    ref = psk.mod_map(mod_bits, psk.mod_hard(mod_bits, cons))
    err = cons - ref
    sp = torch.cumsum((ref.real ** 2 + ref.imag ** 2).sum(dim=-1), dim=-1)
    npow = torch.cumsum((err.real ** 2 + err.imag ** 2).sum(dim=-1), dim=-1)
    precision = sp / npow.clamp(min=1e-12)
    llrs = psk.mod_soft(mod_bits, cons, precision[..., None])
    return llrs, 10.0 * torch.log10(precision)
