"""Unnormalised DFTs on complex tensors (DSP::FastFourierTransform
semantics): ``fwd`` uses e^{-2 pi j nk/N}, ``bwd`` e^{+2 pi j nk/N}, and
neither scales; callers scale explicitly as the reference does
(encode.cc:88,97,109; decode.cc:82).  Counterpart of
``modem_tpu/fft.py``, whose matmul DFTs act on axis -2 of split-complex
arrays; here the transform runs on the last axis of a complex tensor.
"""

from __future__ import annotations

import torch


def fwd(x: torch.Tensor) -> torch.Tensor:
    """Forward unnormalised DFT over the last axis."""
    return torch.fft.fft(x, dim=-1, norm="backward")


def bwd(x: torch.Tensor) -> torch.Tensor:
    """Backward (e^{+j}) unnormalised DFT over the last axis."""
    return torch.fft.ifft(x, dim=-1, norm="forward")
