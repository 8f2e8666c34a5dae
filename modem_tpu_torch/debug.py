"""Numeric-validation aids (sanitizer analogs).

Counterpart of ``modem_tpu/debug.py``.  The reference builds with
-Ofast and no sanitizers; here there are NaN trapping on every torch
operation and a float64 shadow for comparing the numerics of a run on
the CPU.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _NanCheck(TorchDispatchMode):
    """Raises FloatingPointError when an operation returns a floating or
    complex tensor holding a NaN.  Each check reads the result on the
    host, so on a card every operation waits for the device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor)
                    and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


_installed: list[_NanCheck] = []


def enable_nan_checks(on: bool = True) -> None:
    """Trap NaNs produced by any torch operation (the counterpart of
    jax_debug_nans): installs, or with ``on=False`` removes, a dispatch
    mode that raises FloatingPointError on a NaN in any floating output.
    The mode lives on the calling thread's dispatch-mode stack, so
    enable and disable it on one thread, around code that pushes no mode
    of its own in between.

    Note: ``ofdm.demod_or_erase`` deliberately *tolerates* NaNs (they
    become erasures, decode.cc:62-70); with checks enabled those paths
    raise instead, so use this on clean-signal reproductions only.
    """
    if on and not _installed:
        mode = _NanCheck()
        mode.__enter__()
        _installed.append(mode)
    elif not on and _installed:
        _installed.pop().__exit__(None, None, None)


@contextlib.contextmanager
def shadow_f64():
    """Run the enclosed block with torch's default dtype float64.

    Torch has no global switch like ``jax_enable_x64``: dtypes follow
    the tensors, and the default dtype only sets what factory functions
    and Python floats make.  So pass float64 / complex128 arrays in and
    compare against the f32 run.  A shadow run cannot reach past the
    entry points that cast to float32 or complex64 whatever the default
    is:

      * ``pipeline.as_recordings`` and ``sync``'s recording intake
        (complex64), so every ``BatchPipeline`` / ``AdaptivePipeline``
        decode and ``Synchronizer.scan``;
      * ``dsp.frontend`` and the PCM dequantisation of ``ingest``
        (float32), so ``Decoder.decode``, ``decode_recording_auto`` and
        ``StreamDecoder``;
      * the polar decoders ``kernels.sc_decode`` / ``kernels.scl_decode``
        (float32 LLRs and path metrics, kernel or plain version);
      * ``Encoder.encode_batch`` and ``Encoder.encode`` (complex64
        waveforms).

    A dtype knob on the pipelines would be an option that serves no
    user; the shadow covers the stages below those casts (``track``,
    ``ofdm``, ``psk``, ``fec.osd``) called on float64 inputs.
    """
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)
