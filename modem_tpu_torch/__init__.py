"""modem_tpu_torch: the modem's serving decode in PyTorch, for CUDA GPUs.

A port of ``modem_tpu`` (JAX on a TPU), which stays the reference.  The
module names follow the JAX package so each counterpart is easy to
find; inside, the code is plain PyTorch: complex64 tensors, ``torch.fft``
and an explicit ``device`` on :class:`encoder.Encoder` and
:class:`pipeline.BatchPipeline`.  The polar SC decoder is a CUDA kernel
written by hand (``csrc/sc_decode.cu``), built with ``nvcc`` at first
use; on CPU tensors its plain PyTorch version runs instead.

This package never imports ``jax`` or ``modem_tpu``: the numpy host
code it needs (numerology, bits, frozen-set design, BCH, the decoder
schedule) is carried here, and the tests pin it equal to the originals.
"""
