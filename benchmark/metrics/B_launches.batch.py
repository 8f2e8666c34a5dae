"""Launches of kernel B a batch: ``scl_decode.launches`` over the
program's ``pipeline.resolve`` spans (one a group of ``fallback_batch``
escalated frames), over the traced slice's batches."""

from harness.spans import batch_counter


def read(run):
    return batch_counter("scl_launches", names=("pipeline.resolve",))
