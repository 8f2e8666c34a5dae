"""Points at which the serving loop's host thread waits for the card, a
batch: the program's ``syncs`` counter over ``pipeline.dispatch`` and
``pipeline.resolve``, over the traced slice's batches."""

from harness.spans import batch_counter


def read(run):
    return batch_counter("syncs")
