"""Points at which a decode_recording_auto call's host thread waits for
the card: the program's ``syncs`` counter over the ``decode_all.*``
stages, over the traced calls."""

from harness.spans import recording_counter


def read(run):
    return recording_counter("syncs")
