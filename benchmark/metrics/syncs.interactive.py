"""Points at which a Decoder.decode call's host thread waits for the
card: the program's ``syncs`` counter over ``decoder.decode``, over the
traced calls."""

from harness.spans import call_counter


def read(run):
    return call_counter("syncs")
