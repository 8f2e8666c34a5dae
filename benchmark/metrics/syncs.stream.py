"""Points at which a stream call's host thread waits for the card: the
program's ``syncs`` counter over each ``stream.feed`` and
``stream.finish`` span of the traced slice, a call."""

from harness.stream import call_counter


def read(run):
    return call_counter("syncs")
