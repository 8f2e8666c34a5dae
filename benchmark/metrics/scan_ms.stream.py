"""Host ms of the scan in a stream call: the spans ``stream.scan`` (the
chunk walk of sync.Synchronizer.chunk_step over the StreamBuffer, each
chunk's window copied to the card and run through the device front end)
and ``stream.fine`` (the fine stage and gates of the events whose window
is buffered), over the ``stream.feed`` and ``stream.finish`` calls of
the traced slice."""

from harness.stream import call_host_ms


def read(run):
    return call_host_ms("stream.scan", "stream.fine")
