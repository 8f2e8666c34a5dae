"""Host ms of the payloads in a stream call: the span ``stream.payload``
(for the frames whose last payload sample is buffered, the cached
BatchPipeline's windows_at and decode_windows, kernel B at [1], and the
fetch), over the ``stream.feed`` and ``stream.finish`` calls of the
traced slice."""

from harness.stream import call_host_ms


def read(run):
    return call_host_ms("stream.payload")
