"""Host ms of the headers in a stream call: the span ``stream.headers``
(Decoder.decode_headers_batch over the candidates whose header window is
buffered: their metadata symbol, fec.osd.osd_decode, the CRC-16), over
the ``stream.feed`` and ``stream.finish`` calls of the traced slice."""

from harness.stream import call_host_ms


def read(run):
    return call_host_ms("stream.headers")
