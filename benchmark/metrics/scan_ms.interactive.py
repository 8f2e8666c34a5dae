"""Host ms of the sync scan in a Decoder.decode call: the program's span
``decoder.scan`` (Synchronizer.scan: the chunked Schmidl-Cox walk, its
per-chunk fetches and the fine stage), the mean a call over the traced
calls."""

from harness.spans import call_host_ms


def read(run):
    return call_host_ms("decoder.scan")
