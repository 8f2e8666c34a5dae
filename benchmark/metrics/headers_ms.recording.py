"""Host ms of the header batch in a decode_recording_auto call: the span
``decode_all.headers`` (Decoder.decode_headers_batch: every candidate's
metadata symbol, fec.osd.osd_decode, the CRC-16), over the traced
calls."""

from harness.spans import recording_host_ms


def read(run):
    return recording_host_ms("decode_all.headers")
