"""Host ms of the header stage in a Decoder.decode call: every
``decoder.header`` span (Decoder._decode_header of a candidate: the
metadata symbol's demod, fec.osd.osd_decode's elimination and scoring,
the CRC-16), summed over the traced calls over the calls."""

from harness.spans import call_host_ms


def read(run):
    return call_host_ms("decoder.header")
