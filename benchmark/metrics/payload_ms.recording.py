"""Host ms of the payload in a decode_recording_auto call: the spans
``decode_all.windows`` (the frame windows cut through the device front
end) and ``decode_all.payload`` (AdaptivePipeline.decode_windows: the
batch front end, kernel A, the escalation of CRC failures to the list
decoder, the fetch), over the traced calls."""

from harness.spans import recording_host_ms


def read(run):
    return recording_host_ms("decode_all.windows", "decode_all.payload")
