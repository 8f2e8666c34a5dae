"""Host ms of the scan in a decode_recording_auto call: the span
``decode_all.scan`` (the chunked Schmidl-Cox walk of
sync.Synchronizer.scan over a PcmRecording, with its upload, the device
front end of each chunk and the fine stage), over the traced calls."""

from harness.spans import recording_host_ms


def read(run):
    return recording_host_ms("decode_all.scan")
