"""Wall ms from a batch's AdaptivePipeline.decode_batch_async call to
the host dict its resolve returns: the 95th percentile over every batch
of the window, as ``batch_ms_p95`` takes it.  A layer metric where the
loop's pace is the host's and its tail swings with the shared host."""

from harness.common import percentile


def read(run):
    lat = run.counters.get("latency_s")
    return percentile(lat, 95) * 1e3 if lat else None
