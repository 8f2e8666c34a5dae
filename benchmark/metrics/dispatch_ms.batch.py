"""Host ms of one AdaptivePipeline.decode_batch_async call (front end,
SC back end, pack and the copy's dispatch), the mean over the traced
slice's batches, from the harness's span around each call."""

from harness.layers import mean_ms


def read(run):
    return mean_ms(run, "dispatch")
