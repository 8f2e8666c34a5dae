"""Host ms of one AdaptivePipeline.resolve call (the wait for the
batch's packed result, the CRC gate, every escalation group's list
decode and blocking fetch, the merge), the mean over the traced slice's
batches, from the harness's span around each call."""

from harness.layers import mean_ms


def read(run):
    return mean_ms(run, "resolve")
