"""Device ms of the batch front end as the serving loop runs it: the
stream time between the two CUDA events of the program's span
``pipeline.demod`` (BatchPipeline.demod inside
AdaptivePipeline.decode_batch_async), the mean a batch over the traced
slice."""

from harness.spans import named, per_request, records


def read(run):
    demods = [r for r in named(records(), "pipeline.demod")
              if r.events is not None]
    return per_request((r.device_ms for r in demods), demods)
