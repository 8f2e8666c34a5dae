"""Host ms a batch that AdaptivePipeline.resolve spends waiting for the
card: the program's ``wait`` spans under ``pipeline.resolve`` (the
batch's event, each escalation group's index upload and fetch), summed
over the traced slice over its batches."""

from harness.spans import named, per_request, records, under


def read(run):
    recs = records()
    waits = [r for r in under(recs, named(recs, "pipeline.resolve"))
             if r.wait]
    return per_request((r.host_ms for r in waits),
                       named(recs, "pipeline.resolve"))
