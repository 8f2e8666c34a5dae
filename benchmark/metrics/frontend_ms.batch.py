"""Device ms of the batch front end, BatchPipeline.demod (sync, FFT,
OFDM demod, tracking, demap, lengthening), by CUDA events around
pipe.sc.demod on each of the cell's pool batches, called alone after the
traced slice; the mean over the pool."""

import torch


def read(run):
    if run.device.type != "cuda":
        return None
    demod = run.pipe.sc.demod
    times = []
    for x in run.pool:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        demod(x)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sum(times) / len(times)
