"""Share of the traced stream calls' wall time in which no kernel, copy
or set ran on the device: 100 x (1 - the union of the device intervals
/ the slice's seconds), from torch.profiler over the first feeds of a
capture."""


def read(run):
    return run.trace.idle_pct if run.trace is not None else None
