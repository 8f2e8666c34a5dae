"""Share of the window's frames that AdaptivePipeline.resolve sent to
the list decoder: AdaptivePipeline.last_fallbacks summed over the
window's batches against the frames resolved.  A count: it repeats
exactly for a seed."""


def read(run):
    frames = run.counters.get("frames")
    if not frames:
        return None
    return 100.0 * run.counters["escalated"] / frames
