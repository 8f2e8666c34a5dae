"""What the per-layer metrics read of the program's own spans and
counters (``modem_tpu_torch.profiling``), recorded while the traced
slice ran under ``torch.profiler``.

Every reader divides by the number of request spans of the slice (the
batches' ``pipeline.dispatch``, the calls' ``decoder.decode``, or the
recording calls' ``decode_all.scan``) and
reads nothing where the program recorded no span: on the CPU, where the
harness does not profile, and in a program without spans.
"""

from __future__ import annotations


def records() -> list:
    """The program's span records, oldest first; empty where it has no
    recorder."""
    try:
        from modem_tpu_torch import profiling
    except ImportError:
        return []
    spans = getattr(profiling, "spans", None)
    return spans() if spans is not None else []


def named(recs: list, name: str) -> list:
    return [r for r in recs if r.name == name]


def under(recs: list, top: list) -> list:
    """The records whose ancestors include one of ``top``."""
    byid = {r.id: r for r in recs}
    tops = {r.id for r in top}
    out = []
    for r in recs:
        p = r.parent
        while p is not None and p not in tops:
            p = byid[p].parent if p in byid else None
        if p is not None:
            out.append(r)
    return out


def per_request(values, requests: list):
    """sum(values) over the number of request spans; None without
    any."""
    return sum(values) / len(requests) if requests else None


def batch_counter(key: str, names=("pipeline.dispatch",
                                   "pipeline.resolve")):
    """A counter's delta over the spans ``names``, a batch."""
    recs = records()
    batches = named(recs, "pipeline.dispatch")
    return per_request((r.counts[key] for n in names
                        for r in named(recs, n)), batches)


def call_counter(key: str):
    """A counter's delta over ``decoder.decode``, a call."""
    calls = named(records(), "decoder.decode")
    return per_request((r.counts[key] for r in calls), calls)


def call_host_ms(name: str):
    """Host ms of every ``name`` span, a call."""
    recs = records()
    return per_request((r.host_ms for r in named(recs, name)),
                       named(recs, "decoder.decode"))


DECODE_ALL = ("decode_all.scan", "decode_all.headers", "decode_all.windows",
              "decode_all.payload")


def recording_host_ms(*names):
    """Host ms of every span of ``names``, a ``decode_recording_auto``
    call (one ``decode_all.scan`` a call)."""
    recs = records()
    return per_request((r.host_ms for n in names for r in named(recs, n)),
                       named(recs, "decode_all.scan"))


def recording_counter(key: str):
    """A counter's delta over the ``decode_all.*`` stages, a call."""
    recs = records()
    return per_request((r.counts[key] for n in DECODE_ALL
                        for r in named(recs, n)),
                       named(recs, "decode_all.scan"))
