"""The readers of the program's own spans and counters on synthetic
records: each divides by the slice's batches or calls, and reads
nothing where the program recorded nothing or has no recorder."""

import pathlib
import types

import pytest

from harness import common
from modem_tpu_torch import profiling
from modem_tpu_torch.profiling import SpanRecord

REPO = pathlib.Path(__file__).resolve().parents[2]
BATCH = ("demod_ms.batch", "wait_ms.batch", "syncs.batch",
         "B_launches.batch")
CALL = ("scan_ms.interactive", "header_ms.interactive",
        "osd_steps.interactive", "syncs.interactive")
RECORDING = ("scan_ms.recording", "headers_ms.recording",
             "payload_ms.recording", "syncs.recording")
RUN = types.SimpleNamespace(cell={}, counters={}, spans={}, trace=None)


class Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def span(rid, name, parent=None, request=1, ms=1.0, wait=False,
         events=None, **counts):
    rec = SpanRecord(name, rid, parent, request, start_ns=0,
                     end_ns=int(ms * 1e6), wait=wait, events=events)
    rec.counts = {k: counts.get(k, 0) for k in profiling.COUNTERS}
    return rec


def two_batches():
    """Batch 1: clean (its event's wait, 2 ms); batch 2: two escalation
    groups (event 1 ms, each group's upload 0.5 and fetch 3 ms, one B
    launch each)."""
    return [
        span(1, "pipeline.dispatch", ms=9.0),
        span(2, "pipeline.demod", 1, events=(Event(0.0), Event(12.0))),
        span(3, "pipeline.dispatch", request=2, ms=9.0, syncs=1),
        span(4, "pipeline.demod", 3, request=2,
             events=(Event(5.0), Event(19.0))),
        span(5, "pipeline.upload", 4, request=2, wait=True),
        span(6, "pipeline.resolve", ms=3.0, syncs=1),
        span(7, "pipeline.wait", 6, ms=2.0, wait=True),
        span(8, "pipeline.resolve", request=2, ms=20.0, syncs=5,
             scl_launches=2),
        span(9, "pipeline.wait", 8, request=2, wait=True),
        span(10, "pipeline.escalate", 8, request=2, ms=9.0, syncs=2,
             scl_launches=1),
        span(11, "pipeline.upload", 10, request=2, ms=0.5, wait=True),
        span(12, "pipeline.fetch", 10, request=2, ms=3.0, wait=True),
        span(13, "pipeline.escalate", 8, request=2, ms=9.0, syncs=2,
             scl_launches=1),
        span(14, "pipeline.upload", 13, request=2, ms=0.5, wait=True),
        span(15, "pipeline.fetch", 13, request=2, ms=3.0, wait=True)]


def two_calls():
    """Call 1: one candidate; call 2: two, the second's header run
    twice (two OSD calls)."""
    return [
        span(1, "decoder.decode", ms=130.0, syncs=285, osd_steps=255),
        span(2, "decoder.scan", 1, ms=6.0),
        span(3, "decoder.header", 1, ms=70.0),
        span(4, "decoder.decode", request=2, ms=300.0, syncs=571,
             osd_steps=765),
        span(5, "decoder.scan", 4, request=2, ms=8.0),
        span(6, "decoder.header", 4, request=2, ms=80.0),
        span(7, "decoder.header", 4, request=2, ms=150.0)]


def two_recording_calls():
    """Two decode_recording_auto calls: their four stages each, the
    payload's batch spans and waits nested inside (counted once, in the
    stage)."""
    recs = []
    for c, (scan, hdr, win, pay, syncs) in enumerate(
            [(90.0, 100.0, 4.0, 12.0, (30, 256, 3, 4)),
             (96.0, 110.0, 6.0, 14.0, (30, 256, 3, 6))]):
        base = 10 * c
        recs += [
            span(base + 1, "decode_all.scan", request=c + 1, ms=scan,
                 syncs=syncs[0]),
            span(base + 2, "ingest.upload", base + 1, request=c + 1,
                 wait=True, syncs=1),
            span(base + 3, "decode_all.headers", request=c + 1, ms=hdr,
                 syncs=syncs[1], osd_steps=255),
            span(base + 4, "decode_all.windows", request=c + 1, ms=win,
                 syncs=syncs[2]),
            span(base + 5, "decode_all.payload", request=c + 1, ms=pay,
                 syncs=syncs[3], sc_launches=1),
            span(base + 6, "pipeline.dispatch", base + 5, request=c + 1,
                 ms=3.0, syncs=1),
            span(base + 7, "pipeline.resolve", base + 5, request=c + 1,
                 ms=5.0, syncs=syncs[3] - 1)]
    return recs


WANT = {"demod_ms.batch": 13.0,          # (12 + 14) / 2
        "wait_ms.batch": 5.0,            # (2 + 1 + 2 x 3.5) / 2
        "syncs.batch": 3.5,              # (0 + 1 + 1 + 5) / 2
        "B_launches.batch": 1.0,         # (0 + 2) / 2
        "scan_ms.interactive": 7.0,
        "header_ms.interactive": 150.0,  # (70 + 80 + 150) / 2
        "osd_steps.interactive": 510.0,
        "syncs.interactive": 428.0,
        "scan_ms.recording": 93.0,       # (90 + 96) / 2
        "headers_ms.recording": 105.0,
        "payload_ms.recording": 18.0,    # (4 + 12 + 6 + 14) / 2
        "syncs.recording": 294.0}        # (293 + 295) / 2


def records_for(name):
    if name in BATCH:
        return two_batches()
    return two_calls() if name in CALL else two_recording_calls()


@pytest.mark.parametrize("name", BATCH + CALL + RECORDING)
def test_each_reader_divides_by_the_slice_requests(name, monkeypatch):
    recs = records_for(name)
    monkeypatch.setattr(profiling, "spans", lambda: list(recs))
    assert common.reader(REPO, name)(RUN) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", BATCH + CALL + RECORDING)
def test_each_reader_reads_nothing_without_records(name, monkeypatch):
    read = common.reader(REPO, name)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(RUN) is None
    monkeypatch.delattr(profiling, "spans")       # a program without spans
    assert read(RUN) is None


@pytest.mark.parametrize("name", ["idle_pct.interactive",
                                  "idle_pct.recording"])
def test_the_idle_share_is_the_traces(name):
    read = common.reader(REPO, name)
    trace = types.SimpleNamespace(idle_pct=87.5)
    assert read(types.SimpleNamespace(trace=trace)) == 87.5
    assert read(types.SimpleNamespace(trace=None)) is None
