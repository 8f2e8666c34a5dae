"""The port's live StreamDecoder against the benchmark's plain reference
of a live stream (``benchmark/reference/stream.py``, loaded by path; it
imports nothing of the port and nothing of JAX).

One short wire-size capture: 25 s of 8 kHz mono int16 holding two
mode-6 frames at least 1 s apart, each with its own payload and call
sign, made by the reference's encoder and put through the README chain
(multipath x10, CFO 234.567 Hz, SFO 147 ppm) with -30 dB full-scale
noise over the capture.  Fed 8,000 samples at a time (under
``torch.profiler``, whose spans and counters are checked) and 3,001 at
a time: the frames equal the reference's (``pos``, ``mode``, call sign,
``ok``, payload and bit flips exactly, SNR within 1e-3), and each frame
comes out at the call the reference names.
"""

import importlib
import importlib.machinery
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from modem_tpu_torch import profiling
from modem_tpu_torch.ingest import StreamBuffer
from modem_tpu_torch.stream import StreamDecoder

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
RATE = 8000
SAMPLES = 200_000
STARTS = (13_407, 108_805)          # 1.7 s and 13.6 s: 1 s apart or more
SNR_TOL = 1e-3
CHAIN = dict(cfo_hz=234.567, sfo_ppm=147.0, spread=10)
STREAM_SPANS = ("stream.scan", "stream.fine", "stream.headers",
                "stream.payload")


def bench_reference(name: str):
    """``benchmark/reference/<name>.py`` as ``bench_reference.<name>``
    (its relative imports resolve inside that package)."""
    pkg = "bench_reference"
    if pkg not in sys.modules:
        spec = importlib.machinery.ModuleSpec(pkg, None, is_package=True)
        spec.submodule_search_locations = [str(BENCH / "reference")]
        sys.modules[pkg] = importlib.util.module_from_spec(spec)
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(scope="module")
def capture():
    """(int16 samples [SAMPLES], the frames sent as (payload bytes, call
    sign text))."""
    M = bench_reference("modem")
    C = bench_reference("channel")
    Encoder = bench_reference("encoder").Encoder
    cfg = M.Config(RATE, M.MODES[6], 2000)
    rng = np.random.default_rng(20)
    bits = torch.as_tensor(rng.integers(0, 2, (2, cfg.mode.data_bits)),
                           dtype=torch.uint8)
    calls = rng.integers(1, 37 ** 9, 2)
    with torch.no_grad():
        wave = C.impair_real(Encoder(cfg, "cpu").encode(bits, calls)
                             .real.double(), RATE, **CHAIN)
        x = torch.zeros(SAMPLES, dtype=torch.float64)
        for s0, w in zip(STARTS, wave):
            x[s0: s0 + w.shape[0]] += w
        gen = torch.Generator().manual_seed(21)
        x += 10.0 ** (-30.0 / 20.0) * torch.randn(SAMPLES, generator=gen,
                                                  dtype=torch.float64)
    pcm = torch.clamp(torch.round(x * 32767.0), -32768, 32767).to(
        torch.int16).numpy()
    sent = [(M.payload_bytes(b), M.base37_text(int(c)))
            for b, c in zip(bits.numpy(), calls)]
    return pcm, sent


@pytest.fixture(scope="module")
def reference(capture):
    """The reference's frames of the whole capture, with the payload
    bytes and call sign text of the port's answers."""
    M = bench_reference("modem")
    rec = bench_reference("recording")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        frames = rec.decode_recording(capture[0], RATE, 8, 8, "cpu")
    for f in frames:
        f["call_sign"] = M.base37_text(f["call"]) if f["call"] else ""
        if f["ok"]:
            f["payload"] = M.payload_bytes(f["bits"])
    return frames


def new_decoder():
    return StreamDecoder(RATE, channels=1, bits=16, device="cpu")


def feed(sd, pcm, step):
    """[(frame, index of the call that emitted it)]: ``pcm`` fed ``step``
    samples at a time to the StreamDecoder ``sd``, then ended."""
    out = []
    starts = range(0, len(pcm), step)
    for i, s0 in enumerate(starts):
        out += [(f, i) for f in sd.feed(pcm[s0: s0 + step])]
    out += [(f, len(starts)) for f in sd.finish()]
    return out


@pytest.fixture(scope="module")
def traced(capture):
    """The capture fed 8,000 samples at a time under torch.profiler:
    (frames with their calls, the spans recorded, the syncs counted over
    the run, the StreamBuffer.raw_windows calls made)."""
    copies = []
    real = StreamBuffer.raw_windows

    def raw_windows(self, *a, **kw):
        copies.append(1)
        return real(self, *a, **kw)

    sd = new_decoder()
    StreamBuffer.raw_windows = raw_windows
    try:
        profiling.clear_spans()
        s0 = profiling.syncs
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = feed(sd, capture[0], 8000)
        syncs = profiling.syncs - s0
        recs = profiling.spans()
    finally:
        StreamBuffer.raw_windows = real
        profiling.clear_spans()
    return got, recs, syncs, len(copies)


@pytest.fixture(scope="module")
def fed(capture, traced):
    return {8000: traced[0], 3001: feed(new_decoder(), capture[0], 3001)}


@pytest.mark.parametrize("step", [8000, 3001])
def test_stream_frames_equal_the_reference(fed, reference, capture, step):
    got = sorted((f for f, _ in fed[step]), key=lambda f: f["pos"])
    assert len(got) == len(reference) == 2
    for g, r in zip(got, reference):
        assert (g["pos"], g["mode"], g["call_sign"], g["ok"]) == (
            r["pos"], r["mode"], r["call_sign"], r["ok"])
        assert g["payload"] == r["payload"] and g["flips"] == r["flips"]
        assert np.abs(np.asarray(g["snr"]) - r["snr"]).max() <= SNR_TOL
    assert [(g["payload"], g["call_sign"]) for g in got] == capture[1]


@pytest.mark.parametrize("step", [8000, 3001])
def test_each_frame_comes_out_at_the_call_the_reference_names(
        fed, reference, step):
    due_call = bench_reference("stream").due_call
    when = {int(f["pos"]): i for f, i in fed[step]}
    due = {int(r["pos"]): due_call(r["pos"], r["mode"], RATE, SAMPLES, step)
           for r in reference}
    assert when == due
    assert max(due.values()) < -(-SAMPLES // step)   # live, not at finish


def test_stream_spans_and_syncs_under_the_profiler(traced):
    """Every call is a request span holding the four stage spans; the
    header's OSD runs under ``stream.headers``; ``syncs`` over the run
    equals the waits recorded inside the calls, among them one
    ``stream.windows`` upload a window the buffer cut."""
    got, recs, syncs, copies = traced
    calls = [r for r in recs if r.name in ("stream.feed", "stream.finish")]
    assert [r.name for r in calls].count("stream.finish") == 1
    assert len(calls) == -(-SAMPLES // 8000) + 1
    assert len({r.request for r in calls}) == len(calls)
    assert all(r.parent is None for r in calls)
    byid = {r.id: r for r in recs}
    for name in STREAM_SPANS:
        stage = [r for r in recs if r.name == name]
        assert len(stage) == len(calls), name
        assert all(byid[r.parent].name in ("stream.feed", "stream.finish")
                   for r in stage), name
    osd = [r for r in recs if r.name == "osd.eliminate"]
    assert len(osd) == 2
    assert all(byid[r.parent].name == "stream.headers" for r in osd)
    waits = [r for r in recs if r.wait]
    assert syncs == len(waits) == sum(r.counts["syncs"] for r in calls)
    assert sum(r.name == "stream.windows" for r in waits) == copies > 0
