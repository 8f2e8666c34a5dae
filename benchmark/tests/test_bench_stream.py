"""The stream loop on the CPU with a short wire-size mode-6 capture (one
in the pool, two frames): it runs through ``run.main``, its answers
equal the reference's and come out when the reference says they are
due, its window holds whole passes of the pool, a stream that holds its
frames back to ``finish()`` reads ``frames_late``, an altered or a
dropped frame reads ``frames_differ``, and the bfloat16 control fails
the cell's limits.  The live decoder reads each frame's mode from its
header, so the toy numerology of ``toycell.py`` cannot go through it.
On the card: ``syncs.stream`` against torch's sync debug mode over one
header feed of the committed cell."""

import collections
import contextlib
import io
import json
import os
import pathlib
import shutil
import warnings

import pytest

import run as bench_run
from harness import common, recording, stream
from reference import modem as M

REPO = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "m6-8k.live-stream"
TINY = {"loop": "stream", "pool": 1, "frames": 2, "gap_s": 1.0,
        "channel": {"awgn_db": -30.0, "cfo_hz": 234.567, "sfo_ppm": 147.0,
                    "spread": 10},
        "check_hours": 1, "trace_feeds": 4}
TINY_S = 25.0
SEED = 2 ** 40 + 5


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark with the cell ``m6-8k.tiny-s``: the
    committed cell's deployment with 25 s captures, and its limits."""
    root = tmp_path_factory.mktemp("tinystream")
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = common.cell_of(m, CELL, REPO)
    bench = root / "benchmark"
    (bench / "traffic" / "tiny-s.json").write_text(json.dumps(TINY))
    (bench / "workloads" / "m6-8k.tiny-s.json").write_text(
        json.dumps({"limits": cell["limits"]}))
    conf = dict(cell["config"])
    conf["stream"] = dict(conf["stream"], session_s=TINY_S)
    (bench / "configs" / "tiny-live.json").write_text(json.dumps(conf))
    m["configs"].append({"name": "tiny-live", "source": "tests",
                         "file": "benchmark/configs/tiny-live.json",
                         "reduced": ["stream"], "why": "tests"})
    m["workloads"].append({"name": "m6-8k.tiny-s", "config": "tiny-live",
                           "traffic": "tiny-s", "chips": 1, "why": "tests"})
    for e in m["end_to_end"] + m["per_layer"]:
        if CELL in e.get("workloads", []):
            e["workloads"].append("m6-8k.tiny-s")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root, common.cell_of(m, "m6-8k.tiny-s", root)


@pytest.fixture(scope="module")
def answers(tiny):
    """(the mix's parameters, the capture, the frames sent, the
    reference's frames of it)."""
    _, cell = tiny
    params = stream.mix_of(cell)
    cfg = M.config_of(cell["config"]["modem"])
    pool, sent = recording.hour_pool(cfg, params, SEED, "cpu")
    refs = stream.reference_answers(cfg, cell["config"], params, pool,
                                    "cpu")
    return params, pool[0], sent[0], refs[0]


def run_tiny(root, trace=0):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = bench_run.main(["--workload", "m6-8k.tiny-s", "--seed",
                             str(SEED), "--seconds", "1", "--trace",
                             str(trace)], device="cpu", root=root)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_the_stream_loop_runs_and_agrees(tiny):
    rc, res = run_tiny(tiny[0])
    assert rc == 0 and res["correct"] is True
    assert res["failed"] == 0
    per_pass = TINY["pool"] * TINY["frames"]
    assert res["attempted"] >= per_pass and res["attempted"] % per_pass == 0
    assert set(res["metrics"]) == {"decode_ms_p95", "setup_s"}
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert set(checks) == {"frames_differ", "snr_gap_db", "frames_late"}
    assert checks["frames_differ"] == checks["frames_late"] == 0


def test_the_window_ends_on_a_whole_pass(monkeypatch):
    """A pass begun before the deadline runs to its end; none begins
    after it."""
    fed = []

    def feed_stream(pcm, rate, params, device, lat=None, kinds=None,
                    stop=None):
        fed.append(pcm)
        lat += [0.001, 0.002]
        kinds += ["scan", "scan"]
        return []
    clock = iter([0.0] + [1e9] * 100)       # past the deadline at once
    monkeypatch.setattr(stream, "feed_stream", feed_stream)
    monkeypatch.setattr(stream.time, "perf_counter", lambda: next(clock))
    lat, kinds, n, frames, failed = stream.calls_loop(
        [0, 1, 2], [[], [], []], 8000, {}, "cpu",
        (k % 3 for k in range(100)), deadline=0.5)
    assert n == 3 and fed == [0, 1, 2] and len(lat) == len(kinds) == 6


def test_frames_come_out_when_due_and_equal_the_reference(answers):
    params, pcm, sent, ref = answers
    got = stream.feed_stream(pcm, 8000, params, "cpu")
    read = stream.compare({0: [got]}, {0: ref})
    assert read["frames_differ"] == read["frames_late"] == 0
    assert read["snr_gap_db"] <= 1e-3
    assert recording.failed_frames([f for f, _ in got], sent) == 0
    assert sorted(i for _, i in got) == sorted(r["due"] for r in ref)
    assert max(i for _, i in got) < 25.0 * 8000 / params["feed_samples"]


def test_a_stream_that_holds_its_frames_to_the_end_is_late(
        answers, monkeypatch):
    from modem_tpu_torch.stream import StreamDecoder
    params, pcm, _, ref = answers
    feed, finish = StreamDecoder.feed, StreamDecoder.finish
    held = []

    def feed_held(self, samples):
        held.extend(feed(self, samples))
        return []

    def finish_all(self):
        return held + finish(self)
    monkeypatch.setattr(StreamDecoder, "feed", feed_held)
    monkeypatch.setattr(StreamDecoder, "finish", finish_all)
    got = stream.feed_stream(pcm, 8000, params, "cpu")
    read = stream.compare({0: [got]}, {0: ref})
    assert read["frames_differ"] == 0
    assert read["frames_late"] == len(ref) >= 1


@pytest.mark.parametrize("kind", ["altered", "dropped"])
def test_a_wrong_answer_differs(answers, kind):
    params, pcm, _, ref = answers
    got = stream.feed_stream(pcm, 8000, params, "cpu")
    if kind == "altered":
        f, i = got[0]
        got[0] = (dict(f, payload=bytes([f["payload"][0] ^ 1])
                       + f["payload"][1:]), i)
    else:
        got = got[1:]
    read = stream.compare({0: [got]}, {0: ref})
    assert read["frames_differ"] >= 1
    assert read["frames_late"] == (1 if kind == "dropped" else 0)


@pytest.mark.parametrize("seed", [21, 22])
def test_the_control_fails_the_cells_limits(tiny, seed):
    _, cell = tiny
    ctl = stream.readings(cell, seed, "cpu", control=True)
    assert any(ctl[k] > lim for k, lim in cell["limits"].items()), ctl


def test_the_loop_resolves_by_its_name():
    import importlib
    assert bench_run.loop_module("stream", REPO) is importlib.import_module(
        "harness.stream")


@pytest.mark.cuda
def test_syncs_stream_counts_every_wait_of_a_feed(card):
    """One header feed of the committed cell (the feed that runs the OSD
    on a capture's first frame): ``syncs.stream`` over it under the
    profiler equals the program's ``syncs`` counter over it, and that
    equals the synchronising operations torch's sync debug mode flags;
    the flagged sites are printed."""
    import torch
    from modem_tpu_torch import profiling
    from modem_tpu_torch.stream import StreamDecoder
    cell = common.cell_of(MANIFEST, CELL, REPO)
    cfg = M.config_of(cell["config"]["modem"])
    params = dict(stream.mix_of(cell), pool=1)
    pool, _ = recording.hour_pool(cfg, params, 5000000021, card)
    pcm, F = pool[0], params["feed_samples"]
    kinds = []
    stream.feed_stream(pcm, cfg.rate, params, card, lat=[], kinds=kinds)
    k = kinds.index("header")

    def at_header():
        sd = StreamDecoder(cfg.rate, channels=1, bits=16,
                           chunk_samples=params["chunk_samples"],
                           device=str(card))
        for i in range(k):
            sd.feed(pcm[i * F: (i + 1) * F])
        torch.cuda.synchronize()
        return sd, pcm[k * F: (k + 1) * F]

    sd, block = at_header()
    profiling.clear_spans()
    s0 = profiling.syncs
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        sd.feed(block)
        torch.cuda.synchronize()
    traced = profiling.syncs - s0
    read = common.reader(REPO, "syncs.stream")(None)
    sd, block = at_header()
    s0 = profiling.syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sd.feed(block)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counted = profiling.syncs - s0
    flagged = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
               if "synchronizing CUDA operation" in str(w.message)]
    print(f"syncs.stream {read}, counted {counted}, traced {traced}, "
          f"flagged {len(flagged)} (feed {k}): "
          f"{sorted(collections.Counter(flagged).items())}")
    assert read == traced == counted
    assert counted == len(flagged), sorted(flagged)
