"""The recording loop on the CPU with short wire-size mode-6 recordings
(two in the pool, two frames each): it runs, its answers equal the
reference's, its window holds whole passes of the pool, a broken timed
path is not correct, and the bfloat16 control fails the cell's limits.
The recording decoder reads each frame's mode from its header and builds
that mode's pipeline, so the toy numerology of ``toycell.py`` cannot go
through it.  On the card: ``syncs.recording`` against torch's sync debug
mode over one call of the committed cell."""

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
from harness import common, readings, recording
from reference import modem as M

REPO = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "m6-8k.decode-hour"
TINY = {"loop": "recording", "pool": 2, "hour_s": 25.0, "frames": 2,
        "gap_s": 1.0,
        "channel": {"awgn_db": -30.0, "cfo_hz": 234.567, "sfo_ppm": 147.0,
                    "spread": 10},
        "adaptive": True, "check_hours": 2, "trace_calls": 1}
SEED = 2 ** 40 + 3


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tinyrec")
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "benchmark" / "traffic" / "tiny-r.json").write_text(
        json.dumps(TINY))
    limits = common.cell_of(m, CELL, REPO)["limits"]
    (root / "benchmark" / "workloads" / "m6-8k.tiny-r.json").write_text(
        json.dumps({"limits": limits}))
    m["workloads"].append({"name": "m6-8k.tiny-r", "config": "m6-8k",
                           "traffic": "tiny-r", "chips": 1, "why": "tests"})
    for e in m["end_to_end"] + m["per_layer"]:
        if CELL in e.get("workloads", []):
            e["workloads"].append("m6-8k.tiny-r")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root, common.cell_of(m, "m6-8k.tiny-r", root)


def run_tiny(root, trace=0):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = bench_run.main(["--workload", "m6-8k.tiny-r", "--seed",
                             str(SEED), "--seconds", "1", "--trace",
                             str(trace)], device="cpu", root=root)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_the_recording_loop_runs_and_agrees(tiny):
    rc, res = run_tiny(tiny[0])
    assert rc == 0 and res["correct"] is True
    assert res["failed"] == 0
    # whole passes: every recording of the pool as often as the others
    per_pass = TINY["pool"] * TINY["frames"]
    assert res["attempted"] >= per_pass and res["attempted"] % per_pass == 0
    assert set(res["metrics"]) == {"decode_ms_p95", "setup_s"}
    assert res["checks"]["frames_differ"]["value"] == 0


def test_the_window_ends_on_a_whole_pass(monkeypatch):
    """A pass begun before the deadline runs to its end; none begins
    after it."""
    calls = []

    def decode(pcm, rate, params, device):
        calls.append(pcm)
        return []
    clock = iter([0.0] + [1e9] * 100)       # past the deadline at once
    monkeypatch.setattr(recording, "decode", decode)
    monkeypatch.setattr(recording.time, "perf_counter", lambda: next(clock))
    lat, n, frames, failed = recording.calls_loop(
        [0, 1, 2], [[], [], []], 8000, TINY, "cpu",
        (k % 3 for k in range(100)), deadline=0.5)
    assert n == 3 and calls == [0, 1, 2] and len(lat) == 3


def test_failed_counts_missing_and_unsent_frames():
    keys = [(b"a", "X1"), (b"b", "X2")]
    ok = lambda p, c: dict(ok=True, payload=p, call_sign=c)  # noqa: E731
    assert recording.failed_frames([ok(b"a", "X1"), ok(b"b", "X2")],
                                   keys) == 0
    assert recording.failed_frames([ok(b"a", "X1")], keys) == 1
    assert recording.failed_frames([ok(b"a", "X1"), ok(b"a", "X1"),
                                    ok(b"b", "X2")], keys) == 1
    assert recording.failed_frames([dict(ok=False), ok(b"c", "X2")],
                                   keys) == 3


def broken(kind):
    """decode_recording_auto with a fault planted in its answer."""
    from modem_tpu_torch import pipeline
    real = pipeline.decode_recording_auto
    last = {}

    def decode_recording_auto(*a, **kw):
        frames = real(*a, **kw)
        if kind == "altered":                # a payload altered
            f = frames[0]
            f["payload"] = bytes([f["payload"][0] ^ 1]) + f["payload"][1:]
        elif kind == "dropped":              # a frame left out
            frames = frames[1:]
        elif kind == "twice":                # a frame reported twice
            frames = frames[:1] + frames
        elif kind == "stale":                # the last call's answer
            prev = last.get("frames")
            last["frames"] = frames
            if prev is not None:
                frames = prev
        return frames
    return decode_recording_auto


@pytest.mark.parametrize("kind", ["altered", "dropped", "twice", "stale"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, kind):
    from modem_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "decode_recording_auto", broken(kind))
    rc, res = run_tiny(tiny[0])
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["frames_differ"]["value"] > 0


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_the_control_fails_and_the_program_passes_the_cells_limits(
        tiny, seed):
    _, cell = tiny
    ctl = readings.readings(cell, seed, "cpu", control=True)
    prog = readings.readings(cell, seed, "cpu")
    assert any(ctl[k] > lim for k, lim in cell["limits"].items()), ctl
    assert all(prog[k] <= lim for k, lim in cell["limits"].items()), prog


def test_the_generator_repeats_for_a_seed():
    cfg = M.config_of({"rate": 8000, "mode": 6, "freq_off": 2000})
    params = dict(TINY, pool=1)
    a, sa = recording.hour_pool(cfg, params, SEED, "cpu")
    b, sb = recording.hour_pool(cfg, params, SEED, "cpu")
    c, _ = recording.hour_pool(cfg, params, SEED + 1, "cpu")
    assert (a[0] == b[0]).all() and sa == sb and not (a[0] == c[0]).all()
    assert a[0].dtype.name == "int16" and a[0].shape == (200_000,)
    assert len(set(sa[0])) == TINY["frames"]       # each its own payload


@pytest.mark.cuda
def test_syncs_recording_counts_every_wait_of_a_call(card):
    """One call of the committed cell's decode: ``syncs.recording`` over
    it under the profiler equals the program's ``syncs`` counter over it,
    and that equals the synchronising operations torch's sync debug mode
    flags plus the batch's event synchronise (one a mode group), which
    the mode does not flag.  The flagged sites are printed."""
    import torch
    from modem_tpu_torch import profiling
    cell = common.cell_of(MANIFEST, CELL, REPO)
    cfg = M.config_of(cell["config"]["modem"])
    params = dict(cell["params"], pool=1)
    pool, _ = recording.hour_pool(cfg, params, 5000000011, card)
    call = lambda: recording.decode(pool[0], cfg.rate, params, card)  # noqa
    frames = call()                       # builds, plans and tables
    groups = len({f["mode"] for f in frames if f["mode"] is not None})
    profiling.clear_spans()
    s0 = profiling.syncs
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        call()
        torch.cuda.synchronize()
    traced = profiling.syncs - s0
    read = common.reader(REPO, "syncs.recording")(None)
    torch.cuda.synchronize()
    s0 = profiling.syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counted = profiling.syncs - s0
    flagged = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
               if "synchronizing CUDA operation" in str(w.message)]
    print(f"syncs.recording {read}, counted {counted}, traced {traced}, "
          f"flagged {len(flagged)}, groups {groups}: "
          f"{sorted(collections.Counter(flagged).items())}")
    assert read == traced == counted
    assert counted == len(flagged) + groups, sorted(flagged)
