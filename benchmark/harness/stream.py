"""The stream loop: one live capture after another, each fed to a new
``modem_tpu_torch.stream.StreamDecoder(rate, channels=1, bits=16)``
``feed_samples`` at a time as fast as it returns, then ended with
``finish()``, as ``arecord -f S16_LE -r 8000 -c 1 | decode`` feeds a
live decoder (the command line's ``decode-stream``).

Each ``feed`` and ``finish`` is one timed call, from the host int16
block in to the emitted frames' host dicts out; ``decode_ms_p95`` is
the 95th percentile of every call of the window.  The window walks the
pool in whole passes, as the recording loop does: a pass started before
the deadline finishes, so every capture is fed equally often.

Set-up makes the pool from the seed (``harness.recording.hour_pool``:
int16 in host memory, each frame through the chain's multipath, CFO and
SFO, noise over the capture) and feeds one whole capture, which builds
every shape the window uses: the fine stage, the header batch at [1],
kernel B at [1] and the FFT plans.  ``failed`` counts each sent frame
that no ``ok`` frame of its capture delivers, and each ``ok`` frame that
delivers no sent one.  The frames of ``check_hours`` captures drawn from
the seed, and the call that emitted each, are kept from every pass for
the comparison with ``reference.stream``: what was answered
(``frames_differ``, ``snr_gap_db``, as the recording loop reads them)
and when (``frames_late``: frames the reference says were due that came
out at a later call, or never).  With ``--trace 1`` the first
``trace_feeds`` feeds of capture 0, on a new decoder, run under the
profiler after the window.

The deployment (configuration ``stream``): ``feed_samples`` a call,
the scan's ``chunk_samples``, ``session_s`` seconds a capture.  The mix
(``benchmark/traffic/<mix>.json``): ``pool``, ``frames``, ``gap_s``,
``channel`` as the recording loop's, ``check_hours`` and
``trace_feeds``.

The cell's correctness readings, as ``harness/readings.py`` gives them
for the other loops:

    python3 benchmark/harness/stream.py --workload <cell> \
        --seeds <n> ... [--control-seeds <n> ...] [--out <file.json>]
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(BENCH.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import common, recording, trace  # noqa: E402
from harness.common import note, percentile  # noqa: E402
from harness.layers import Run  # noqa: E402
from harness.spans import named, per_request, records  # noqa: E402
from reference import modem as M  # noqa: E402
from reference.frontend import identity, to_bf16  # noqa: E402
from reference.stream import decode_stream  # noqa: E402

NUMBERS = ("frames_differ", "snr_gap_db", "frames_late")
KINDS = ("header", "payload", "scan")
CALLS = ("stream.feed", "stream.finish")       # the program's request spans


def mix_of(cell: dict) -> dict:
    """The mix's parameters with the deployment's: ``hour_s`` (the
    capture's seconds, as ``recording.hour_pool`` reads it), the feed
    and the chunk."""
    live = cell["config"]["stream"]
    return dict(cell["params"], hour_s=live["session_s"],
                feed_samples=live["feed_samples"],
                chunk_samples=live["chunk_samples"])


def call_host_ms(*names):
    """Host ms of every span of ``names``, a stream call (``feed`` or
    ``finish``) of the traced slice; None where the program recorded no
    call."""
    recs = records()
    return per_request((r.host_ms for n in names for r in named(recs, n)),
                       [r for n in CALLS for r in named(recs, n)])


def call_counter(key: str):
    """A counter's delta over each stream call of the traced slice, a
    call."""
    recs = records()
    calls = [r for n in CALLS for r in named(recs, n)]
    return per_request((r.counts[key] for r in calls), calls)


def feed_stream(pcm: np.ndarray, rate: int, params: dict, device,
                lat=None, kinds=None, stop=None) -> list:
    """One capture through a new StreamDecoder: its first ``stop`` feeds
    (all, then ``finish()``, by default).  Returns [(frame, index of the
    call that emitted it)]; appends each call's seconds to ``lat`` and
    its kind to ``kinds``: "header" where it ran the OSD, else
    "payload" where it emitted a frame, else "scan"."""
    from torch.profiler import record_function

    from modem_tpu_torch import profiling
    from modem_tpu_torch.stream import StreamDecoder
    sd = StreamDecoder(rate, channels=1, bits=16,
                       chunk_samples=params["chunk_samples"],
                       device=str(device))
    F = params["feed_samples"]
    starts = list(range(0, pcm.shape[0], F))[:stop]
    out = []
    for i in range(len(starts) + (stop is None)):
        s0 = profiling.osd_steps
        with record_function("bench.feed"):
            t0 = time.perf_counter()
            got = (sd.feed(pcm[starts[i]: starts[i] + F])
                   if i < len(starts) else sd.finish())
            t1 = time.perf_counter()
        if lat is not None:
            lat.append(t1 - t0)
        if kinds is not None:
            kinds.append("header" if profiling.osd_steps > s0 else
                         "payload" if got else "scan")
        out += [(f, i) for f in got]
    return out


def calls_loop(pool, sent, rate, params, device, order, keep=None,
               deadline=None):
    """Feed pool[j] whole for j in ``order``, by whole passes of the pool
    when ``deadline`` is given: no pass starts after it.  Returns the
    calls' latencies (s) and kinds, captures fed, frames sent and frames
    failed."""
    lat, kinds, fed, frames, failed = [], [], 0, 0, 0
    P = len(pool)
    for k, j in enumerate(order):
        if (deadline is not None and k % P == 0
                and time.perf_counter() >= deadline):
            break
        got = feed_stream(pool[j], rate, params, device, lat, kinds)
        fed += 1
        frames += len(sent[j])
        failed += recording.failed_frames([f for f, _ in got], sent[j])
        if keep is not None:
            keep(j, got)
    return lat, kinds, fed, frames, failed


def reference_answers(cfg: M.Config, config: dict, params: dict, pcms,
                      device, q=identity) -> list:
    """The reference's frames of each capture, with ``due`` and the
    payload bytes and call sign text of the program's answers."""
    dec = config["decoder"]
    out = []
    for pcm in pcms:
        frames = decode_stream(pcm, cfg.rate, params["feed_samples"],
                               dec["list_size"], dec["sync_stride"], device,
                               q)
        for f in frames:
            f["call_sign"] = M.base37_text(f["call"]) if f["call"] else ""
            if f.get("ok"):
                f["payload"] = M.payload_bytes(f["bits"])
        out.append(frames)
    return out


def late_frames(kept: dict, refs: dict) -> int:
    """Over every kept answer: the reference's frames with a due call
    that no frame at their position came out by."""
    late = 0
    for j, ref in refs.items():
        for got in kept[j]:
            first = {}
            for f, i in got:
                pos = int(f["pos"])
                first[pos] = min(first.get(pos, i), i)
            late += sum(1 for r in ref if r["due"] is not None
                        and first.get(int(r["pos"]), math.inf) > r["due"])
    return late


def compare(kept: dict, refs: dict) -> dict:
    """The numbers compared with the cell's limits."""
    got = recording.compare(
        {j: [[f for f, _ in ans] for ans in answers]
         for j, answers in kept.items()}, refs)
    if math.isinf(got["frames_differ"]):
        return {k: math.inf for k in NUMBERS}
    return dict(got, frames_late=late_frames(kept, refs))


def class_note(lat, kinds) -> str:
    """p50 and p95 ms of each kind of call, and how many."""
    parts = []
    for kind in KINDS:
        v = [t for t, k in zip(lat, kinds) if k == kind]
        if v:
            parts.append(f"{kind} {len(v)} calls p50 "
                         f"{percentile(v, 50) * 1e3:.3f} p95 "
                         f"{percentile(v, 95) * 1e3:.3f}")
    return "; ".join(parts)


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float, root) -> dict:
    params = mix_of(cell)
    cfg = M.config_of(cell["config"]["modem"])
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    from modem_tpu_torch import stream  # noqa: F401  (the program)
    note("program imported", time.time() - t_start)
    pool, sent = recording.hour_pool(cfg, params, seed, device)
    P = len(pool)
    sync()
    note(f"pool of {P} captures of {pool[0].shape[0]} samples made",
         time.time() - t_start)
    feed_stream(pool[0], cfg.rate, params, device)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_start
    note("set-up", setup_s)

    rows = recording.sample(params, seed)
    kept = {int(j): [] for j in rows}

    def keep(j, got):
        if j in kept:
            kept[j].append(got)

    order = (k % P for k in range(10 ** 9))
    with common.old_objects_frozen():
        t0 = time.perf_counter()
        lat, kinds, fed, frames, failed = calls_loop(
            pool, sent, cfg.rate, params, device, order, keep=keep,
            deadline=t0 + seconds)
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    note(f"window: {fed} captures, {len(lat)} calls, {frames} frames, "
         f"{failed} failed; ms a call p50 {percentile(lat, 50) * 1e3:.3f} "
         f"p95 {percentile(lat, 95) * 1e3:.3f}; {class_note(lat, kinds)}",
         window_s)
    out = dict(attempted=frames, failed=failed, memory_peak_bytes=peak,
               e2e={"decode_ms_p95": percentile(lat, 95) * 1e3,
                    "setup_s": setup_s},
               per_layer={}, device_extra={}, breakdown=None)
    if traced:
        from modem_tpu_torch import profiling
        profiling.clear_spans()
        body = lambda: feed_stream(  # noqa: E731
            pool[0], cfg.rate, params, device, stop=params["trace_feeds"])
        summary = None
        if cuda:
            summary = trace.profile(body)
            out["device_extra"] = dict(busy_s=summary.busy_s,
                                       window_s=summary.window_s)
            out["breakdown"] = dict(device_ops=summary.device_ops,
                                    idle_gaps=summary.idle_gaps)
        else:
            body()
        r = Run(cell=cell, cfg=cfg, device=device, pipe=None, pool=pool,
                spans={}, counters=dict(calls=len(lat)), trace=summary)
        out["per_layer"] = {m["name"]: m["_read"](r)
                            for m in cell["per_layer"]}
        del r

    recording.free_program()
    t_ref = time.perf_counter()
    with torch.no_grad():
        refs = dict(zip((int(j) for j in rows), reference_answers(
            cfg, cell["config"], params, [pool[j] for j in rows], device)))
    got = compare(kept, refs)
    out["checks"] = {k: (got[k], cell["limits"][k]) for k in NUMBERS
                     if k in cell["limits"]}
    note(f"window {window_s:.3f} s, {len(lat)} calls; reference over "
         f"{len(rows)} capture(s)", time.perf_counter() - t_ref)
    return out


def readings(cell: dict, seed: int, device, control: bool = False) -> dict:
    """The numbers compared for one seed: each capture drawn from the
    seed fed once through a StreamDecoder (control=False), or the
    reference computed with every stage's output rounded to bfloat16 in
    the program's place, each frame emitted at its own due call; against
    the reference."""
    params = mix_of(cell)
    cfg = M.config_of(cell["config"]["modem"])
    device = torch.device(device)
    pool, _ = recording.hour_pool(cfg, params, seed, device)
    rows = [int(j) for j in recording.sample(params, seed)]
    pcms = [pool[j] for j in rows]
    if control:
        with torch.no_grad():
            low = reference_answers(cfg, cell["config"], params, pcms,
                                    device, q=to_bf16)
        kept = {j: [[(dict(f, flips=f.get("flips"), snr=f.get("snr"),
                           payload=f.get("payload", b"")),
                      0 if f["due"] is None else f["due"]) for f in ans]]
                for j, ans in zip(rows, low)}
    else:
        kept = {j: [feed_stream(p, cfg.rate, params, device)]
                for j, p in zip(rows, pcms)}
        recording.free_program()
    with torch.no_grad():
        refs = dict(zip(rows, reference_answers(cfg, cell["config"], params,
                                                pcms, device)))
    return compare(kept, refs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = BENCH.parent
    common.cache_dirs(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = common.cell_of(common.load_json(root / "BENCHMARK.json"),
                          args.workload, root)
    out = {"workload": args.workload, "program": {}, "control": {}}
    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            got = readings(cell, seed, "cuda", control=kind == "control")
            out[kind][str(seed)] = got
            print(f"{args.workload} {kind} seed {seed}: {got} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
