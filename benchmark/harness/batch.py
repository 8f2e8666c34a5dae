"""The batch loop: one process serving a pool of recordings through
``modem_tpu_torch.pipeline.AdaptivePipeline``, pipelined as a batch
decoder runs it (dispatch batch i, then resolve batch i - 1), closed:
the next batch goes out as soon as the host is free.

Set-up builds the pipeline with the configuration's decoder settings,
makes the pool from the seed, and runs the loop once over the pool (and
the list decoder once at its group shape, which only an escalation would
otherwise load): every shape the window uses.  The window then runs for
``seconds``; a batch dispatched before it closes is resolved and counted
in it.  Each resolved frame is checked against the payload sent
(``failed``) on a thread beside the loop; ``check_rows`` rows of each
pool batch, drawn from the seed, are kept from every batch for the
comparison with the reference.  With ``--trace 1`` a slice of
``trace_batches`` batches runs under the profiler after the window.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from reference import modem as M

from . import check, common, inputs, trace
from .common import note, percentile, seed_for
from .layers import Run

RESULT_KEYS = ("ok", "bits", "p0", "cfo_rad", "snr", "flips", "sync_gate")
WARM_BATCHES = 2


def program_pipeline(config: dict, device):
    """The system under test, as the configuration states it."""
    from modem_tpu_torch.numerology import toy_mode
    from modem_tpu_torch.pipeline import AdaptivePipeline

    modem, dec = config["modem"], config["decoder"]
    kw = {}
    mode = modem["mode"]
    if not isinstance(mode, int):        # a toy numerology (CPU tests)
        kw = dict(mode_spec=toy_mode(**mode),
                  symbol_len_override=modem["symbol_len"])
        mode = 0
    return AdaptivePipeline(modem["rate"], mode, list_size=dec["list_size"],
                            fallback_batch=dec["fallback_batch"],
                            sync_stride=dec["sync_stride"], device=device,
                            **kw)


def failed_frames(host: dict, want: np.ndarray) -> int:
    """Frames of a resolved batch whose CRC failed or whose payload bits
    differ from the ones sent."""
    got = np.ascontiguousarray(host["bits"], dtype=np.uint8)
    if want.shape[1] % 8 == 0:
        differ = (got.view(np.uint64) != want.view(np.uint64)).any(1)
    else:
        differ = (got != want).any(1)
    return int((differ | ~host["ok"]).sum())


class Checker:
    """Checks each resolved batch against the payloads sent (and keeps
    the rows drawn for the comparison) on a thread of its own, so that
    the serving loop's host time is the system's: numpy's comparisons
    release the interpreter lock.  :meth:`close` waits for every check
    and returns the failed frames."""

    def __init__(self, sent, keep=None):
        self.sent, self.keep = sent, keep
        self.failed = 0
        self.error = None
        self.queue = queue.SimpleQueue()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        while (item := self.queue.get()) is not None:
            if self.error is not None:
                continue
            try:
                j, host = item
                self.failed += failed_frames(host, self.sent[j])
                if self.keep is not None:
                    self.keep(j, host)
            except Exception as e:      # re-raised by close()
                self.error = e

    def put(self, j: int, host: dict) -> None:
        self.queue.put((j, host))

    def close(self) -> int:
        self.queue.put(None)
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.failed


def serve(pipe, pool, sent, batches, keep=None, spans=None, deadline=None):
    """The pipelined loop over ``batches`` pool indices (or until
    ``deadline``, a perf_counter time: no dispatch after it).  Returns
    per-batch latencies (s), frames, failed frames, escalated frames and
    the perf_counter time at which the last batch was resolved."""
    from torch.profiler import record_function

    lat, frames, escalated = [], 0, 0
    checker = Checker(sent, keep)
    pending = None

    def resolve(p):
        nonlocal frames, escalated
        j, t0, handle = p
        with record_function("bench.resolve"):
            t1 = time.perf_counter()
            host = pipe.resolve(handle)
            t2 = time.perf_counter()
        lat.append(t2 - t0)
        if spans is not None:
            spans["resolve"].append(t2 - t1)
        frames += len(host["ok"])
        escalated += pipe.last_fallbacks
        checker.put(j, host)

    try:
        for j in batches:
            if deadline is not None and time.perf_counter() >= deadline:
                break
            with record_function("bench.dispatch"):
                t0 = time.perf_counter()
                handle = pipe.decode_batch_async(pool[j])
                if spans is not None:
                    spans["dispatch"].append(time.perf_counter() - t0)
            if pending is not None:
                resolve(pending)
            pending = (j, t0, handle)
        if pending is not None:
            resolve(pending)
        end = time.perf_counter()
    finally:
        failed = checker.close()
    return lat, frames, failed, escalated, end


def sample_rows(params: dict, seed: int, pool: int) -> list:
    """The rows of each pool batch whose answers are compared with the
    reference, drawn from the seed."""
    rng = np.random.default_rng(seed_for(seed, "sample"))
    k = min(params["check_rows"], params["batch"])
    return [np.sort(rng.choice(params["batch"], k, replace=False))
            for _ in range(pool)]


def window_metrics(lat, frames: int, window_s: float, setup_s: float):
    """The end-to-end metrics of a batch window: every frame resolved in
    it over its seconds, and the 95th percentile of every batch's
    latency."""
    return {"frames_per_s": frames / window_s,
            "batch_ms_p95": percentile(lat, 95) * 1e3, "setup_s": setup_s}


def cycle(pool_size: int, start: int = 0):
    j = start
    while True:
        yield j % pool_size
        j += 1


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float, root) -> dict:
    params = cell["params"]
    cfg = M.config_of(cell["config"]["modem"])
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    pipe = program_pipeline(cell["config"], device)
    sync()
    note("program imported and its pipeline built", time.time() - t_start)
    pool, sent = inputs.batch_pool(cfg, params, seed, device)
    P = len(pool)
    sync()
    note(f"pool of {P} x {params['batch']} made", time.time() - t_start)

    # warm-up: the loop over two batches (every recording of a cell has
    # one length, so every batch one set of shapes), and the list decoder
    # once at its group shape on the first batch's LLRs
    serve(pipe, pool, sent, range(min(WARM_BATCHES, P)))
    front = pipe.sc.demod(pool[0])
    idx = torch.zeros(pipe.fallback_batch, dtype=torch.int64, device=device)
    pipe.scl.fetch(pipe.scl._fec_select(
        {k: v.index_select(0, idx) for k, v in front.items()}))
    del front
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_start
    note("set-up", setup_s)

    rows = sample_rows(params, seed, P)
    kept = {j: [] for j in range(P)}

    def keep(j, host):
        kept[j].append({key: np.array(host[key][rows[j]])
                        for key in RESULT_KEYS})

    held = {"dispatch": [], "resolve": []}
    with common.old_objects_frozen():
        t0 = time.perf_counter()
        lat, frames, failed, escalated, end = serve(
            pipe, pool, sent, cycle(P), keep=keep, spans=held,
            deadline=t0 + seconds)
    window_s = end - t0
    note(f"window: {len(lat)} batches; host ms a batch: dispatch mean "
         f"{np.mean(held['dispatch']) * 1e3:.3f} p95 "
         f"{percentile(held['dispatch'], 95) * 1e3:.3f}, resolve mean "
         f"{np.mean(held['resolve']) * 1e3:.3f} p95 "
         f"{percentile(held['resolve'], 95) * 1e3:.3f}; latency ms p50 "
         f"{percentile(lat, 50) * 1e3:.3f} max {max(lat) * 1e3:.3f}",
         window_s)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    out = dict(attempted=frames, failed=failed, memory_peak_bytes=peak,
               e2e=window_metrics(lat, frames, window_s, setup_s),
               per_layer={}, device_extra={}, breakdown=None)
    if traced:
        spans = {"dispatch": [], "resolve": []}
        n = params["trace_batches"]
        summary = None
        if cuda:
            summary = trace.profile(lambda: serve(
                pipe, pool, sent, [j % P for j in range(n)], spans=spans))
            out["device_extra"] = dict(busy_s=summary.busy_s,
                                       window_s=summary.window_s)
            out["breakdown"] = dict(device_ops=summary.device_ops,
                                    idle_gaps=summary.idle_gaps)
        else:
            serve(pipe, pool, sent, [j % P for j in range(n)], spans=spans)
        r = Run(cell=cell, cfg=cfg, device=device, pipe=pipe, pool=pool,
                spans=spans, counters=dict(frames=frames,
                                           escalated=escalated,
                                           latency_s=lat),
                trace=summary)
        out["per_layer"] = {m["name"]: m["_read"](r)
                            for m in cell["per_layer"]}
        del r

    # the comparison: the program's state is freed first
    recs = [pool[j].index_select(0, torch.as_tensor(rows[j], device=device))
            for j in range(P)]
    del pipe, pool
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    out["checks"] = check.batch_checks(cfg, cell, recs, kept, device)
    note(f"reference over {sum(len(r) for r in rows)} recordings",
         time.perf_counter() - t_ref)
    return out

