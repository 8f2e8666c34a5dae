"""The recording loop: one caller decoding long mono 16-bit recordings
whole, one after another, with ``modem_tpu_torch.pipeline.
decode_recording_auto(PcmRecording(samples, 16, rate), rate,
channels=1, adaptive=...)``, as the command line's ``decode-all
[--adaptive]`` decodes a WAV file.

Set-up makes the pool of recordings from the seed (int16 in host
memory), and decodes one of them, and the list decoder once at its group
shape, which only a CRC failure would otherwise load: every shape the
window uses (every recording of a mix has one length and one frame
count).  The window then decodes the pool in turn, closed, for
``seconds``, and ends on a whole pass: a pass started before the
deadline finishes and is counted, so every recording is decoded equally
often and the share of frames that fail cannot depend on where the
deadline fell.  Each call gets a new ``PcmRecording``, whose upload is
part of the call, and no ``stats`` (which would synchronise the card at
every stage).  ``failed`` counts each sent frame that no reported
``ok`` frame delivers with its payload and call sign, and each ``ok``
frame that delivers no sent one; the answers of ``check_hours``
recordings drawn from the seed are kept from every call for the
comparison with the reference.

Parameters of a recording mix (``benchmark/traffic/<mix>.json``):

  * ``pool``: recordings made in set-up; ``hour_s``: seconds each;
  * ``frames``: frames a recording, at seeded offsets, one slot of
    (length - gap) / frames samples each, at least ``gap_s`` seconds
    apart; ``modes``: their modes in turn (default: the configuration's);
    each frame its own payload and call sign;
  * ``channel``: the demonstration chain's multipath, CFO and SFO on
    each frame, then ``awgn_db`` of noise over the whole recording,
    which is then quantised to 16 bits;
  * ``adaptive``: ``decode_recording_auto``'s (which, as the command
    line, takes its default of at most 64 frames a recording);
  * ``check_hours``: recordings compared with the reference;
    ``trace_calls``: calls traced after the window with ``--trace 1``.
"""

from __future__ import annotations

import collections
import gc
import math
import time

import numpy as np
import torch

from reference import channel as C
from reference import modem as M
from reference.encoder import Encoder
from reference.frontend import identity
from reference.recording import decode_recording

from . import common, inputs, trace
from .common import note, percentile, seed_for
from .layers import Run


def pcm16_raw(x: torch.Tensor) -> torch.Tensor:
    """Samples in [-1, 1] as 16-bit PCM stores them (round half to even,
    clipped)."""
    return torch.clamp(torch.round(x * 32767.0), -32768, 32767).to(
        torch.int16)


def mix_modes(cfg: M.Config, params: dict) -> list:
    """The modes of a recording's frames in turn."""
    return params.get("modes") or [cfg.mode.oper_mode]


def hour_pool(cfg: M.Config, params: dict, seed: int, device):
    """(recordings: int16 numpy [T] each, the frames sent in each as a
    list of (payload bytes, call sign text))."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_for(seed, "inputs"))
    rng = np.random.default_rng(seed_for(seed, "layout"))
    rate = cfg.rate
    T = int(round(params["hour_s"] * rate))
    n = params["frames"]
    modes = mix_modes(cfg, params)
    gap = int(round(params["gap_s"] * rate))
    chan = params["channel"]
    encoders = {}
    pool, sent = [], []
    for _ in range(params["pool"]):
        waves, keys = [None] * n, [None] * n
        for mode in dict.fromkeys(modes):
            rows = [i for i in range(n) if modes[i % len(modes)] == mode]
            if not rows:
                continue
            mcfg = M.Config(rate, M.MODES[mode], cfg.freq_off)
            enc = encoders.get(mode) or encoders.setdefault(
                mode, Encoder(mcfg, device))
            bits = inputs.payload_bits(mcfg.mode.data_bytes, len(rows), gen,
                                       device)
            call = torch.randint(1, 37 ** 9, (len(rows),), generator=gen,
                                 device=device).cpu().numpy()
            wave = C.impair_real(enc.encode(bits, call).real.double(), rate,
                                 cfo_hz=chan["cfo_hz"],
                                 sfo_ppm=chan["sfo_ppm"],
                                 spread=chan["spread"])
            for r, i in enumerate(rows):
                waves[i] = wave[r]
                keys[i] = (M.payload_bytes(bits[r].cpu().numpy()),
                           M.base37_text(int(call[r])))
        longest = max(w.shape[0] for w in waves)
        slot = (T - gap) // n
        if slot < longest + gap:
            raise ValueError(f"{n} frames of {longest} samples do not fit "
                             f"{T} samples {gap} apart")
        starts = (rng.integers(0, slot - longest - gap + 1, n)
                  + np.arange(n) * slot + gap)
        x = torch.zeros(T, dtype=torch.float64, device=device)
        for s0, w in zip(starts, waves):
            x[s0: s0 + w.shape[0]] += w
        x += 10.0 ** (chan["awgn_db"] / 20.0) * torch.randn(
            T, generator=gen, device=device, dtype=torch.float64)
        pool.append(pcm16_raw(x).cpu().numpy())
        sent.append(keys)
        del x
    return pool, sent


def failed_frames(frames: list, keys: list) -> int:
    """Sent frames that no ok frame delivers, plus ok frames that deliver
    no sent frame (each sent frame delivered once)."""
    due = collections.Counter(keys)
    extra = 0
    for f in frames:
        if not f["ok"]:
            continue
        key = (f["payload"], f["call_sign"])
        if due[key] > 0:
            due[key] -= 1
        else:
            extra += 1
    return sum(due.values()) + extra


def decode(pcm: np.ndarray, rate: int, params: dict, device) -> list:
    """The timed call: a new PcmRecording of the samples, decoded
    whole."""
    from modem_tpu_torch import pipeline
    from modem_tpu_torch.ingest import PcmRecording
    return pipeline.decode_recording_auto(
        PcmRecording(pcm, 16, rate), rate, channels=1,
        adaptive=params["adaptive"], device=str(device))


def calls_loop(pool, sent, rate, params, device, order, keep=None,
               spans=None, deadline=None):
    """Decode pool[j] for j in ``order``, by whole passes of the pool
    when ``deadline`` is given: no pass starts after it.  Returns
    per-call latencies (s), calls, frames sent and frames failed."""
    from torch.profiler import record_function
    lat, frames, failed = [], 0, 0
    P = len(pool)
    for k, j in enumerate(order):
        if (deadline is not None and k % P == 0
                and time.perf_counter() >= deadline):
            break
        with record_function("bench.decode_all"):
            t0 = time.perf_counter()
            got = decode(pool[j], rate, params, device)
            t1 = time.perf_counter()
        lat.append(t1 - t0)
        if spans is not None:
            spans["decode_all"].append(t1 - t0)
        frames += len(sent[j])
        failed += failed_frames(got, sent[j])
        if keep is not None:
            keep(j, got)
    return lat, len(lat), frames, failed


def warm_list_decoder(cfg: M.Config, pcm: np.ndarray, params: dict, device):
    """The list decoder of every mode of the mix once at its group shape,
    on a window of the recording (escalation only runs it on a CRC
    failure)."""
    from modem_tpu_torch.ingest import PcmRecording
    from modem_tpu_torch.pipeline import cached_adaptive_pipeline
    rec = PcmRecording(pcm, 16, cfg.rate)
    for mode in dict.fromkeys(mix_modes(cfg, params)):
        pipe = cached_adaptive_pipeline(cfg.rate, mode,
                                        mls_convention="galois",
                                        device=str(device))
        wins, _ = pipe.windows_at(rec, [0])
        front = pipe.sc.demod(wins)
        idx = torch.zeros(pipe.fallback_batch, dtype=torch.int64,
                          device=device)
        pipe.scl.fetch(pipe.scl._fec_select(
            {k: v.index_select(0, idx) for k, v in front.items()}))


def free_program() -> None:
    """Drop the program's cached decoder and pipelines, and their device
    memory."""
    from modem_tpu_torch import decoder, pipeline
    decoder.cached_decoder.cache_clear()
    pipeline.cached_adaptive_pipeline.cache_clear()
    pipeline.cached_pipeline.cache_clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_answers(cfg: M.Config, config: dict, pcms, device,
                      q=identity) -> list:
    """The reference's frames of each recording, with the payload bytes
    and call sign text of the program's answers."""
    dec = config["decoder"]
    out = []
    for pcm in pcms:
        frames = decode_recording(pcm, cfg.rate, dec["list_size"],
                                  dec["sync_stride"], device, q)
        for f in frames:
            f["call_sign"] = M.base37_text(f["call"]) if f["call"] else ""
            if f.get("ok"):
                f["payload"] = M.payload_bytes(f["bits"])
        out.append(frames)
    return out


NUMBERS = ("frames_differ", "snr_gap_db")


def _by_pos(frames: list) -> dict:
    out = collections.defaultdict(list)
    for f in frames:
        out[int(f["pos"])].append(f)
    return out


def compare(kept: dict, refs: dict) -> dict:
    """frames_differ: over every kept answer, the frames that one side
    reports and the other does not (matched by position, each once), and
    the matched frames whose mode, call sign or verdict differ, or (where
    the reference decoded) whose payload or bit flips differ; snr_gap_db:
    the widest gap of the per-row SNR where both decoded the payload."""
    differ, snr, seen = 0, 0.0, 0
    for j, ref in refs.items():
        want = _by_pos(ref)
        for got in kept[j]:
            seen += 1
            have = _by_pos(got)
            for pos in set(want) | set(have):
                a, b = have.get(pos, []), want.get(pos, [])
                differ += abs(len(a) - len(b))
                for g, r in zip(a, b):
                    bad = (g["mode"] != r["mode"]
                           or g["call_sign"] != r["call_sign"]
                           or bool(g["ok"]) != bool(r["ok"]))
                    if r["ok"]:
                        bad = bad or (g["payload"] != r["payload"]
                                      or g["flips"] != r["flips"])
                    differ += int(bad)
                    if r.get("snr") is not None and g.get("snr") is not None:
                        snr = max(snr, float(np.abs(
                            np.asarray(g["snr"]) - r["snr"]).max()))
    if not seen:
        return {k: math.inf for k in NUMBERS}
    return dict(frames_differ=differ, snr_gap_db=snr)


def sample(params: dict, seed: int) -> np.ndarray:
    """The recordings whose answers are compared, drawn from the seed."""
    rng = np.random.default_rng(seed_for(seed, "sample"))
    return np.sort(rng.choice(params["pool"], min(params["check_hours"],
                                                  params["pool"]),
                              replace=False))


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float, root) -> dict:
    params = cell["params"]
    cfg = M.config_of(cell["config"]["modem"])
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    from modem_tpu_torch import pipeline  # noqa: F401  (the program)
    note("program imported", time.time() - t_start)
    pool, sent = hour_pool(cfg, params, seed, device)
    P = len(pool)
    sync()
    note(f"pool of {P} recordings of {pool[0].shape[0]} samples made",
         time.time() - t_start)
    calls_loop(pool, sent, cfg.rate, params, device, [0])
    # the plain list decoder of the CPU loads nothing; without
    # escalation the warm call ran the list decoder
    if cuda and params["adaptive"]:
        warm_list_decoder(cfg, pool[0], params, device)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_start
    note("set-up", setup_s)

    rows = sample(params, seed)
    kept = {int(j): [] for j in rows}

    def keep(j, got):
        if j in kept:
            kept[j].append(got)

    order = (k % P for k in range(10 ** 9))
    with common.old_objects_frozen():
        t0 = time.perf_counter()
        lat, calls, frames, failed = calls_loop(
            pool, sent, cfg.rate, params, device, order, keep=keep,
            deadline=t0 + seconds)
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    note(f"window: {calls} calls, {frames} frames, {failed} failed; "
         f"ms a call p50 {percentile(lat, 50) * 1e3:.3f} max "
         f"{max(lat) * 1e3:.3f}", window_s)
    out = dict(attempted=frames, failed=failed, memory_peak_bytes=peak,
               e2e={"decode_ms_p95": percentile(lat, 95) * 1e3,
                    "setup_s": setup_s},
               per_layer={}, device_extra={}, breakdown=None)
    if traced:
        spans = {"decode_all": []}
        body = lambda: calls_loop(  # noqa: E731
            pool, sent, cfg.rate, params, device,
            [k % P for k in range(params["trace_calls"])], spans=spans)
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
                spans=spans, counters=dict(calls=calls), trace=summary)
        out["per_layer"] = {m["name"]: m["_read"](r)
                            for m in cell["per_layer"]}
        del r

    free_program()
    t_ref = time.perf_counter()
    with torch.no_grad():
        refs = dict(zip((int(j) for j in rows), reference_answers(
            cfg, cell["config"], [pool[j] for j in rows], device)))
    got = compare(kept, refs)
    out["checks"] = {k: (got[k], cell["limits"][k]) for k in NUMBERS
                     if k in cell["limits"]}
    note(f"window {window_s:.3f} s, {calls} calls; reference over "
         f"{len(rows)} recording(s)", time.perf_counter() - t_ref)
    return out
