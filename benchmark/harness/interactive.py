"""The interactive loop: one caller who waits, decoding one recording at
a time with ``modem_tpu_torch.decoder.Decoder.decode(samples,
channels=1)``, as the reference's ``decode`` reads a mono WAV.

Set-up builds the Decoder with the configuration's list size, makes the
pool of mono recordings from the seed (in host memory, float32 samples
of 16-bit PCM), and decodes a few of them: every shape the window uses
(all recordings have one length).  The window then calls ``decode`` on
the pool in turn for ``seconds``; a call started before it closes is
counted in it.  Each answer is checked against the payload and call sign
sent (``failed``); the answers of ``check_rows`` recordings drawn from
the seed are kept for the comparison with the reference.  The mix's
parameters: ``pool`` recordings, ``pad_s`` of silence either side,
``channel`` (harness.inputs), and ``trace_calls`` calls traced after the
window with ``--trace 1``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from reference import channel as C
from reference import modem as M
from reference.encoder import Encoder
from reference.frontend import identity
from reference.interactive import Receiver

from . import common, inputs, trace
from .common import note, percentile, seed_for
from .layers import Run

WARM_CALLS = 3


def program_decoder(config: dict, device):
    """The system under test, as the configuration states it."""
    from modem_tpu_torch.decoder import Decoder
    return Decoder(config["modem"]["rate"],
                   list_size=config["decoder"]["list_size"], device=device)


def mono_pool(cfg: M.Config, params: dict, seed: int, device):
    """(recordings: float32 numpy [T] each, payload bytes, call signs)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_for(seed, "inputs"))
    enc = Encoder(cfg, device)
    n = params["pool"]
    pad = int(round(params["pad_s"] * cfg.rate))
    chan = params.get("channel")
    recs, payloads, calls = [], [], []
    for r0 in range(0, n, inputs.ENCODE_ROWS):
        rows = min(inputs.ENCODE_ROWS, n - r0)
        bits = inputs.payload_bits(cfg.mode.data_bytes, rows, gen, device)
        call = torch.randint(1, 37 ** 9, (rows,), generator=gen,
                             device=device).cpu().numpy()
        wave = torch.nn.functional.pad(enc.encode(bits, call).real,
                                       (pad, pad)).double()
        if chan:
            wave = C.chain_real(wave, cfg.rate, chan["awgn_db"], gen,
                                cfo_hz=chan["cfo_hz"],
                                sfo_ppm=chan["sfo_ppm"],
                                spread=chan["spread"])
        recs += list(inputs.pcm16(wave).to(torch.float32).cpu().numpy())
        payloads += [M.payload_bytes(b) for b in bits.cpu().numpy()]
        calls += [int(c) for c in call]
    return recs, payloads, calls


def answer(res) -> dict:
    """The exact and the measured fields of a DecodeResult."""
    return dict(ok=bool(res.ok), mode=int(res.oper_mode),
                call=res.call_sign, symbol_pos=int(res.symbol_pos),
                payload=res.payload, flips=int(res.bit_flips),
                sfo_ppm=float(res.sfo_ppm),
                snr=None if res.snr_db is None else np.array(res.snr_db))


def calls_loop(dec, pool, payloads, calls, order, keep=None, spans=None,
               deadline=None):
    """Decode pool[j] for j in ``order`` (until ``deadline``): per-call
    latencies (s), calls and failed calls."""
    from torch.profiler import record_function
    lat, done, failed = [], 0, 0
    for j in order:
        if deadline is not None and time.perf_counter() >= deadline:
            break
        with record_function("bench.decode"):
            t0 = time.perf_counter()
            res = dec.decode(pool[j], channels=1)
            t1 = time.perf_counter()
        lat.append(t1 - t0)
        if spans is not None:
            spans["decode"].append(t1 - t0)
        done += 1
        failed += int(not (res.ok and res.payload == payloads[j]
                           and res.call_sign == M.base37_text(calls[j])))
        if keep is not None:
            keep(j, res)
    return lat, done, failed


def reference_answers(cfg, config, recs, device, q=identity) -> list:
    rx = Receiver(cfg.rate, config["decoder"]["list_size"], device)
    got = [rx.decode(x, q) for x in recs]
    answers = rx.finish([a for a, _ in got], [f for _, f in got], q)
    for a in answers:
        if a is not None and a.get("ok"):
            a["payload"] = M.payload_bytes(a["bits"])
    return answers


NUMBERS = ("calls_differ", "snr_gap_db", "sfo_gap_ppm")


def compare(kept: dict, refs: dict) -> dict:
    """calls_differ: answers whose verdict, mode, call sign, symbol
    position, or (where the reference decoded) payload or bit flips
    differ from the reference's; the widest gaps of the per-row SNR (dB)
    and the SFO (ppm) estimates where both decoded.  The fine CFO is not
    compared: the bfloat16 control moves it by only ~7 f32 ulps at
    2 kHz, too few to set a limit between."""
    differ, snr, sfo, seen = 0, 0.0, 0.0, 0
    for j, ref in refs.items():
        for got in kept[j]:
            seen += 1
            if ref is None:
                differ += int(got["ok"] or got["mode"] != -1)
                continue
            ok = bool(ref.get("ok"))
            bad = (got["ok"] != ok or got["mode"] != ref["mode"]
                   or got["call"] != M.base37_text(ref["call"])
                   or got["symbol_pos"] != ref["symbol_pos"])
            if ok:
                bad = bad or (got["payload"] != ref["payload"]
                              or got["flips"] != ref["flips"])
            differ += int(bad)
            if "snr" in ref and got["snr"] is not None:
                snr = max(snr, float(np.abs(got["snr"] - ref["snr"]).max()))
                sfo = max(sfo, abs(got["sfo_ppm"] - ref["sfo_ppm"]))
    if not seen:
        return {k: math.inf for k in NUMBERS}
    return dict(calls_differ=differ, snr_gap_db=snr, sfo_gap_ppm=sfo)


def sample(params: dict, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed_for(seed, "sample"))
    return np.sort(rng.choice(params["pool"], min(params["check_rows"],
                                                  params["pool"]),
                              replace=False))


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float, root) -> dict:
    params = cell["params"]
    cfg = M.config_of(cell["config"]["modem"])
    device = torch.device(device)
    cuda = device.type == "cuda"
    dec = program_decoder(cell["config"], device)
    if cuda:
        torch.cuda.synchronize()
    note("program imported and its Decoder built", time.time() - t_start)
    pool, payloads, calls = mono_pool(cfg, params, seed, device)
    P = len(pool)
    calls_loop(dec, pool, payloads, calls, range(min(WARM_CALLS, P)))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_start
    note("set-up", setup_s)

    rows = sample(params, seed)
    kept = {int(j): [] for j in rows}

    def keep(j, res):
        if j in kept:
            kept[j].append(answer(res))

    order = (j % P for j in range(10 ** 9))
    with common.old_objects_frozen():
        t0 = time.perf_counter()
        lat, done, failed = calls_loop(dec, pool, payloads, calls, order,
                                       keep=keep, deadline=t0 + seconds)
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    out = dict(attempted=done, failed=failed, memory_peak_bytes=peak,
               e2e={"decode_ms_p95": percentile(lat, 95) * 1e3,
                    "setup_s": setup_s},
               per_layer={}, device_extra={}, breakdown=None)
    if traced:
        spans = {"decode": []}
        n = params["trace_calls"]
        summary = None
        body = lambda: calls_loop(dec, pool, payloads, calls,  # noqa: E731
                                  [j % P for j in range(n)], spans=spans)
        if cuda:
            summary = trace.profile(body)
            out["device_extra"] = dict(busy_s=summary.busy_s,
                                       window_s=summary.window_s)
            out["breakdown"] = dict(device_ops=summary.device_ops,
                                    idle_gaps=summary.idle_gaps)
        else:
            body()
        r = Run(cell=cell, cfg=cfg, device=device, pipe=dec, pool=pool,
                spans=spans, counters=dict(calls=done), trace=summary)
        out["per_layer"] = {m["name"]: m["_read"](r)
                            for m in cell["per_layer"]}
        del r

    del dec
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    with torch.no_grad():
        refs = dict(zip((int(j) for j in rows), reference_answers(
            cfg, cell["config"], [pool[j] for j in rows], device)))
    got = compare(kept, refs)
    out["checks"] = {k: (got[k], cell["limits"][k]) for k in NUMBERS
                     if k in cell["limits"]}
    note(f"window {window_s:.3f} s, {done} calls; reference over "
         f"{len(rows)} recordings", time.perf_counter() - t_ref)
    return out
