#!/usr/bin/env python3
"""Where the time goes in the port's serving decode on one GPU.

Six modes, one process each (run from the root of a checkout):

  python3 profile_card.py [--out FILE]
      kernel B (list-8) ms at 1, 16, 64, 132 and 264 frames; the
      pipelined AdaptivePipeline(8000, 6) loop of chip_smoke.py at batch
      512: frames/s over 10 runs with the host ms spent in
      decode_batch_async (dispatch) and in resolve, then one run under
      torch.profiler: its wall, its device time (kernel events) and the
      device idle share of that one run, and the largest kernels.

  python3 profile_card.py --rows [--out FILE]
      per-opcode clock profile of the decode kernels: instrumented
      copies of csrc/sc_decode.cu and csrc/scl_decode.cu, built under
      build/profile_card/, in which thread 0 of block 0 adds the
      clock64() cycles of each schedule row to its opcode (through the
      ROW_PROFILE_BEGIN / ROW_PROFILE_END hook of each row loop; kernel
      A's rows also by class: on warp 0 alone or the block, touching the
      global tier or not; B's and C's by tier, and the phases of their
      forks: load and search, per-lane top L, the first barrier, merge or
      rank, beta write, map permute; each phase's clock restarts after its
      counter's update); kernel A at 1 and 512 frames, kernels B and C
      (list-8 exact and fast) at 1 and 16, sigma 0.70 wire-size frames.
      The instrumentation adds two clock reads and a branch to each row,
      and the same to each fork phase.

  python3 profile_card.py --list [--against DIR] [--out FILE]
      kernels B and C (list-8 exact and fast) at [16] and [1, 65536],
      sigma 0.70 wire-size frames, by CUDA events, with nvcc's register
      and spill report; with --against, the same for DIR's
      modem_tpu_torch/csrc/scl_decode.cu (another checkout, e.g. one
      unpacked with git archive; the same C interface), both versions'
      outputs held equal and timed in turns in this one process (this,
      that, that, this; three times).

  python3 profile_card.py --decode-all [--out FILE]
      pipeline.decode_recording_auto on chip_smoke.py's two decode-all
      recordings (the hour of int16 audio, adaptive; the 64 frames of
      modes 6-13, exact): a warm-up run, then one run under
      torch.profiler: its wall and stage split, its device time (kernel
      events) and idle share, the largest kernels by device time and the
      host ops by their own CPU time (synchronising copies included).

  python3 profile_card.py --stream [--out FILE]
      stream.StreamDecoder fed 1 s (8,000 samples) a feed: the first ten
      minutes of chip_smoke.py's hour and bench/stream_bench.py's 16
      frames back to back, each a warm-up run, then one run under
      torch.profiler, reported as --decode-all's.

  python3 profile_card.py --sync-gate [--out FILE]
      the synchroniser's gate (peak > 4 * next) at each sample rate: a
      mode-6 frame and a frame of another mode, 2,000 samples apart,
      made by the port's encoder on the CPU from seeded payloads (the
      recordings of tests/test_torch_card.py's every-rate test), as
      noiseless complex64 and as 16-bit I/Q PCM; each candidate's p0,
      gate and peak ratio from the scan on the CPU and on the card.

Prints the card's name and power limit and a JSON summary, also
written to FILE (default build/profile_card.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from modem_tpu_torch.kernels import _build  # noqa: E402

OPS = "F G COMBINE RATE0 REP RATE1 SPC".split()
B_FRAMES = (1, 16, 64, 132, 264)

# --rows: each kernel's row loop calls ROW_PROFILE_BEGIN() before a row
# and ROW_PROFILE_END(key) after it, macros that the source defines empty
# behind GUARD unless they are defined first.  The key is the opcode + 16
# if the row touches the global tier, + 8 (A) if warp 0 ran it alone,
# below ROW_KEYS.  B's and C's forks also call ROW_PROFILE_PHASES() at the
# row's start and ROW_PROFILE_PHASE(key) at the end of each phase, with
# the keys from ROW_KEYS on (PHASE_KEY).  The instrumented copy is
# PRELUDE (the counters and the macros), the source, then TAIL (the
# counters' readers).
KEYS = 64
ROW_KEYS = 32
PHASE_KEY = 32       # + (opcode - REP) * 8 + phase (kPhaseKey)
PHASES = ("load+search", "lane top L", "merge/rank", "beta write",
          "map permute", "barrier 1")
GUARD = "#ifndef ROW_PROFILE_BEGIN\n"
HOOKS = ("ROW_PROFILE_BEGIN();", "ROW_PROFILE_END(")   # the calls, and
DEFINES = ("#define ROW_PROFILE_BEGIN(", "#define ROW_PROFILE_END(")
PRELUDE = """// instrumented by profile_card.py --rows
#include <cuda_runtime.h>
__device__ unsigned long long g_prof[128];  // cycles, then rows, by key
#define ROW_PROFILE_BEGIN() const long long t_row = clock64()
#define ROW_PROFILE_END(key)                      \\
  if (threadIdx.x == 0 && blockIdx.x == 0) {      \\
    const int k_row = (key);                      \\
    g_prof[k_row] += clock64() - t_row;           \\
    g_prof[64 + k_row] += 1;                      \\
  }
#define ROW_PROFILE_PHASES() long long t_phase = clock64()
#define ROW_PROFILE_PHASE(key)                    \\
  if (threadIdx.x == 0 && blockIdx.x == 0) {      \\
    const int k_row = (key);                      \\
    const long long t_now = clock64();            \\
    g_prof[k_row] += t_now - t_phase;             \\
    g_prof[64 + k_row] += 1;                      \\
    t_phase = clock64();                          \\
  }
"""
TAIL = """
extern "C" int prof_read(void* out) {
  cudaDeviceSynchronize();
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
extern "C" int prof_reset() {
  unsigned long long z[128] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
"""


def instrument(name: str, out_dir: pathlib.Path) -> pathlib.Path:
    """Write the instrumented copy of csrc/<name>.cu into ``out_dir`` and
    return its path; raise if the source lacks the hook."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    begins = src.count(HOOKS[0])
    ends = src.count(HOOKS[1]) - src.count(DEFINES[1])
    if (src.count(GUARD) != 1 or any(src.count(d) != 1 for d in DEFINES)
            or begins == 0 or begins != ends):
        raise RuntimeError(f"csrc/{name}.cu: no row-profile hook (one "
                           f"{GUARD.strip()!r} guard, ROW_PROFILE_BEGIN() "
                           "and ROW_PROFILE_END(op) paired in the row loop)")
    out = out_dir / f"{name}.cu"
    out.write_text(PRELUDE + src + TAIL)
    return out


def key_name(key: int, kernel: str = "A") -> str:
    """A row-profile key as text.  Below ROW_KEYS the opcode, then (A)
    "/warp" if warp 0 ran the row alone or "/block", and "/global" if it
    touched the global tier ((B, C) else "/shared"); from PHASE_KEY a
    fork opcode and its phase."""
    if key >= PHASE_KEY:
        op, phase = divmod(key - PHASE_KEY, 8)
        return f"{OPS[4 + op]}:{PHASES[phase]}"
    if kernel != "A":
        return OPS[key % 8] + ("/global" if key & 16 else "/shared")
    return (OPS[key % 8] + ("/warp" if key & 8 else "/block")
            + ("/global" if key & 16 else ""))


def wire_llrs(frames: int, dev):
    from modem_tpu_torch.fec.polar import PolarCode
    from modem_tpu_torch.kernels.sc_decode import ScPlan
    code = PolarCode(64800, 43072, 16)
    llrs, _cw = cs.parity_llrs(code, frames, 0.70)
    return ScPlan.from_frozen(code.frozen), llrs.to(dev)


def row_profile(dev) -> dict:
    """Per-opcode cycles of block 0 for kernels A, B and C."""
    prof_dir = ROOT / "build" / "profile_card"
    (prof_dir / "csrc").mkdir(parents=True, exist_ok=True)
    for name in ("sc_decode", "scl_decode"):
        instrument(name, prof_dir / "csrc")
    _build.CSRC = prof_dir / "csrc"
    _build.BUILD_DIR = prof_dir / "lib"
    from modem_tpu_torch.kernels import sc_decode as sc_mod
    from modem_tpu_torch.kernels import scl_decode as scl_mod
    cs.build_all({"sc_decode": sc_mod._library,
                  "scl_decode": scl_mod._library})
    plan, llrs = wire_llrs(512, dev)
    res = {}
    for kname, lib, run, sizes in (
            ("A", sc_mod._library(), lambda x: sc_mod.sc_decode(x, plan),
             (1, 512)),
            ("B", scl_mod._library(),
             lambda x: scl_mod.scl_decode(x, plan, 8), (1, 16)),
            ("C", scl_mod._library(),
             lambda x: scl_mod.scl_decode(x, plan, 8, exact=False),
             (1, 16))):
        lib.prof_read.argtypes = [ctypes.c_void_p]
        for frames in sizes:
            x = llrs[:frames].contiguous()
            run(x)
            ms = cs.cuda_ms(lambda: run(x), 3)
            if lib.prof_reset():
                raise RuntimeError("prof_reset failed")
            run(x)
            buf = (ctypes.c_ulonglong * (2 * KEYS))()
            if lib.prof_read(ctypes.addressof(buf)):
                raise RuntimeError("prof_read failed")
            cyc, cnt = list(buf[:KEYS]), list(buf[KEYS:])

            def entry(c, n):
                return {"rows": n, "share": c / total,
                        "cycles_per_row": c / max(n, 1),
                        "us_per_row": c / max(n, 1) / ghz / 1e3}

            rows = slice(0, ROW_KEYS)
            total = sum(cyc[rows])
            ghz = total / (ms * 1e6)
            ops = {op: entry(sum(cyc[rows][i::8]), sum(cnt[rows][i::8]))
                   for i, op in enumerate(OPS)}
            classes = {key_name(k, kname): entry(cyc[k], cnt[k])
                       for k in range(KEYS) if cnt[k]}
            res[f"{kname}_{frames}"] = {"ms": ms, "cycles": total,
                                        "clock_ghz_implied": ghz,
                                        "ops": ops, "classes": classes}
            print(f"kernel {kname}, {frames} frames: {ms:.3f} ms, {total} "
                  f"cycles of block 0 ({ghz:.3f} GHz implied)")
            for name, r in (ops | classes).items():
                print(f"  {name:18s} rows {r['rows']:5d}  share "
                      f"{r['share'] * 100:5.1f} %  {r['cycles_per_row']:8.0f}"
                      f" cycles a row  {r['us_per_row']:.3f} us a row")
    return res


def list_times(dev, against: str | None) -> dict:
    """Kernels B and C at [16] and [1], this checkout's source and, with
    ``against``, another's in turns."""
    from modem_tpu_torch.kernels import scl_decode as scl_mod
    default = scl_mod._library
    logs = {"this": _build.library_path("scl_decode")}
    loads = {"this": default}
    if against:
        text = (pathlib.Path(against) / "modem_tpu_torch" / "csrc"
                / "scl_decode.cu").read_text()
        logs["against"] = _build.generated_path("scl_decode_against", text)
        loads["against"] = lambda: scl_mod.bind(
            _build.load_generated("scl_decode_against", text))
    out = {"build_s": cs.build_all(loads), "ptxas": {}, "equal": {},
           "ms": {}}
    libs = {name: load() for name, load in loads.items()}
    for name, lib in logs.items():
        out["ptxas"][name] = [
            line.strip() for line in lib.with_suffix(".log").read_text()
            .splitlines() if "registers" in line or "spill" in line]
        print(f"ptxas {name}:", *out["ptxas"][name], sep="\n  ")
    plan, llrs = wire_llrs(16, dev)

    def run(name, x, exact):
        scl_mod._library = lambda options=False: libs[name]
        try:
            return scl_mod.scl_decode(x, plan, 8, exact)
        finally:
            scl_mod._library = default

    for exact in (True, False):
        for frames in (16, 1):
            key = f"{'B' if exact else 'C'}_{frames}"
            x = llrs[:frames].contiguous()
            want = run("this", x, exact)
            if against:
                got = run("against", x, exact)
                out["equal"][key] = bool(torch.equal(got[0], want[0])
                                         and torch.equal(got[1], want[1]))
                pairs = [cs.turns_ms(lambda: run("this", x, exact),
                                     lambda: run("against", x, exact), 10)
                         for _ in range(3)]
                out["ms"][key] = {"this": [a for a, _ in pairs],
                                  "against": [b for _, b in pairs]}
            else:
                out["ms"][key] = {"this": [
                    cs.cuda_ms(lambda: run("this", x, exact), 10)
                    for _ in range(3)]}
            print(f"kernel {key[0]} [{frames}, 65536]: " + "; ".join(
                f"{name} " + ", ".join(f"{t:.3f}" for t in ts) + " ms"
                for name, ts in out["ms"][key].items())
                + (f"; outputs equal: {out['equal'][key]}" if against
                   else ""), flush=True)
    return out


def serve_profile(dev) -> dict:
    """Kernel B's scaling, then the pipelined serve loop: host split over
    10 runs and one run under the profiler."""
    from modem_tpu_torch import bits as B
    from modem_tpu_torch.encoder import Encoder
    from modem_tpu_torch.kernels import sc_decode as sc_mod
    from modem_tpu_torch.kernels import scl_decode as scl_mod
    from modem_tpu_torch.numerology import make_config
    from modem_tpu_torch.pipeline import AdaptivePipeline
    from torch.profiler import ProfilerActivity, profile

    cs.build_all({"sc_decode": sc_mod._library,
                  "scl_decode": scl_mod._library})
    out = {}
    plan, llrs = wire_llrs(max(B_FRAMES), dev)
    kb = {}
    for frames in B_FRAMES:
        x = llrs[:frames].contiguous()
        scl_mod.scl_decode(x, plan, 8)
        kb[frames] = cs.cuda_ms(lambda: scl_mod.scl_decode(x, plan, 8), 3)
        print(f"kernel B, {frames} frames: {kb[frames]:.3f} ms", flush=True)
    out["kernel_b_ms_by_frames"] = kb

    cfg = make_config(8000, 6, 2000)
    enc = Encoder(cfg, device=dev)
    rng = np.random.default_rng(0)
    call = B.base37_encode("N0CALL")
    pad = torch.zeros(cs.BATCH, cfg.rate // 4, dtype=torch.complex64,
                      device=dev)
    recs = []
    for _ in range(cs.SETS):
        payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                                 dtype=np.uint8).tobytes()
                    for _ in range(cs.BATCH)]
        waves, _ = enc.encode_batch(payloads, call)
        recs.append(torch.cat([pad, waves, pad], dim=1))
    pipe = AdaptivePipeline(8000, 6, device=dev)
    pipe.decode_batch(recs[0])
    timing = {"dispatch": [], "resolve": []}

    def loop():
        pending = None
        for i in range(1, cs.SETS):
            t0 = time.perf_counter()
            handle = pipe.decode_batch_async(recs[i])
            timing["dispatch"].append(time.perf_counter() - t0)
            if pending is not None:
                t0 = time.perf_counter()
                pipe.resolve(pending)
                timing["resolve"].append(time.perf_counter() - t0)
            pending = handle
        t0 = time.perf_counter()
        pipe.resolve(pending)
        timing["resolve"].append(time.perf_counter() - t0)

    batches = cs.SETS - 1
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        loop()
        walls.append((time.perf_counter() - t0) / batches)
    out["serve_ms_per_batch"] = sorted(w * 1e3 for w in walls)
    out["serve_fps_median"] = cs.BATCH / statistics.median(walls)
    out["dispatch_ms_median"] = statistics.median(timing["dispatch"]) * 1e3
    out["resolve_ms_median"] = statistics.median(timing["resolve"]) * 1e3

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    device_s = sum(k[0] for k in kernels) / 1e6
    out["profiled_wall_ms_per_batch"] = wall * 1e3 / batches
    out["profiled_device_ms_per_batch"] = device_s * 1e3 / batches
    out["profiled_idle_share"] = 1 - device_s / wall
    out["top_kernels_ms_per_batch"] = [
        (us / 1e3 / batches, key[:90], count)
        for us, key, count in kernels[:14]]
    print(f"serve: median {out['serve_fps_median']:.1f} frames/s; host "
          f"dispatch {out['dispatch_ms_median']:.2f} ms, resolve "
          f"{out['resolve_ms_median']:.2f} ms (medians)")
    print(f"profiled run: wall {out['profiled_wall_ms_per_batch']:.2f} ms, "
          f"device {out['profiled_device_ms_per_batch']:.2f} ms a batch; "
          f"idle share {out['profiled_idle_share'] * 100:.1f} %")
    for row in out["top_kernels_ms_per_batch"]:
        print(f"  {row[0]:8.3f} ms  x{row[2]:<5d} {row[1]}")
    return out


def device_kernels(prof) -> list:
    """(device us, name, count) of every CUDA kernel event, largest
    first."""
    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out.append((us, e.key, e.count))
    return sorted(out, reverse=True)


def profiled(label: str, run, stats=None) -> dict:
    """run() once under torch.profiler (after the caller's warm-up): its
    wall, its device time (kernel events) and idle share, the largest
    kernels by device time and the host ops by their own CPU time
    (synchronising copies included); printed, and returned."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    device_s = sum(k[0] for k in kernels) / 1e6
    host = sorted(((e.self_cpu_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), reverse=True)
    res = {"stage_ms": stats or {}, "profiled_wall_ms": wall * 1e3,
           "device_ms": device_s * 1e3,
           "idle_share": 1 - device_s / wall,
           "top_kernels_ms": [(us / 1e3, key[:90], n)
                              for us, key, n in kernels[:14]],
           "top_host_ms": [(us / 1e3, key[:60], n)
                           for us, key, n in host[:14]]}
    print(f"{label}: profiled wall {res['profiled_wall_ms']:.1f} ms, device "
          f"{res['device_ms']:.1f} ms, idle share "
          f"{res['idle_share'] * 100:.1f} %; stages " + ", ".join(
              f"{k} {v:.1f}" for k, v in res["stage_ms"].items()), flush=True)
    for row in res["top_kernels_ms"]:
        print(f"  device {row[0]:8.3f} ms  x{row[2]:<6d} {row[1]}")
    for row in res["top_host_ms"]:
        print(f"  host   {row[0]:8.3f} ms  x{row[2]:<6d} {row[1]}")
    return res


def decode_all_profile(dev) -> dict:
    """decode_recording_auto on the hour and on the 64 frames: one run
    each under the profiler, after a warm-up run."""
    from modem_tpu_torch.ingest import PcmRecording
    from modem_tpu_torch.kernels import sc_decode as sc_mod
    from modem_tpu_torch.kernels import scl_decode as scl_mod
    from modem_tpu_torch.pipeline import decode_recording_auto

    cs.build_all({"sc_decode": sc_mod._library,
                  "scl_decode": scl_mod._library})
    hour, _, _ = cs.hour_recording(dev)
    auto, _ = cs.auto_recording(dev)
    out = {}
    for label, pcm, kw in (("hour", hour, dict(channels=1, adaptive=True)),
                           ("auto exact", auto,
                            dict(channels=1, adaptive=False))):
        def fresh():
            return PcmRecording(data=pcm.data, bits=pcm.bits, rate=pcm.rate)
        decode_recording_auto(fresh(), 8000, device=dev, **kw)
        stats = {}
        out[label] = profiled(
            f"decode-all {label}",
            lambda: decode_recording_auto(fresh(), 8000, device=dev,
                                          stats=stats, **kw), stats)
    return out


STREAM_PROFILE_S = 600      # the hour's first ten minutes


def stream_profile(dev) -> dict:
    """stream.StreamDecoder fed 1 s at a time under the profiler, after a
    warm-up run: the first STREAM_PROFILE_S seconds of chip_smoke.py's
    hour, and bench/stream_bench.py's 16 frames back to back."""
    from modem_tpu_torch.kernels import scl_decode as scl_mod
    from modem_tpu_torch.stream import StreamDecoder

    cs.build_all({"scl_decode": scl_mod._library})
    hour, _, _ = cs.hour_recording(dev)
    bench, _ = cs.stream_bench_pcm(dev)

    def run(pcm):
        sd = StreamDecoder(8000, channels=1, bits=16, device=dev)
        got = []
        for i in range(0, len(pcm), 8000):
            got += sd.feed(pcm[i: i + 8000])
        return got + sd.finish()

    out = {}
    for label, pcm in ((f"hour's first {STREAM_PROFILE_S} s",
                        hour.data[: STREAM_PROFILE_S * 8000]),
                       ("16 frames", bench)):
        frames = run(pcm)
        out[label] = profiled(f"stream {label}", lambda: run(pcm))
        out[label]["frames_ok"] = sum(f["ok"] for f in frames)
    return out


GATE_RATES = ((8000, 13), (16000, 7), (44100, 10), (48000, 12))


def sync_gate(dev) -> dict:
    """The scan's candidates at every rate, noiseless float and int16
    PCM, on the CPU and on the card."""
    from modem_tpu_torch import bits as B
    from modem_tpu_torch.decoder import cached_decoder
    from modem_tpu_torch.encoder import Encoder
    from modem_tpu_torch.ingest import PcmRecording
    from modem_tpu_torch.numerology import make_config

    out = {}
    for rate, other in GATE_RATES:
        rng = np.random.default_rng(rate)
        gap = torch.zeros(2000, dtype=torch.complex64)
        parts = [gap]
        for mode, call in zip((6, other), ("AB1CDE", "N0CALL")):
            cfg = make_config(rate, mode, 2000)
            payload = rng.integers(0, 256, cfg.mode.data_bytes,
                                   dtype=np.uint8).tobytes()
            wave, _ = Encoder(cfg, device="cpu").encode_batch(
                [payload], B.base37_encode(call))
            parts += [wave[0], gap]
        rec = torch.cat(parts).numpy()
        iq = np.stack([rec.real, rec.imag], axis=-1)
        iq = 0.5 * iq / np.abs(iq).max()
        pcm = np.clip(np.rint(iq * 32767.0), -32768, 32767).astype(np.int16)
        for kind in ("float", "int16"):
            for where in ("cpu", dev):
                x = (rec if kind == "float"
                     else PcmRecording(data=pcm, bits=16, rate=rate))
                cands = cached_decoder(rate, device=where).sync.scan(x)
                key = f"{rate} {kind} {torch.device(where).type}"
                out[key] = [(c.p0, c.ok, c.peak_ratio) for c in cands]
                print(f"sync gate {key}: " + ", ".join(
                    f"p0 {p} {'ok' if ok else 'rejected'} ratio {r:.2f}"
                    for p, ok, r in out[key]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", action="store_true",
                    help="per-opcode clock profile of both kernels")
    ap.add_argument("--list", action="store_true",
                    help="kernels B and C at [16] and [1]")
    ap.add_argument("--sync-gate", action="store_true",
                    help="the sync gate at every rate, CPU and card")
    ap.add_argument("--decode-all", action="store_true",
                    help="decode_recording_auto under the profiler")
    ap.add_argument("--stream", action="store_true",
                    help="StreamDecoder in 1 s feeds under the profiler")
    ap.add_argument("--against", default=None,
                    help="with --list: another checkout to time in turns")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "profile_card.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_card: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    if args.rows:
        res = row_profile(dev)
    elif args.list:
        res = list_times(dev, args.against)
    elif args.decode_all:
        res = decode_all_profile(dev)
    elif args.stream:
        res = stream_profile(dev)
    elif args.sync_gate:
        res = sync_gate(dev)
    else:
        res = serve_profile(dev)
    res = {"card": card, **res}
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps({k: v for k, v in res.items()
                      if not isinstance(v, (dict, list))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
