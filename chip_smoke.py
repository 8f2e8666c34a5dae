#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (modem_tpu_torch) on one GPU.

Drives the serving decode as a user would: BatchPipeline(8000, 6,
list_size=1, device="cuda") on batches of 512 mode-6 recordings made by
the port's own encoder, with the SC kernel built from csrc/ by nvcc.

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build the SC kernel (nvcc, sm_90a) and report the build seconds;
  3. the kernel against its plain PyTorch version on 64 noisy wire-size
     frames (noise at which plain SC loses some frames): codewords equal
     on every frame, path metrics within rtol 1e-4;
  4. the main path: 4 sets of 512 distinct seeded payloads encoded on
     the card and padded with silence; one warm-up batch, then 5 timed
     runs over 3 disjoint batches (median frames/s); every frame must
     decode ok and byte-exact, and the kernel's launch counter must
     count every batch; then the front-end and SC
     times per batch, the kernel against the plain version at the main
     path's shape, and the peak device memory;
  5. the frozen golden recording tests/data/golden_mode6_galois.wav
     decoded byte-exact on the card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Prints a
JSON line of kernel results before the last line, and as the last line
{"ok": true, "device": {...}}.  Exits nonzero, printing no result, when
there is no CUDA device, outside a checkout, or if any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import wave

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 512
SETS = 4                 # one warm-up batch + three timed batches
REPEATS = 5              # timed runs over the three batches
PARITY_FRAMES = 64
PARITY_SIGMA = 0.68      # plain SC loses some of these frames
PARITY_SEED = 1234
PM_RTOL = 1e-4           # f32 leaf sums reduced in another order


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout
    return out.strip().splitlines()[0]


def parity_llrs(code, frames: int, sigma: float):
    """Seeded noisy wire-size LLRs of one random codeword, made as
    bench.parity_llrs makes them.  Returns (llrs [frames, code_len] f32,
    the transmitted codeword)."""
    rng = np.random.default_rng(PARITY_SEED)
    m = rng.integers(0, 2, code.mesg_bits, dtype=np.uint8)
    m[code.k:] = 0
    cw = code.encode_systematic(torch.from_numpy(m))
    tx = 1.0 - 2.0 * code.shorten(cw).double()
    noise = torch.from_numpy(rng.standard_normal((frames, code.n)))
    llrs = code.lengthen(2.0 * (tx + sigma * noise) / sigma ** 2)
    return llrs.float(), cw


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over reps calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def read_golden():
    with wave.open(os.path.join(ROOT, "tests", "data",
                                "golden_mode6_galois.wav")) as f:
        check((f.getframerate(), f.getnchannels(), f.getsampwidth())
              == (8000, 2, 2), "golden recording format")
        raw = np.frombuffer(f.readframes(f.getnframes()),
                            dtype="<i2").reshape(-1, 2)
    x = raw.astype(np.float32) / 32767.0
    return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from modem_tpu_torch import bits as B
    from modem_tpu_torch.encoder import Encoder
    from modem_tpu_torch.fec.polar import PolarCode
    from modem_tpu_torch.kernels import _build
    from modem_tpu_torch.kernels.sc_decode import (ScPlan, _library,
                                                   sc_decode,
                                                   sc_decode_reference)
    from modem_tpu_torch.numerology import make_config
    from modem_tpu_torch.pipeline import BatchPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. the card ---------------------------------------------------
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          "device(s)")

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    _library()
    build_s = time.perf_counter() - t0
    print(f"build: sc_decode.cu in {build_s:.2f} s")
    log = _build.library_path("sc_decode").with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # ---- 3. kernel vs plain version, noisy wire-size frames -------------
    code = PolarCode(64800, 43072, 16)
    plan = ScPlan.from_frozen(code.frozen)
    llrs, cw = parity_llrs(code, PARITY_FRAMES, PARITY_SIGMA)
    llrs = llrs.to(dev)
    cw_k, pm_k = sc_decode(llrs, plan)
    cw_r, pm_r = sc_decode_reference(llrs, plan.sched)
    torch.cuda.synchronize()
    hits = int((cw_k[:, 0].cpu() == cw).all(dim=1).sum())
    parity_err = float((pm_k - pm_r).abs().max())
    print(f"parity: {PARITY_FRAMES} frames at sigma {PARITY_SIGMA}: "
          f"{hits} decode the sent codeword; codewords equal: "
          f"{bool(torch.equal(cw_k, cw_r))}; max |pm diff| {parity_err}")
    check(torch.equal(cw_k, cw_r), "kernel codewords differ from plain")
    check(torch.allclose(pm_k, pm_r, rtol=PM_RTOL, atol=0.0),
          "kernel path metrics differ from plain")
    check(0 < hits < PARITY_FRAMES, "noise point does not split outcomes")

    # ---- 4. the main path ----------------------------------------------
    cfg = make_config(8000, 6, 2000)
    enc = Encoder(cfg, device=dev)
    rng = np.random.default_rng(0)
    call = B.base37_encode("N0CALL")
    t0 = time.perf_counter()
    payload_sets, rec_sets = [], []
    pad = torch.zeros(BATCH, cfg.rate // 4, dtype=torch.complex64,
                      device=dev)
    for _ in range(SETS):
        payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                                 dtype=np.uint8).tobytes()
                    for _ in range(BATCH)]
        waves, _papr = enc.encode_batch(payloads, call)
        payload_sets.append(payloads)
        rec_sets.append(torch.cat([pad, waves, pad], dim=1))
    torch.cuda.synchronize()
    print(f"encode: {SETS} x {BATCH} recordings of "
          f"{rec_sets[0].shape[1]} samples in "
          f"{time.perf_counter() - t0:.1f} s")

    pipe = BatchPipeline(8000, 6, list_size=1, device=dev)
    check(pipe.sync_stride == 8, "stride-8 coarse sync expected")

    def verify(host, payloads):
        check(host["ok"].all(), f"{int((~host['ok']).sum())} frames "
              "failed CRC")
        bad = sum(pipe.payload_bytes(host, i) != p
                  for i, p in enumerate(payloads))
        check(bad == 0, f"{bad} payloads not byte-exact")

    torch.cuda.reset_peak_memory_stats()
    sc_decode.launches = 0
    hosts = [pipe.fetch(pipe.decode_batch(rec_sets[0]))]   # warm-up
    rates = []
    for rep in range(REPEATS):
        t0 = time.perf_counter()
        for i in range(1, SETS):
            host = pipe.fetch(pipe.decode_batch(rec_sets[i]))
            if rep == 0:
                hosts.append(host)
        rates.append(BATCH * (SETS - 1) / (time.perf_counter() - t0))
    launches = sc_decode.launches
    for host, payloads in zip(hosts, payload_sets):
        verify(host, payloads)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    fps = float(np.median(rates))
    want = 1 + REPEATS * (SETS - 1)
    check(launches == want, f"SC kernel launched {launches} times, "
          f"want {want}")
    print(f"serve: median {fps:.1f} frames/s over {REPEATS} runs of "
          f"{SETS - 1} disjoint batches of {BATCH} (runs: "
          f"{', '.join(f'{r:.1f}' for r in rates)}); every frame ok and "
          f"byte-exact; SC kernel launches {launches}; peak device "
          f"memory {peak_mb:.0f} MiB")

    # stage split at the main path's shapes (after the counted run)
    recs = rec_sets[1]
    front_ms = cuda_ms(lambda: pipe.demod(recs), 3)
    front = pipe.demod(recs)
    llrs = front["llrs"]
    select_ms = cuda_ms(lambda: pipe._fec_select(front), 3)
    plain_a = cuda_ms(lambda: sc_decode_reference(llrs, plan.sched), 1)
    sc_decode(llrs, plan)
    kernel_ms = cuda_ms(lambda: sc_decode(llrs, plan), 10)
    kernel_b = cuda_ms(lambda: sc_decode(llrs, plan), 10)
    plain_b = cuda_ms(lambda: sc_decode_reference(llrs, plan.sched), 1)
    kernel_ms = (kernel_ms + kernel_b) / 2
    plain_ms = (plain_a + plain_b) / 2
    cw_main, pm_main = sc_decode(llrs, plan)
    cw_plain, pm_plain = sc_decode_reference(llrs, plan.sched)
    check(torch.equal(cw_main, cw_plain), "main-path codewords differ")
    check(torch.allclose(pm_main, pm_plain, rtol=PM_RTOL, atol=0.0),
          "main-path path metrics differ")
    max_abs_err = max(parity_err, float((pm_main - pm_plain).abs().max()))
    print(f"stages per batch of {BATCH}: front end {front_ms:.2f} ms, "
          f"SC + CRC select {select_ms:.2f} ms; SC kernel {kernel_ms:.3f} "
          f"ms vs plain PyTorch {plain_ms:.1f} ms")

    # ---- 5. golden recording on the card --------------------------------
    want = np.load(os.path.join(ROOT, "tests", "data",
                                "waveform_pin_payload_seed.npy")).tobytes()
    host = pipe.fetch(pipe.decode_batch(read_golden()[None]))
    check(bool(host["ok"][0]) and pipe.payload_bytes(host, 0) == want,
          "golden recording did not decode byte-exact")
    print(f"golden: golden_mode6_galois.wav decodes byte-exact, p0 "
          f"{int(host['p0'][0])}, cfo "
          f"{float(host['cfo_rad'][0]) * 8000 / (2 * np.pi):.3f} Hz")

    print(json.dumps({"kernels": [{
        "name": "sc_decode", "route": "cuda",
        "source": "modem_tpu_torch/csrc/sc_decode.cu",
        "replaces": "modem_tpu/kernels/scl_pallas.py:1732",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms}],
        "card": card, "build_s": build_s, "frames_per_s": fps,
        "frames_per_s_runs": rates,
        "front_ms": front_ms, "select_ms": select_ms,
        "peak_mib": peak_mb}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
