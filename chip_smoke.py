#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (modem_tpu_torch) on one GPU.

Drives the port's two paths as a user would, with every kernel built
from csrc/ by nvcc: the serving decode, AdaptivePipeline(8000, 6,
device="cuda") on batches of 512 mode-6 recordings made by the port's
own encoder (every frame through the SC kernel A, the frames whose CRC
fails through the list-8 kernel B, or C with scl_exact=False), and the
interactive Decoder(8000, device="cuda") on whole recordings of every
mode (sync scan, OSD header, all-pairs payload demod, list decode with B
or C).

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel library (nvcc, sm_90a), one nvcc each, all
     started together: kernel A, kernels B and C, their C' options
     (scl_decode.cu again with -DSCL_DECODE_OPTIONS) and the probes D, E
     and F; report the build seconds and ptxas lines;
  3. the SC kernel against its plain PyTorch version on 64 noisy
     wire-size frames (noise at which plain SC loses some frames):
     codewords equal on every frame, path metrics within rtol 1e-4;
  4. the list-8 kernels B (exact) and C (Fast-SSC-List) each against its
     plain version on 16 noisy wire-size frames at sigma 0.70, the first
     8 of which are bench.py's parity batch: the same per-frame recovery
     of the sent codeword (as bench.scl_parity_check), the same codeword
     list in the same lane order on every frame, and the path metrics
     within rtol 1e-4; the same again at the Decoder's shape [1, 65536];
     then kernel against plain times at [16, 65536] and [1, 65536];
  5. both list kernels against the bit-by-bit oracle: the 500 frames of
     bench/ab_scl.py (sigma 0.64-0.76, 100 each) must recover the sent
     codeword where bench/ab_scl_oracle_64800.json says, B on all 500, C
     on all but frame 0.72:52, the one the fast mode loses
     (tests/test_scl_vm.py);
  6. the serving path: 4 sets of 512 distinct seeded payloads encoded on
     the card and padded with silence; one warm-up batch, then 5 timed
     runs over 3 disjoint batches in bench.py's pipelined loop (dispatch
     batch i, then resolve batch i - 1), median frames/s; every frame
     must decode ok and byte-exact with no escalation, and the SC
     kernel's launch count must equal the number of batches; then the
     front-end and SC times per batch, the SC kernel against the plain
     version at the main path's shape, and the peak device memory;
  7. escalation at wire size: 64 recordings with complex AWGN at a level
     where SC fails on part of them: the adaptive result equals
     BatchPipeline(list_size=8)'s on every key, frames escalate, at
     least one frame that SC lost decodes byte-exact, and kernel B
     launched; the noisy batch dispatched before a clean one and
     resolved while that one is in flight equals decode_batch on every
     key, as does the clean one; the escalation cost (noisy against
     clean decode_batch ms); then AdaptivePipeline(scl_exact=False) on
     the noisy batch equals BatchPipeline(list_size=8, scl_exact=False)
     on every key, through kernel C;
  8. the frozen golden recording tests/data/golden_mode6_galois.wav
     decoded byte-exact by the serving pipeline on the card;
  9. the interactive Decoder on the card: the golden recording as 2-channel
     I/Q and as its first channel through the mono front end, with
     kernel B and with kernel C, and one recording of each of the 8 modes
     (the port's encoder, call sign N0CALL, 1 s of silence either side),
     each decoded byte-exact with the right mode and call sign; B and C
     launched once per decode; then the decode's wall time split into
     scan, header (demod + OSD), payload demod and list decode;
 10. kernel C', make_decoder's options at wire size, each driven with
     every launch count at 0 just before and read just after:
     decompose_spc (B at [16, 65536] against its plain version: same
     recovery, lists, lane order, pm within rtol 1e-4; A at [64, 65536]),
     rank_select and beta_compact=False (B and C at [16] and [1], A at
     the serving batch), each array_equal to the default kernel and timed
     in turns with it; ops_override with 2,048 cycled rows of each opcode
     class, kernel B against plain at [16], and microseconds a row;
 11. the unroll ladder (kernels/unroll.py): A at n = 1024 and 4096, B and
     C at 1024, generated, built (one nvcc each, together), bit-identical
     to the interpreter, with build seconds and ms a batch against it;
     then each kernel's longest rung against its plain version on the
     same LLRs (codewords equal, pm within rtol 1e-4);
 12. the probes D (p256), E (rank3) and F (interleave): each kernel
     against its plain twin at small R (tolerances in the modules; F's
     output and its pm each at their own), then the timings at the
     original probes' R, with F's verdicts (chain, leaf and the narrow
     width-4 body: single, dual, dual through shared barriers, double).

Run from the root of a checkout: ``python3 chip_smoke.py``.  Prints a
JSON line of kernel results (each kernel's time, its plain version's,
and its bound: the larger of the bytes it must move over 3.35 TB/s and
its operations over 67 TFLOP/s) before the last line, and as the last
line {"ok": true, "device": {...}}.  Exits nonzero, printing no result,
when there is no CUDA device, outside a checkout, or if any phase fails.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import time
import wave

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from modem_tpu_torch.card import cuda_ms, roofline  # noqa: E402

BATCH = 512
SETS = 4                 # one warm-up batch + three timed batches
REPEATS = 5              # timed runs over the three batches
PARITY_FRAMES = 64
PARITY_SIGMA = 0.68      # plain SC loses some of these frames
PARITY_SEED = 1234
PM_RTOL = 1e-4           # f32 leaf sums reduced in another order
LIST_SIZE = 8
FALLBACK_BATCH = 16      # AdaptivePipeline's list-decoder batch
SCL_FRAMES = 16          # the first 8 are bench.parity_llrs's batch
SCL_SIGMA = 0.70         # the list decoder's sensitivity edge
ORACLE_SIGMAS = (0.64, 0.68, 0.7, 0.72, 0.76)
ORACLE_FRAMES = 100
ESC_FRAMES = 64
ESC_SIGMA = 0.128        # complex AWGN per component: SC fails on part
ESC_SEED = 5
ORACLE_FAST_LOSS = "0.72:52"   # the oracle frame the fast mode loses
CALL = "N0CALL"
OVERRIDE_ROWS = 2048     # rows of a per-class override table
# the unroll ladder in this run: A at both codes, B and C at the
# shorter (they take 5-10 minutes to build at 4096; PERF.md)
UNROLL_RUNGS = ((1024, "A"), (1024, "B"), (1024, "C"), (4096, "A"))
INTERLEAVE_REPS = 2000   # bench/probe_interleave.py's defaults
WIDTH_REPS = 50000


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


def oracle_llrs(code, sigma: float, frames: int, dev):
    """The frames of bench/ab_scl.py at sigma (seed sigma*1000*100000 +
    i, one codeword each), encoded on ``dev``: (llrs [frames, code_len]
    f32, codewords [frames, code_len])."""
    mesg, noise = [], []
    for i in range(frames):
        rng = np.random.default_rng(int(sigma * 1000) * 100000 + i)
        m = rng.integers(0, 2, code.mesg_bits, dtype=np.uint8)
        m[code.k:] = 0
        mesg.append(m)
        noise.append(rng.standard_normal(code.n))
    cw = code.encode_systematic(torch.from_numpy(np.stack(mesg)).to(dev))
    tx = 1.0 - 2.0 * code.shorten(cw).double()
    rx = tx + sigma * torch.from_numpy(np.stack(noise)).to(dev)
    return code.lengthen(2.0 * rx / sigma ** 2).float().contiguous(), cw


def recovered(cws, cw) -> torch.Tensor:
    """[B, L, n] lists, [n] or [B, n] sent codewords -> [B] bool: the
    sent codeword is in the list."""
    if cw.dim() == 1:
        cw = cw[None]
    return (cws == cw[:, None, :].to(cws.device)).all(dim=2).any(dim=1)


def same_lists(a, b) -> int:
    """Frames whose two lists [L, n] hold the same codewords."""
    return sum(torch.equal(torch.unique(x.long(), dim=0),
                           torch.unique(y.long(), dim=0))
               for x, y in zip(a, b))


def kernel_vs_plain_ms(kernel, plain, reps: int):
    """(kernel ms, plain ms) in turns: plain, kernel, kernel, plain."""
    kernel()
    p1 = cuda_ms(plain, 1)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, 1)
    return (k1 + k2) / 2, (p1 + p2) / 2


def read_golden():
    with wave.open(os.path.join(ROOT, "tests", "data",
                                "golden_mode6_galois.wav")) as f:
        check((f.getframerate(), f.getnchannels(), f.getsampwidth())
              == (8000, 2, 2), "golden recording format")
        raw = np.frombuffer(f.readframes(f.getnframes()),
                            dtype="<i2").reshape(-1, 2)
    x = raw.astype(np.float32) / 32767.0
    return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)


def build_all(libraries: dict) -> dict:
    """Build every kernel library, one nvcc each, all started together;
    returns the seconds each took (a failed build raises)."""
    def one(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        futs = {name: pool.submit(one, load)
                for name, load in libraries.items()}
        return {name: f.result() for name, f in futs.items()}


def turns_ms(first, second, reps: int):
    """(first ms, second ms) in turns: first, second, second, first."""
    first()
    second()
    a1 = cuda_ms(first, reps)
    b1 = cuda_ms(second, reps)
    b2 = cuda_ms(second, reps)
    a2 = cuda_ms(first, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


def kernel_bound(sched, batch: int, lsz: int, exact: bool = True) -> dict:
    """The least time the card could take for one decode launch: the
    larger of its bytes (LLRs in, f32; codewords out, uint8; path
    metrics out, f32) over the memory rate and its operations over the
    f32 rate.  Operations are counted from the schedule, per list lane
    and frame: 4 an F column (two magnitudes, a min, a sign product), 2
    a G column, 1 a COMBINE column, 2 a leaf column (a magnitude or relu
    and a sum); and per frame at a fork, a top-L selection of N
    candidates costs N comparisons (a linear selection): 2L at REP and
    at each fast round (4 a RATE1 leaf, 3 an SPC); at an exact RATE1 /
    SPC leaf each lane's 128 patterns over its 7 least-reliable columns
    add only their set bits (7 x 64 = 448 additions a lane), and the
    top L of the L x 128 candidates take L x 128 comparisons."""
    from modem_tpu_torch.fec.schedule import (C_OP, C_WIDTH, OP_COMBINE,
                                              OP_F, OP_G, OP_RATE0, OP_RATE1,
                                              OP_REP, OP_SPC)
    width = sched.ops[:, C_WIDTH].astype(np.int64)
    kind = sched.ops[:, C_OP]
    count = {op: int((kind == op).sum()) for op in (OP_REP, OP_RATE1,
                                                    OP_SPC)}
    lane_ops = (4 * int(width[kind == OP_F].sum())
                + 2 * int(width[kind == OP_G].sum())
                + int(width[kind == OP_COMBINE].sum())
                + 2 * int(width[kind >= OP_RATE0].sum()))
    fork_ops = 0
    if lsz > 1:
        fork_ops = count[OP_REP] * 2 * lsz
        if exact:
            fork_ops += (count[OP_RATE1] + count[OP_SPC]) * (
                lsz * 7 * 64 + lsz * 128)
        else:
            fork_ops += (4 * count[OP_RATE1] + 3 * count[OP_SPC]) * 2 * lsz
    n = sched.code_len
    nbytes = batch * (4 * n + lsz * n + 4 * lsz)
    return roofline(nbytes, batch * (lsz * lane_ops + fork_ops))


def wall_ms(fn, reps: int) -> float:
    """Median host milliseconds of fn() over reps calls, each ending in a
    device synchronise."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from modem_tpu_torch import bits as B
    from modem_tpu_torch.decoder import Decoder
    from modem_tpu_torch.encoder import Encoder
    from modem_tpu_torch.fec.polar import PolarCode
    from modem_tpu_torch.kernels import _build
    from modem_tpu_torch.kernels import sc_decode as sc_mod
    from modem_tpu_torch.kernels import scl_decode as scl_mod
    from modem_tpu_torch.kernels.sc_decode import (ScPlan, sc_decode,
                                                   sc_decode_reference)
    from modem_tpu_torch.kernels.scl_decode import (scl_decode,
                                                    scl_decode_reference)
    from modem_tpu_torch.numerology import MODES, make_config
    from modem_tpu_torch.kernels import unroll
    from modem_tpu_torch.kernels.scl_decode import make_decoder, variant_name
    from modem_tpu_torch.pipeline import AdaptivePipeline, BatchPipeline
    from modem_tpu_torch.probes import interleave, p256, rank3

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
    libraries = {
        "sc_decode": (sc_mod._library, ("sc_decode", ())),
        "scl_decode": (scl_mod._library, ("scl_decode", ())),
        "scl_decode options": (lambda: scl_mod._library(True),
                               ("scl_decode", ("SCL_DECODE_OPTIONS",))),
        "probe_p256": (p256.library, ("probe_p256", ())),
        "probe_rank3": (rank3.library, ("probe_rank3", ())),
        "probe_interleave": (interleave.library, ("probe_interleave", ()))}
    t0 = time.perf_counter()
    build_s = build_all({k: v[0] for k, v in libraries.items()})
    build_wall = time.perf_counter() - t0
    print(f"build: {len(build_s)} kernel libraries in {build_wall:.2f} s, "
          "one nvcc each, started together ("
          + ", ".join(f"{k} {v:.2f} s" for k, v in build_s.items())
          + "; scl_decode.cu holds kernels B and C, built again with "
          "-DSCL_DECODE_OPTIONS for their C' options)")
    for name, (_load, (src, defines)) in libraries.items():
        log = _build.library_path(src, defines).with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())

    # ---- 3. SC kernel vs plain version, noisy wire-size frames ----------
    code = PolarCode(64800, 43072, 16)
    plan = ScPlan.from_frozen(code.frozen)
    llrs, cw = parity_llrs(code, PARITY_FRAMES, PARITY_SIGMA)
    llrs = llrs.to(dev)
    cw_k, pm_k = sc_decode(llrs, plan)
    cw_r, pm_r = sc_decode_reference(llrs, plan.sched)
    torch.cuda.synchronize()
    hits = int(recovered(cw_k, cw).sum())
    parity_err = float((pm_k - pm_r).abs().max())
    print(f"parity A: {PARITY_FRAMES} frames at sigma {PARITY_SIGMA}: "
          f"{hits} decode the sent codeword; codewords equal: "
          f"{bool(torch.equal(cw_k, cw_r))}; max |pm diff| {parity_err}")
    check(torch.equal(cw_k, cw_r), "SC kernel codewords differ from plain")
    check(torch.allclose(pm_k, pm_r, rtol=PM_RTOL, atol=0.0),
          "SC kernel path metrics differ from plain")
    check(0 < hits < PARITY_FRAMES, "noise point does not split outcomes")

    # ---- 4. list-8 kernels B and C vs their plain versions ---------------
    llrs_b, cw = parity_llrs(code, SCL_FRAMES, SCL_SIGMA)
    llrs_b = llrs_b.to(dev)
    list_err, list_ms = {}, {}
    for exact, name in ((True, "B"), (False, "C")):
        cw_k, pm_k = scl_decode(llrs_b, plan, LIST_SIZE, exact)
        cw_r, pm_r = scl_decode_reference(llrs_b, plan.sched, LIST_SIZE,
                                          exact)
        torch.cuda.synchronize()
        hits_k, hits_r = recovered(cw_k, cw), recovered(cw_r, cw)
        pm_k_s, pm_r_s = pm_k.sort(dim=1).values, pm_r.sort(dim=1).values
        list_err[name] = float((pm_k_s - pm_r_s).abs().max())
        rel = float(((pm_k_s - pm_r_s).abs() / pm_r_s.abs()).max())
        print(f"parity {name}: {SCL_FRAMES} frames at sigma {SCL_SIGMA}: "
              f"kernel recovers {int(hits_k.sum())}, plain "
              f"{int(hits_r.sum())}; identical codeword sets on "
              f"{same_lists(cw_k, cw_r)} frames "
              f"({same_lists(cw_k[:8], cw_r[:8])} of bench.py's 8); "
              f"identical lane order: {bool(torch.equal(cw_k, cw_r))}; max "
              f"|sorted pm diff| {list_err[name]} ({rel:.3g} relative)")
        # bench.scl_parity_check asks for the same recovery and pm within
        # 1 %; the kernels keep their plain versions' lists outright
        check(torch.equal(hits_k, hits_r) and bool(hits_k.any()),
              f"kernel {name} recovers other frames than its plain version")
        check(same_lists(cw_k, cw_r) == SCL_FRAMES,
              f"kernel {name} lists differ from its plain version's")
        # the Decoder takes the first CRC pass in stable path-metric order,
        # so lane order decides between tied paths: it must be the same
        check(torch.equal(cw_k, cw_r),
              f"kernel {name} lane order differs from its plain version's")
        check(torch.allclose(pm_k, pm_r, rtol=PM_RTOL, atol=0.0),
              f"kernel {name} path metrics differ from plain")
        for n_frames in (FALLBACK_BATCH, 1):
            x = llrs_b[:n_frames].contiguous()
            if n_frames != SCL_FRAMES:
                # the Decoder's shape, [1, 65536]: outputs held too
                cw1_k, pm1_k = scl_decode(x, plan, LIST_SIZE, exact)
                cw1_r, pm1_r = scl_decode_reference(x, plan.sched,
                                                    LIST_SIZE, exact)
                check(torch.equal(cw1_k, cw1_r) and torch.allclose(
                    pm1_k, pm1_r, rtol=PM_RTOL, atol=0.0),
                    f"kernel {name} at [{n_frames}, 65536] differs from "
                    "its plain version")
                err1 = float((pm1_k - pm1_r).abs().max())
                list_err[name] = max(list_err[name], err1)
                print(f"parity {name} at [{n_frames}, 65536]: codewords "
                      f"and lane order equal; max |pm diff| {err1}")
            list_ms[name, n_frames] = kernel_vs_plain_ms(
                lambda: scl_decode(x, plan, LIST_SIZE, exact),
                lambda: scl_decode_reference(x, plan.sched, LIST_SIZE,
                                             exact), 5)
    print("list-8 kernels vs plain PyTorch: " + "; ".join(
        f"{k[0]} [{k[1]}, 65536] {v[0]:.3f} ms vs {v[1]:.1f} ms"
        for k, v in list_ms.items()))

    # ---- 5. list-8 kernels vs the bit-by-bit oracle ----------------------
    with open(os.path.join(ROOT, "bench", "ab_scl_oracle_64800.json")) as f:
        oracle = json.load(f)
    n_oracle = len(ORACLE_SIGMAS) * ORACLE_FRAMES
    oracle_agree = {}
    for exact, name in ((True, "B"), (False, "C")):
        diverge, rows = [], []
        for sigma in ORACLE_SIGMAS:
            x, cws = oracle_llrs(code, sigma, ORACLE_FRAMES, dev)
            got = recovered(scl_decode(x, plan, LIST_SIZE, exact)[0],
                            cws).cpu()
            for i in range(ORACLE_FRAMES):
                if bool(got[i]) != oracle[f"{sigma}:{i}"]:
                    diverge.append(f"{sigma}:{i}")
            rows.append(f"{sigma}: {int(got.sum())} vs "
                        f"{sum(oracle[f'{sigma}:{i}'] for i in range(ORACLE_FRAMES))}")
        oracle_agree[name] = n_oracle - len(diverge)
        print(f"oracle {name}: kernel recovery agrees with "
              f"ab_scl_oracle_64800.json on {oracle_agree[name]}/{n_oracle} "
              f"frames, diverging on {diverge or 'none'} (kernel vs oracle "
              f"recoveries per sigma: {'; '.join(rows)})")
        want_div = [] if exact else [ORACLE_FAST_LOSS]
        check(diverge == want_div,
              f"kernel {name} diverges from the oracle on {diverge}")
        if not exact:
            check(oracle[ORACLE_FAST_LOSS],
                  "the fast mode's lost frame is no oracle recovery")

    # ---- 6. the main path ----------------------------------------------
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

    pipe = AdaptivePipeline(8000, 6, list_size=LIST_SIZE,
                            fallback_batch=FALLBACK_BATCH, device=dev)
    check(pipe.sc.sync_stride == 8, "stride-8 coarse sync expected")

    def verify(host, payloads):
        check(host["ok"].all(), f"{int((~host['ok']).sum())} frames "
              "failed CRC")
        bad = sum(pipe.payload_bytes(host, i) != p
                  for i, p in enumerate(payloads))
        check(bad == 0, f"{bad} payloads not byte-exact")

    def reset_counts():
        sc_decode.launches = scl_decode.launches = 0
        scl_decode.fast_launches = 0
        sc_decode.variant_launches.clear()
        scl_decode.variant_launches.clear()
        for probe in (p256, rank3, interleave):
            probe.run.launches.clear()

    def option_counts() -> dict:
        """Launches of every kernel that is not a default A, B or C: the
        C' options and the probes."""
        return {**{f"A+{k}": v for k, v in sc_decode.variant_launches.items()},
                **dict(scl_decode.variant_launches),
                **{f"probe {probe.__name__.rsplit('.', 1)[1]} {k}": v
                   for probe in (p256, rank3, interleave)
                   for k, v in probe.run.launches.items()}}

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hosts = [pipe.decode_batch(rec_sets[0])]                # warm-up
    fallbacks = pipe.last_fallbacks
    rates = []
    for rep in range(REPEATS):
        t0 = time.perf_counter()
        pending = None
        for i in range(1, SETS):
            handle = pipe.decode_batch_async(rec_sets[i])
            if pending is not None:
                host = pipe.resolve(pending)
                fallbacks += pipe.last_fallbacks
                if rep == 0:
                    hosts.append(host)
            pending = handle
        host = pipe.resolve(pending)
        fallbacks += pipe.last_fallbacks
        if rep == 0:
            hosts.append(host)
        rates.append(BATCH * (SETS - 1) / (time.perf_counter() - t0))
    launches = sc_decode.launches
    serve_scl_launches = scl_decode.launches
    serve_option_launches = option_counts()
    check(not any(serve_option_launches.values()),
          f"the serving path launched {serve_option_launches}")
    for host, payloads in zip(hosts, payload_sets):
        verify(host, payloads)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    fps = float(np.median(rates))
    want = 1 + REPEATS * (SETS - 1)
    check(launches == want, f"SC kernel launched {launches} times, "
          f"want {want}")
    check(fallbacks == 0 and serve_scl_launches == 0,
          f"{fallbacks} clean frames escalated")
    print(f"serve: median {fps:.1f} frames/s over {REPEATS} runs of "
          f"{SETS - 1} disjoint batches of {BATCH}, pipelined (runs: "
          f"{', '.join(f'{r:.1f}' for r in rates)}); every frame ok and "
          f"byte-exact; fallbacks {fallbacks}; SC kernel launches "
          f"{launches}; peak device memory {peak_mb:.0f} MiB")

    # stage split at the main path's shapes (after the counted run)
    sc = pipe.sc
    recs = rec_sets[1]
    front_ms = cuda_ms(lambda: sc.demod(recs), 3)
    front = sc.demod(recs)
    llrs = front["llrs"]
    select_ms = cuda_ms(lambda: sc._fec_select(front), 3)
    kernel_ms, plain_ms = kernel_vs_plain_ms(
        lambda: sc_decode(llrs, plan),
        lambda: sc_decode_reference(llrs, plan.sched), 10)
    cw_main, pm_main = sc_decode(llrs, plan)
    cw_plain, pm_plain = sc_decode_reference(llrs, plan.sched)
    check(torch.equal(cw_main, cw_plain), "main-path codewords differ")
    check(torch.allclose(pm_main, pm_plain, rtol=PM_RTOL, atol=0.0),
          "main-path path metrics differ")
    max_abs_err = max(parity_err, float((pm_main - pm_plain).abs().max()))
    print(f"stages per batch of {BATCH}: front end {front_ms:.2f} ms, "
          f"SC + CRC select {select_ms:.2f} ms; SC kernel {kernel_ms:.3f} "
          f"ms vs plain PyTorch {plain_ms:.1f} ms")

    # ---- 7. escalation at wire size ---------------------------------------
    nrng = np.random.default_rng(ESC_SEED)
    shape = (ESC_FRAMES, rec_sets[0].shape[1])
    noise = torch.from_numpy(
        (nrng.standard_normal(shape) + 1j * nrng.standard_normal(shape))
        .astype(np.complex64)).to(dev)
    noisy = rec_sets[0][:ESC_FRAMES] + ESC_SIGMA * noise
    sc_decode.launches = 0
    scl_decode.launches = 0
    scl_decode.fast_launches = 0
    host = pipe.decode_batch(noisy)
    torch.cuda.synchronize()
    esc_launches = (sc_decode.launches, scl_decode.launches)
    check(scl_decode.fast_launches == 0, "the exact escalation ran kernel C")
    escalated = pipe.last_fallbacks
    ref_pipe = BatchPipeline(8000, 6, list_size=LIST_SIZE, device=dev,
                             state=pipe.sc.state)
    ref = ref_pipe.fetch(ref_pipe.decode_batch(noisy))
    sc_ok = sc.fetch(sc.decode_batch(noisy))["ok"]
    payloads = payload_sets[0]
    byte_exact = [pipe.payload_bytes(host, i) == payloads[i]
                  for i in range(ESC_FRAMES)]
    saved = sum(byte_exact[i] for i in np.flatnonzero(~sc_ok))
    print(f"escalation: {ESC_FRAMES} recordings with complex AWGN sigma "
          f"{ESC_SIGMA}: SC fails {escalated}, escalated to list-8 in "
          f"{esc_launches[1]} launches; {sum(byte_exact)} byte-exact in all, "
          f"{saved} of them lost by SC; adaptive == BatchPipeline("
          f"list_size=8) on every key: "
          f"{all(np.array_equal(host[k], ref[k]) for k in ref)}")
    check(0.1 * ESC_FRAMES <= escalated <= 0.9 * ESC_FRAMES,
          f"SC failed on {escalated} of {ESC_FRAMES}: not between 10 % "
          "and 90 %")
    check(set(host) == set(ref), "adaptive result keys differ")
    for key in ref:
        check(np.array_equal(host[key], ref[key]),
              f"adaptive {key} differs from BatchPipeline(list_size=8)")
    check(esc_launches == (1, -(-escalated // FALLBACK_BATCH)),
          f"escalation launches {esc_launches}")
    check(saved > 0, "the list decoder recovered no frame that SC lost")

    # the pipelined pair on an escalating batch: the noisy batch is
    # resolved (and escalated) while a clean one is in flight
    clean = rec_sets[0][:ESC_FRAMES].contiguous()
    h_noisy = pipe.decode_batch_async(noisy)
    h_clean = pipe.decode_batch_async(clean)
    got = {"noisy": pipe.resolve(h_noisy)}
    check(pipe.last_fallbacks == escalated, "async escalation count")
    got["clean"] = pipe.resolve(h_clean)
    check(pipe.last_fallbacks == 0, "clean batch escalated")
    for name, x in (("noisy", noisy), ("clean", clean)):
        want_res = pipe.decode_batch(x)
        for key in want_res:
            check(np.array_equal(got[name][key], want_res[key]),
                  f"async {name} {key} differs from decode_batch")

    # escalation cost: decode_batch of the same 64 recordings, clean and
    # noisy, median of 5 each
    esc_ms = {name: wall_ms(lambda: pipe.decode_batch(x), 5)
              for name, x in (("clean", clean), ("noisy", noisy))}
    print(f"escalation cost: {ESC_FRAMES} recordings {esc_ms['noisy']:.2f}"
          f" ms at sigma {ESC_SIGMA} ({escalated} fallbacks) vs "
          f"{esc_ms['clean']:.2f} ms clean (decode_batch, median of 5); "
          "async dispatch of the noisy batch then a clean one, resolved "
          "in order: both equal decode_batch on every key")

    # escalation through kernel C: the same noisy batch
    fast = AdaptivePipeline(8000, 6, list_size=LIST_SIZE, scl_exact=False,
                            fallback_batch=FALLBACK_BATCH, device=dev,
                            state=pipe.sc.state)
    sc_decode.launches = scl_decode.launches = 0
    scl_decode.fast_launches = 0
    host_c = fast.decode_batch(noisy)
    torch.cuda.synchronize()
    esc_c_launches = (sc_decode.launches, scl_decode.launches,
                      scl_decode.fast_launches)
    ref_c_pipe = BatchPipeline(8000, 6, list_size=LIST_SIZE, scl_exact=False,
                               device=dev, state=pipe.sc.state)
    ref_c = ref_c_pipe.fetch(ref_c_pipe.decode_batch(noisy))
    saved_c = sum(fast.payload_bytes(host_c, i) == payloads[i]
                  for i in np.flatnonzero(~sc_ok))
    print(f"escalation with C: AdaptivePipeline(scl_exact=False) escalates "
          f"{fast.last_fallbacks} frames in {esc_c_launches[2]} kernel C "
          f"launches, recovers {saved_c} that SC lost; == BatchPipeline("
          f"list_size=8, scl_exact=False) on every key: "
          f"{all(np.array_equal(host_c[k], ref_c[k]) for k in ref_c)}")
    check(set(host_c) == set(ref_c), "fast adaptive result keys differ")
    for key in ref_c:
        check(np.array_equal(host_c[key], ref_c[key]),
              f"fast adaptive {key} differs from BatchPipeline(list_size=8, "
              "scl_exact=False)")
    check(fast.last_fallbacks == escalated
          and esc_c_launches == (1, 0, -(-escalated // FALLBACK_BATCH)),
          f"fast escalation launches {esc_c_launches}")

    # ---- 8. golden recording on the card --------------------------------
    want = np.load(os.path.join(ROOT, "tests", "data",
                                "waveform_pin_payload_seed.npy")).tobytes()
    golden = read_golden()
    host = pipe.decode_batch(golden[None])
    check(bool(host["ok"][0]) and pipe.payload_bytes(host, 0) == want,
          "golden recording did not decode byte-exact")
    print(f"golden: golden_mode6_galois.wav decodes byte-exact, p0 "
          f"{int(host['p0'][0])}, cfo "
          f"{float(host['cfo_rad'][0]) * 8000 / (2 * np.pi):.3f} Hz")

    # ---- 9. the interactive Decoder on the card --------------------------
    decoders = {ex: Decoder(8000, scl_exact=ex, device=dev)
                for ex in (True, False)}
    t0 = time.perf_counter()
    mode_recs = {}
    for mode in sorted(MODES):
        mcfg = make_config(8000, mode, 2000)
        payload = rng.integers(0, 256, mcfg.mode.data_bytes,
                               dtype=np.uint8).tobytes()
        wave_, _ = Encoder(mcfg, device=dev).encode_batch(
            [payload], B.base37_encode(CALL))
        sil = torch.zeros(mcfg.rate, dtype=torch.complex64, device=dev)
        mode_recs[mode] = (torch.cat([sil, wave_[0], sil]), payload)
    torch.cuda.synchronize()
    print(f"encode: one recording of each of modes {sorted(MODES)} in "
          f"{time.perf_counter() - t0:.1f} s")
    runs = [("golden I/Q", golden, 2, want, 6),
            ("golden mono", golden.real.copy(), 1, want, 6)]
    reset_counts()
    dec_rows = []
    t0 = time.perf_counter()
    for ex, dec in decoders.items():
        for label, samples, channels, payload, mode in runs:
            res = dec.decode(samples, channels=channels)
            dec_rows.append((f"{label} {'B' if ex else 'C'}", res))
            check(res.ok and res.payload == payload
                  and (res.oper_mode, res.call_sign) == (mode, CALL),
                  f"Decoder on {label} with kernel {'B' if ex else 'C'}: "
                  f"{res.status}")
    for mode, (rec, payload) in mode_recs.items():
        res = decoders[True].decode(rec, channels=2)
        dec_rows.append((f"mode {mode}", res))
        check(res.ok and res.payload == payload
              and (res.oper_mode, res.call_sign) == (mode, CALL),
              f"Decoder on the mode-{mode} recording: {res.status}")
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    dec_launches = (sc_decode.launches, scl_decode.launches,
                    scl_decode.fast_launches)
    check(not any(option_counts().values()),
          f"the Decoder path launched {option_counts()}")
    print(f"decoder: {len(dec_rows)} recordings byte-exact with the right "
          f"mode and call sign in {dec_s:.2f} s; launches A, B, C "
          f"{dec_launches}: " + "; ".join(
              f"{name}: p0 {r.symbol_pos}, flips {r.bit_flips}, cfo "
              f"{r.cfo_hz:.3f} Hz" for name, r in dec_rows))
    check(dec_launches == (0, len(runs) + len(MODES), len(runs)),
          f"Decoder launches {dec_launches}")

    # the stage split of one decode: golden I/Q, kernel B
    dec = decoders[True]
    x = dec.frontend(golden, 2)
    cands = [c for c in dec.sync.scan(x) if c.ok]
    cand = cands[0]
    stage_ms = {
        "mono front end": wall_ms(lambda: dec.frontend(golden.real.copy(),
                                                       1), 5),
        "scan": wall_ms(lambda: dec.sync.scan(x), 5),
        "header (demod + OSD + CRC-16)": wall_ms(
            lambda: dec._decode_header(x, cand), 5),
        "payload demod": wall_ms(lambda: dec._demod(x, cand, 6), 5),
    }
    full = dec._demod(x, cand, 6)[0]
    stage_ms["list decode + select (B)"] = wall_ms(
        lambda: dec._list_select(full, 6), 5)
    stage_ms["list decode + select (C)"] = wall_ms(
        lambda: decoders[False]._list_select(full, 6), 5)
    stage_ms["whole decode (I/Q, B)"] = wall_ms(
        lambda: dec.decode(golden, channels=2), 5)
    stage_ms["whole decode (I/Q, C)"] = wall_ms(
        lambda: decoders[False].decode(golden, channels=2), 5)
    print("decoder stages, golden recording, median of 5: " + "; ".join(
        f"{k} {v:.2f} ms" for k, v in stage_ms.items()))

    # ---- 10. kernel C': the decoder's options at wire size, mode 6 --------
    # Each option is a path of its own: driven through make_decoder with
    # every launch count at 0 just before and read just after (drive), then
    # held to its plain version or to the default kernel, and timed.  None
    # of them ran on the main paths above (checked there).
    options = []
    llrs16, cw16 = parity_llrs(code, SCL_FRAMES, SCL_SIGMA)
    llrs16 = llrs16.to(dev)
    llrs64, _cw64 = parity_llrs(code, PARITY_FRAMES, PARITY_SIGMA)
    llrs64 = llrs64.to(dev)
    serve_llrs = llrs             # the main path's SC input, phase 6

    def drive(fn, count, what):
        """fn() with every launch count at 0 just before; returns (its
        result, count() just after), which must be positive."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        n = count()
        check(n > 0, f"{what} launched its kernel no time")
        return out, n

    def option(name, source, launches, kernel_ms, plain_ms, err, shape,
               sched_, lsz, exact, **extra):
        options.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": "modem_tpu/kernels/scl_pallas.py:1732",
            "launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms,
            **kernel_bound(sched_, shape[0], lsz, exact),
            "library_ms": None, "shape": list(shape), **extra})

    # decompose_spc: B at [16, 65536] and A at [64, 65536] on the SPC-free
    # schedule, each against its plain version
    dec_b = make_decoder(code.frozen, LIST_SIZE, decompose_spc=True,
                         device=dev)
    dsched = dec_b.plan.sched
    (cw_k, pm_k), n_db = drive(lambda: dec_b(llrs16),
                               lambda: scl_decode.launches, "decomposed B")
    cw_r, pm_r = scl_decode_reference(llrs16, dsched, LIST_SIZE, True)
    torch.cuda.synchronize()
    check(torch.equal(recovered(cw_k, cw16), recovered(cw_r, cw16)),
          "decomposed B recovers other frames than its plain version")
    check(same_lists(cw_k, cw_r) == SCL_FRAMES and torch.equal(cw_k, cw_r),
          "decomposed B lists or lane order differ from its plain version")
    check(torch.allclose(pm_k, pm_r, rtol=PM_RTOL, atol=0.0),
          "decomposed B path metrics differ from its plain version")
    err_db = float((pm_k - pm_r).abs().max())
    n_rec = int(recovered(cw_k, cw16).sum())
    db_ms, db_plain = kernel_vs_plain_ms(
        lambda: dec_b(llrs16),
        lambda: scl_decode_reference(llrs16, dsched, LIST_SIZE, True), 3)
    b_ms, dbk_ms = turns_ms(lambda: scl_decode(llrs16, plan, LIST_SIZE),
                            lambda: dec_b(llrs16), 3)
    option("scl_decode+decompose_spc", "modem_tpu_torch/csrc/scl_decode.cu",
           n_db, dbk_ms, db_plain, err_db, (SCL_FRAMES, code.code_len),
           dsched, LIST_SIZE, True, rows=dsched.n_ops, default_ms=b_ms,
           recovered=n_rec)
    dec_a = make_decoder(code.frozen, 1, decompose_spc=True, device=dev)
    (cw_k, pm_k), n_da = drive(lambda: dec_a(llrs64),
                               lambda: sc_decode.launches, "decomposed A")
    cw_r, pm_r = sc_decode_reference(llrs64, dec_a.plan.sched)
    check(torch.equal(cw_k, cw_r) and torch.allclose(pm_k, pm_r,
                                                     rtol=PM_RTOL, atol=0.0),
          "decomposed A differs from its plain version")
    da_ms, da_plain = kernel_vs_plain_ms(
        lambda: dec_a(llrs64),
        lambda: sc_decode_reference(llrs64, dec_a.plan.sched), 5)
    option("sc_decode+decompose_spc", "modem_tpu_torch/csrc/sc_decode.cu",
           n_da, da_ms, da_plain, float((pm_k - pm_r).abs().max()),
           (PARITY_FRAMES, code.code_len), dec_a.plan.sched, 1, True,
           rows=dec_a.plan.sched.n_ops)
    print(f"C' decompose_spc: schedule of {dsched.n_ops} rows (SPC-leaf "
          f"{plan.sched.n_ops}); B at [{SCL_FRAMES}, 65536] recovers "
          f"{n_rec}/{SCL_FRAMES}, lists and lane order equal to plain, max "
          f"|pm diff| {err_db}; {dbk_ms:.3f} ms vs the SPC-leaf B "
          f"{b_ms:.3f} ms (plain {db_plain:.1f} ms); A at "
          f"[{PARITY_FRAMES}, 65536] equal to plain, {da_ms:.3f} ms "
          f"(plain {da_plain:.1f} ms)")

    # rank_select (B; C runs its default code) and f32 betas (A, B, C):
    # array_equal to the default kernel, and timed in turns with it
    opt_sets = ({"rank_select": True}, {"beta_compact": False},
                {"rank_select": True, "beta_compact": False})
    decs = {(exact, i): make_decoder(code.frozen, LIST_SIZE, exact,
                                     device=dev, **opts)
            for exact in (True, False) for i, opts in enumerate(opt_sets)}

    def list_count(vname):
        if vname in ("B", "C"):
            return (scl_decode.launches if vname == "B"
                    else scl_decode.fast_launches)
        return scl_decode.variant_launches[vname]

    done = set()
    for n_frames in (SCL_FRAMES, 1):
        x = llrs16[:n_frames].contiguous()
        for exact, kname in ((True, "B"), (False, "C")):
            want = scl_decode(x, plan, LIST_SIZE, exact)
            # the plain versions the variants are held to: the default one
            # (f32 betas change nothing there) and, for B, the rank path
            plain_out, plain_t = {}, {}
            for rank in ((False, True) if exact else (False,)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plain_out[rank] = scl_decode_reference(
                    x, plan.sched, LIST_SIZE, exact, rank_select=rank)
                torch.cuda.synchronize()
                plain_t[rank] = (time.perf_counter() - t0) * 1e3
            for i, opts in enumerate(opt_sets):
                dec = decs[exact, i]
                vname = variant_name(exact, **opts)
                got, n_v = drive(lambda: dec(x), lambda: list_count(vname),
                                 f"{kname} with {opts}")
                check(torch.equal(got[0], want[0])
                      and torch.equal(got[1], want[1]),
                      f"{kname} with {opts} differs from the default at "
                      f"[{n_frames}, 65536]")
                rank = exact and opts.get("rank_select", False)
                ref = plain_out[rank]
                check(torch.equal(got[0], ref[0]) and torch.allclose(
                    got[1], ref[1], rtol=PM_RTOL, atol=0.0),
                    f"{kname} with {opts} differs from its plain version at "
                    f"[{n_frames}, 65536]")
                err = float((got[1] - ref[1]).abs().max())
                if vname == kname or (vname, n_frames) in done:
                    continue          # C: rank_select is its default code
                done.add((vname, n_frames))
                d_ms, v_ms = turns_ms(
                    lambda: scl_decode(x, plan, LIST_SIZE, exact),
                    lambda: dec(x), 3)
                key = f"scl_decode[{vname}]"
                if n_frames == SCL_FRAMES:
                    option(key, "modem_tpu_torch/csrc/scl_decode.cu", n_v,
                           v_ms, plain_t[rank], err,
                           (n_frames, code.code_len), plan.sched, LIST_SIZE,
                           exact, default_ms=d_ms)
                else:
                    entry = next(o for o in options if o["name"] == key)
                    entry.update(ms_1=v_ms, default_ms_1=d_ms,
                                 plain_ms_1=plain_t[rank],
                                 max_abs_err=max(entry["max_abs_err"], err),
                                 bound_ms_1=kernel_bound(plan.sched, 1,
                                                         LIST_SIZE,
                                                         exact)["bound_ms"])
    dec_af = make_decoder(code.frozen, 1, beta_compact=False, device=dev)
    got, n_af = drive(lambda: dec_af(serve_llrs),
                      lambda: sc_decode.variant_launches["beta_f32"],
                      "A with f32 betas")
    want = sc_decode(serve_llrs, plan)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "A with f32 betas differs from the default")
    check(torch.equal(got[0], cw_plain) and torch.allclose(
        got[1], pm_plain, rtol=PM_RTOL, atol=0.0),
        "A with f32 betas differs from its plain version")
    a_ms, af_ms = turns_ms(lambda: sc_decode(serve_llrs, plan),
                           lambda: dec_af(serve_llrs), 5)
    option("sc_decode[A+beta_f32]", "modem_tpu_torch/csrc/sc_decode.cu", n_af,
           af_ms, plain_ms, float((got[1] - pm_plain).abs().max()),
           (BATCH, code.code_len), plan.sched, 1, True, default_ms=a_ms)
    print("C' rank_select / f32 betas: equal to the default kernels and to "
          f"their plain versions at [{SCL_FRAMES}] and [1] (A at "
          f"[{BATCH}]); ms (default ms) "
          "at [16] / [1]: " + "; ".join(
              f"{o['name']} {o['ms']:.3f} ({o['default_ms']:.3f})"
              + (f" / {o['ms_1']:.3f} ({o['default_ms_1']:.3f})"
                 if "ms_1" in o else "") for o in options
              if o["name"].startswith(("scl_decode[", "sc_decode["))))

    # ops_override: per opcode class of the mode-6 schedule, 2,048 cycled
    # copies of its rows; B against its plain version at [16]
    op_names = ("F", "G", "COMBINE", "RATE0", "REP", "RATE1", "SPC")
    per_row_us = {}
    for op in range(len(op_names)):
        rows = plan.sched.ops[plan.sched.ops[:, 0] == op]
        table = np.tile(rows, (OVERRIDE_ROWS // len(rows) + 1, 1))
        table = table[:OVERRIDE_ROWS]
        dec = make_decoder(code.frozen, LIST_SIZE, ops_override=table,
                           device=dev)
        (cw_k, pm_k), n_o = drive(lambda: dec(llrs16),
                                  lambda: scl_decode.launches,
                                  f"the override of {op_names[op]} rows")
        t0 = time.perf_counter()
        cw_r, pm_r = scl_decode_reference(llrs16, dec.plan.sched, LIST_SIZE,
                                          True)
        torch.cuda.synchronize()
        o_plain = (time.perf_counter() - t0) * 1e3
        check(torch.equal(cw_k, cw_r) and torch.allclose(
            pm_k, pm_r, rtol=PM_RTOL, atol=0.0),
            f"override of {op_names[op]} rows: kernel differs from plain")
        o_ms = cuda_ms(lambda: dec(llrs16), 3)
        per_row_us[op_names[op]] = o_ms * 1e3 / OVERRIDE_ROWS
        option(f"scl_decode[override {op_names[op]}]",
               "modem_tpu_torch/csrc/scl_decode.cu", n_o, o_ms, o_plain,
               float((pm_k - pm_r).abs().max()), (SCL_FRAMES, code.code_len),
               dec.plan.sched, LIST_SIZE, True, rows=OVERRIDE_ROWS,
               us_per_row=per_row_us[op_names[op]])
    print(f"C' ops_override: {OVERRIDE_ROWS} cycled rows a class, kernel B "
          f"equal to plain at [{SCL_FRAMES}, 65536]; us a row (16 frames): "
          + ", ".join(f"{k} {v:.3f}" for k, v in per_row_us.items()))
    print("C' launches, each option's own drive: " + ", ".join(
        f"{o['name']} {o['launches']}" for o in options))

    # ---- 11. the unroll ladder -------------------------------------------
    t0 = time.perf_counter()
    ladder = unroll.ladder(UNROLL_RUNGS, dev)
    print(f"unroll ladder ({time.perf_counter() - t0:.1f} s in all):")
    for row in ladder:
        print(f"  n={row['size']} {row['kernel']} ({row['rows']} rows, "
              f"batch {row['batch']}): build {row['build_s']:.1f} s, "
              f"unrolled {row['ms_unrolled']:.3f} ms vs interpreter "
              f"{row['ms_interpreter']:.3f} ms, bit-identical "
              f"{row['identical']}")
    for row in ladder:
        if row["size"] != max(r["size"] for r in ladder
                              if r["kernel"] == row["kernel"]):
            continue          # each kernel's entry: its longest code
        ucode = PolarCode(*unroll.CODES[row["size"]])
        uplan = ScPlan.from_frozen(ucode.frozen)
        lsz, exact, batch = unroll.KERNELS[row["kernel"]]
        x = torch.from_numpy(np.random.default_rng(0).normal(
            2.0, 1.0, (batch, uplan.sched.code_len)).astype(
                np.float32)).to(dev)
        udec = make_decoder(ucode.frozen, lsz, exact, unroll=True,
                            device=dev)
        if lsz == 1:
            (cw_u, pm_u), n_u = drive(
                lambda: udec(x), lambda: sc_decode.variant_launches["unroll"],
                "unrolled A")

            def u_ref():
                return sc_decode_reference(x, uplan.sched)
        else:
            vname = variant_name(exact, unroll=True)
            (cw_u, pm_u), n_u = drive(
                lambda: udec(x), lambda: scl_decode.variant_launches[vname],
                f"unrolled {row['kernel']}")

            def u_ref():
                return scl_decode_reference(x, uplan.sched, lsz, exact)
        # the unrolled kernel against the plain version on the same LLRs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cw_r, pm_r = u_ref()
        torch.cuda.synchronize()
        u_plain = (time.perf_counter() - t0) * 1e3
        check(torch.equal(cw_u, cw_r) and torch.allclose(
            pm_u, pm_r, rtol=PM_RTOL, atol=0.0),
            f"unrolled {row['kernel']} at n={row['size']} differs from its "
            "plain version")
        name = "sc_decode" if lsz == 1 else "scl_decode"
        option(f"{name}[{row['kernel']}+unroll]",
               f"modem_tpu_torch/csrc/{name}.cu (kernels/unroll.py)", n_u,
               row["ms_unrolled"], u_plain,
               float((pm_u - pm_r).abs().max()),
               (batch, uplan.sched.code_len), uplan.sched, lsz, exact,
               interpreter_ms=row["ms_interpreter"], build_s=row["build_s"],
               ladder=[r for r in ladder if r["kernel"] == row["kernel"]])
    print("unroll at wire size: not run (its build ran out of the "
          "machine's memory; PERF.md), and the pipelines refuse "
          "scl_unroll=True on a schedule of more than "
          f"{unroll.MAX_ROWS} rows on the card")

    # ---- 12. probes D, E, F ----------------------------------------------
    # each held to its plain twin at small R first, then its timing run is
    # the drive (counts at 0 just before, read just after)
    t0 = time.perf_counter()
    d_err = p256.check(dev)
    d_times, _ = drive(lambda: p256.timings(dev),
                       lambda: sum(p256.run.launches.values()), "probe D")
    d_launches = dict(p256.run.launches)
    for k, body in enumerate(p256.BODIES):
        check(d_launches.get(body, 0) > 0, f"probe D {body} never launched")
        (ms128, pl128), (ms256, pl256) = (d_times[body, P]
                                          for P in p256.PS)
        options.append({
            "name": f"probe_p256[{body}]", "route": "cuda",
            "source": "modem_tpu_torch/csrc/probe_p256.cu",
            "replaces": "bench/probe_p256.py:45",
            "launches": d_launches[body],
            "max_abs_err": d_err[body], "ms": ms128, "plain_ms": pl128,
            **p256.bound(body, 128, p256.R), "library_ms": None,
            "shape": [128, p256.COLS], "reps": p256.R,
            "us_per_iter": ms128 * 1e3 / p256.R, "ms_256": ms256,
            "plain_ms_256": pl256,
            "bound_ms_256": p256.bound(body, 256, p256.R)["bound_ms"],
            "ratio_256_128": ms256 / ms128})
        print(f"probe D {p256.LABELS[k]:34s}: P=128 "
              f"{ms128 * 1e3 / p256.R:.3f} us/iter, P=256 "
              f"{ms256 * 1e3 / p256.R:.3f} us/iter, ratio "
              f"{ms256 / ms128:.2f}x (plain twin {pl128 * 1e3 / p256.R:.2f} "
              f"/ {pl256 * 1e3 / p256.R:.2f} us/iter)")
    x_e = rank3.inputs()
    xt_e = torch.from_numpy(x_e).to(dev)
    e_err = {}
    for kind in rank3.KINDS:
        e_err[kind] = rank3.check_one(kind, rank3.run(kind, xt_e), x_e)
        rank3.check_one(kind, rank3.plain(kind, xt_e), x_e)
    e_ms, _ = drive(lambda: {kind: cuda_ms(lambda: rank3.run(kind, xt_e), 100)
                             for kind in rank3.KINDS},
                    lambda: sum(rank3.run.launches.values()), "probe E")
    e_launches = dict(rank3.run.launches)
    for kind in rank3.KINDS:
        check(e_launches.get(kind, 0) > 0, f"probe E {kind} never launched")
        e_plain = cuda_ms(lambda: rank3.plain(kind, xt_e), 100)
        options.append({
            "name": f"probe_rank3[{kind}]", "route": "cuda",
            "source": "modem_tpu_torch/csrc/probe_rank3.cu",
            "replaces": "bench/probe_rank3.py:33",
            "launches": e_launches[kind], "max_abs_err": e_err[kind],
            "ms": e_ms[kind], "plain_ms": e_plain, **rank3.bound(kind),
            "library_ms": None, "shape": [rank3.P, rank3.C]})
        print(f"probe E {kind}: kernel and twin equal to numpy (kernel max "
              f"diff {e_err[kind]}); {e_ms[kind] * 1e3:.2f} us a launch, "
              f"plain twin {e_plain * 1e3:.2f} us")
    f_err = interleave.check(dev)
    reps = INTERLEAVE_REPS
    f_t, _ = drive(lambda: interleave.timings(reps, WIDTH_REPS, dev),
                   lambda: sum(interleave.run.launches.values()), "probe F")
    f_launches = dict(interleave.run.launches)
    x_f = interleave.inputs(1).to(dev)
    x_w = interleave.inputs(1, 256, 1).to(dev)
    x_n = interleave.inputs(1, interleave.NARROW).to(dev)
    f_rows = (  # body, replaced site, [P, W], reps, plain twin
        ("chain", ":107", 128, reps,
         lambda: interleave.run_plain("chain", x_f, 1, reps)),
        ("leaf", ":107", 128, reps,
         lambda: interleave.run_plain("leaf", x_f, 1, reps)),
        ("narrow", ":177", interleave.NARROW, WIDTH_REPS,
         lambda: interleave.run_width_plain(x_n, interleave.NARROW,
                                            WIDTH_REPS)))
    for body, site, width, r, plain in f_rows:
        for key in (body, f"{body}_shared"):
            check(key == "chain_shared" or f_launches.get(key, 0) > 0,
                  f"probe F {key} never launched")
        t = f_t[body]
        f_plain = cuda_ms(plain, 1)
        entry = {
            "name": f"probe_interleave[{body}]", "route": "cuda",
            "source": "modem_tpu_torch/csrc/probe_interleave.cu",
            "replaces": f"bench/probe_interleave.py{site}",
            "launches": f_launches[body] + f_launches.get(f"{body}_shared", 0),
            "max_abs_err": f_err, "ms": t["single"], "plain_ms": f_plain,
            **interleave.bound("width" if body == "narrow" else body, 1, r,
                               width),
            "library_ms": None, "shape": [interleave.P, width], "reps": r,
            "dual_ms": t["dual"], "double_ms": t["double"],
            "verdict": interleave.verdict(t["single"], t["dual"],
                                          t["double"])}
        if "shared" in t:
            entry.update(shared_dual_ms=t["shared"],
                         shared_verdict=interleave.verdict(
                             t["single"], t["shared"], t["double"]))
        options.append(entry)
        print(f"probe F, {r} reps, plain twin single {f_plain:.1f} ms: "
              + interleave.report(body, t))
    check(f_launches.get("width", 0) > 0, "probe F width never launched")
    w_ms = f_t["width"]
    w_plain = cuda_ms(lambda: interleave.run_width_plain(x_w, 128, WIDTH_REPS),
                      1)
    options.append({
        "name": "probe_interleave[width]", "route": "cuda",
        "source": "modem_tpu_torch/csrc/probe_interleave.cu",
        "replaces": "bench/probe_interleave.py:177",
        "launches": f_launches["width"], "max_abs_err": f_err,
        "ms": w_ms[128], "plain_ms": w_plain,
        **interleave.bound("width", 1, WIDTH_REPS), "library_ms": None,
        "shape": [interleave.P, 128], "reps": WIDTH_REPS,
        "ms_256": w_ms[256],
        "bound_ms_256": interleave.bound("width", 1, WIDTH_REPS,
                                         256)["bound_ms"]})
    print(f"probe F width: 128 {w_ms[128]:.3f} ms, 256 {w_ms[256]:.3f} ms "
          f"({w_ms[256] / w_ms[128]:.2f}x) at {WIDTH_REPS} reps (plain twin "
          f"at 128 {w_plain:.1f} ms); probes in {time.perf_counter() - t0:.1f}"
          " s")
    print("probe launches, each probe's timing run: D "
          f"{d_launches}, E {e_launches}, F {f_launches}")

    sched = plan.sched
    kernels = [
        {"name": "sc_decode", "route": "cuda",
         "source": "modem_tpu_torch/csrc/sc_decode.cu",
         "replaces": "modem_tpu/kernels/scl_pallas.py:1732",
         "launches": launches, "max_abs_err": max_abs_err,
         "ms": kernel_ms, "plain_ms": plain_ms,
         **kernel_bound(sched, BATCH, 1), "library_ms": None,
         "shape": [BATCH, sched.code_len]},
        {"name": "scl_decode", "route": "cuda",
         "source": "modem_tpu_torch/csrc/scl_decode.cu",
         "replaces": "modem_tpu/kernels/scl_pallas.py:1732",
         "launches": dec_launches[1], "max_abs_err": list_err["B"],
         "ms": list_ms["B", FALLBACK_BATCH][0],
         "plain_ms": list_ms["B", FALLBACK_BATCH][1],
         **kernel_bound(sched, FALLBACK_BATCH, LIST_SIZE, True),
         "library_ms": None, "shape": [FALLBACK_BATCH, sched.code_len],
         "ms_1": list_ms["B", 1][0], "plain_ms_1": list_ms["B", 1][1],
         "bound_ms_1": kernel_bound(sched, 1, LIST_SIZE, True)["bound_ms"],
         "escalation_launches": esc_launches[1]},
        {"name": "scl_decode_fast", "route": "cuda",
         "source": "modem_tpu_torch/csrc/scl_decode.cu",
         "replaces": "modem_tpu/kernels/scl_pallas.py:1732",
         "launches": dec_launches[2], "max_abs_err": list_err["C"],
         "ms": list_ms["C", FALLBACK_BATCH][0],
         "plain_ms": list_ms["C", FALLBACK_BATCH][1],
         **kernel_bound(sched, FALLBACK_BATCH, LIST_SIZE, False),
         "library_ms": None, "shape": [FALLBACK_BATCH, sched.code_len],
         "ms_1": list_ms["C", 1][0], "plain_ms_1": list_ms["C", 1][1],
         "bound_ms_1": kernel_bound(sched, 1, LIST_SIZE, False)["bound_ms"],
         "escalation_launches": esc_c_launches[2]}] + options
    for k in kernels:
        print(f"bound {k['name']} at {k['shape']}: {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}: {k['bytes']} bytes, {k['operations']} "
              f"operations) against {k['ms']:.3f} ms measured, "
              f"{k['bound_ms'] / k['ms'] * 100:.2f} % of the roofline")
    print(json.dumps({
        "kernels": kernels, "card": card, "build_s": build_s,
        "frames_per_s": fps, "frames_per_s_runs": rates,
        "front_ms": front_ms, "select_ms": select_ms, "peak_mib": peak_mb,
        "oracle_agree": oracle_agree, "escalated": escalated,
        "escalation_recovered": saved, "escalation_recovered_fast": saved_c,
        "escalation_ms": esc_ms, "decoder_s": dec_s,
        "decoder_stage_ms": stage_ms, "override_us_per_row": per_row_us,
        "unroll_ladder": ladder}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
