#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (modem_tpu_torch) on one GPU.

Drives the port's paths as a user would, with every kernel built
from csrc/ by nvcc: the serving decode, AdaptivePipeline(8000, 6,
device="cuda") on batches of 512 mode-6 recordings made by the port's
own encoder (every frame through the SC kernel A, the frames whose CRC
fails through the list-8 kernel B, or C with scl_exact=False), the
interactive Decoder(8000, device="cuda") on whole recordings of every
mode (sync scan, OSD header, all-pairs payload demod, list decode with B
or C), and decode-all, pipeline.decode_recording_auto on int16 PCM (the
scan and its front end on the card, one header batch, one windowed
decode a mode group: A then B, or B alone), live decoding
(stream.StreamDecoder fed 1 s at a time) and the command line.

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel library (nvcc, sm_90a), one nvcc each, all
     started together: kernel A, kernels B and C, their C' options
     (scl_decode.cu again with -DSCL_DECODE_OPTIONS) and the probes D, E
     and F; report the build seconds and ptxas lines;
  3. the SC kernel against its plain PyTorch version on 64 noisy
     wire-size frames (noise at which plain SC loses some frames):
     codewords equal on every frame, path metrics within rtol 1e-4;
     its tiers of state (the depth from which a frame's state lives in
     shared memory, the bytes, the blocks an SM holds: at least 4) for
     int8 and f32 partial sums;
  4. the list-8 kernels B (exact) and C (Fast-SSC-List) each against its
     plain version on 16 noisy wire-size frames at sigma 0.70, the first
     8 of which are bench.py's parity batch: the same per-frame recovery
     of the sent codeword (as bench.scl_parity_check), the same codeword
     list in the same lane order on every frame, and the path metrics
     within rtol 1e-4; the same again at the Decoder's shape [1, 65536];
     then kernel against plain times at [16, 65536] and [1, 65536]; their
     tiers of state for L = 2, 4, 8 with int8 and f32 partial sums (depth,
     shared bytes, blocks an SM, global scratch a frame): the list-8 int8
     instance must get its shared tier;
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
     version at the main path's shape (and beside its time before the
     redesign, A_BEFORE_MS), and the peak device memory;
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
  8. the frozen golden recording tests/data/golden_mode6_galois.wav, read
     by the port's native WAV codec, decoded byte-exact by the serving
     pipeline on the card;
  9. the interactive Decoder on the card: the golden recording as 2-channel
     I/Q and as its first channel through the mono front end, with
     kernel B and with kernel C, and one recording of each of the 8 modes
     (the port's encoder, call sign N0CALL, 1 s of silence either side),
     each decoded byte-exact with the right mode and call sign; B and C
     launched once per decode, the OSD elimination kernel once a header
     hypothesis (its launches equal to the osd_decode calls, 255
     profiling.osd_steps each, on every drive of phases 9, 13 and 14:
     no header decode on the card takes the plain loop); then one
     whole decode's wall time with each kernel (the benchmark's
     m6-8k.interactive cell times the stages);
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
     output and its pm each at their own), D and F at every cluster size
     they are timed at (D's [P, 512] state on chip across a thread-block
     cluster of 2, 4, 8, 16 blocks at P = 128 and 4, 8, 16 at P = 256;
     F's 128 rows over 1, 2, 4, 8 blocks), E's five kinds at R = 1, 4
     and 43 on the probe's tile and a tile of ties and signed zeros (and
     numpy at R = 1, where the frame rank's 16 frames, one a block, show
     its grid of 16 blocks ran); then the timings at
     the original probes' R: microseconds an iteration at each cluster
     size with the bound and the share, D's P = 256 / 128 ratios, F's
     verdicts (chain, leaf and the narrow width-4 body: single, dual, dual
     through shared barriers, double) at each cluster size; E's µs an
     iteration at R = 20,000 and its one-pass launch (R = 1) timed on the
     device from a CUDA graph of 1,000 launches, beside torch.roll's
     (the roll's library call) and the host-paced launch; every twin
     and its kernel over the same 2,000 iterations (the kernels line's
     ms and plain_ms; the long launches under "timing"); each probe's
     seconds;
     the build (phase 2) fails if ptxas gives a probe kernel a stack
     frame or spills;
 13. decode-all (decode_recording_auto, each drive a warm-up call then a
     timed one with the counts at 0 just before): an hour of mono int16
     at 8 kHz (28,800,000 samples, 12 mode-6 frames at seeded offsets,
     bench/long_recording.py's layout) adaptive, 12/12 byte-exact; 64
     frames, 8 of each mode 6-13 in turn with 0.5 s gaps, seeded call
     signs, exact (B on every frame) and adaptive, 64/64 right and the
     two lists equal but for snr; each run's wall ms split into scan,
     headers, windows and payload, the chunks, A's, B's and the OSD
     kernel's launches and the peak device memory; every mode's B tier; A at the hour's
     [12, 65536] and B at the mode-6 group's [8, 65536] against their
     plain versions; the three golden WAVs read in wire dtype and
     decoded under "auto" (and by Decoder(mls_convention="auto")), a
     galois-only receiver rejecting the fibonacci one; one mode-6 frame
     through channel.reference_chain (-30 dB) decoded byte-exact;
 14. stream and CLI (each drive with the counts at 0 just before): the
     hour of phase 13 through stream.StreamDecoder(8000, channels=1,
     bits=16) in 1 s feeds, 12/12 byte-exact and equal to phase 13's
     decode_recording_auto (snr within 1e-4), one launch of B a frame,
     the samples held within buffer_bound, no feed over 1 s; wall s,
     real-time factor, median, longest and emitting feed ms, chunks,
     peak device memory; bench/stream_bench.py's 16 mode-6 frames (the
     port's Encoder.encode, seed 0) after a warm-up, in 1 s feeds and in
     one feed, 16/16 both ways; B at the stream's [1, 65536] against its
     plain version; the hour written and read back by the native WAV
     codec (csrc/modem_host.cc), its ms each way; the command line, whose
     WAVs go through the native codec, as subprocesses (python3 -m
     modem_tpu_torch.cli): the Makefile's smoke (encode, decode,
     compare), decode-all and decode-all --adaptive on a two-frame WAV,
     decode-stream PREFIX - through a pipe 1 s at a time with the first
     payload file written while stdin is open; then the same decodes
     through cli.main in this process for the launches of A, B and the
     OSD kernel, and A and B at decode-all's [2, 65536] against their
     plain versions; then the OSD header's elimination kernel
     (csrc/osd_eliminate.cu) on card tensors at 1, 12 and 128 headers
     (the Decoder's, decode-all's hour, HEADER_BATCH): byte for byte its
     plain loop's (kernels.osd_eliminate.osd_eliminate_reference) on the
     BCH generator in seeded reliability orders and on a rank-deficient
     matrix, its ms (as issued and from a CUDA graph) against the loop's
     on the card, and a whole osd_decode call's wall ms with each; its
     kernels-line entry counts the launches of phases 9, 13 and 14;
 15. multi-device (modem_tpu_torch.parallel; each drive with the counts
     at 0 just before): an NCCL group of one rank in this process (a
     FileStore group; make_mesh must refuse a CPU device on it):
     sharded_decode_batched on phase 6's 512 recordings with
     BatchPipeline(8000, 6, list_size=1) (kernel A at [512, 65536]) and on
     16 of them with BatchPipeline(8000, 6) (kernel B at [16, 65536]),
     then sharded_decode_recording on phase 13's hour (B at [12]), each
     equal to the single-device decode on bits, ok and flips, every frame
     byte-exact, the hour's positions equal to decode_recording's; wall ms
     of each beside the single-device one, and all_gather_rows' ms; then
     four gloo ranks spawned on this card (parallel.run_ranks; NCCL
     refuses two ranks on one GPU) decoding the hour, equal on every rank,
     with each rank's chunks of the sharded scan; then
     parallel.dryrun_multichip(2, "gloo", "cuda"); A and B at every shape
     of the phase against their plain versions;
 16. the impaired-channel envelope of the serving defaults (each drive
     with the counts at 0 just before): bench/ber_sweep.py's 64 mode-6
     recordings (payloads of seed 0, 0.5 s of silence either side)
     through channel.reference_chain (multipath x10, cfo 234.567 Hz, sfo
     147 ppm) with recording i's AWGN from default_rng(100 + i) at -30,
     -22, -20 and -18 dB, each level a cell decoded four ways: (a)
     AdaptivePipeline(8000, 6), stride 8; (b) the same at sync_stride=1;
     (c) BatchPipeline(8000, 6, list_size=8) at stride 8; (d)
     Decoder(8000) on each recording; per cell the byte-exact frames, ok
     frames with wrong bytes (must be 0), the escalations of (a) and (b),
     p0 of (a) against (b) and the frames one decoder recovers and another
     loses; (a) equals (c) on every key, and at -30 dB every decoder
     recovers 64/64; B's launches counted by shape; A at the cell's
     [64, 65536], and B at each of its shapes (the escalated rows of (a)
     at [16, 65536], (c)'s [64, 65536], the Decoder's [1, 65536]), each
     on that path's own LLRs, against their plain versions.

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
A_BEFORE_MS = 7.733      # kernel A at [512, 65536] before its redesign
                         # (PERF.md; same card)
# kernels B and C at [16, 65536] before their redesign (PERF.md; same card)
LIST_BEFORE_MS = {"B": 22.513, "C": 18.756}
# the unroll ladder in this run: A at both codes, B and C at the
# shorter (they take 5-10 minutes to build at 4096; PERF.md)
UNROLL_RUNGS = ((1024, "A"), (1024, "B"), (1024, "C"), (4096, "A"))
INTERLEAVE_REPS = 2000   # bench/probe_interleave.py's defaults
WIDTH_REPS = 50000
HOUR_SAMPLES = 3600 * 8000   # bench/long_recording.py: 1 h of 8 kHz mono
HOUR_FRAMES = 12
HOUR_SEED = 7
PER_MODE = 8                 # frames of each mode 6-13 in the auto recording
AUTO_SEED = 3
IMPAIRED_SEED = 2            # tests/test_channel.py's reference chain
STREAM_FRAMES = 16           # bench/stream_bench.py's default, seed 0
CLI_SEED = 21
ENVELOPE_FRAMES = 64         # bench/ber_sweep.py's geometry, payloads seed 0
ENVELOPE_DB = (-30.0, -22.0, -20.0, -18.0)   # the demo, then the cliff grid
ENVELOPE_SEED = 100          # recording i's AWGN: default_rng(100 + i)
ENVELOPE_SPREAD = 10
ENVELOPE_CFO_HZ = 234.567
ENVELOPE_SFO_PPM = 147.0
OSD_BATCHES = (1, 12, 128)   # headers a launch: the Decoder's hypothesis,
                             # decode-all's hour, HEADER_BATCH
OSD_REPS = 200               # host-issued launches a kernel timing
OSD_SEED = 21
OSD_PATHS: dict = {}         # OSD kernel launches of each drive, by label


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
    """The golden I/Q recording through the port's WAV reader (the native
    codec, as for any regular file)."""
    from modem_tpu_torch import wav
    data = wav.read_wav(os.path.join(ROOT, "tests", "data",
                                     "golden_mode6_galois.wav"))
    check((data.rate, data.channels, data.bits) == (8000, 2, 16),
          "golden recording format")
    return data.analytic


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


def stack_frames(ptxas_log: str) -> dict:
    """{kernel: (stack frame bytes, spill store bytes, spill load bytes)}
    from nvcc's -Xptxas -v report."""
    out, name = {}, None
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "bytes stack frame" in line:
            out[name] = tuple(int(w) for w in line.split()
                              if w.isdigit())[:3]
    return out


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


def osd_launches(label: str) -> int:
    """The OSD elimination kernel's launches since the counts were reset,
    held to the ``osd_decode`` calls (``profiling.osd_steps`` adds 255 a
    call on either device): every header decode of the drive went through
    the kernel.  Recorded in OSD_PATHS under ``label``."""
    from modem_tpu_torch import profiling
    from modem_tpu_torch.kernels.osd_eliminate import osd_eliminate
    n = osd_eliminate.launches
    check(n > 0 and profiling.osd_steps == 255 * n,
          f"{label}: {n} OSD kernel launches for {profiling.osd_steps} "
          "osd_steps (255 an osd_decode call)")
    OSD_PATHS[label] = n
    return n


def osd_entry(dev) -> dict:
    """The OSD header's elimination kernel on card tensors at OSD_BATCHES
    headers: byte for byte its plain loop's on the same inputs (the BCH
    generator in seeded reliability orders, and a rank-deficient matrix
    with repeated rows and a zero column, whose columns past the rank find
    no pivot), then timed in turns with the loop on the card, as the host
    issues it and from a CUDA graph; a whole ``osd_decode`` call's wall ms
    with the kernel and with the loop patched in.  Returns its
    kernels-line entry, with the launches OSD_PATHS counted on the main
    paths."""
    from modem_tpu_torch.card import graph_ms
    from modem_tpu_torch.fec import bch
    from modem_tpu_torch.fec import osd as osd_mod
    from modem_tpu_torch.kernels.osd_eliminate import (K, N, osd_eliminate,
                                                       osd_eliminate_reference)

    def plain(g, perm):
        return osd_eliminate_reference(g[:, perm].permute(1, 0, 2))

    rng = np.random.default_rng(OSD_SEED)
    low = rng.integers(0, 2, (40, N), dtype=np.uint8)
    deficient = np.concatenate([low, low[: K - 40]])
    deficient[:, 7] = 0
    gens = {"bch": torch.from_numpy(
                bch.generator_matrix().astype(np.uint8)).to(dev),
            "rank-deficient": torch.from_numpy(deficient).to(dev)}
    g = gens["bch"]
    by_batch = {}
    for batch in OSD_BATCHES:
        soft = torch.from_numpy(rng.integers(-128, 128, (batch, N))
                                ).float().to(dev)
        perm = torch.argsort(-soft.abs(), dim=1, stable=True)
        for name, gen in gens.items():
            red, piv = osd_eliminate(gen, perm)
            want_red, want_piv = plain(gen, perm)
            check(torch.equal(red, want_red) and torch.equal(piv, want_piv),
                  f"osd_eliminate [{batch}] on the {name} matrix differs "
                  "from its plain loop")
        ms, plain_ms = kernel_vs_plain_ms(lambda: osd_eliminate(g, perm),
                                          lambda: plain(g, perm), OSD_REPS)
        graph, _ = graph_ms(lambda: osd_eliminate(g, perm))
        decode_ms = wall_ms(lambda: osd_mod.osd_decode(soft), 5)
        osd_mod.osd_eliminate = plain
        try:
            decode_plain_ms = wall_ms(lambda: osd_mod.osd_decode(soft), 5)
        finally:
            osd_mod.osd_eliminate = osd_eliminate
        # g once (the blocks after the first read it from L2), perm, the
        # reduced matrices and the pivots
        bound = roofline(K * N + batch * (N * 8 + K * N + K * 8), 0)
        by_batch[batch] = {"ms": ms, "graph_ms": graph, "plain_ms": plain_ms,
                           **bound, "osd_decode_ms": decode_ms,
                           "osd_decode_plain_ms": decode_plain_ms}
        print(f"osd_eliminate [{batch}]: byte-equal to its plain loop on the "
              f"BCH generator and a rank-deficient matrix; {ms:.4f} ms a "
              f"launch as the host issues it, {graph:.4f} from a CUDA graph, "
              f"plain loop {plain_ms:.3f} ms; bound {bound['bound_ms']:.6f} "
              f"ms ({bound['bound_ms'] / graph * 100:.3f} %); osd_decode "
              f"{decode_ms:.3f} ms (plain loop {decode_plain_ms:.3f})")
    print(f"osd_eliminate launches on the main paths: {OSD_PATHS}")
    top = by_batch[OSD_BATCHES[-1]]
    return {"name": "osd_eliminate", "route": "cuda",
            "source": "modem_tpu_torch/csrc/osd_eliminate.cu",
            "replaces": "modem_tpu/fec/osd.py:84",
            "launches": sum(OSD_PATHS.values()),
            "launches_by_path": dict(OSD_PATHS), "max_abs_err": 0,
            **top, "library_ms": None, "shape": [OSD_BATCHES[-1], K, N],
            "by_batch": {str(b): v for b, v in by_batch.items()}}


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


def int16_pcm(x: np.ndarray):
    """A real recording quantised to the 16-bit wire format, as a
    PcmRecording (wav._quantize's rounding)."""
    from modem_tpu_torch.ingest import PcmRecording
    q = np.clip(np.rint(x * 32767.0), -32768, 32767).astype(np.int16)
    return PcmRecording(data=q, bits=16, rate=8000)


def hour_recording(dev, samples: int = HOUR_SAMPLES,
                   frames: int = HOUR_FRAMES):
    """bench/long_recording.py's recording: mono int16 at 8 kHz, ``frames``
    mode-6 frames (the port's encoder on ``dev``, seeded payloads, call
    sign CALL), each at a seeded offset in its own slot and at least 1 s
    apart, over 1e-4 of seeded noise.  Returns (PcmRecording, payloads,
    frame starts)."""
    from modem_tpu_torch import bits as B
    from modem_tpu_torch.encoder import Encoder
    from modem_tpu_torch.numerology import make_config

    cfg = make_config(8000, 6, 2000)
    rng = np.random.default_rng(HOUR_SEED)
    payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes()
                for _ in range(frames)]
    waves, _ = Encoder(cfg, device=dev).encode_batch(
        payloads, B.base37_encode(CALL))
    waves = waves.real.cpu().numpy()
    flen = waves.shape[1]
    gap = cfg.rate
    slot = (samples - gap) // frames
    check(slot > flen + gap, "recording too short for its frames")
    starts = np.sort(rng.integers(0, slot - flen - gap, frames)
                     + np.arange(frames) * slot + gap)
    xm = (1e-4 * rng.standard_normal(samples)).astype(np.float32)
    for s0, w in zip(starts, waves):
        xm[s0: s0 + flen] += w
    return int16_pcm(xm), payloads, starts


def auto_recording(dev, per_mode: int = PER_MODE):
    """``per_mode`` frames of each mode 6-13 in turn, seeded payloads and
    call signs, 0.5 s of silence around each, as mono int16 at 8 kHz.
    Returns (PcmRecording, [(mode, call sign, True, payload)])."""
    from modem_tpu_torch import bits as B
    from modem_tpu_torch.encoder import Encoder
    from modem_tpu_torch.numerology import MODES, make_config

    rng = np.random.default_rng(AUTO_SEED)
    encoders = {m: Encoder(make_config(8000, m, 2000), device=dev)
                for m in MODES}
    gap = torch.zeros(4000, dtype=torch.float32, device=dev)
    parts, sent = [gap], []
    for _ in range(per_mode):
        for m in sorted(MODES):
            payload = rng.integers(0, 256, MODES[m].data_bytes,
                                   dtype=np.uint8).tobytes()
            call = "".join(rng.choice(
                list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"), 6))
            w, _ = encoders[m].encode_batch([payload],
                                            B.base37_encode(call))
            parts += [w[0].real, gap]
            sent.append((m, call, True, payload))
    return int16_pcm(torch.cat(parts).cpu().numpy()), sent


def decode_all(dev, reset_counts, hour_samples: int = HOUR_SAMPLES,
               hour_frames: int = HOUR_FRAMES, per_mode: int = PER_MODE):
    """Phase 13: pipeline.decode_recording_auto, the decode-all path, on
    recordings made on the card by the port's encoder (and channel), and
    on the golden WAVs read by the port's wav module.  Each drive runs
    with the launch counts at 0 just before and read just after.
    Returns (summary dict, kernel entries for A and B on this path)."""
    from modem_tpu_torch import bits as B
    from modem_tpu_torch import channel, wav
    from modem_tpu_torch.decoder import Decoder, cached_decoder
    from modem_tpu_torch.encoder import Encoder
    from modem_tpu_torch.kernels.sc_decode import (sc_decode,
                                                   sc_decode_reference)
    from modem_tpu_torch.kernels.scl_decode import (list_blocks_per_sm,
                                                    list_tiers, scl_decode,
                                                    scl_decode_reference)
    from modem_tpu_torch.numerology import MODES, make_config
    from modem_tpu_torch.pipeline import (cached_adaptive_pipeline,
                                          cached_pipeline,
                                          decode_recording_auto)

    summary = {}

    def drive(label, pcm, **kw):
        """One warm-up call, then one timed call with every count at 0
        just before and read just after, the peak device memory reset
        before it; the PcmRecording is made anew for each call, so its
        one copy to the card counts."""
        def fresh():
            return type(pcm)(data=pcm.data, bits=pcm.bits, rate=pcm.rate)
        decode_recording_auto(fresh(), 8000, device=dev, **kw)
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = decode_recording_auto(fresh(), 8000, device=dev, stats=stats,
                                    **kw)
        torch.cuda.synchronize()
        stats["wall_ms"] = (time.perf_counter() - t0) * 1e3
        stats["launches_A"] = sc_decode.launches
        stats["launches_B"] = scl_decode.launches
        stats["launches_C"] = scl_decode.fast_launches
        stats["launches_osd"] = osd_launches(f"decode-all {label}")
        stats["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
        summary[label] = stats
        print(f"decode-all {label}: {len(out)} frames; wall {stats['wall_ms']:.1f}"
              f" ms (scan {stats['scan_ms']:.1f} in {stats['chunks']} chunks, "
              f"headers {stats['headers_ms']:.1f}, windows "
              f"{stats['windows_ms']:.1f}, payload {stats['payload_ms']:.1f});"
              f" launches A {stats['launches_A']}, B {stats['launches_B']}, "
              f"C {stats['launches_C']}, OSD {stats['launches_osd']}; peak "
              f"device memory {stats['peak_mib']:.0f} MiB")
        check(stats["launches_C"] == 0, f"{label} launched kernel C")
        return out

    # -- 13.1 an hour of int16 audio, 12 mode-6 frames (the layout of
    # bench/long_recording.py: one slot a frame, at least 1 s apart)
    t0 = time.perf_counter()
    cfg = make_config(8000, 6, 2000)
    hour, payloads, starts = hour_recording(dev, hour_samples, hour_frames)
    print(f"decode-all hour: {hour_samples} samples of mono int16 at 8 kHz "
          f"({hour.data.nbytes / 1e6:.1f} MB), {hour_frames} mode-6 frames, "
          f"made in {time.perf_counter() - t0:.1f} s")
    out = hour_out = drive("hour", hour, channels=1, adaptive=True)
    got = [(f["mode"], f["call_sign"], f["ok"], f["payload"]) for f in out]
    offsets = {f["pos"] - int(s0) for f, s0 in zip(out, starts)}
    check(got == [(6, CALL, True, p) for p in payloads],
          f"hour: {sum(g[2] for g in got)} of {hour_frames} frames ok")
    check(len(offsets) == 1, f"hour: frame positions off the layout "
          f"{sorted(offsets)}")
    hour_stats = summary["hour"]
    hour_stats["realtime_x"] = hour_samples / 8000 / (
        hour_stats["wall_ms"] / 1e3)
    print(f"decode-all hour: {hour_frames}/{hour_frames} frames byte-exact, "
          f"mode 6, {CALL}; {hour_stats['realtime_x']:.1f}x real time")

    # A at this path's shape: the hour's frames through the SC pipeline's
    # front end, kernel against its plain version
    pipe = cached_adaptive_pipeline(8000, 6, device=dev)
    wins, _ = pipe.windows_at(hour, [f["pos"] for f in out])
    llrs_a = pipe.sc.demod(wins)["llrs"]
    plan6 = pipe.sc.plan
    cw_k, pm_k = sc_decode(llrs_a, plan6)
    cw_r, pm_r = sc_decode_reference(llrs_a, plan6.sched)
    check(torch.equal(cw_k, cw_r) and torch.allclose(
        pm_k, pm_r, rtol=PM_RTOL, atol=0.0),
        "decode-all: kernel A differs from its plain version")
    a_err = float((pm_k - pm_r).abs().max())
    a_ms, a_plain = kernel_vs_plain_ms(
        lambda: sc_decode(llrs_a, plan6),
        lambda: sc_decode_reference(llrs_a, plan6.sched), 10)
    print(f"decode-all A at [{hour_frames}, 65536]: codewords equal, max "
          f"|pm diff| {a_err}; {a_ms:.3f} ms vs plain {a_plain:.1f} ms")

    # -- 13.2 frames of every mode, auto mode: 0.5 s gaps, modes 6-13 in
    # turn, seeded payloads and call signs
    t0 = time.perf_counter()
    auto_rec, sent = auto_recording(dev, per_mode)
    n_auto = len(sent)
    print(f"decode-all auto: {n_auto} frames ({per_mode} of each mode "
          f"6-13), {auto_rec.n_samples} samples of mono int16, made in "
          f"{time.perf_counter() - t0:.1f} s")
    lists = {}
    for adaptive in (False, True):
        label = f"auto {'adaptive' if adaptive else 'exact'}"
        out = drive(label, auto_rec, channels=1, adaptive=adaptive)
        got = [(f["mode"], f["call_sign"], f["ok"], f["payload"])
               for f in out]
        good = sum(g == w for g, w in zip(got, sent))
        check(got == sent, f"{label}: {good} of {n_auto} frames right")
        lists[adaptive] = [{k: v for k, v in f.items() if k != "snr"}
                           for f in out]
        print(f"decode-all {label}: {n_auto}/{n_auto} frames with the right "
              "mode, call sign and bytes")
    check(lists[False] == lists[True],
          "decode-all: adaptive and exact lists differ")
    check(summary["auto exact"]["launches_B"] == len(MODES)
          and summary["auto exact"]["launches_A"] == 0,
          "decode-all exact: not one kernel-B launch a mode group")
    for m in sorted(MODES):
        t = list_tiers(cached_pipeline(8000, m, device=dev).plan.sched, 8)
        print(f"decode-all tiers B, mode {m}: shared from depth {t.depth}, "
              f"{t.shared_bytes} bytes, {list_blocks_per_sm(t, True)} block "
              "an SM")

    # B at this path's shape: the mode-6 group, [per_mode, 65536]
    pipe_b = cached_pipeline(8000, 6, device=dev)
    pos6 = [f["pos"] for f in lists[True] if f["mode"] == 6]
    wins, _ = pipe_b.windows_at(auto_rec, pos6)
    llrs_b = pipe_b.demod(wins)["llrs"]
    cw_k, pm_k = scl_decode(llrs_b, pipe_b.plan, LIST_SIZE, True)
    cw_r, pm_r = scl_decode_reference(llrs_b, pipe_b.plan.sched, LIST_SIZE,
                                      True)
    check(torch.equal(cw_k, cw_r) and torch.allclose(
        pm_k, pm_r, rtol=PM_RTOL, atol=0.0),
        "decode-all: kernel B differs from its plain version")
    b_err = float((pm_k - pm_r).abs().max())
    b_ms, b_plain = kernel_vs_plain_ms(
        lambda: scl_decode(llrs_b, pipe_b.plan, LIST_SIZE, True),
        lambda: scl_decode_reference(llrs_b, pipe_b.plan.sched, LIST_SIZE,
                                     True), 5)
    print(f"decode-all B at [{len(pos6)}, 65536]: codewords and lane order "
          f"equal, max |pm diff| {b_err}; {b_ms:.3f} ms vs plain "
          f"{b_plain:.1f} ms")

    # -- 13.3 the three MLS conventions: the golden WAVs in wire dtype
    want = np.load(os.path.join(ROOT, "tests", "data",
                                "waveform_pin_payload_seed.npy")).tobytes()
    auto_dec = cached_decoder(8000, mls_convention="auto", device=dev)
    for conv in ("galois", "fibonacci", "msb"):
        path = os.path.join(ROOT, "tests", "data", f"golden_mode6_{conv}.wav")
        pcm = wav.read_wav_raw(path)
        out = decode_recording_auto(pcm, 8000, channels=2,
                                    mls_convention="auto", device=dev)
        check([(f["mode"], f["ok"], f["payload"]) for f in out]
              == [(6, True, want)], f"decode-all auto convention: {conv}")
        res = auto_dec.decode(wav.read_wav(path).analytic, channels=2)
        check(res.ok and res.payload == want,
              f"Decoder(mls_convention='auto') on {conv}: {res.status}")
        print(f"decode-all conventions: golden_mode6_{conv}.wav byte-exact "
              "through decode_recording_auto and Decoder under 'auto'")
    fib = os.path.join(ROOT, "tests", "data", "golden_mode6_fibonacci.wav")
    galois_only = Decoder(8000, device=dev).decode(
        wav.read_wav(fib).analytic, channels=2)
    out = decode_recording_auto(wav.read_wav_raw(fib), 8000, channels=2,
                                device=dev)
    check(not galois_only.ok and not any(f["ok"] for f in out),
          "a galois-only receiver decoded the fibonacci recording")
    print(f"decode-all conventions: a galois-only receiver rejects the "
          f"fibonacci recording ({galois_only.status!r}; decode-all "
          f"{[f['status'] for f in out]})")

    # -- 13.4 the impaired chain at the demonstrated -30 dB point
    rng = np.random.default_rng(HOUR_SEED)
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    w, _ = Encoder(cfg, device=dev).encode_batch([payload],
                                                  B.base37_encode(CALL))
    sil = np.zeros(cfg.rate, np.complex64)
    clean = np.concatenate([sil, w[0].cpu().numpy(), sil])
    impaired = channel.reference_chain(
        clean, 8000, rng=np.random.default_rng(IMPAIRED_SEED)).astype(
        np.complex64)
    out = decode_recording_auto(impaired, 8000, channels=2, adaptive=True,
                                device=dev)
    check([(f["mode"], f["ok"], f["payload"]) for f in out]
          == [(6, True, payload)], "decode-all: impaired frame")
    summary["impaired_flips"] = out[0]["flips"]
    print(f"decode-all impaired: multipath x10, cfo 234.567 Hz, sfo 147 "
          f"ppm, awgn -30 dB: byte-exact, {out[0]['flips']} bit flips, "
          f"mean Es/N0 {float(np.mean(out[0]['snr'])):.2f} dB")

    entries = [
        {"name": "sc_decode[decode-all]", "route": "cuda",
         "source": "modem_tpu_torch/csrc/sc_decode.cu",
         "replaces": "modem_tpu/kernels/scl_pallas.py:1732",
         "launches": summary["hour"]["launches_A"]
         + summary["auto adaptive"]["launches_A"],
         "max_abs_err": a_err, "ms": a_ms, "plain_ms": a_plain,
         **kernel_bound(plan6.sched, len(llrs_a), 1), "library_ms": None,
         "shape": list(llrs_a.shape)},
        {"name": "scl_decode[decode-all]", "route": "cuda",
         "source": "modem_tpu_torch/csrc/scl_decode.cu",
         "replaces": "modem_tpu/kernels/scl_pallas.py:1732",
         "launches": summary["auto exact"]["launches_B"]
         + summary["auto adaptive"]["launches_B"]
         + summary["hour"]["launches_B"],
         "max_abs_err": b_err, "ms": b_ms, "plain_ms": b_plain,
         **kernel_bound(pipe_b.plan.sched, len(llrs_b), LIST_SIZE, True),
         "library_ms": None, "shape": list(llrs_b.shape)}]
    check(entries[0]["launches"] > 0 and entries[1]["launches"] > 0,
          "decode-all: kernel A or B never launched")
    return summary, entries, (hour, hour_out, payloads)


def same_frames(got, want) -> bool:
    """Frame dicts equal on every key but snr, snr within 1e-4."""
    exact = ("pos", "mode", "call_sign", "ok", "payload", "flips", "status")
    return len(got) == len(want) and all(
        [a[k] for k in exact] == [b[k] for k in exact]
        and np.allclose(a["snr"], b["snr"], rtol=0, atol=1e-4)
        for a, b in zip(got, want))


def buffer_bound(sd, frame_samples: int, feed: int) -> int:
    """The most samples a StreamDecoder may hold after a feed, from its
    retirement rule (stream.StreamDecoder._retire): the span back to the
    oldest pending p0 (a frame waiting for its payload, at most a frame
    span; or a future event, at most c + 3L + 2g behind the end), its
    windows' lead 2s + 2g, a block, the mono front end's lead, and the
    feed itself."""
    cfg = sd.cfg
    s, g = cfg.symbol_len, cfg.guard_len
    return (max(frame_samples, sd.c + 3 * sd.L + 2 * g) + 2 * s + 2 * g
            + 512 + sd.lead + feed)


def cli_run(args, label: str, **kw):
    """python3 -m modem_tpu_torch.cli ARGS in a subprocess on the card;
    returns (completed process, wall s)."""
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "modem_tpu_torch.cli"]
                          + args, cwd=ROOT, capture_output=True, timeout=300,
                          **kw)
    wall = time.perf_counter() - t0
    check(done.returncode == 0, f"cli {label}: rc {done.returncode}: "
          f"{done.stderr.decode(errors='replace')[-2000:]}")
    print(f"cli {label}: rc 0 in {wall:.2f} s")
    return done, wall


def stream_bench_pcm(dev, frames: int | None = None):
    """bench/stream_bench.py's recording: ``frames`` (STREAM_FRAMES)
    mode-6 frames of seeded payloads (seed 0) in one transmission of the
    port's Encoder.encode on ``dev``, 1 s of silence either side, mono
    int16 at 8 kHz.  Returns (samples, payloads)."""
    from modem_tpu_torch import bits as B
    from modem_tpu_torch.encoder import Encoder
    from modem_tpu_torch.numerology import make_config

    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
                for _ in range(frames or STREAM_FRAMES)]
    wave_, _ = Encoder(make_config(8000, 6, 2000, 1), device=dev).encode(
        payloads, B.base37_encode(CALL))
    sil = np.zeros(8000, np.complex64)
    rec = np.concatenate([sil, wave_, sil]).real
    return (np.clip(np.rint(rec * 32767), -32768, 32767).astype(np.int16),
            payloads)


def stream_and_cli(dev, reset_counts, hour, hour_ref, hour_payloads):
    """Phase 14: live decoding (stream.StreamDecoder) and the command line
    (modem_tpu_torch.cli) on the card.  Returns (summary dict, kernel
    entries for B on the stream, A and B on the CLI)."""
    import shutil
    import threading

    from modem_tpu_torch import cli, wav
    from modem_tpu_torch.kernels.sc_decode import (sc_decode,
                                                   sc_decode_reference)
    from modem_tpu_torch.kernels.scl_decode import (scl_decode,
                                                    scl_decode_reference)
    from modem_tpu_torch.numerology import make_config
    from modem_tpu_torch.pipeline import (cached_adaptive_pipeline,
                                          cached_pipeline)
    from modem_tpu_torch.stream import StreamDecoder

    cfg = make_config(8000, 6, 2000, 1)
    summary = {}

    def live(label, pcm, feed):
        """Stream ``pcm`` in blocks of ``feed`` samples (feed 0: all in
        one), every count at 0 just before, read just after; each feed's
        wall ms ends in a device synchronise."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        sd = StreamDecoder(8000, channels=1, bits=16, device=dev)
        step = feed or len(pcm)
        got, feed_ms, emit_ms = [], [], []
        t0 = time.perf_counter()
        for i in range(0, len(pcm), step):
            tf = time.perf_counter()
            out = sd.feed(pcm[i: i + step])
            torch.cuda.synchronize()
            feed_ms.append((time.perf_counter() - tf) * 1e3)
            if out:
                emit_ms.append(round(feed_ms[-1], 3))
            got += out
        tf = time.perf_counter()
        got += sd.finish()
        torch.cuda.synchronize()
        finish_ms = (time.perf_counter() - tf) * 1e3
        wall = time.perf_counter() - t0
        stats = dict(
            audio_s=len(pcm) / 8000, wall_s=wall,
            realtime_x=len(pcm) / 8000 / wall, feeds=len(feed_ms),
            median_feed_ms=float(np.median(feed_ms)),
            longest_feed_ms=max(feed_ms), emission_ms=emit_ms,
            finish_ms=finish_ms, chunks=sd.chunks,
            launches_A=sc_decode.launches, launches_B=scl_decode.launches,
            launches_C=scl_decode.fast_launches,
            launches_osd=osd_launches(f"stream {label}"),
            peak_buffered=sd.peak_buffered,
            buffer_bound=buffer_bound(sd, cfg.frame_samples, step),
            peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
            peak_rise_mib=(torch.cuda.max_memory_allocated() - held)
            / 2 ** 20)
        summary[label] = stats
        print(f"stream {label}: {stats['audio_s']:.0f} s of audio in "
              f"{stats['feeds']} feeds: wall {wall:.3f} s, "
              f"{stats['realtime_x']:.1f}x real time; feed ms median "
              f"{stats['median_feed_ms']:.3f}, longest "
              f"{stats['longest_feed_ms']:.3f}, finish {finish_ms:.3f}; "
              f"emitting feeds (ms) {emit_ms}; {sd.chunks} chunks; "
              f"launches A {stats['launches_A']}, B {stats['launches_B']}, "
              f"C {stats['launches_C']}, OSD {stats['launches_osd']}; "
              f"buffered at most "
              f"{sd.peak_buffered} samples (bound {stats['buffer_bound']}); "
              f"peak device memory {stats['peak_mib']:.0f} MiB, "
              f"{stats['peak_rise_mib']:.0f} MiB over the run's start")
        check(sd.peak_buffered <= stats["buffer_bound"],
              f"stream {label}: buffer over its bound")
        check(not feed or stats["longest_feed_ms"] < 1000.0,
              f"stream {label}: a 1 s feed took over 1 s: the stream "
              "falls behind a live source")
        check(stats["launches_C"] == 0 and stats["launches_A"] == 0,
              f"stream {label}: launched kernel A or C")
        return sorted(got, key=lambda f: f["pos"]), stats

    # -- 14.1 the live hour: phase 13's PCM, 1 s feeds
    got, stats = live("hour", hour.data, 8000)
    n = len(hour_payloads)
    check([(f["mode"], f["call_sign"], f["ok"], f["payload"]) for f in got]
          == [(6, CALL, True, p) for p in hour_payloads],
          f"stream hour: {sum(f['ok'] for f in got)} of {n} frames ok")
    check(same_frames(got, hour_ref),
          "stream hour: frames differ from decode_recording_auto's")
    check(stats["launches_B"] == n, "stream hour: not one B launch a frame")

    # the native WAV codec on the hour: written as 16-bit mono, read back
    # (floats and wire dtype); the numpy quantiser, its plain version, beside
    hour_wav = os.path.join(ROOT, "build", "chip_smoke_hour.wav")
    os.makedirs(os.path.dirname(hour_wav), exist_ok=True)
    x = hour.data.astype(np.float32) / np.float32(32767.0)
    tw = time.perf_counter()
    wav.write_wav(hour_wav, x, 8000, 16, 1)
    codec = {"write_ms": (time.perf_counter() - tw) * 1e3}
    tw = time.perf_counter()
    back = wav.read_wav(hour_wav)
    codec["read_ms"] = (time.perf_counter() - tw) * 1e3
    tw = time.perf_counter()
    wav._quantize(x.astype(np.float64), 16)
    codec["numpy_quantize_ms"] = (time.perf_counter() - tw) * 1e3
    check(np.array_equal(wav.read_wav_raw(hour_wav).data, hour.data)
          and np.allclose(back.samples[:, 0], x, rtol=1e-6, atol=0.0),
          "native WAV codec: the hour's samples changed in a round trip")
    os.remove(hour_wav)
    summary["native_wav"] = codec
    print(f"stream hour: {n}/{n} frames byte-exact, mode 6, {CALL}, equal "
          "to decode_recording_auto (snr within 1e-4); native WAV codec on "
          f"the hour ({len(x)} samples, 16-bit mono): write "
          f"{codec['write_ms']:.1f} ms, read {codec['read_ms']:.1f} ms, "
          "the int16 samples back exact (numpy quantiser alone "
          f"{codec['numpy_quantize_ms']:.1f} ms)")

    # B at the stream's shape: one frame, [1, 65536]
    pipe_b = cached_pipeline(8000, 6, device=dev)
    wins, _ = pipe_b.windows_at(hour, [got[0]["pos"]])
    llrs_b = pipe_b.demod(wins)["llrs"]
    cw_k, pm_k = scl_decode(llrs_b, pipe_b.plan, LIST_SIZE, True)
    cw_r, pm_r = scl_decode_reference(llrs_b, pipe_b.plan.sched, LIST_SIZE,
                                      True)
    check(torch.equal(cw_k, cw_r) and torch.allclose(
        pm_k, pm_r, rtol=PM_RTOL, atol=0.0),
        "stream: kernel B differs from its plain version")
    b_err = float((pm_k - pm_r).abs().max())
    b_ms, b_plain = kernel_vs_plain_ms(
        lambda: scl_decode(llrs_b, pipe_b.plan, LIST_SIZE, True),
        lambda: scl_decode_reference(llrs_b, pipe_b.plan.sched, LIST_SIZE,
                                     True), 5)
    print(f"stream B at [1, 65536]: codewords and lane order equal, max "
          f"|pm diff| {b_err}; {b_ms:.3f} ms vs plain {b_plain:.1f} ms")

    # -- 14.2 bench/stream_bench.py's geometry: 16 mode-6 frames, seed 0
    pcm, payloads = stream_bench_pcm(dev)
    live("bench warm-up", pcm, 8000)
    replays = {}
    for label, feed in (("bench", 8000), ("bench one feed", 0)):
        got, _ = live(label, pcm, feed)
        check([(f["ok"], f["payload"]) for f in got]
              == [(True, p) for p in payloads],
              f"stream {label}: {sum(f['ok'] for f in got)} of "
              f"{STREAM_FRAMES} frames byte-exact")
        replays[label] = got
    check(same_frames(replays["bench"], replays["bench one feed"]),
          "stream bench: 1 s feeds and one feed differ")
    print(f"stream bench: {STREAM_FRAMES}/{STREAM_FRAMES} frames byte-exact "
          "in 1 s feeds and in one feed")

    # -- 14.3 the command line: subprocesses as a user runs them, then the
    # same commands in this process to count the launches
    work = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(CLI_SEED)
    data = [rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
            for _ in range(3)]
    inputs = [os.path.join(work, f"in{i}.dat") for i in range(3)]
    for name, payload in zip(inputs, data):
        with open(name, "wb") as f:
            f.write(payload)
    path = lambda name: os.path.join(work, name)  # noqa: E731

    def read(name):
        with open(path(name), "rb") as f:
            return f.read()

    walls = {}
    # the reference's smoke (Makefile:12-20)
    _, walls["encode"] = cli_run(
        ["encode", path("encoded.wav"), "8000", "8", "1", "2000", "6", CALL,
         inputs[0]], "encode (Makefile smoke)")
    done, walls["decode"] = cli_run(
        ["decode", path("decoded.dat"), path("encoded.wav")],
        "decode (Makefile smoke)")
    check(read("decoded.dat") == data[0], "cli smoke: payload differs")
    print("cli smoke: decoded.dat equals uncoded.dat; transcript tail "
          f"{done.stderr.decode().splitlines()[-1]!r}")
    _, walls["encode two"] = cli_run(
        ["encode", path("two.wav"), "8000", "16", "1", "2000", "6", CALL,
         inputs[1], inputs[2]], "encode two frames")
    for flag in ([], ["--adaptive"]):
        label = "decode-all" + "".join(" " + f for f in flag)
        prefix = path("all" + "".join(flag))
        _, walls[label] = cli_run(["decode-all"] + flag
                                  + [prefix, path("two.wav")], label)
        check([read(prefix + f".{i:03d}") for i in range(2)] == data[1:],
              f"cli {label}: payloads differ")
    walls["decode-stream"], first_at = pipe_stream(path("two.wav"),
                                                   path("live"), cfg)
    check([read(f"live.{i:03d}") for i in range(2)] == data[1:],
          "cli decode-stream: payloads differ")

    launches = {}
    for label, argv in (
            ("decode", ["decode", path("p.dat"), path("encoded.wav")]),
            ("decode-all", ["decode-all", path("p_all"), path("two.wav")]),
            ("decode-all --adaptive", ["decode-all", "--adaptive",
                                       path("p_ad"), path("two.wav")]),
            ("decode-stream", ["decode-stream", path("p_live"),
                               path("two.wav")])):
        reset_counts()
        rc = cli.main(argv, device=dev)
        torch.cuda.synchronize()
        launches[label] = (sc_decode.launches, scl_decode.launches,
                           scl_decode.fast_launches)
        osd_launches(f"cli {label}")
        check(rc == 0, f"cli.main {label}: rc {rc}")
    print(f"cli launches in this process (A, B, C): {launches}")
    check(launches["decode"] == (0, 1, 0)
          and launches["decode-all"] == (0, 1, 0)
          and launches["decode-all --adaptive"] == (1, 0, 0)
          and launches["decode-stream"][0] == 0
          and launches["decode-stream"][1] >= 1,
          "cli: the decodes did not go through A and B as expected")

    # A and B at the CLI's shapes: decode-all's two frames, [2, 65536]
    pipe = cached_adaptive_pipeline(8000, 6, device=dev)
    two = wav.read_wav_raw(path("two.wav"))
    frames = pipe.sc.sync.scan(two)
    wins, _ = pipe.windows_at(two, [c.p0 for c in frames if c.ok])
    llrs = pipe.sc.demod(wins)["llrs"]
    cw_k, pm_k = sc_decode(llrs, pipe.sc.plan)
    cw_r, pm_r = sc_decode_reference(llrs, pipe.sc.plan.sched)
    check(torch.equal(cw_k, cw_r) and torch.allclose(
        pm_k, pm_r, rtol=PM_RTOL, atol=0.0),
        "cli: kernel A differs from its plain version")
    a_err = float((pm_k - pm_r).abs().max())
    a_ms, a_plain = kernel_vs_plain_ms(
        lambda: sc_decode(llrs, pipe.sc.plan),
        lambda: sc_decode_reference(llrs, pipe.sc.plan.sched), 10)
    cw_k, pm_k = scl_decode(llrs, pipe.scl.plan, LIST_SIZE, True)
    cw_r, pm_r = scl_decode_reference(llrs, pipe.scl.plan.sched, LIST_SIZE,
                                      True)
    check(torch.equal(cw_k, cw_r) and torch.allclose(
        pm_k, pm_r, rtol=PM_RTOL, atol=0.0),
        "cli: kernel B differs from its plain version")
    c_err = float((pm_k - pm_r).abs().max())
    c_ms, c_plain = kernel_vs_plain_ms(
        lambda: scl_decode(llrs, pipe.scl.plan, LIST_SIZE, True),
        lambda: scl_decode_reference(llrs, pipe.scl.plan.sched, LIST_SIZE,
                                     True), 5)
    print(f"cli A at [{len(llrs)}, 65536]: {a_ms:.3f} ms vs plain "
          f"{a_plain:.1f} ms, max |pm diff| {a_err}; B: {c_ms:.3f} ms vs "
          f"plain {c_plain:.1f} ms, max |pm diff| {c_err}")
    summary["cli_wall_s"] = walls
    summary["cli_first_payload_s"] = first_at
    summary["cli_launches"] = {k: list(v) for k, v in launches.items()}

    entries = [
        {"name": "scl_decode[stream]", "route": "cuda",
         "source": "modem_tpu_torch/csrc/scl_decode.cu",
         "replaces": "modem_tpu/kernels/scl_pallas.py:1732",
         "launches": summary["hour"]["launches_B"]
         + summary["bench"]["launches_B"]
         + summary["bench one feed"]["launches_B"],
         "max_abs_err": b_err, "ms": b_ms, "plain_ms": b_plain,
         **kernel_bound(pipe_b.plan.sched, 1, LIST_SIZE, True),
         "library_ms": None, "shape": list(llrs_b.shape)},
        {"name": "sc_decode[cli]", "route": "cuda",
         "source": "modem_tpu_torch/csrc/sc_decode.cu",
         "replaces": "modem_tpu/kernels/scl_pallas.py:1732",
         "launches": sum(v[0] for v in launches.values()),
         "max_abs_err": a_err, "ms": a_ms, "plain_ms": a_plain,
         **kernel_bound(pipe.sc.plan.sched, len(llrs), 1),
         "library_ms": None, "shape": list(llrs.shape)},
        {"name": "scl_decode[cli]", "route": "cuda",
         "source": "modem_tpu_torch/csrc/scl_decode.cu",
         "replaces": "modem_tpu/kernels/scl_pallas.py:1732",
         "launches": sum(v[1] for v in launches.values()),
         "max_abs_err": c_err, "ms": c_ms, "plain_ms": c_plain,
         **kernel_bound(pipe.scl.plan.sched, len(llrs), LIST_SIZE, True),
         "library_ms": None, "shape": list(llrs.shape)}]
    shutil.rmtree(work, ignore_errors=True)
    return summary, entries


def kernel_entry(name: str, plan, llrs, lsz: int, launches: int) -> dict:
    """Kernel A (``lsz`` 1) or the exact list-``lsz`` kernel B on ``llrs``
    timed in turns with its plain version and held to the plain output
    of the timed run (codewords and lane order equal, pm within
    PM_RTOL): its kernels-line entry."""
    from modem_tpu_torch.kernels.sc_decode import (sc_decode,
                                                   sc_decode_reference)
    from modem_tpu_torch.kernels.scl_decode import (scl_decode,
                                                    scl_decode_reference)
    if lsz == 1:
        source = "sc_decode"
        kernel = lambda: sc_decode(llrs, plan)               # noqa: E731
        plain = lambda: sc_decode_reference(llrs, plan.sched)  # noqa: E731
    else:
        source = "scl_decode"
        kernel = lambda: scl_decode(llrs, plan, lsz, True)    # noqa: E731
        plain = lambda: scl_decode_reference(           # noqa: E731
            llrs, plan.sched, lsz, True)
    kept = []
    ms, plain_ms = kernel_vs_plain_ms(
        kernel, lambda: kept.append(plain()), 5)
    (cw_k, pm_k), (cw_r, pm_r) = kernel(), kept[0]
    shape = list(llrs.shape)
    check(torch.equal(cw_k, cw_r) and torch.allclose(
        pm_k, pm_r, rtol=PM_RTOL, atol=0.0),
        f"{name} at {shape} differs from its plain version")
    err = float((pm_k - pm_r).abs().max())
    print(f"{name} at {shape} (L = {lsz}): codewords and lane order equal, "
          f"max |pm diff| {err}; {ms:.3f} ms vs plain {plain_ms:.1f} ms; "
          f"{launches} launches on the path")
    return {"name": name, "route": "cuda",
            "source": f"modem_tpu_torch/csrc/{source}.cu",
            "replaces": "modem_tpu/kernels/scl_pallas.py:1732",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **kernel_bound(plan.sched, len(llrs), lsz),
            "library_ms": None, "shape": shape, "list_size": lsz}


def multi_device(dev, reset_counts, recs, payloads, hour, hour_payloads):
    """Phase 15: modem_tpu_torch.parallel on the card, each drive with the
    launch counts at 0 just before it and read just after.  Returns
    (summary, kernel entries for A and B on these paths)."""
    import tempfile

    import torch.distributed as dist

    from modem_tpu_torch import bits as B
    from modem_tpu_torch import parallel as P
    from modem_tpu_torch.kernels.sc_decode import sc_decode
    from modem_tpu_torch.kernels.scl_decode import scl_decode
    from modem_tpu_torch.pipeline import BatchPipeline

    summary = {}
    pipe_a = BatchPipeline(8000, 6, list_size=1, device=dev)
    pipe_b = BatchPipeline(8000, 6, device=dev)
    recs_b, payloads_b = recs[:FALLBACK_BATCH], payloads[:FALLBACK_BATCH]

    def fresh_hour():
        """The hour anew, so each call copies it to the card itself."""
        return type(hour)(data=hour.data, bits=hour.bits, rate=hour.rate)

    def host(res) -> dict:
        return {k: np.asarray(res[k].cpu() if isinstance(res[k], torch.Tensor)
                              else res[k]) for k in ("bits", "ok", "flips")}

    def held(got, want, sent, label) -> None:
        """Sharded equal to single-device on bits, ok and flips, and every
        frame byte-exact."""
        for key in ("bits", "ok", "flips"):
            check(np.array_equal(got[key], want[key]),
                  f"multi-device {label}: {key} differs from one device")
        good = sum(bool(ok) and B.scramble(B.bits_to_bytes_le(b)) == p
                   for b, ok, p in zip(got["bits"], got["ok"], sent))
        check(good == len(sent), f"multi-device {label}: {good} of "
              f"{len(sent)} frames byte-exact")

    # -- 15.1 NCCL: one rank on this card, in this process, its group on a
    # FileStore
    world = 1
    launches, pos_h = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=0, world_size=world)
        try:
            mesh = P.make_mesh(device=dev)
            try:
                P.make_mesh(device="cpu")
            except ValueError as err:
                print(f"multi-device nccl: make_mesh(device='cpu') refused: "
                      f"{err}")
            else:
                check(False, "an NCCL mesh took a CPU device")
            runs = {
                f"A [{len(recs)}]": (
                    lambda: pipe_a.decode_batch(recs),
                    lambda: P.sharded_decode_batched(
                        pipe_a, mesh, len(recs) // world)(recs), payloads),
                f"B [{len(recs_b)}]": (
                    lambda: pipe_b.decode_batch(recs_b),
                    lambda: P.sharded_decode_batched(
                        pipe_b, mesh, len(recs_b) // world)(recs_b),
                    payloads_b),
                "hour": (
                    lambda: pipe_b.decode_recording(fresh_hour()),
                    lambda: P.sharded_decode_recording(pipe_b, mesh,
                                                       fresh_hour()),
                    hour_payloads)}
            for label, (single, sharded, sent) in runs.items():
                want = single()
                sharded()                                   # warm-up
                torch.cuda.synchronize()
                reset_counts()
                got = sharded()
                torch.cuda.synchronize()
                launches[label] = (sc_decode.launches, scl_decode.launches,
                                   scl_decode.fast_launches)
                if label == "hour":
                    (got, pos), (want, pos_h) = got, want
                    check([int(p) for p in pos] == [int(p) for p in pos_h],
                          "multi-device hour: positions differ from "
                          "BatchPipeline.decode_recording's")
                held(host(got), host(want), sent, label)
                ms = wall_ms(single, 3), wall_ms(sharded, 3)
                summary[f"nccl {label}"] = {
                    "single_ms": ms[0], "sharded_ms": ms[1],
                    "launches_A": launches[label][0],
                    "launches_B": launches[label][1]}
                print(f"multi-device nccl world {world} {label}: "
                      f"{len(sent)}/{len(sent)} frames byte-exact, equal to "
                      f"one device on bits, ok, flips; wall {ms[1]:.1f} ms "
                      f"sharded vs {ms[0]:.1f} ms single-device; launches A "
                      f"{launches[label][0]}, B {launches[label][1]}, C "
                      f"{launches[label][2]}")
            bits = pipe_a.decode_batch(recs)["bits"]
            gather_ms = cuda_ms(lambda: P.all_gather_rows(bits, mesh), 10)
            summary["nccl all_gather_ms"] = gather_ms
            print(f"multi-device nccl: all_gather_rows of bits "
                  f"{list(bits.shape)} {bits.dtype} {gather_ms:.3f} ms")
        finally:
            dist.destroy_process_group()
    check(launches[f"A [{len(recs)}]"] == (1, 0, 0)
          and launches[f"B [{len(recs_b)}]"] == (0, 1, 0)
          and launches["hour"] == (0, 1, 0),
          f"multi-device nccl launches {launches}")

    # -- 15.2 gloo: four ranks time-sharing this card (NCCL refuses two
    # ranks on one GPU: "Duplicate GPU detected"); the second of two calls
    # on each rank is read
    t0 = time.perf_counter()
    job = (P.recording_worker, ((8000, 6, 8), fresh_hour(), 64))
    ranks = P.run_ranks(4, "gloo", "cuda", P.run_jobs, [job, job],
                        timeout=600)
    want = host(pipe_b.decode_recording(fresh_hour())[0])
    for r, (_first, (res, pos, got_payloads, stats)) in enumerate(ranks):
        check([int(p) for p in pos] == [int(p) for p in pos_h]
              and got_payloads == hour_payloads,
              f"multi-device gloo rank {r}: positions or payloads differ")
        held(host(res), want, hour_payloads, f"gloo rank {r}")
        summary[f"gloo rank {r}"] = stats
        print(f"multi-device gloo world 4 on one card, rank {r}: the hour "
              f"{len(pos)}/{len(hour_payloads)} byte-exact, positions equal; "
              f"{stats['rank_chunks']} of {stats['chunks']} chunks walked "
              f"here; wall {stats['wall_ms']:.1f} ms; launches A "
              f"{stats['launches_A']}, B {stats['launches_B']} (four "
              "processes share one card, NCCL refuses two ranks on one GPU: "
              "no scaling is measured)")
    walk = [r[1][3] for r in ranks]
    check(sum(w["rank_chunks"] for w in walk) == walk[0]["chunks"],
          "multi-device gloo: the ranks' chunks do not cover the walk")
    print(f"multi-device gloo: 4 ranks in {time.perf_counter() - t0:.1f} s "
          "(spawn and set-up included)")

    # -- 15.3 the dry-run: two gloo ranks on this card
    t0 = time.perf_counter()
    dry = P.dryrun_multichip(2, backend="gloo", device="cuda")
    summary["dryrun"] = dry
    print(f"multi-device dryrun: {time.perf_counter() - t0:.1f} s")

    # A and B at every shape of the phase, against their plain versions
    toy = P.toy_pipeline(4, device=dev)
    toy_llrs = toy.demod(P.toy_recordings(2, device=dev)[0])["llrs"]
    wires, _ = P.wire_recordings(2, dev)
    wins, _ = pipe_b.windows_at(hour, pos_h)
    hour_llrs = pipe_b.demod(wins)["llrs"]
    sched_b = pipe_b.plan
    entries = [
        kernel_entry("sc_decode[parallel]", pipe_a.plan,
                     pipe_a.demod(recs)["llrs"], 1,
                     launches[f"A [{len(recs)}]"][0]),
        kernel_entry("scl_decode[parallel]", sched_b,
                     pipe_b.demod(recs_b)["llrs"], LIST_SIZE,
                     launches[f"B [{len(recs_b)}]"][1]),
        kernel_entry("scl_decode[parallel]", sched_b, hour_llrs, LIST_SIZE,
                     launches["hour"][1]),
        kernel_entry("scl_decode[parallel]", sched_b, hour_llrs[:3],
                     LIST_SIZE, sum(r[1][3]["launches_B"] for r in ranks)),
        kernel_entry("scl_decode[parallel]", sched_b,
                     pipe_b.demod(wires)["llrs"], LIST_SIZE,
                     sum(d["wire_launches_B"] for d in dry)),
        kernel_entry("scl_decode[parallel]", toy.plan, toy_llrs[:1], 4,
                     sum(d["toy_launches_B"] for d in dry)),
        kernel_entry("scl_decode[parallel]", toy.plan, toy_llrs, 4,
                     sum(d["toy_batched_launches_B"] for d in dry))]
    check(all(e["launches"] > 0 for e in entries),
          f"multi-device: a kernel never launched: "
          f"{[(e['shape'], e['launches']) for e in entries]}")
    return summary, entries


def envelope_recordings(dev, frames: int = ENVELOPE_FRAMES):
    """bench/ber_sweep.py's geometry: ``frames`` mode-6 payloads of
    default_rng(0) encoded on ``dev`` by the port's Encoder.encode_batch
    (freq_off 2000, N0CALL), 0.5 s of silence either side, through the
    reference chain's multipath x10, cfo 234.567 Hz and sfo 147 ppm.
    Returns (payloads, clean length, the impaired recordings before their
    AWGN): channel.reference_chain is that chain then awgn, so each level
    adds its AWGN to these."""
    from modem_tpu_torch import bits as B
    from modem_tpu_torch import channel
    from modem_tpu_torch.encoder import Encoder
    from modem_tpu_torch.numerology import make_config

    cfg = make_config(8000, 6, 2000)
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes() for _ in range(frames)]
    waves, _ = Encoder(cfg, device=dev).encode_batch(payloads,
                                                     B.base37_encode(CALL))
    sil = np.zeros(cfg.rate // 2, np.complex64)
    clean = [np.concatenate([sil, w, sil]) for w in waves.cpu().numpy()]
    chained = [channel.sfo(channel.cfo(channel.multipath(
        c, spread=ENVELOPE_SPREAD), ENVELOPE_CFO_HZ, 8000), ENVELOPE_SFO_PPM)
        for c in clean]
    return payloads, clean, chained


def envelope(dev, reset_counts, frames: int = ENVELOPE_FRAMES,
             levels=ENVELOPE_DB):
    """Phase 16: the impaired-channel envelope of the serving defaults.
    Each level is a cell of ``frames`` recordings, decoded four ways, each
    drive with the counts at 0 just before and read just after: (a)
    AdaptivePipeline(8000, 6), stride 8, SC then list-8 on CRC failures;
    (b) the same at sync_stride=1; (c) BatchPipeline(8000, 6, list_size=8)
    at stride 8; (d) Decoder(8000) on each recording.  Returns (summary,
    kernel entries for A and B on this path)."""
    from modem_tpu_torch import channel
    from modem_tpu_torch.decoder import Decoder
    from modem_tpu_torch.kernels.sc_decode import sc_decode
    from modem_tpu_torch.kernels.scl_decode import scl_decode
    from modem_tpu_torch.pipeline import AdaptivePipeline, BatchPipeline

    t0 = time.perf_counter()
    payloads, clean, chained = envelope_recordings(dev, frames)
    n = len(clean[0])
    check(np.array_equal(
        channel.reference_chain(clean[0], 8000,
                                rng=np.random.default_rng(ENVELOPE_SEED),
                                cfo_hz=ENVELOPE_CFO_HZ,
                                sfo_ppm=ENVELOPE_SFO_PPM, awgn_db=levels[0],
                                spread=ENVELOPE_SPREAD),
        channel.awgn(chained[0], levels[0],
                     np.random.default_rng(ENVELOPE_SEED))),
        "envelope: the chain split before its AWGN differs from "
        "channel.reference_chain")
    chain_s = time.perf_counter() - t0
    print(f"envelope: {frames} mode-6 recordings of {n} samples through "
          f"multipath x{ENVELOPE_SPREAD}, cfo {ENVELOPE_CFO_HZ} Hz, sfo "
          f"{ENVELOPE_SFO_PPM} ppm in {chain_s:.1f} s on the host")

    pipes = {"a": AdaptivePipeline(8000, 6, device=dev)}
    state = pipes["a"].sc.state
    pipes["b"] = AdaptivePipeline(8000, 6, sync_stride=1, device=dev,
                                  state=state)
    pipes["c"] = BatchPipeline(8000, 6, list_size=LIST_SIZE, device=dev,
                               state=state)
    check((pipes["a"].sc.sync_stride, pipes["b"].sc.sync_stride,
           pipes["c"].sync_stride) == (8, 1, 8),
          "envelope: the decoders' coarse-sync strides are not 8, 1, 8")
    dec = Decoder(8000, device=dev)
    names = {"a": "adaptive stride 8", "b": "adaptive stride 1",
             "c": "list-8 stride 8", "d": "Decoder"}

    def counts():
        torch.cuda.synchronize()
        return sc_decode.launches, scl_decode.launches, \
            scl_decode.fast_launches

    # B runs at three shapes here, each counted on its own: the
    # escalation groups of (a) and (b) [FALLBACK_BATCH], (c) [frames],
    # the Decoder one recording at a time [1]
    cells = {}
    launches = {"A": 0, "B escalation": 0, "B list": 0, "B Decoder": 0}
    for db in levels:
        recs = np.stack([
            channel.awgn(y, db, np.random.default_rng(ENVELOPE_SEED + i))[:n]
            for i, y in enumerate(chained)]).astype(np.complex64)
        x = torch.from_numpy(recs).to(dev)
        good, wrong, hosts, cell = {}, {}, {}, {"db": db}
        for key in ("a", "b", "c"):
            pipe = pipes[key]
            reset_counts()
            tk = time.perf_counter()
            host = pipe.fetch(pipe.decode_batch(x))
            a_n, b_n, c_n = counts()
            cell[f"{key}_ms"] = (time.perf_counter() - tk) * 1e3
            check(c_n == 0, f"envelope {db} dB ({key}) launched kernel C")
            hosts[key] = host
            exact = [bool(host["ok"][i]) and pipe.payload_bytes(host, i)
                     == payloads[i] for i in range(frames)]
            good[key] = {i for i in range(frames) if exact[i]}
            wrong[key] = sum(bool(host["ok"][i]) and not exact[i]
                             for i in range(frames))
            cell[f"{key}_launches"] = [a_n, b_n]
            if key in ("a", "b"):
                cell[f"{key}_escalated"] = pipe.last_fallbacks
                check(a_n == 1 and b_n == -(-pipe.last_fallbacks
                                            // FALLBACK_BATCH),
                      f"envelope {db} dB ({key}): launches A {a_n}, B {b_n}"
                      f" for {pipe.last_fallbacks} escalations")
            else:
                check((a_n, b_n) == (0, 1),
                      f"envelope {db} dB (c): launches A {a_n}, B {b_n}")
            launches["A"] += a_n
            launches["B list" if key == "c" else "B escalation"] += b_n
        reset_counts()
        tk = time.perf_counter()
        res = [dec.decode(recs[i], channels=2) for i in range(frames)]
        a_n, b_n, c_n = counts()
        cell["d_ms"] = (time.perf_counter() - tk) * 1e3
        check(a_n == 0 and c_n == 0,
              f"envelope {db} dB (d): launched kernel A or C")
        launches["B Decoder"] += b_n
        cell["d_launches"] = [a_n, b_n]
        good["d"] = {i for i, r in enumerate(res)
                     if r.ok and r.payload == payloads[i]}
        wrong["d"] = sum(r.ok and r.payload != payloads[i]
                         for i, r in enumerate(res))
        for key in "abcd":
            cell[f"{key}_exact"] = len(good[key])
            cell[f"{key}_ok_wrong"] = wrong[key]
        p0_diff = hosts["a"]["p0"].astype(np.int64) - hosts["b"][
            "p0"].astype(np.int64)
        cell["p0_differ"] = int(np.count_nonzero(p0_diff))
        cell["p0_max_abs_diff"] = int(np.abs(p0_diff).max())
        lost = {f"{p} not {q}": sorted(good[p] - good[q])
                for p in "abcd" for q in "abcd"
                if p != q and good[p] - good[q]}
        cell["recovered_not_by"] = lost
        cell["lost_by_all"] = sorted(set(range(frames)).difference(
            *good.values()))
        cell["faults"] = sorted((good["b"] | good["d"]) - good["a"])
        cells[db] = cell
        print(f"envelope {db:+.0f} dB ({frames} recordings): byte-exact "
              + ", ".join(f"({k}) {names[k]} {len(good[k])}" for k in "abcd")
              + "; ok but wrong " + ", ".join(
                  f"({k}) {wrong[k]}" for k in "abcd")
              + f"; escalated (a) {cell['a_escalated']}, (b) "
              f"{cell['b_escalated']}; p0 (a) vs (b): {cell['p0_differ']} "
              f"differ, max |diff| {cell['p0_max_abs_diff']}; frames one "
              f"recovers and another loses: {lost or 'none'}; lost by all: "
              f"{cell['lost_by_all'] or 'none'}; wall ms (a) "
              f"{cell['a_ms']:.1f}, (b) {cell['b_ms']:.1f}, (c) "
              f"{cell['c_ms']:.1f}, (d) {cell['d_ms']:.1f}")
        check(not any(wrong.values()),
              f"envelope {db} dB: ok frames with wrong bytes {wrong}")
        check(set(hosts["a"]) == set(hosts["c"]),
              "envelope: adaptive result keys differ")
        for key in hosts["c"]:
            check(np.array_equal(hosts["a"][key], hosts["c"][key]),
                  f"envelope {db} dB: adaptive {key} differs from "
                  "BatchPipeline(list_size=8)")
        if db == levels[0]:
            check(all(len(g) == frames for g in good.values()),
                  f"envelope {db} dB: not every decoder recovers "
                  f"{frames}/{frames}")

    faults = {db: c["faults"] for db, c in cells.items() if c["faults"]}
    print(f"envelope: frames that stride 1 or the Decoder recovers and the "
          f"serving default loses (faults of the stride-8 path): "
          f"{faults or 'none'}; launches {launches}; phase in "
          f"{time.perf_counter() - t0:.1f} s")

    # A and B at each shape of this path, on the hardest cell's own
    # inputs: A at [frames] through (a)'s front end; B on the rows (a)
    # escalates, padded as resolve pads them, at [FALLBACK_BATCH]; B at
    # [frames] through (c)'s front end; B on the LLRs the Decoder lists
    # for one recording it decodes, at [1]
    pipe = pipes["a"]
    front = pipe.sc.demod(x)
    sc_ok = pipe.sc.fetch(pipe.sc._fec_select(front))["ok"]
    fails = np.flatnonzero(~sc_ok)[:FALLBACK_BATCH]
    check(fails.size > 0, "envelope: the hardest cell escalated no frame")
    group = np.full(FALLBACK_BATCH, fails[0], dtype=np.int64)
    group[: fails.size] = fails
    esc_llrs = front["llrs"].index_select(
        0, torch.as_tensor(group, device=x.device))
    i = min(good["d"])
    xd = dec.frontend(recs[i], 2)
    cands = [c for c in dec.sync.scan(xd) if c.ok]
    found = [(c, h) for c, (h, _) in zip(
        cands, dec.decode_headers_batch(xd, cands)) if h is not None]
    check(bool(found), f"envelope: no header in recording {i}")
    cand, hdr = found[0]
    dec_pipe = dec.pipeline(hdr[0])
    dec_llrs = dec_pipe.demod_at(
        xd[None], torch.tensor([cand.p0], device=x.device),
        torch.tensor([cand.cfo_rad], dtype=torch.float32,
                     device=x.device))[0]
    entries = [
        kernel_entry("sc_decode[envelope]", pipe.sc.plan, front["llrs"], 1,
                     launches["A"]),
        kernel_entry("scl_decode[envelope]", pipe.scl.plan, esc_llrs,
                     LIST_SIZE, launches["B escalation"]),
        kernel_entry("scl_decode[envelope]", pipes["c"].plan,
                     pipes["c"].demod(x)["llrs"], LIST_SIZE,
                     launches["B list"]),
        kernel_entry("scl_decode[envelope]", dec_pipe.plan, dec_llrs,
                     LIST_SIZE, launches["B Decoder"])]
    check(all(e["launches"] > 0 for e in entries),
          f"envelope: a kernel never launched at its shape: "
          f"{[(e['shape'], e['launches']) for e in entries]}")
    summary = {"chain_s": chain_s, "frames": frames,
               "cells": {str(db): c for db, c in cells.items()},
               "launches": launches}
    return summary, entries


def pipe_stream(wav_path: str, prefix: str, cfg):
    """``decode-stream PREFIX -`` in a subprocess fed through a pipe 1 s
    at a time: the first frame's payload file must appear while stdin is
    still open (written through the end of frame 0 plus 3 s, then
    waiting).  Returns (wall s, s until the first file appeared)."""
    with open(wav_path, "rb") as f:
        raw = f.read()
    head = raw.index(b"data") + 8
    block = 8000 * 2                                  # 1 s of mono int16
    first_end = 8000 + cfg.extended_len + cfg.frame_samples
    upto = head + (first_end // 8000 + 4) * block
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "modem_tpu_torch.cli", "decode-stream",
         prefix, "-"], cwd=ROOT, stdin=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        proc.stdin.write(raw[:head])
        for i in range(head, upto, block):
            proc.stdin.write(raw[i: i + block])
            proc.stdin.flush()
        first = prefix + ".000"
        deadline = time.perf_counter() + 240
        while not os.path.exists(first) and proc.poll() is None \
                and time.perf_counter() < deadline:
            time.sleep(0.05)
        first_at = time.perf_counter() - t0
        live_ok = os.path.exists(first)
        _, err = proc.communicate(raw[upto:], timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli decode-stream: rc {proc.returncode}: "
          f"{err.decode(errors='replace')[-2000:]}")
    check(live_ok, "cli decode-stream: no payload file before stdin closed")
    print(f"cli decode-stream through a pipe: rc 0 in {wall:.2f} s; "
          f"{prefix}.000 written {first_at:.2f} s after start, with "
          f"{(upto - head) // block} of {(len(raw) - head) // block} s sent "
          "and stdin open")
    return wall, first_at


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from modem_tpu_torch import bits as B
    from modem_tpu_torch import profiling
    from modem_tpu_torch.decoder import Decoder
    from modem_tpu_torch.encoder import Encoder
    from modem_tpu_torch.fec.polar import PolarCode
    from modem_tpu_torch.kernels import _build
    from modem_tpu_torch.kernels.osd_eliminate import osd_eliminate
    from modem_tpu_torch.kernels import sc_decode as sc_mod
    from modem_tpu_torch.kernels import scl_decode as scl_mod
    from modem_tpu_torch.kernels.sc_decode import (ScPlan, blocks_per_sm,
                                                   sc_decode,
                                                   sc_decode_reference,
                                                   tiers_of)
    from modem_tpu_torch.kernels.scl_decode import (LIST_SIZES,
                                                    list_blocks_per_sm,
                                                    list_tiers, scl_decode,
                                                    scl_decode_reference)
    from modem_tpu_torch.numerology import MODES, make_config
    from modem_tpu_torch.kernels import unroll
    from modem_tpu_torch.kernels.scl_decode import make_decoder, variant_name
    from modem_tpu_torch.pipeline import AdaptivePipeline, BatchPipeline
    from modem_tpu_torch.probes import interleave, p256, rank3
    from modem_tpu_torch.probes import _common
    from modem_tpu_torch.probes._common import PLAIN_REPS

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
        if name.startswith("probe_"):
            frames = stack_frames(log.read_text())
            off_chip = {k: v for k, v in frames.items() if any(v)}
            check(frames and not off_chip,
                  f"{name}: a kernel keeps state off chip (ptxas stack "
                  f"frame, spill stores, spill loads): {off_chip}")
            print(f"  {name}: {len(frames)} kernels, no stack frame, no "
                  "spill (the state stays in registers and shared memory)")

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
    tiers = {bc: tiers_of(plan.sched, bc) for bc in (True, False)}
    occupancy = {bc: blocks_per_sm(t) for bc, t in tiers.items()}
    for bc, t in tiers.items():
        print(f"tiers A ({'int8' if bc else 'f32'} betas): shared from depth "
              f"{t.depth} of {plan.sched.n_depths}, {t.shared_bytes} bytes "
              f"of dynamic shared memory a block, {occupancy[bc]} blocks "
              f"per SM; global scratch {t.g_llr_len} LLRs and "
              f"{t.g_beta_len} betas a frame")
    check(occupancy[True] >= 4, "kernel A holds fewer than 4 blocks an SM")

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
        for k, v in list_ms.items()) + " (at [16] before the redesign: "
        + ", ".join(f"{k} {v} ms" for k, v in LIST_BEFORE_MS.items()) + ")")
    # the list kernels' tiers of state: every lane's regions from depth D_s
    # in shared memory, one block an SM
    list_tier = {}
    for lsz in LIST_SIZES:
        for bc in (True, False):
            t = list_tiers(plan.sched, lsz, bc)
            blocks = {ex: list_blocks_per_sm(t, ex) for ex in (True, False)}
            list_tier[lsz, bc] = {
                "shared_depth": t.depth, "shared_bytes": t.shared_bytes,
                "blocks_per_sm": min(blocks.values()),
                "global_bytes_per_frame": lsz * (
                    4 * t.g_llr_len + t.beta_bytes * t.g_beta_len)}
            print(f"tiers B/C (L = {lsz}, {'int8' if bc else 'f32'} betas): "
                  f"shared from depth {t.depth} of {plan.sched.n_depths}, "
                  f"{t.shared_bytes} bytes of dynamic shared memory a block, "
                  f"B {blocks[True]} and C {blocks[False]} blocks per SM; "
                  "global scratch "
                  f"{list_tier[lsz, bc]['global_bytes_per_frame']} bytes a "
                  "frame")
    main_tier = list_tier[LIST_SIZE, True]
    check(main_tier["shared_depth"] < plan.sched.n_depths
          and main_tier["shared_bytes"] > 0
          and main_tier["blocks_per_sm"] >= 1,
          f"the list-8 int8 instance has no shared tier: {main_tier}")

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
        osd_eliminate.launches = profiling.osd_steps = 0
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
    a_bound = kernel_bound(plan.sched, BATCH, 1)["bound_ms"]
    print(f"stages per batch of {BATCH}: front end {front_ms:.2f} ms, "
          f"SC + CRC select {select_ms:.2f} ms; SC kernel {kernel_ms:.3f} "
          f"ms (before the redesign {A_BEFORE_MS} ms; bound "
          f"{a_bound:.4f} ms) "
          f"vs plain PyTorch {plain_ms:.1f} ms")

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
    dec_osd = osd_launches("Decoder")
    check(not any(option_counts().values()),
          f"the Decoder path launched {option_counts()}")
    check(dec_osd >= len(dec_rows), f"Decoder: {dec_osd} OSD launches for "
          f"{len(dec_rows)} decodes")
    print(f"decoder: {len(dec_rows)} recordings byte-exact with the right "
          f"mode and call sign in {dec_s:.2f} s; launches A, B, C "
          f"{dec_launches}, OSD {dec_osd} (one a header hypothesis): "
          + "; ".join(
              f"{name}: p0 {r.symbol_pos}, flips {r.bit_flips}, cfo "
              f"{r.cfo_hz:.3f} Hz" for name, r in dec_rows))
    check(dec_launches == (0, len(runs) + len(MODES), len(runs)),
          f"Decoder launches {dec_launches}")

    # one whole decode, golden I/Q, each kernel (the benchmark's
    # m6-8k.interactive cell times the stages: scan_ms, header_ms)
    stage_ms = {
        f"whole decode (I/Q, {'B' if ex else 'C'})": wall_ms(
            lambda d=d: d.decode(golden, channels=2), 5)
        for ex, d in decoders.items()}
    print("decoder, golden recording, median of 5: " + "; ".join(
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
    # each held to its plain twin at small R first (D and F at every
    # cluster size), then its timing run is the drive (counts at 0 just
    # before, read just after).  In each probe entry of the kernels line,
    # ms, plain_ms, bound_ms and library_ms are of one call of ``reps`` =
    # PLAIN_REPS iterations (kernel and twin by _common.pair_ms, the
    # kernel at its smallest cluster), and the times under "timing" of
    # one launch of its ``reps`` iterations, where us_per_iter comes from
    t0 = t_probe = time.perf_counter()
    d_err = p256.check(dev)
    (d_ms, d_pair), _ = drive(lambda: p256.timings(dev),
                              lambda: sum(p256.run.launches.values()),
                              "probe D")
    d_launches = dict(p256.run.launches)
    for k, body in enumerate(p256.BODIES):
        us = {}
        for P in p256.PS:
            bound_us = p256.bound(body, P, p256.R)["bound_ms"] * 1e3 / p256.R
            for n in p256.CLUSTERS[P]:
                check(d_launches.get((body, P, n), 0) > 0,
                      f"probe D {body} at P={P}, cluster {n} never launched")
                us[P, n] = d_ms[body, P, n] * 1e3 / p256.R
            print(f"probe D {p256.LABELS[k]:34s} P={P}: us/iter by cluster "
                  "size " + ", ".join(f"{n}: {us[P, n]:.3f}"
                                      for n in p256.CLUSTERS[P])
                  + f"; bound {bound_us:.6f} us/iter, share "
                  + ", ".join(f"{bound_us / us[P, n]:.2%}"
                              for n in p256.CLUSTERS[P])
                  + f" (over {PLAIN_REPS} iterations plain twin "
                  f"{d_pair[body, P][1]:.3f} ms, kernel "
                  f"{d_pair[body, P][0]:.4f} ms)")
        n128, n256 = p256.CLUSTERS[128][0], p256.CLUSTERS[256][0]
        ratios = {n: d_ms[body, 256, n] / d_ms[body, 128, n]
                  for n in p256.CLUSTERS[256]}
        print(f"probe D {body}: ratio P=256 / P=128 by cluster size "
              + ", ".join(f"{n}: {r:.2f}x" for n, r in ratios.items())
              + f"; at each P's smallest cluster "
              f"{d_ms[body, 256, n256] / d_ms[body, 128, n128]:.2f}x")
        (k128, p128), (k256, p256_ms) = d_pair[body, 128], d_pair[body, 256]
        options.append({
            "name": f"probe_p256[{body}]", "route": "cuda",
            "source": "modem_tpu_torch/csrc/probe_p256.cu",
            "replaces": "bench/probe_p256.py:45",
            "launches": sum(v for (b, _, _), v in d_launches.items()
                            if b == body),
            "max_abs_err": d_err[body], "reps": PLAIN_REPS, "ms": k128,
            "plain_ms": p128, "plain_us_per_iter": p128 * 1e3 / PLAIN_REPS,
            **p256.bound(body, 128, PLAIN_REPS), "library_ms": None,
            "shape": [128, p256.COLS], "cluster": n128,
            "ms_256": k256, "plain_ms_256": p256_ms, "cluster_256": n256,
            "bound_ms_256": p256.bound(body, 256, PLAIN_REPS)["bound_ms"],
            "us_per_iter": us[128, n128],
            "timing": {
                "reps": p256.R, "ms": d_ms[body, 128, n128],
                "ms_256": d_ms[body, 256, n256],
                "us_per_iter_by_cluster": {
                    str(P): {str(n): us[P, n] for n in p256.CLUSTERS[P]}
                    for P in p256.PS},
                "ratio_256_128": d_ms[body, 256, n256] / d_ms[body, 128, n128],
                "ratio_256_128_by_cluster": {str(n): r
                                             for n, r in ratios.items()}}})
    print(f"probe D: {time.perf_counter() - t_probe:.1f} s")
    t_probe = time.perf_counter()
    e_err = rank3.check(dev)
    print(f"probe E: every kind equal to its twin at R = {rank3.CHECK_REPS} "
          "on the probe's tile and the tile of ties, and to numpy at R = 1 "
          f"(max diff {max(e_err.values())}); block f of the frame rank "
          f"ranks frame f alone, so its {rank3.P // rank3.L} frames equal to "
          "numpy show its grid of one block a frame ran")
    (e_ms, e_pair), _ = drive(lambda: rank3.timings(dev),
                              lambda: sum(rank3.run.launches.values()),
                              "probe E per iteration")
    e_launches = dict(rank3.run.launches)
    e_pass, _ = drive(lambda: rank3.one_pass_us(dev),
                      lambda: sum(rank3.run.launches.values()),
                      "probe E one pass")
    e_pass_launches = dict(rank3.run.launches)
    e_roll = {r: rank3.library_us(dev, r) for r in (1, PLAIN_REPS)}
    for kind in rank3.KINDS:
        check(e_launches.get(kind, 0) > 0 and e_pass_launches.get(kind, 0) > 0,
              f"probe E {kind} never launched in a timing run "
              f"({e_launches.get(kind, 0)}, {e_pass_launches.get(kind, 0)})")
        k_ms, p_ms = e_pair[kind]
        bound = rank3.bound(kind, PLAIN_REPS)
        roll = kind == "sublane_roll"
        options.append({
            "name": f"probe_rank3[{kind}]", "route": "cuda",
            "source": "modem_tpu_torch/csrc/probe_rank3.cu",
            "replaces": "bench/probe_rank3.py:33",
            "launches": e_launches[kind] + e_pass_launches[kind],
            "max_abs_err": e_err[kind], "reps": PLAIN_REPS, "ms": k_ms,
            "plain_ms": p_ms, "plain_us_per_iter": p_ms * 1e3 / PLAIN_REPS,
            **bound, "share": bound["bound_ms"] / k_ms,
            "library_ms": e_roll[PLAIN_REPS] / 1e3 if roll else None,
            "shape": [rank3.P, rank3.C],
            "us_per_iter": e_ms[kind] * 1e3 / rank3.R,
            "us_reps1_device": e_pass[kind][0],
            "library_us_reps1_device": e_roll[1] if roll else None,
            "timing": {"reps": rank3.R, "ms": e_ms[kind]},
            "launches_per_iteration_run": e_launches[kind],
            "launches_one_pass_run": e_pass_launches[kind]})
    for line in rank3.report(e_ms, e_pair, e_pass, e_roll):
        print("probe E " + line)
    print(f"probe E: {time.perf_counter() - t_probe:.1f} s")
    t_probe = time.perf_counter()
    f_err = interleave.check(dev)
    reps = INTERLEAVE_REPS
    f_t, _ = drive(lambda: {c: interleave.timings(reps, WIDTH_REPS, dev, c)
                            for c in interleave.CLUSTERS},
                   lambda: sum(interleave.run.launches.values()), "probe F")
    f_launches = dict(interleave.run.launches)
    x_f = interleave.inputs(1).to(dev)
    x_w = interleave.inputs(1, 256, 1).to(dev)
    x_n = interleave.inputs(1, interleave.NARROW).to(dev)
    c1 = interleave.CLUSTERS[0]
    nw = interleave.NARROW
    f_rows = (  # body, replaced site, [P, W], reps, kernel (one chain at
        # the smallest cluster) and twin of r iterations
        ("chain", ":107", 128, reps,
         lambda r: interleave.run("chain", x_f, 1, r, cluster=c1),
         lambda r: interleave.run_plain("chain", x_f, 1, r)),
        ("leaf", ":107", 128, reps,
         lambda r: interleave.run("leaf", x_f, 1, r, cluster=c1),
         lambda r: interleave.run_plain("leaf", x_f, 1, r)),
        ("narrow", ":177", nw, WIDTH_REPS,
         lambda r: interleave.run_width(x_n, nw, r, cluster=c1),
         lambda r: interleave.run_width_plain(x_n, nw, r)))
    for body, site, width, r, kernel, plain in f_rows:
        for c in interleave.CLUSTERS:
            for key in (body, f"{body}_shared"):
                check(key == "chain_shared" or f_launches.get((key, c), 0) > 0,
                      f"probe F {key} at cluster {c} never launched")
        k_ms, p_ms = _common.pair_ms(kernel, plain)
        bound = interleave.bound("width" if body == "narrow" else body, 1, r,
                                 width)
        by_cluster = {}
        for c in interleave.CLUSTERS:
            t = f_t[c][body]
            by_cluster[str(c)] = {
                **{f"{k}_ms": v for k, v in t.items()},
                "us_per_iter": t["single"] * 1e3 / r,
                "verdict": interleave.verdict(t["single"], t["dual"],
                                              t["double"]),
                **({"shared_verdict": interleave.verdict(
                    t["single"], t["shared"], t["double"])}
                   if "shared" in t else {})}
            print(f"probe F, cluster {c}, {r} reps, "
                  f"{t['single'] * 1e3 / r:.3f} us/iter single, bound "
                  f"{bound['bound_ms'] * 1e3 / r:.6f} us/iter, share "
                  f"{bound['bound_ms'] / t['single']:.2%}: "
                  + interleave.report(body, t))
        print(f"probe F {body}: over {PLAIN_REPS} iterations plain twin "
              f"{p_ms:.3f} ms, kernel {k_ms:.4f} ms (cluster {c1})")
        t = f_t[c1][body]
        options.append({
            "name": f"probe_interleave[{body}]", "route": "cuda",
            "source": "modem_tpu_torch/csrc/probe_interleave.cu",
            "replaces": f"bench/probe_interleave.py{site}",
            "launches": sum(v for (k, _), v in f_launches.items()
                            if k in (body, f"{body}_shared")),
            "max_abs_err": f_err, "reps": PLAIN_REPS, "ms": k_ms,
            "plain_ms": p_ms, "plain_us_per_iter": p_ms * 1e3 / PLAIN_REPS,
            **interleave.bound("width" if body == "narrow" else body, 1,
                               PLAIN_REPS, width),
            "library_ms": None, "shape": [interleave.P, width],
            "cluster": c1, "us_per_iter": t["single"] * 1e3 / r,
            "timing": {"reps": r, "ms": t["single"], "dual_ms": t["dual"],
                       "double_ms": t["double"],
                       "verdict": interleave.verdict(t["single"], t["dual"],
                                                     t["double"]),
                       "by_cluster": by_cluster}})
        pace = ", ".join(f"{c}: {f_t[c][body]['single'] * 1e3 / r:.3f}"
                         for c in interleave.CLUSTERS)
        print(f"probe F {body}: us/iter single by cluster size {pace}")
    w_us = {c: {w: f_t[c]["width"][w] * 1e3 / WIDTH_REPS for w in (128, 256)}
            for c in interleave.CLUSTERS}
    for c in interleave.CLUSTERS:
        check(f_launches.get(("width", c), 0) > 0,
              f"probe F width at cluster {c} never launched")
    wk_ms, wp_ms = _common.pair_ms(
        lambda r: interleave.run_width(x_w, 128, r, cluster=c1),
        lambda r: interleave.run_width_plain(x_w, 128, r))
    w_bound = interleave.bound("width", 1, WIDTH_REPS)
    options.append({
        "name": "probe_interleave[width]", "route": "cuda",
        "source": "modem_tpu_torch/csrc/probe_interleave.cu",
        "replaces": "bench/probe_interleave.py:177",
        "launches": sum(v for (k, _), v in f_launches.items()
                        if k == "width"),
        "max_abs_err": f_err, "reps": PLAIN_REPS, "ms": wk_ms,
        "plain_ms": wp_ms, "plain_us_per_iter": wp_ms * 1e3 / PLAIN_REPS,
        **interleave.bound("width", 1, PLAIN_REPS), "library_ms": None,
        "shape": [interleave.P, 128], "cluster": c1,
        "us_per_iter": w_us[c1][128],
        "timing": {"reps": WIDTH_REPS, "ms": f_t[c1]["width"][128],
                   "ms_256": f_t[c1]["width"][256],
                   "us_per_iter_by_cluster": {
                       str(c): {str(w): v for w, v in u.items()}
                       for c, u in w_us.items()}}})
    print(f"probe F width, {WIDTH_REPS} reps, us/iter by cluster size: "
          + "; ".join(f"{c}: 128 {u[128]:.3f}, 256 {u[256]:.3f} "
                      f"({u[256] / u[128]:.2f}x)" for c, u in w_us.items())
          + f"; bound at 128 {w_bound['bound_ms'] * 1e3 / WIDTH_REPS:.6f} "
          f"us/iter; at 128 over {PLAIN_REPS} iterations plain twin "
          f"{wp_ms:.3f} ms, kernel {wk_ms:.4f} ms")
    print(f"probe F: {time.perf_counter() - t_probe:.1f} s; probes D-F in "
          f"{time.perf_counter() - t0:.1f} s")
    print("probe launches, each probe's timing run: D "
          f"{sum(d_launches.values())} ({len(d_launches)} body, P, cluster "
          f"cells), E {e_launches} and one pass {e_pass_launches}, F "
          f"{sum(f_launches.values())} "
          f"({len(f_launches)} variant, cluster cells)")

    # ---- 13. decode-all ----------------------------------------------------
    t0 = time.perf_counter()
    decode_all_summary, decode_all_entries, hour = decode_all(dev,
                                                              reset_counts)
    check(not any(option_counts().values()),
          f"the decode-all path launched {option_counts()}")
    print(f"decode-all: phase in {time.perf_counter() - t0:.1f} s on {card}")

    # ---- 14. stream and CLI ------------------------------------------------
    t0 = time.perf_counter()
    stream_summary, stream_entries = stream_and_cli(dev, reset_counts, *hour)
    check(not any(option_counts().values()),
          f"the stream and CLI paths launched {option_counts()}")
    osd = osd_entry(dev)
    print(f"stream and cli: phase in {time.perf_counter() - t0:.1f} s on "
          f"{card}")

    # ---- 15. multi-device -------------------------------------------------
    t0 = time.perf_counter()
    multi_summary, multi_entries = multi_device(
        dev, reset_counts, rec_sets[1], payload_sets[1], hour[0], hour[2])
    check(not any(option_counts().values()),
          f"the multi-device paths launched {option_counts()}")
    print(f"multi-device: phase in {time.perf_counter() - t0:.1f} s on "
          f"{card}")

    # ---- 16. the impaired-channel envelope of the serving defaults --------
    t0 = time.perf_counter()
    envelope_summary, envelope_entries = envelope(dev, reset_counts)
    check(not any(option_counts().values()),
          f"the envelope's decoders launched {option_counts()}")
    print(f"envelope: phase in {time.perf_counter() - t0:.1f} s on {card}")

    sched = plan.sched
    kernels = [
        {"name": "sc_decode", "route": "cuda",
         "source": "modem_tpu_torch/csrc/sc_decode.cu",
         "replaces": "modem_tpu/kernels/scl_pallas.py:1732",
         "launches": launches, "max_abs_err": max_abs_err,
         "ms": kernel_ms, "plain_ms": plain_ms,
         **kernel_bound(sched, BATCH, 1), "library_ms": None,
         "shape": [BATCH, sched.code_len],
         "shared_depth": tiers[True].depth,
         "shared_bytes": tiers[True].shared_bytes,
         "blocks_per_sm": occupancy[True],
         "f32_shared_depth": tiers[False].depth,
         "f32_shared_bytes": tiers[False].shared_bytes,
         "f32_blocks_per_sm": occupancy[False]},
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
         "escalation_launches": esc_launches[1], **main_tier,
         "tiers": [{"list_size": k[0], "beta": "int8" if k[1] else "f32",
                    **v} for k, v in list_tier.items()]},
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
         "escalation_launches": esc_c_launches[2], **main_tier}] + \
        decode_all_entries + stream_entries + [osd] + multi_entries + \
        envelope_entries + options
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
        "unroll_ladder": ladder, "decode_all": decode_all_summary,
        "stream_cli": stream_summary, "multi_device": multi_summary,
        "envelope": envelope_summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
