"""The port's CUDA kernels and pipelines on the card, against their plain
versions and CPU runs; every test needs a CUDA device and skips without
one.

The file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX (``--noconftest`` skips tests/conftest.py, which
imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q
"""

import dataclasses
import functools
import os
import statistics
import warnings
import wave

import numpy as np
import pytest
import torch

from modem_tpu_torch import bits as B
from modem_tpu_torch import profiling
from modem_tpu_torch.card import GRAPH_CALLS, GRAPH_REPLAYS, graph_ms
from modem_tpu_torch.decoder import Decoder, cached_decoder
from modem_tpu_torch.encoder import Encoder
from modem_tpu_torch.fec.bch import generator_matrix
from modem_tpu_torch.fec.osd import osd_decode
from modem_tpu_torch.fec.osd_np import osd_decode_np
from modem_tpu_torch.fec.polar import PolarCode
from modem_tpu_torch.fec.schedule import C_WIDTH
from modem_tpu_torch.kernels import sc_decode as sc_mod
from modem_tpu_torch.kernels.osd_eliminate import (osd_eliminate,
                                                   osd_eliminate_reference)
from modem_tpu_torch.kernels.sc_decode import (NARROW, ScPlan, blocks_per_sm,
                                               narrow_runs, sc_decode,
                                               sc_decode_reference, tiers_of)
from modem_tpu_torch.kernels import scl_decode as scl_mod
from modem_tpu_torch.kernels.scl_decode import (LIST_BUDGET,
                                                list_blocks_per_sm,
                                                list_tiers, make_decoder,
                                                scl_decode,
                                                scl_decode_reference)
from modem_tpu_torch.ingest import PcmRecording
from modem_tpu_torch.numerology import make_config, toy_config
from modem_tpu_torch.pipeline import (AdaptivePipeline, BatchPipeline,
                                      decode_recording_auto)
from modem_tpu_torch.sync import Synchronizer, _edge_events
from modem_tpu_torch.probes import _common, interleave, p256, rank3

# (n, k, order, sigma) as tests/test_torch_sc_decode.py and
# tests/test_torch_scl_decode.py
CODES = {"toy": (224, 144, 8, 0.75), "chunked": (960, 480, 10, 0.85),
         "narrow": (56, 36, 6, 0.8)}
EXACT_KEYS = ("ok", "bits", "p0", "flips", "sync_gate")
WIRE = (64800, 43072, 16, 0.70)   # wire size at the list decoders' edge
_DATA = os.path.join(os.path.dirname(__file__), "data")


def noisy_llrs(n, k, order, sigma, frames=16, seed=9):
    """Seeded noisy LLRs of one random codeword, [frames, code_len] f32:
    bit for bit tests/test_torch_sc_decode.py's JAX-made ones (pinned
    there)."""
    code = PolarCode(n, k, order)
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2, code.mesg_bits, dtype=np.uint8)
    m[code.k:] = 0
    cw = code.encode_systematic(torch.from_numpy(m))
    tx = 1.0 - 2.0 * code.shorten(cw).double()
    noise = torch.from_numpy(rng.standard_normal((frames, code.n)))
    return code, code.lengthen(2.0 * (tx + sigma * noise) / sigma ** 2
                               ).float()


@functools.lru_cache(maxsize=None)
def toy_batches():
    """tests/test_torch_pipeline.py's toy batches made without JAX: 8
    recordings of the payloads of modem_tpu.parallel.toy_recordings(8,
    seed=3) by the port's encoder, clean and with the same seeded noise
    of sigma 0.05 and 0.3, split-complex [8, T, 2] numpy.  That file
    pins the port's decode of these equal to the JAX package's decode
    of its own recordings."""
    cfg = toy_config()
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes() for _ in range(8)]
    waves, _ = Encoder(cfg, device="cpu").encode_batch(
        payloads, B.base37_encode("TOY"))
    pad = torch.zeros(8, cfg.symbol_len, dtype=torch.complex64)
    recs = torch.view_as_real(torch.cat([pad, waves, pad], dim=1)).numpy()
    rng = np.random.default_rng(42)
    out = {0.0: recs}
    for sigma in (0.05, 0.3):
        out[sigma] = recs + sigma * rng.standard_normal(recs.shape).astype(
            np.float32)
    return out


def toy_pipeline(cls, device, **kw):
    cfg = toy_config()
    return cls(rate=cfg.rate, oper_mode=0, mode_spec=cfg.mode,
               symbol_len_override=cfg.symbol_len, device=device, **kw)


def assert_same_result(got: dict, want: dict):
    for key in EXACT_KEYS:
        assert np.array_equal(got[key], want[key]), key


def rows_sorted(a: torch.Tensor) -> np.ndarray:
    a = a.cpu().numpy()
    return a[np.lexsort(a.T[::-1])]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chunked", "toy"])
def test_kernel_matches_plain_version_on_card(cuda_device, name):
    """Kernel A against its plain version: codewords equal, path metrics
    within rtol 1e-5, atol 1e-3."""
    code, llrs = noisy_llrs(*CODES[name])
    plan = ScPlan.from_frozen(code.frozen)
    x = llrs.to(cuda_device)
    before = sc_decode.launches
    cw, pm = sc_decode(x, plan)
    torch.cuda.synchronize()
    assert sc_decode.launches == before + 1
    cw_r, pm_r = sc_decode_reference(x, plan.sched)
    assert torch.equal(cw, cw_r)
    assert torch.allclose(pm, pm_r, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.0, 0.05, 0.3])
def test_card_decode_matches_cpu(cuda_device, sigma):
    """The toy BatchPipeline(list_size=1) on the card, through kernel A,
    against the CPU run of the same batch: ok, bits, p0, flips and
    sync_gate equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = toy_batches()[sigma]
    cpu = toy_pipeline(BatchPipeline, "cpu", list_size=1)
    card = toy_pipeline(BatchPipeline, cuda_device, list_size=1)
    before = sc_decode.launches
    got = card.fetch(card.decode_batch(x))
    assert sc_decode.launches == before + 1
    want = cpu.fetch(cpu.decode_batch(x))
    assert_same_result(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CODES))
@pytest.mark.parametrize("lsz", [2, 4, 8])
def test_list_kernel_matches_plain_version(cuda_device, name, lsz):
    """Kernel B against its plain version on the same card tensors: the
    same codewords in every list, sorted path metrics within rtol 1e-5,
    atol 1e-3 (penalty sums reduced in another order)."""
    code, llrs = noisy_llrs(*CODES[name])
    plan = ScPlan.from_frozen(code.frozen)
    x = llrs.to(cuda_device)
    before = scl_decode.launches
    cw, pm = scl_decode(x, plan, lsz)
    torch.cuda.synchronize()
    assert scl_decode.launches == before + 1
    cw_r, pm_r = scl_decode_reference(x, plan.sched, lsz)
    assert cw.shape == cw_r.shape == (len(llrs), lsz, code.code_len)
    for b in range(len(llrs)):
        assert np.array_equal(rows_sorted(cw[b]), rows_sorted(cw_r[b])), b
    assert torch.allclose(pm.sort(dim=1).values, pm_r.sort(dim=1).values,
                          rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_adaptive_pipeline_matches_cpu(cuda_device):
    """The toy AdaptivePipeline(list_size=4) on the card, through both
    kernels, against its CPU run on the sigma 0.3 batch, which
    escalates: the same fallbacks, and ok, bits, p0, flips and
    sync_gate equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    recs = toy_batches()[0.3]
    cpu = toy_pipeline(AdaptivePipeline, "cpu", list_size=4)
    card = toy_pipeline(AdaptivePipeline, cuda_device, list_size=4)
    sc0, scl0 = sc_decode.launches, scl_decode.launches
    got = card.decode_batch(recs)
    assert sc_decode.launches == sc0 + 1 and scl_decode.launches > scl0
    want = cpu.decode_batch(recs)
    assert card.last_fallbacks == cpu.last_fallbacks > 0
    assert_same_result(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,lsz", [(n, lsz) for n in sorted(CODES)
                                      for lsz in (2, 4, 8)] + [("wire", 8)])
def test_fast_list_kernel_matches_plain_version(cuda_device, name, lsz):
    """Kernel C (scl_exact=False) against its plain version on the same
    card tensors, toy codes at L = 2, 4, 8 and 16 wire-size frames at
    L = 8: the same codewords in every list, in the same lane order,
    sorted path metrics within rtol 1e-5, atol 1e-3."""
    code, llrs = noisy_llrs(*(WIRE if name == "wire" else CODES[name]))
    plan = ScPlan.from_frozen(code.frozen)
    x = llrs.to(cuda_device)
    before = scl_decode.launches, scl_decode.fast_launches
    cw, pm = scl_decode(x, plan, lsz, exact=False)
    torch.cuda.synchronize()
    assert (scl_decode.launches, scl_decode.fast_launches) == (
        before[0], before[1] + 1)
    cw_r, pm_r = scl_decode_reference(x, plan.sched, lsz, exact=False)
    for b in range(len(llrs)):
        assert np.array_equal(rows_sorted(cw[b]), rows_sorted(cw_r[b])), b
    assert torch.equal(cw, cw_r)
    assert torch.allclose(pm.sort(dim=1).values, pm_r.sort(dim=1).values,
                          rtol=1e-5, atol=1e-3)


def read_golden() -> np.ndarray:
    with wave.open(os.path.join(_DATA, "golden_mode6_galois.wav")) as f:
        raw = np.frombuffer(f.readframes(f.getnframes()),
                            dtype="<i2").reshape(-1, 2)
    x = raw.astype(np.float32) / 32767.0
    return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("scl_exact", [True, False])
@pytest.mark.parametrize("channels", [2, 1])
def test_decoder_golden_on_card(cuda_device, scl_exact, channels):
    """The interactive Decoder on the card decodes the golden recording
    byte-exact through kernel B (or C), and agrees with its CPU run on
    ok, payload, mode, call sign, symbol position and bit flips."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = read_golden()
    samples = rec if channels == 2 else rec.real.copy()
    want_payload = np.load(os.path.join(
        _DATA, "waveform_pin_payload_seed.npy")).tobytes()
    card = Decoder(8000, scl_exact=scl_exact, device=cuda_device)
    before = scl_decode.launches, scl_decode.fast_launches
    got = card.decode(samples, channels=channels)
    after = scl_decode.launches, scl_decode.fast_launches
    assert after == ((before[0] + 1, before[1]) if scl_exact
                     else (before[0], before[1] + 1))
    want = Decoder(8000, scl_exact=scl_exact, device="cpu").decode(
        samples, channels=channels)
    assert got.ok and got.payload == want.payload == want_payload
    for key in ("oper_mode", "call_sign", "symbol_pos", "bit_flips"):
        assert getattr(got, key) == getattr(want, key), key



def _syncs_and_flags(fn):
    """Run fn() under torch's sync debug mode: (the program's ``syncs``
    counted over it, the warnings torch raised for synchronising
    operations, as "file:line" sites)."""
    torch.cuda.synchronize()
    s0 = profiling.syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    flagged = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
               if "synchronizing CUDA operation" in str(w.message)]
    return profiling.syncs - s0, flagged


@pytest.mark.cuda
def test_syncs_count_every_wait_for_the_card(cuda_device):
    """profiling.syncs against torch's own sync debug mode: on a clean
    batch, an escalating batch (the card's recordings; and a clean one
    from the host, whose upload waits), a mono golden decode and an
    adaptive decode-all of a mono int16 recording whose scan walks
    several chunks, the counter equals the synchronising operations torch
    flags, plus the event synchronise of each batch, which the mode does
    not flag.  The golden decode's OSD elimination is one kernel launch:
    it counts 255 waits fewer than with the plain column loop on the
    card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = toy_pipeline(AdaptivePipeline, cuda_device, list_size=4)
    clean = torch.as_tensor(toy_batches()[0.0]).to(cuda_device)
    noisy = torch.as_tensor(toy_batches()[0.3]).to(cuda_device)
    dec = Decoder(8000, device=cuda_device)
    samples = read_golden().real.copy()
    rec, sent = two_mode_recording(8000, (10, 12))
    rec = np.concatenate([np.zeros(3 * Synchronizer.CHUNK_SMALL,
                                   rec.dtype), rec])
    pcm = int16_pcm(rec, stereo=False)
    got: dict = {}

    def recording():
        got["frames"] = decode_recording_auto(
            pcm, 8000, channels=1, adaptive=True, device=cuda_device)

    runs = {"clean": lambda: pipe.decode_batch(clean),
            "escalating": lambda: pipe.decode_batch(noisy),
            "host clean": lambda: pipe.decode_batch(toy_batches()[0.0]),
            "decode": lambda: dec.decode(samples, channels=1),
            "recording": recording}
    for fn in runs.values():            # builds, plans and tables first
        fn()
    # one batch (one event) a mode group of the recording's frames
    groups = len({f["mode"] for f in got["frames"]})
    assert [(f["mode"], f["ok"]) for f in got["frames"]] == [
        (mode, True) for mode, _call, _payload in sent]
    for name, fn in runs.items():
        syncs, flagged = _syncs_and_flags(fn)
        events = {"decode": 0, "recording": groups}.get(name, 1)
        assert syncs == len(flagged) + events, (name, syncs, flagged)
        if name == "escalating":
            assert pipe.last_fallbacks > 0
    scan = cached_decoder(8000, mls_convention="galois",
                          device=cuda_device).sync
    assert scan.last_chunks > 1 and scan.last_rounds == 1
    assert len(_syncs_and_flags(runs["clean"])[1]) == 0
    launches = osd_eliminate.launches
    kernel, _ = _syncs_and_flags(runs["decode"])
    assert osd_eliminate.launches == launches + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("modem_tpu_torch.fec.osd.osd_eliminate",
                   lambda g, perm: osd_eliminate_reference(
                       g[:, perm].permute(1, 0, 2)))
        plain, flagged = _syncs_and_flags(runs["decode"])
    assert plain == len(flagged) and plain - kernel == 255


SLEEP_CYCLES = 10 ** 8        # ~50 ms at the H100's clock


@pytest.mark.cuda
def test_demod_span_times_the_front_end_as_cuda_events_do(cuda_device):
    """The events of the span ``pipeline.demod``, on a batch of 512
    golden recordings run alone under the profiler, within 5 % of CUDA
    events around BatchPipeline.demod called alone (as
    frontend_ms.batch takes it); medians of three.  A sleep queued
    first lets the host queue the whole front end before the card
    reaches it, on both sides, as the serving loop's queue does: the
    profiler slows the host's launches, whose gaps would otherwise be
    timed inside the span."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = AdaptivePipeline(8000, 6, device=cuda_device)
    x = torch.as_tensor(read_golden(), device=cuda_device)
    x = x.expand(512, -1).contiguous()
    pipe.decode_batch(x)
    alone = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        pipe.sc.demod(x)
        end.record()
        torch.cuda.synchronize()
        alone.append(start.elapsed_time(end))
    profiling.clear_spans()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        for _ in range(3):
            torch.cuda._sleep(SLEEP_CYCLES)
            pipe.decode_batch(x)
        torch.cuda.synchronize()
    spans = [r.device_ms for r in profiling.spans()
             if r.name == "pipeline.demod"]
    assert len(spans) == 3
    ratio = statistics.median(spans) / statistics.median(alone)
    assert abs(ratio - 1.0) <= 0.05, (spans, alone)


# -- kernel C' (the options of the decoder) and the probes D-F ---------------

def _class_table(sched, op, rows=64):
    """``rows`` cycled copies of the schedule's rows of opcode ``op``."""
    sel = sched.ops[sched.ops[:, 0] == op]
    return np.tile(sel, (rows // len(sel) + 1, 1))[:rows]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CODES))
@pytest.mark.parametrize("lsz", [2, 4, 8])
def test_rank_select_and_f32_betas_equal_default(cuda_device, name, lsz):
    """rank_select (kernel B) and beta_compact=False (B and C): the same
    codewords, lane order and path metrics as the default kernel, bit for
    bit, and the same lists as the plain rank-select version."""
    code, llrs = noisy_llrs(*CODES[name])
    plan = ScPlan.from_frozen(code.frozen)
    x = llrs.to(cuda_device)
    for exact in (True, False):
        want = scl_decode(x, plan, lsz, exact)
        for opts in ({"rank_select": True}, {"beta_compact": False},
                     {"rank_select": True, "beta_compact": False}):
            got = scl_decode(x, plan, lsz, exact, **opts)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
        cw_r, _ = scl_decode_reference(x, plan.sched, lsz, exact,
                                       rank_select=True)
        assert torch.equal(cw_r, want[0])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CODES))
def test_sc_f32_betas_equal_default(cuda_device, name):
    """Kernel A with f32 partial sums equals the default bit for bit."""
    code, llrs = noisy_llrs(*CODES[name])
    plan = ScPlan.from_frozen(code.frozen)
    x = llrs.to(cuda_device)
    got, want = sc_decode(x, plan, beta_compact=False), sc_decode(x, plan)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CODES))
@pytest.mark.parametrize("lsz", [1, 8])
def test_decompose_spc_kernel_matches_plain(cuda_device, name, lsz):
    """The decomposed-SPC schedule (leaves down to width 1, BIG columns
    and inf sums) through kernel A (L = 1) or B: codewords in the same
    lane order as the plain version's, path metrics within rtol 1e-5,
    atol 1e-3."""
    code, llrs = noisy_llrs(*CODES[name])
    dec = make_decoder(code.frozen, lsz, decompose_spc=True,
                       device=cuda_device)
    plain = make_decoder(code.frozen, lsz, decompose_spc=True, device="cpu")
    cw, pm = dec(llrs)
    cw_r, pm_r = plain(llrs)
    assert torch.equal(cw.cpu(), cw_r)
    assert torch.allclose(pm.cpu(), pm_r, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("lsz", [1, 8])
def test_ops_override_kernel_matches_plain(cuda_device, lsz):
    """An override table of each opcode class's rows, cycled: the kernel
    (scratch zero-filled) equals the plain version (zeros) on codewords
    and, within rtol 1e-5, atol 1e-3, path metrics."""
    code, llrs = noisy_llrs(*CODES["chunked"])
    sched = ScPlan.from_frozen(code.frozen).sched
    for op in sorted(set(sched.ops[:, 0].tolist())):
        table = _class_table(sched, op)
        dec = make_decoder(code.frozen, lsz, ops_override=table,
                           device=cuda_device)
        cw, pm = dec(llrs)
        cw_r, pm_r = make_decoder(code.frozen, lsz, ops_override=table,
                                  device="cpu")(llrs)
        assert torch.equal(cw.cpu(), cw_r), op
        assert torch.allclose(pm.cpu(), pm_r, rtol=1e-5, atol=1e-3), op


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["narrow", "toy"])
@pytest.mark.parametrize("lsz,exact", [(1, True), (8, True), (4, False)])
def test_unrolled_kernel_equals_interpreter(cuda_device, name, lsz, exact):
    """The kernel generated for the schedule (unroll=True) equals the
    interpreter bit for bit, and counts its launch as the unroll
    variant."""
    code, llrs = noisy_llrs(*CODES[name])
    kw = dict(device=cuda_device, exact=exact)
    got = make_decoder(code.frozen, lsz, unroll=True, **kw)(llrs)
    want = make_decoder(code.frozen, lsz, **kw)(llrs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- kernel A's tiers of state, narrow runs and packed rows -------------------

# codes whose default shared depth D_s and depth count differ (tiers_of):
# n = 64 (D_s 1, 7 depths), 1024 (1 / 2 with f32 betas, 11), 4096 (1 /
# 4, 13); the wire code's is 5 / 8 of 17
TIER_CODES = {"n64": (56, 36, 6, 0.8), "n1024": (960, 480, 10, 0.85),
              "n4096": (4032, 2304, 12, 0.85)}
_tiers_of = tiers_of


def _assert_sc_equal_plain(got, x, sched):
    cw_r, pm_r = sc_decode_reference(x, sched)
    assert torch.equal(got[0], cw_r)
    assert torch.allclose(got[1], pm_r, rtol=1e-5, atol=1e-3)


def _forced_tiers(monkeypatch, depth):
    """Make kernel A's wrapper place the shared tier at ``depth``."""
    def forced(sched, beta_compact=True, _depth=None):
        return _tiers_of(sched, beta_compact, depth)
    monkeypatch.setattr(sc_mod, "tiers_of", forced)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TIER_CODES))
@pytest.mark.parametrize("beta_compact", [True, False])
def test_sc_tiers_at_every_depth(cuda_device, monkeypatch, name,
                                 beta_compact):
    """Kernel A with the shared tier starting at every depth, from 1 (all
    but the input in shared memory) to the code's depth count (none):
    codewords equal to the plain version's and path metrics within rtol
    1e-5, atol 1e-3; and bit for bit the default depth's result."""
    code, llrs = noisy_llrs(*TIER_CODES[name])
    plan = ScPlan.from_frozen(code.frozen)
    x = llrs.to(cuda_device)
    want = sc_decode(x, plan, beta_compact=beta_compact)
    _assert_sc_equal_plain(want, x, plan.sched)
    for depth in range(1, plan.sched.n_depths + 1):
        _forced_tiers(monkeypatch, depth)
        got = sc_decode(x, plan, beta_compact=beta_compact)
        assert torch.equal(got[0], want[0]), depth
        assert torch.equal(got[1], want[1]), depth


@pytest.mark.cuda
def test_sc_wire_tiers_and_instances(cuda_device, monkeypatch):
    """At wire size: the default int8 instance (D_s = 5), the f32-beta
    one (D_s = 8), the tiers moved to depths 3 and 12, and the
    decomposed-SPC schedule, each against the plain version; the
    instances on the SPC-leaf schedule bit for bit equal."""
    code, llrs = noisy_llrs(*WIRE)
    plan = ScPlan.from_frozen(code.frozen)
    assert tiers_of(plan.sched).depth == 5
    assert tiers_of(plan.sched, beta_compact=False).depth == 8
    x = llrs.to(cuda_device)
    want = sc_decode(x, plan)
    _assert_sc_equal_plain(want, x, plan.sched)
    dec = make_decoder(code.frozen, 1, decompose_spc=True,
                       device=cuda_device)
    _assert_sc_equal_plain(dec(x), x, dec.plan.sched)
    got = sc_decode(x, plan, beta_compact=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for depth in (3, 12):
        _forced_tiers(monkeypatch, depth)
        got = sc_decode(x, plan)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                            want[1]), depth


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["n1024", "n4096"])
@pytest.mark.parametrize("narrow", [True, False])
def test_sc_all_narrow_or_all_wide_override(cuda_device, name, narrow):
    """Override tables of only narrow rows (width <= 32: warp 0 runs
    them all, in runs cut at RUN_MAX rows) or only wide ones (the block
    runs them all), 300 cycled rows of the schedule: kernel A on zeroed
    scratch equals the plain version on zeros."""
    code, llrs = noisy_llrs(*TIER_CODES[name])
    ops = ScPlan.from_frozen(code.frozen).sched.ops
    sel = ops[(ops[:, C_WIDTH] <= NARROW) == narrow]
    table = np.tile(sel, (300 // len(sel) + 1, 1))[:300]
    dec = make_decoder(code.frozen, 1, ops_override=table,
                       device=cuda_device)
    runs = narrow_runs(table, tiers_of(dec.plan.sched))
    assert (runs.sum() == 300) if narrow else not runs.any()
    cw, pm = dec(llrs)
    cw_r, pm_r = make_decoder(code.frozen, 1, ops_override=table,
                              device="cpu")(llrs)
    assert torch.equal(cw.cpu(), cw_r)
    assert torch.allclose(pm.cpu(), pm_r, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_sc_four_blocks_per_sm_at_wire_size(cuda_device):
    """The default instance's shared tier at wire size leaves room for
    four blocks an SM (the occupancy calculator), so a batch of 512
    frames runs in one wave; the f32-beta instance too."""
    sched = ScPlan.from_frozen(PolarCode(*WIRE[:3]).frozen).sched
    assert blocks_per_sm(tiers_of(sched)) >= 4
    assert blocks_per_sm(tiers_of(sched, beta_compact=False)) >= 4


@pytest.mark.cuda
def test_probe_p256_matches_twin(cuda_device):
    """Probe D: each body's kernel against its plain twin at R = 4, P =
    128 and 256, at every cluster size of p256.CLUSTERS, at p256.RTOL."""
    p256.check(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("P,cluster", [(P, n) for P in p256.PS
                                       for n in p256.CLUSTERS[P]])
def test_probe_p256_cluster_matches_twin(cuda_device, P, cluster):
    """Probe D as one cluster of ``cluster`` blocks: every body against
    its twin at R = 4 (p256.RTOL), the one-hot body exactly at R = 2P + 3
    (its pushed row comes from every block in turn), and a cluster the
    kernel does not take refused by the C interface (no launch)."""
    p256.check(cuda_device, clusters={P: (cluster,)})
    x = p256.inputs(P, cuda_device)
    reps = 2 * P + 3
    assert torch.equal(p256.run("one_hot", x, reps, cluster),
                       p256.run_plain("one_hot", x, reps))
    lib = p256.library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for bad in (1, 3, 32):
        rc = lib.probe_p256_launch(0, x.data_ptr(), out.data_ptr(), P, bad, 1,
                                   stream)
        assert rc != 0, bad
        with pytest.raises(RuntimeError):
            _common.check_rc(lib, "probe_p256", rc)


@pytest.mark.cuda
def test_probe_rank3_matches_numpy(cuda_device):
    """Probe E: each computation's kernel against the probe's numpy
    expectation at R = 1 (exact, slot extract atol 1e-5), and composed
    over 43 iterations on the tile of ties and signed zeros."""
    x, t = rank3.inputs(), rank3.ties()
    xt = torch.from_numpy(x).to(cuda_device)
    tt = torch.from_numpy(t).to(cuda_device)
    for kind in rank3.KINDS:
        rank3.check_one(kind, rank3.run(kind, xt), x)
        rank3.check_one(kind, rank3.run(kind, tt, 43), t, 43)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", rank3.KINDS)
def test_probe_rank3_matches_twin(cuda_device, kind):
    """Probe E, one template instance: the kernel against its plain twin
    at R = 1, 4 and 43, on the probe's tile and on the tile of ties and
    signed zeros (counts and the roll exact, the slot extract within
    atol 1e-5 an iteration)."""
    rank3.check(cuda_device, kinds=(kind,))


@pytest.mark.cuda
def test_probe_rank3_refuses(cuda_device):
    """The C interface refuses a kind off its table and R outside 1 ..
    rank3.MAX_REPS (no launch), and the wrapper raises on the code and on
    a tile its 16-byte accesses cannot take."""
    x = torch.from_numpy(rank3.inputs()).to(cuda_device)
    lib = rank3.library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for kind, reps in ((5, 1), (-1, 1), (0, 0), (4, rank3.MAX_REPS + 1)):
        rc = lib.probe_rank3_launch(kind, x.data_ptr(), out.data_ptr(), reps,
                                    stream)
        assert rc != 0, (kind, reps)
        with pytest.raises(RuntimeError):
            _common.check_rc(lib, "probe_rank3", rc)
    shifted = torch.empty(x.numel() + 1, device=cuda_device)[1:]
    with pytest.raises(ValueError):
        rank3.run("sublane_roll", shifted.view(rank3.P, rank3.C))


@pytest.mark.cuda
def test_probe_rank3_graph_equals_eager(cuda_device):
    """Each kind's one-pass launch (R = 1), captured in a CUDA graph as
    the device timing (card.graph_ms) captures it, writes on replay what
    an eager launch writes."""
    x = torch.from_numpy(rank3.inputs()).to(cuda_device)
    for kind in rank3.KINDS:
        eager = rank3.run(kind, x)
        out = torch.empty_like(eager)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            rank3.run(kind, x, 1, out)
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager), kind


@pytest.mark.cuda
def test_probe_rank3_one_pass_counts_the_launches_run(cuda_device):
    """The one-pass timing counts the launches the device ran, from what
    the wrapper counted: the eager call, the captured calls once a replay
    (one warm-up and GRAPH_REPLAYS timed), and the 100 host-paced ones;
    a graph that captured no launch of the kernel counts none."""
    rank3.run.launches.clear()
    rank3.one_pass_us(cuda_device)
    want = 1 + (1 + GRAPH_REPLAYS) * GRAPH_CALLS + 100
    assert dict(rank3.run.launches) == dict.fromkeys(rank3.KINDS, want)
    x = torch.from_numpy(rank3.inputs()).to(cuda_device)
    _, ran = graph_ms(lambda: torch.roll(x, 3, 0),
                      lambda: rank3.run.launches["sublane_roll"])
    assert ran == 0


@pytest.mark.cuda
def test_probe_interleave_matches_twin(cuda_device):
    """Probe F: chain and leaf, one and two chains (the leaf's also
    through shared barriers), the width probe at 128 and 256 and the
    narrow width-4 body at one and two chains, kernel against twin at 8
    iterations, at every cluster size of interleave.CLUSTERS: the output
    within rtol 1e-5, atol 1e-3, and pm on its own within rtol 1e-5."""
    interleave.check(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", interleave.CLUSTERS)
def test_probe_interleave_cluster_matches_twin(cuda_device, cluster):
    """Probe F with its rows over ``cluster`` blocks: every kernel against
    its twin at 8 and at 40 iterations (the leaf's gathered rows from
    every block), and a cluster size the kernel does not take refused by
    the C interface."""
    for reps in (interleave.CHECK_REPS, 40):
        interleave.check(cuda_device, reps, (cluster,))
    lib = interleave.library()
    x = interleave.inputs(1).to(cuda_device)
    out = torch.empty(2, interleave.P, device=cuda_device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.probe_interleave_launch(0, 1, 128, 0, x.data_ptr(), 128, 1,
                                     out.data_ptr(), 3, stream)
    assert rc != 0


# -- kernels B and C: their tiers of state -------------------------------------

_list_tiers = list_tiers


def _forced_list_tiers(monkeypatch, depth):
    """Make the list kernels' wrapper place the shared tier at ``depth``,
    fitting or not (a tier the card refuses must raise)."""
    def forced(sched, list_size, beta_compact=True, _depth=None):
        return tiers_of(sched, beta_compact, depth, lanes=list_size,
                        budget=LIST_BUDGET, limit=1 << 40)
    monkeypatch.setattr(scl_mod, "list_tiers", forced)


def _fitting_depths(sched, lsz, beta_compact=True):
    return [d for d in range(1, sched.n_depths + 1)
            if tiers_of(sched, beta_compact, d, lanes=lsz,
                        limit=1 << 40).shared_bytes <= LIST_BUDGET]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TIER_CODES))
@pytest.mark.parametrize("lsz", [2, 4, 8])
@pytest.mark.parametrize("exact", [True, False])
def test_list_tiers_at_every_depth(cuda_device, monkeypatch, name, lsz,
                                   exact):
    """Kernel B (exact) or C with the shared tier starting at every depth
    that fits a block, from all but the input in shared memory to none:
    codewords in the plain version's lane order and path metrics within
    rtol 1e-5, atol 1e-3; bit for bit the default depth's result; and
    the rank and f32-beta instances equal to it at the shallowest and
    deepest of those depths."""
    code, llrs = noisy_llrs(*TIER_CODES[name])
    plan = ScPlan.from_frozen(code.frozen)
    x = llrs.to(cuda_device)
    want = scl_decode(x, plan, lsz, exact)
    cw_r, pm_r = scl_decode_reference(x, plan.sched, lsz, exact)
    assert torch.equal(want[0], cw_r)
    assert torch.allclose(want[1], pm_r, rtol=1e-5, atol=1e-3)
    depths = _fitting_depths(plan.sched, lsz)
    assert depths[-1] == plan.sched.n_depths
    for depth in depths:
        _forced_list_tiers(monkeypatch, depth)
        got = scl_decode(x, plan, lsz, exact)
        assert torch.equal(got[0], want[0]), depth
        assert torch.equal(got[1], want[1]), depth
    for depth in (depths[0], depths[-1]):
        _forced_list_tiers(monkeypatch, depth)
        for opts in ({"rank_select": exact}, {"beta_compact": False}):
            if opts.get("beta_compact") is False and depth not in \
                    _fitting_depths(plan.sched, lsz, False):
                continue
            got = scl_decode(x, plan, lsz, exact, **opts)
            assert torch.equal(got[0], want[0]), (depth, opts)
            assert torch.equal(got[1], want[1]), (depth, opts)


@pytest.mark.cuda
def test_list_wire_tiers_one_block_an_sm(cuda_device, monkeypatch):
    """At wire size every instance (L = 2, 4, 8; B and C; int8 and f32
    betas) holds one block an SM with its shared tier, L = 8 with int8
    betas from depth 8 (221,184 bytes); B and C with the tier moved to
    depths 10 and 17 (none) equal the default on 4 frames; a tier the
    card cannot hold makes the wrapper raise, with no fallback."""
    code, llrs = noisy_llrs(*WIRE, frames=4)
    plan = ScPlan.from_frozen(code.frozen)
    t8 = list_tiers(plan.sched, 8)
    assert (t8.depth, t8.shared_bytes) == (8, 221184)
    for lsz in (2, 4, 8):
        for bc in (True, False):
            t = list_tiers(plan.sched, lsz, bc)
            for exact in (True, False):
                assert list_blocks_per_sm(t, exact) == 1, (lsz, bc, exact)
    x = llrs.to(cuda_device)
    for exact in (True, False):
        want = scl_decode(x, plan, 8, exact)
        for depth in (10, plan.sched.n_depths):
            _forced_list_tiers(monkeypatch, depth)
            got = scl_decode(x, plan, 8, exact)
            assert torch.equal(got[0], want[0]) and torch.equal(
                got[1], want[1]), (exact, depth)
        _forced_list_tiers(monkeypatch, 5)       # 393,216 bytes
        with pytest.raises(RuntimeError, match="launch failed"):
            scl_decode(x, plan, 8, exact)
        monkeypatch.undo()


@pytest.mark.cuda
@pytest.mark.parametrize("spc", [False, True])
def test_list_wide_leaf_of_infinite_llrs(cuda_device, spc):
    """A RATE1 (or SPC) leaf of 512 columns whose LLRs are infinite but
    for fewer than the 7-8 the exact search takes (none on the first
    frame): no BIG column is left past the width, so the search takes the
    inf columns, as the plain version does; B and C give the plain
    version's codewords and path metrics (tests/test_torch_scl_emulated.py
    holds the same on the CPU)."""
    frozen = np.zeros(512, dtype=bool)
    frozen[0] = spc
    plan = ScPlan.from_frozen(frozen)
    rng = np.random.default_rng(3)
    llrs = torch.from_numpy(
        rng.choice(np.float32([-np.inf, np.inf]), (4, 512)))
    for b in range(1, 4):
        llrs[b, rng.choice(512, 2 * b - 1, replace=False)] = torch.from_numpy(
            rng.standard_normal(2 * b - 1).astype(np.float32))
    for exact in (True, False):
        cw, pm = scl_decode(llrs.to(cuda_device), plan, 8, exact)
        cw_r, pm_r = scl_decode_reference(llrs, plan.sched, 8, exact)
        assert torch.equal(cw.cpu(), cw_r), exact
        assert torch.allclose(pm.cpu(), pm_r, rtol=1e-5, atol=1e-3), exact


# -- decode-all ------------------------------------------------------------

def two_mode_recording(rate: int, modes, seed: int = 9):
    """A recording of one frame of each mode in ``modes`` (call signs
    AB1CDE and N0CALL in turn) made by the port's encoder, 2000 samples
    of silence around and between them, complex64; with seed 9 and
    modes (10, 12) the payloads of tests/test_multiframe.py's mixed-mode
    recording.  Returns (recording, [(mode, call sign, payload)])."""
    rng = np.random.default_rng(seed)
    gap = torch.zeros(2000, dtype=torch.complex64)
    parts, sent = [gap], []
    for mode, call in zip(modes, ("AB1CDE", "N0CALL")):
        cfg = make_config(rate, mode, 2000)
        payload = rng.integers(0, 256, cfg.mode.data_bytes,
                               dtype=np.uint8).tobytes()
        wave_, _ = Encoder(cfg, device="cpu").encode_batch(
            [payload], B.base37_encode(call))
        parts += [wave_[0], gap]
        sent.append((mode, call, payload))
    return torch.cat(parts).numpy(), sent


def int16_pcm(rec: np.ndarray, stereo: bool = True, bits: int = 16,
              rate: int = 8000):
    """A recording scaled to half of full scale and quantised as a WAV
    holds it (wav._quantize): I/Q pairs, or the real part in mono."""
    x = np.stack([rec.real, rec.imag], axis=-1) if stereo else rec.real
    x = 0.5 * x / np.abs(x).max()
    if bits == 16:
        q = np.clip(np.rint(x * 32767.0), -32768, 32767).astype(np.int16)
    else:
        q = (np.clip(np.rint(x * 127.0), -128, 127) + 128).astype(np.uint8)
    return PcmRecording(data=q, bits=bits, rate=rate)


def same_frames(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for key in a:
            if key != "snr":
                assert a[key] == b[key], key
        assert np.allclose(a["snr"], b["snr"], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [False, True])
def test_decode_recording_auto_on_card(cuda_device, adaptive):
    """decode_recording_auto on the card equals its CPU run on the
    modes-10/12 recording (every key; snr within 1e-4), through kernel A
    then B (adaptive) or B alone."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rec, sent = two_mode_recording(8000, (10, 12))
    before = sc_decode.launches, scl_decode.launches
    got = decode_recording_auto(rec, 8000, adaptive=adaptive,
                                device=cuda_device)
    torch.cuda.synchronize()
    launched = (sc_decode.launches - before[0],
                scl_decode.launches - before[1])
    assert launched == ((2, 0) if adaptive else (0, 2))
    want = decode_recording_auto(rec, 8000, adaptive=adaptive, device="cpu")
    same_frames(got, want)
    assert [(f["mode"], f["call_sign"], f["payload"]) for f in got] == sent
    assert all(f["ok"] and f["status"] == "ok" for f in got)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,stereo", [(16, False), (16, True),
                                         (8, False)])
def test_pcm_scan_on_card(cuda_device, bits, stereo):
    """The chunked scan of a PcmRecording on the card: the raw events
    (edge, n_max) equal the CPU's at two chunk sizes, their phases within
    1e-5, the candidates' p0 and ok equal and cfo within 1e-5."""
    rec, _ = two_mode_recording(8000, (10, 12))
    pcm = int16_pcm(rec, stereo, bits)
    cfg = dataclasses.replace(make_config(8000, 6), freq_off=0)
    card = Synchronizer(cfg, cuda_device)
    host = Synchronizer(cfg, "cpu")
    for chunk in (card.CHUNK_SMALL, 1 << 14):
        got = card._events_device(pcm, chunk, 32)
        want = host._events_device(pcm, chunk, 32)
        assert [e[:2] for e in got] == [e[:2] for e in want], chunk
        assert np.allclose([e[2] for e in got], [e[2] for e in want],
                           atol=1e-5)
    got, want = card.scan(pcm), host.scan(pcm)
    assert [(c.p0, c.ok) for c in got] == [(c.p0, c.ok) for c in want]
    assert sum(c.ok for c in got) == 2
    assert np.allclose([c.cfo_rad for c in got], [c.cfo_rad for c in want],
                       atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,stereo", [(16, False), (16, True),
                                         (8, False)])
def test_scan_graph_equals_eager_on_card(cuda_device, bits, stereo):
    """The chunk walk on the card, whose chunks past the recording start
    replay the chunk body's CUDA graph, gives the events of the eager
    body walked chunk by chunk on the card, phases and all, at two chunk
    sizes and edge counts (the second stops at the first of the
    recording's two edges)."""
    rec, _ = two_mode_recording(8000, (10, 12))
    pcm = int16_pcm(rec, stereo, bits)
    cfg = dataclasses.replace(make_config(8000, 6), freq_off=0)
    card = Synchronizer(cfg, cuda_device)
    n_out = pcm.n_samples - 2 * card.L
    for chunk, max_edges in ((1 << 14, 32), (1 << 12, 1)):
        got = card._events_device(pcm, chunk, max_edges)
        assert card.last_chunks > 1 and len(card._graphs) >= 1
        c, ctx = card._context(chunk)
        carry, want = card.scan_start(), []
        for n0 in range(0, n_out, c):
            t_c, psh_c = card._chunk_metrics(pcm, n0, c, ctx)
            firsts, carry = card._chunk_finish(t_c, psh_c, n0, carry,
                                               min(max_edges, c))
            want += _edge_events(n0, firsts.cpu().numpy(), n_out)
            if len(want) >= max_edges:
                break
        assert got == want[:max_edges], chunk
        assert len(got) == min(max_edges, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("rate,other", [(8000, 13), (16000, 7),
                                        (44100, 10), (48000, 12)])
def test_decode_all_every_rate_on_card(cuda_device, rate, other):
    """A mode-6 frame and a frame of another mode at each sample rate,
    as 16-bit I/Q PCM (decode-all's input), through decode_recording_auto
    on the card, adaptive and exact: both byte-exact with the right mode
    and call sign.  (The noiseless float recording is not a fair input
    at 44.1 and 48 kHz: its out-of-band bins hold only the FFT's
    rounding residue, and the sync gate's second peak turns on it;
    ROADMAP queue 3.)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    rec, sent = two_mode_recording(rate, (6, other), seed=rate)
    pcm = int16_pcm(rec, rate=rate)
    for adaptive in (True, False):
        got = decode_recording_auto(pcm, rate, adaptive=adaptive,
                                    device=cuda_device)
        assert [(f["mode"], f["call_sign"], f["payload"], f["ok"])
                for f in got] == [s + (True,) for s in sent], adaptive


# -- stream and CLI ----------------------------------------------------------

def two_frame_mono(seed: int = 31):
    """Two mode-10 frames (tests/test_torch_stream.py's recording) by the
    port's continuous encoder, 1 s of silence either side, mono int16."""
    from modem_tpu_torch.encoder import cached_encoder
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
                for _ in range(2)]
    wave_, _ = cached_encoder(make_config(8000, 10, 2300), "cpu").encode(
        payloads, B.base37_encode("AB1CDE"))
    sil = np.zeros(8000, np.complex64)
    rec = np.concatenate([sil, wave_, sil]).real
    return (np.clip(np.rint(rec * 32767), -32768, 32767).astype(np.int16),
            payloads)


@pytest.mark.cuda
def test_stream_on_card(cuda_device):
    """StreamDecoder on the card, fed 1 s at a time, equals
    decode_recording_auto on the card (every key; snr within 1e-4),
    with one launch of B a frame and none of A or C."""
    from modem_tpu_torch.stream import StreamDecoder
    torch.backends.cuda.matmul.allow_tf32 = False
    mono, payloads = two_frame_mono()
    want = decode_recording_auto(PcmRecording(data=mono, bits=16, rate=8000),
                                 8000, channels=1, device=cuda_device)
    before = (sc_decode.launches, scl_decode.launches,
              scl_decode.fast_launches)
    sd = StreamDecoder(8000, channels=1, bits=16, device=cuda_device)
    got = []
    for i in range(0, len(mono), 8000):
        got += sd.feed(mono[i: i + 8000])
    got += sd.finish()
    torch.cuda.synchronize()
    assert (sc_decode.launches - before[0], scl_decode.launches - before[1],
            scl_decode.fast_launches - before[2]) == (0, 2, 0)
    same_frames(sorted(got, key=lambda f: f["pos"]), want)
    assert [f["payload"] for f in want] == payloads


def _cli(args, **kw):
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.run([sys.executable, "-m", "modem_tpu_torch.cli"]
                          + args, cwd=root, capture_output=True, timeout=600,
                          **kw)


@pytest.mark.cuda
def test_cli_makefile_smoke_on_card(cuda_device, tmp_path):
    """The reference's smoke (Makefile:12-20) through the port's CLI on
    the card: encode one frame to an 8-bit 8 kHz WAV, decode, compare."""
    payload = np.random.default_rng(12).integers(
        0, 256, 5380, dtype=np.uint8).tobytes()
    (tmp_path / "uncoded.dat").write_bytes(payload)
    enc = _cli(["encode", str(tmp_path / "encoded.wav"), "8000", "8", "1",
                "2000", "6", "N0CALL", str(tmp_path / "uncoded.dat")])
    assert enc.returncode == 0, enc.stderr
    dec = _cli(["decode", str(tmp_path / "decoded.dat"),
                str(tmp_path / "encoded.wav")])
    assert dec.returncode == 0, dec.stderr
    assert (tmp_path / "decoded.dat").read_bytes() == payload
    assert dec.stderr.decode().splitlines()[-1] == "bit flips: 0"


@pytest.mark.cuda
def test_cli_decode_stream_pipe_on_card(cuda_device, tmp_path):
    """decode-stream PREFIX - fed through a pipe 1 s at a time: the first
    frame's payload file appears while stdin is still open."""
    import subprocess
    import sys
    import time
    from modem_tpu_torch import wav
    mono, payloads = two_frame_mono()
    path = str(tmp_path / "two.wav")
    wav.write_wav(path, mono.astype(np.float32) / 32767.0, 8000, 16, 1)
    with open(path, "rb") as f:
        raw = f.read()
    head = raw.index(b"data") + 8
    cfg = make_config(8000, 10, 2300)
    first_end = 8000 + cfg.extended_len + cfg.frame_samples
    upto = head + (first_end // 8000 + 4) * 16000
    prefix = str(tmp_path / "live")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "modem_tpu_torch.cli", "decode-stream",
         prefix, "-"], cwd=root, stdin=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        for i in range(0, upto, 16000):
            proc.stdin.write(raw[i: min(i + 16000, upto)])
            proc.stdin.flush()
        deadline = time.time() + 300
        while (not os.path.exists(prefix + ".000") and proc.poll() is None
               and time.time() < deadline):
            time.sleep(0.05)
        live = os.path.exists(prefix + ".000")
        _, err = proc.communicate(raw[upto:], timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert live
    for i, p in enumerate(payloads):
        assert open(f"{prefix}.{i:03d}", "rb").read() == p


@pytest.mark.cuda
def test_nccl_world1_sharded_decode_on_card(cuda_device, tmp_path):
    """parallel.sharded_decode over an NCCL group of one rank (a FileStore
    group in this process) equals the CPU decode; the same group refuses
    a CPU device instead of falling back to gloo."""
    import torch.distributed as dist

    from modem_tpu_torch import parallel as P

    recs, payloads = P.toy_recordings(4, seed=4, device="cpu")
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="NCCL"):
            P.make_mesh(device="cpu")
        mesh = P.make_mesh(device=cuda_device)
        assert (mesh.backend, mesh.size, mesh.device.type) == ("nccl", 1,
                                                               "cuda")
        out = P.sharded_decode(P.toy_pipeline(device=cuda_device),
                               mesh)(recs)
        out = {k: v.cpu().numpy() for k, v in out.items()}
    finally:
        dist.destroy_process_group()
    want = P.toy_pipeline(device="cpu").decode_batch(recs)
    for key in ("bits", "ok", "flips"):
        assert np.array_equal(out[key], want[key].numpy()), key
    assert out["ok"].all()
    assert [B.scramble(B.bits_to_bytes_le(b)) for b in out["bits"]] == \
        payloads


@pytest.mark.cuda
def test_gloo_world2_sharded_recording_on_card(cuda_device):
    """Two gloo ranks on one card (NCCL refuses two ranks on one GPU):
    sharded_decode_recording of a toy six-frame recording as int16 PCM
    equals the single-device decode_recording on every rank.  Each frame
    is followed by 20,000 samples of silence, so the scan walks two
    chunks of 2^17, one a rank, the sixth preamble across their
    boundary."""
    from modem_tpu_torch import parallel as P

    recs, payloads = P.toy_recordings(6, seed=2, device="cpu")
    gap = np.zeros((20000, 2), np.float32)
    x = np.concatenate([part for r in recs for part in (r, gap)], axis=0)
    pcm = np.clip(np.rint(x * 32767), -32768, 32767).astype(np.int16)

    def rec():
        return PcmRecording(data=pcm.copy(), bits=16, rate=8000)

    pipe = P.toy_pipeline(device=cuda_device)
    want, pos = pipe.decode_recording(rec(), max_frames=8)
    assert [pipe.payload_bytes(want, i) for i in range(len(pos))] == payloads
    out = P.run_ranks(2, "gloo", "cuda", P.recording_worker, ("toy", 4),
                      rec(), 8, timeout=300)
    for res, got_pos, got_payloads, stats in out:
        assert [int(p) for p in got_pos] == [int(p) for p in pos]
        assert got_payloads == payloads
        for key in ("ok", "flips"):
            assert np.array_equal(res[key].numpy(), want[key].cpu().numpy())
        assert stats["launches_B"] == 1
        assert (stats["chunks"], stats["rank_chunks"]) == (2, 1)

# -- the OSD header's elimination kernel (csrc/osd_eliminate.cu) --------------
# The kernel byte for byte equal to its plain loop, osd_eliminate_reference
# (run on the card's tensors), at [1], [12] and [128] on the BCH generator
# in reliability orders and on random matrices, full rank and
# rank-deficient; osd_decode on the card equal to the CPU's and to osd_np
# in (data, unique) on tests/test_osd.py's blocks and an all-erased tie
# (tests/test_torch_decoder.py holds the CPU's to JAX's on the same
# blocks); one card call launches once, counts 255 columns and waits only
# for its uploads; the wrapper raises on what it does not take.  The
# emulated kernel takes the same inputs (tests/test_torch_osd_emulated.py).

OSD_K, OSD_N = 71, 255


def osd_blocks(name):
    """tests/test_osd.py's inputs as soft [n, 255] int8 (the port's
    generator, which tests/test_torch_host.py holds to JAX's)."""
    g = generator_matrix()
    if name == "tie":
        return np.zeros((1, 255), np.int8)
    if name == "noiseless":
        rng = np.random.default_rng(1)
        u = rng.integers(0, 2, (1, 71), dtype=np.uint8)
        soft = 127 * (1 - 2 * ((u @ g) % 2).astype(np.int32))
    elif name == "erasure":
        rng = np.random.default_rng(3)
        u = rng.integers(0, 2, (1, 71), dtype=np.uint8)
        soft = 100 * (1 - 2 * ((u @ g) % 2).astype(np.int32))
        soft[0, rng.choice(255, 40, replace=False)] = 0
    else:
        sigma = float(name[len("awgn"):])
        rng = np.random.default_rng(2)
        softs = []
        for _ in range(5):
            u = rng.integers(0, 2, 71, dtype=np.uint8)
            rx = (1.0 - 2.0 * ((u @ g) % 2)) + sigma * rng.standard_normal(255)
            softs.append(np.clip(np.round(127 * rx / 4), -128, 127))
        soft = np.stack(softs)
    return soft.astype(np.int8)


OSD_NAMES = ["noiseless", "awgn0.5", "awgn0.8", "erasure", "tie"]


def osd_soft_batch(batch: int) -> np.ndarray:
    """tests/test_osd.py's blocks, then seeded noisy ones, [batch, 255]."""
    soft = np.concatenate([osd_blocks(n) for n in OSD_NAMES])
    rng = np.random.default_rng(batch)
    g = generator_matrix()
    extra = []
    while len(soft) + len(extra) < batch:
        u = rng.integers(0, 2, 71, dtype=np.uint8)
        rx = (1.0 - 2.0 * ((u @ g) % 2)) + 0.9 * rng.standard_normal(255)
        extra.append(np.clip(np.round(127 * rx / 4), -128, 127))
    if extra:
        soft = np.concatenate([soft, np.stack(extra).astype(np.int8)])
    return soft[:batch]


OSD_KINDS = ["bch", "random", "deficient", "rank3", "zero"]


def osd_case(kind: str, batch: int, seed: int):
    """(g [71, 255] uint8 0/1, perm [batch, 255] int64): BCH(255,71)'s
    generator in the stable reliability orders of osd_soft_batch, or, in
    seeded random orders, a random matrix, one of rank < 71 (zero and
    repeated columns, dependent and zero rows), one of rank 3, or zeros."""
    rng = np.random.default_rng(seed)
    if kind == "bch":
        soft = torch.from_numpy(osd_soft_batch(batch)).float()
        perm = torch.argsort(-soft.abs(), dim=1, stable=True).numpy()
        return generator_matrix().astype(np.uint8), perm
    perm = np.stack([rng.permutation(OSD_N) for _ in range(batch)])
    if kind == "zero":
        return np.zeros((OSD_K, OSD_N), np.uint8), perm
    if kind == "rank3":
        basis = rng.integers(0, 2, (3, OSD_N))
        mix = rng.integers(0, 2, (OSD_K, 3))
        return (mix @ basis % 2).astype(np.uint8), perm
    g = rng.integers(0, 2, (OSD_K, OSD_N), dtype=np.uint8)
    if kind == "deficient":
        g[:, rng.choice(OSD_N, 20, replace=False)] = 0
        g[:, rng.choice(OSD_N, 30, replace=False)] = g[:, rng.choice(
            OSD_N, 30, replace=False)]
        for r in rng.choice(OSD_K, 12, replace=False):
            a, b = rng.choice(OSD_K, 2, replace=False)
            g[r] = g[a] ^ g[b]
        g[rng.choice(OSD_K, 4, replace=False)] = 0
    return g, perm


def assert_osd_rank(red, kind: str) -> None:
    """Full rank for the BCH generator, below 71 where the input is."""
    ranks = [int(r.any(axis=1).sum()) for r in np.asarray(red)]
    if kind == "bch":
        assert ranks == [OSD_K] * len(ranks)
    elif kind in ("deficient", "rank3", "zero"):
        assert max(ranks) < OSD_K


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 12, 128])
@pytest.mark.parametrize("kind", OSD_KINDS)
def test_osd_kernel_equals_plain_elimination_on_card(cuda_device, kind, batch):
    g, perm = (torch.from_numpy(a).to(cuda_device)
               for a in osd_case(kind, batch, seed=batch))
    before = osd_eliminate.launches
    red, piv = osd_eliminate(g, perm)
    torch.cuda.synchronize()
    assert osd_eliminate.launches == before + 1
    want_red, want_piv = osd_eliminate_reference(
        g[:, perm].permute(1, 0, 2))
    assert red.dtype == torch.uint8 and piv.dtype == torch.int64
    assert torch.equal(red, want_red) and torch.equal(piv, want_piv)
    assert_osd_rank(red.cpu(), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("name", OSD_NAMES)
def test_osd_decode_on_card_equals_cpu_and_oracle(cuda_device, name):
    soft = torch.from_numpy(osd_blocks(name))
    data, unique = osd_decode(soft.to(cuda_device))
    cdata, cunique = osd_decode(soft)
    assert torch.equal(data.cpu(), cdata) and torch.equal(unique.cpu(),
                                                          cunique)
    for i, s in enumerate(soft.numpy()):
        nd, nu = osd_decode_np(s)
        assert np.array_equal(data[i].cpu().numpy(), nd), i
        assert bool(unique[i]) == nu, i
    if name == "tie":
        assert not bool(unique[0])


@pytest.mark.cuda
def test_osd_decode_on_card_launches_once_and_waits_only_to_upload(
        cuda_device):
    soft = torch.from_numpy(osd_blocks("awgn0.8")).to(cuda_device)
    osd_decode(soft)                       # builds and loads the kernel
    torch.cuda.synchronize()
    n0, o0, s0 = (osd_eliminate.launches, profiling.osd_steps,
                  profiling.syncs)
    osd_decode(soft)
    assert osd_eliminate.launches - n0 == 1
    assert profiling.osd_steps - o0 == 255
    assert profiling.syncs - s0 == 3       # the osd.upload waits
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        osd_decode(soft)
    spans = {r.name: r for r in profiling.spans()}
    assert "osd.column" not in spans
    counts = spans["osd.eliminate"].counts
    assert counts["osd_launches"] == 1 and counts["syncs"] == 0
    assert counts["osd_steps"] == 255


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["cpu perm", "g dtype", "perm dtype",
                                 "g shape", "perm shape"])
def test_osd_eliminate_raises_on_card_inputs_it_does_not_take(cuda_device,
                                                               bad):
    g = torch.from_numpy(generator_matrix().astype(np.uint8))
    g = g.to(cuda_device)
    perm = torch.stack([torch.randperm(OSD_N) for _ in range(3)])
    perm = perm.to(cuda_device)
    if bad == "cpu perm":
        perm = perm.cpu()
    elif bad == "g dtype":
        g = g.float()
    elif bad == "perm dtype":
        perm = perm.int()
    elif bad == "g shape":
        g = g[:70].contiguous()
    else:
        perm = perm[:, :254].contiguous()
    before = osd_eliminate.launches
    with pytest.raises((TypeError, ValueError)):
        osd_eliminate(g, perm)
    assert osd_eliminate.launches == before
