"""The port's multi-device path (modem_tpu_torch.parallel over
torch.distributed) against the JAX package's shard_map path and the
port's single-device path, on the toy configuration.

Each world size (gloo, 2 and 4 ranks on the CPU) is spawned once a
module and runs every check's job (parallel.run_jobs); each JAX sharded
function runs once, on a 4-device mesh of tests/conftest.py's 8 virtual
devices.  The inputs are the JAX package's toy recordings, clean (on
noisy toy frames one LLR takes the other sign under the two FFTs'
rounding), except the scan's: tests/test_pipeline.py's noisy six-frame
recording, and a noisy mono int16 one (the port's encoder).  Exact:
bits, ok, flips, positions, payloads and the scan's (p0, ok), and
against the port's single device its (conv, frac_cfo) too; cfo_rad
within 1e-6.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from modem_tpu import parallel as jax_parallel
from modem_tpu.ingest import PcmRecording as JaxPcm
from modem_tpu_torch import bits as B
from modem_tpu_torch import parallel as P
from modem_tpu_torch.encoder import Encoder
from modem_tpu_torch.ingest import PcmRecording
from modem_tpu_torch.numerology import toy_config
from modem_tpu_torch.pipeline import AdaptivePipeline
from modem_tpu_torch.sync import Synchronizer

TOY = ("toy", 4)
JAX_DEVICES = 4
# (input, max_candidates, chunk_samples): tests/test_pipeline.py's scan,
# the same stopping after a round in mid-recording (rounds of 16 chunks),
# and mono int16 PCM (its front end a chunk at a time) at two chunk sizes
SCANS = {"chunks 2048": ("scan", 8, 2048),
         "stop mid-recording": ("scan", 1, 512),
         "mono pcm 1024": ("mono", 8, 1024),
         "mono pcm 2048": ("mono", 8, 2048)}
JAX_SCANS = ("chunks 2048", "stop mid-recording")
KINDS = ("analytic", "pcm")


def scan_recording():
    """tests/test_pipeline.py:75-98: toy x6 plus 0.02 noise (seed 7)."""
    recs, _ = jax_parallel.toy_recordings(1, seed=5)
    x = np.concatenate([np.asarray(recs[0])] * 6, axis=0)
    rng = np.random.default_rng(7)
    return x + rng.normal(0, 0.02, x.shape).astype(np.float32)


def mono_recording():
    """Five toy frames at a 2 kHz offset (the port's encoder), 0.01 of
    seeded noise, their real part as mono int16 (as
    tests/test_torch_ingest.py makes its mono case)."""
    cfg = dataclasses.replace(toy_config(), freq_off=2000)
    payload = np.random.default_rng(3).integers(
        0, 256, cfg.mode.data_bytes, dtype=np.uint8).tobytes()
    wave, _ = Encoder(cfg, device="cpu").encode(payload,
                                                B.base37_encode("TOY"))
    sil = np.zeros(cfg.symbol_len, np.complex64)
    x = np.concatenate([sil, wave, sil] * 5).real
    x = x + np.random.default_rng(42).normal(0, 0.01, x.shape)
    x = x * (0.5 / np.abs(x).max())
    return PcmRecording(data=np.rint(x * 32767.0).astype(np.int16), bits=16,
                        rate=8000)


@pytest.fixture(scope="module")
def inputs():
    """The JAX package's toy recordings, numpy, as both sides take them."""
    recs, payloads = jax_parallel.toy_recordings(8, seed=4)
    batched, batched_payloads = jax_parallel.toy_recordings(8, seed=1)
    one, one_payloads = jax_parallel.toy_recordings(1, seed=8)
    four, four_payloads = jax_parallel.toy_recordings(4, seed=2)
    stereo = np.concatenate([np.asarray(r) for r in four], axis=0)
    return dict(
        recs=np.asarray(recs), payloads=payloads,
        batched=np.asarray(batched), batched_payloads=batched_payloads,
        scan=scan_recording(), mono=mono_recording(),
        analytic=np.concatenate([np.asarray(one[0])] * 6, axis=0),
        analytic_payloads=one_payloads * 6,
        pcm=np.clip(np.rint(stereo * 32767), -32768, 32767).astype(np.int16),
        pcm_payloads=four_payloads)


def recording(inputs, kind, cls):
    if kind == "pcm":
        return cls(data=inputs["pcm"].copy(), bits=16, rate=8000)
    return inputs["analytic"]


@pytest.fixture(scope="module")
def jax_results(inputs):
    """Each JAX sharded function once, on a 4-device mesh."""
    assert len(jax.devices()) >= JAX_DEVICES
    mesh = jax_parallel.make_mesh(JAX_DEVICES)
    cfg = jax_parallel.toy_config()
    pipe = jax_parallel.toy_pipeline()
    out = jax_parallel.sharded_decode(pipe, mesh)(inputs["recs"])
    scans = {name: jax_parallel.sharded_sync(cfg, mesh).scan(
        inputs[SCANS[name][0]], max_candidates=SCANS[name][1],
        chunk_samples=SCANS[name][2]) for name in JAX_SCANS}
    recordings = {}
    for kind in KINDS:
        res, pos = jax_parallel.sharded_decode_recording(
            pipe, mesh, recording(inputs, kind, JaxPcm), max_frames=8)
        recordings[kind] = (
            [pipe.payload_bytes(res, i) for i in range(len(pos))],
            list(pos), np.asarray(res["ok"]), np.asarray(res["flips"]))
    return dict(decode={k: np.asarray(v) for k, v in out.items()},
                scans=scans, recordings=recordings)


@pytest.fixture(scope="module")
def single(inputs):
    """The port on one device (the CPU)."""
    pipe = P.toy_pipeline(device="cpu")
    sync = Synchronizer(toy_config(), "cpu")
    decode = {k: v.numpy() for k, v in pipe.decode_batch(
        inputs["recs"]).items()}
    batched = {k: v.numpy() for k, v in pipe.decode_batch(
        inputs["batched"]).items()}
    scans = {}
    for name, (x, mc, cs) in SCANS.items():
        scans[name] = sync.scan(inputs[x], max_candidates=mc,
                                chunk_samples=cs)
        scans[name + " chunks"] = sync.last_chunks
    recordings = {}
    for kind in KINDS:
        res, pos = pipe.decode_recording(
            recording(inputs, kind, PcmRecording), max_frames=8)
        recordings[kind] = (
            [pipe.payload_bytes(res, i) for i in range(len(pos))],
            [int(p) for p in pos], res["ok"].numpy(), res["flips"].numpy())
    return dict(decode=decode, batched=batched, scans=scans,
                recordings=recordings)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"world{n}")
def world(request, inputs):
    """One spawned gloo world on the CPU running every check's job: the
    world size and each rank's results."""
    n = request.param
    jobs = [(P.decode_worker, (TOY, inputs["recs"])),
            (P.decode_worker, (TOY, inputs["batched"][: 2 * n], 2))]
    jobs += [(P.scan_worker, (TOY, inputs[x], mc, cs))
             for x, mc, cs in SCANS.values()]
    jobs += [(P.recording_worker,
              (TOY, recording(inputs, kind, PcmRecording), 8))
             for kind in KINDS]
    out = P.run_ranks(n, "gloo", "cpu", P.run_jobs, jobs, timeout=300)
    names = ["decode", "batched"] + list(SCANS) + list(KINDS)
    return n, [dict(zip(names, rank)) for rank in out]


def rank_rows(n, rank, rows):
    per = rows // n
    return slice(rank * per, (rank + 1) * per)


def test_sharded_decode_matches_jax_and_single_device(world, jax_results,
                                                      single, inputs):
    n, ranks = world
    want = single["decode"]
    jax_out = jax_results["decode"]
    assert np.array_equal(jax_out["bits"], want["bits"])
    for rank, got in enumerate(ranks):
        got = got["decode"]
        assert np.array_equal(got["bits"].numpy(), want["bits"])
        rows = rank_rows(n, rank, len(inputs["recs"]))
        for key in ("ok", "flips"):
            assert np.array_equal(got[key].numpy(), want[key][rows]), key
            assert np.array_equal(got[key].numpy(),
                                  jax_out[key][rows].astype(want[key].dtype))
    assert want["ok"].all()


def test_sharded_decode_batched_matches_single_device(world, single,
                                                      inputs):
    n, ranks = world
    want = single["batched"]
    for rank, got in enumerate(ranks):
        got = got["batched"]
        assert np.array_equal(got["bits"].numpy(), want["bits"][: 2 * n])
        rows = rank_rows(n, rank, 2 * n)
        for key in ("ok", "flips"):
            assert np.array_equal(got[key].numpy(), want[key][rows]), key
    assert want["ok"][: 2 * n].all()


@pytest.mark.parametrize("scan", list(SCANS))
def test_sharded_scan_matches_jax_and_single_device(world, jax_results,
                                                    single, scan):
    n, ranks = world
    want = single["scans"][scan]
    assert sum(c.ok for c in want) >= 1
    for rank in ranks:
        cands = rank[scan][0]
        # event for event: the same edges, peaks and phases
        assert [(c.p0, c.ok, c.conv, c.frac_cfo) for c in cands] == \
            [(c.p0, c.ok, c.conv, c.frac_cfo) for c in want]
        refs = [want] + ([jax_results["scans"][scan]]
                         if scan in JAX_SCANS else [])
        for ref in refs:
            assert [(c.p0, c.ok) for c in cands] == \
                [(c.p0, c.ok) for c in ref]
            assert max(abs(a.cfo_rad - b.cfo_rad)
                       for a, b in zip(cands, ref)) < 1e-6
    # every rank walked the same rounds and its own share of them
    walked = {rank[scan][1] for rank in ranks}
    assert len(walked) == 1
    assert sum(rank[scan][2] for rank in ranks) == walked.pop()


def test_scan_stops_after_a_round_mid_recording(world, single, inputs):
    """With one candidate wanted, the sharded walk stops after the round
    that brings its four raw edges, well before the recording's end,
    and not before the single-device walk did."""
    n, ranks = world
    x, mc, cs = SCANS["stop mid-recording"]
    sync = Synchronizer(toy_config(), "cpu")
    c, _ctx = sync._context(cs)
    total = -(-(len(inputs[x]) - 2 * sync.L) // c)
    walked = ranks[0]["stop mid-recording"][1]
    assert single["scans"]["stop mid-recording chunks"] <= walked < total
    assert walked % Synchronizer.MAX_CHUNKS_PER_ROUND == 0


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_decode_recording_matches_jax_and_single_device(
        world, jax_results, single, inputs, kind):
    n, ranks = world
    payloads, pos, ok, flips = single["recordings"][kind]
    j_payloads, j_pos, j_ok, j_flips = jax_results["recordings"][kind]
    assert payloads == inputs[f"{kind}_payloads"] == j_payloads
    assert pos == j_pos and ok.all()
    assert np.array_equal(flips, j_flips.astype(flips.dtype))
    for rank in ranks:
        res, got_pos, got_payloads, stats = rank[kind]
        assert [int(p) for p in got_pos] == pos
        assert got_payloads == payloads
        assert np.array_equal(res["ok"].numpy(), ok)
        assert np.array_equal(res["flips"].numpy(), flips)
        assert stats["launches_A"] == 0     # the plain versions on the CPU
    assert sum(r[kind][3]["rank_chunks"] for r in ranks) == \
        ranks[0][kind][3]["chunks"]


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A gloo group of one rank in this process: the sharded walk's
    composition of carries, without spawning."""
    dist = torch.distributed
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield P.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def synthetic_timing(sync, n, seed):
    """A timing metric of runs of random length (1 to 3 chunks of 512)
    at a few levels around the Schmitt thresholds, so collect regions
    span whole chunks and values tie, and random phases."""
    rng = np.random.default_rng(seed)
    levels = np.array([0.0, (sync.thr_lo + sync.thr_hi) / 2,
                       1.5 * sync.thr_hi, 2.0 * sync.thr_hi], np.float32)
    runs = []
    while sum(len(r) for r in runs) < n:
        runs.append(np.full(rng.integers(1, 1536), rng.choice(levels),
                            np.float32))
    t = np.concatenate(runs)[:n]
    return (torch.from_numpy(t),
            torch.from_numpy(rng.uniform(-3, 3, n).astype(np.float32)))


@pytest.mark.parametrize("seed", range(6))
def test_sharded_walk_composes_carries_exactly(one_rank_mesh, monkeypatch,
                                               seed):
    """The sharded walk against the single-device walk on a synthetic
    metric (in place of each chunk's computed one) whose collect regions
    run over whole chunks and tie across them: the carries composed from
    the chunks' summaries give the same events, edge, peak index and
    phase, stopping early or not."""
    sync = Synchronizer(toy_config(), "cpu")
    c, _ctx = sync._context(512)
    n_out = 40 * c - 100
    t, ph = synthetic_timing(sync, 40 * c, seed)
    monkeypatch.setattr(sync, "_chunk_metrics", lambda x, n0, c, ctx: (
        t[n0: n0 + c].clone(), ph[n0: n0 + c].clone()))
    x = torch.zeros(n_out + 2 * sync.L, dtype=torch.complex64)
    for max_edges in (1000, 5):
        want = sync._events_device(x, c, max_edges)
        sync.mesh = one_rank_mesh
        sync.MAX_CHUNKS_PER_ROUND = 3
        got = sync._events_device(x, c, max_edges)
        sync.mesh = None
        assert got == want
        assert len(want) == min(max_edges, len(got)) > 0


def test_toy_recordings_match_jax():
    got, got_payloads = P.toy_recordings(3, seed=6, device="cpu")
    want, want_payloads = jax_parallel.toy_recordings(3, seed=6)
    assert got_payloads == want_payloads
    assert got.shape == np.asarray(want).shape
    assert np.abs(got - np.asarray(want)).max() <= 1e-6


def test_pcm_recording_pickles_without_device_copies():
    """A recording sent to spawned ranks carries its samples only: each
    rank copies them to its own device."""
    import pickle
    pcm = PcmRecording(data=np.arange(8, dtype=np.int16), bits=16,
                       rate=8000)
    pcm.on("cpu")
    got = pickle.loads(pickle.dumps(pcm))
    assert got._device_copy == {} and pcm._device_copy
    assert np.array_equal(got.data, pcm.data)


def fake_mesh(size=2, rank=0):
    """A mesh that never reaches a collective: the checks before one."""
    return P.Mesh(group=None, rank=rank, size=size,
                  device=torch.device("cpu"), backend="gloo")


def test_batch_must_divide_over_the_ranks(inputs):
    pipe = P.toy_pipeline(device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        P.sharded_decode(pipe, fake_mesh())(inputs["recs"][:3])
    with pytest.raises(ValueError, match="2 a rank"):
        P.sharded_decode_batched(pipe, fake_mesh(), 2)(inputs["recs"][:6])


def test_sharded_decode_takes_a_batch_pipeline():
    """No adaptive gate on the sharded path, as in the JAX package."""
    cfg = toy_config()
    pipe = AdaptivePipeline(cfg.rate, 0, list_size=4, mode_spec=cfg.mode,
                            symbol_len_override=cfg.symbol_len,
                            device="cpu")
    with pytest.raises(TypeError, match="BatchPipeline"):
        P.sharded_decode(pipe, fake_mesh())


@pytest.mark.parametrize("entry", ["toy_pipeline", "toy_recordings",
                                   "wire_recordings", "dryrun_multichip"])
def test_entry_points_run_on_the_card_by_default(entry):
    """Every entry point of the module takes the card unless the caller
    passes device="cpu" (make_mesh's default is the rank's card, pinned
    in test_no_fallback_from_nccl_or_the_card)."""
    import inspect
    param = inspect.signature(getattr(P, entry)).parameters["device"]
    assert param.default == "cuda"


def test_make_mesh_needs_an_initialised_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="not initialised"):
        P.make_mesh(device="cpu")


def test_no_fallback_from_nccl_or_the_card(monkeypatch):
    """An NCCL group with a CPU device raises (never becomes gloo), and
    with no card a rank asked for the default device raises (never runs
    on the CPU)."""
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="NCCL"):
        P.make_mesh(group=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.make_mesh(group=object())
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "mpi")
    with pytest.raises(ValueError, match="mpi"):
        P.make_mesh(group=object(), device="cpu")


def test_a_failing_rank_fails_the_call(inputs):
    """A rank's exception raises in the caller, with its traceback; no
    partial results come back."""
    with pytest.raises(RuntimeError, match="does not divide"):
        P.run_ranks(2, "gloo", "cpu", P.decode_worker, TOY,
                    inputs["recs"][:3], timeout=120)
