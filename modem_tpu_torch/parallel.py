"""Multi-device decoding over ``torch.distributed``: frame-batch data
parallelism and the rank-sharded sync scan.

Counterpart of ``modem_tpu/parallel.py``.  Frames are independent, so a
batch shards over the ranks of a 1-D ``"dp"`` mesh and one all-gather of
the decoded payload bits is the only collective (no intra-frame state
crosses devices); the long-recording sync scan shards its chunk axis and
recovers the Schmitt and argmax carries by composing per-chunk summaries
(``sync.Synchronizer._events_sharded``).  The mesh and its all-gather
are ``mesh.py``'s, imported here as the JAX module has them.  The idiom is PyTorch's SPMD: one
process a rank, one device a rank, every rank calling the same functions
on the same whole input, as JAX's host array is.  The caller picks the
process group's backend: NCCL between cards, gloo on the CPU (a gloo rank
on a card copies each gathered tensor to the host and back).  Nothing
falls back: an NCCL group on the CPU, a missing card or a failed rank
raises.

Also the toy configuration of the JAX package's multichip dry-run
(tiny symbol and code sizes, the pipeline's own code paths), and
:func:`run_ranks`, which spawns a world of ranks on one machine.  The
worker functions that :func:`run_ranks` runs live here: a spawned child
unpickles its worker by module, and must not import the test modules,
which import JAX.
"""

from __future__ import annotations

import functools
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from . import bits as B
from .mesh import BACKENDS, Mesh, all_gather_rows, make_mesh, resolve
from .numerology import make_config, toy_config
from .pipeline import BatchPipeline
from .sync import Synchronizer

def _rank_rows(mesh: Mesh, n_rows: int) -> slice:
    if n_rows % mesh.size:
        raise ValueError(f"a batch of {n_rows} does not divide over "
                         f"{mesh.size} ranks: pad it")
    per = n_rows // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _check_pipeline(pipe, mesh: Mesh) -> None:
    if not isinstance(pipe, BatchPipeline):
        raise TypeError("the sharded decode takes a BatchPipeline (no "
                        f"adaptive gate, as in the JAX package), not "
                        f"{type(pipe).__name__}")
    if resolve(pipe.device) != mesh.device:
        raise ValueError(f"pipeline on {pipe.device}, rank on "
                         f"{mesh.device}")


def sharded_decode_batched(pipe: BatchPipeline, mesh: Mesh,
                           per_chip: int | None = None):
    """Batched decode sharded over the mesh's ranks.  Returns fn:
    recordings [B, T] complex or [B, T, 2] float, the whole batch on
    every rank (B = mesh.size * per_chip; any multiple of mesh.size with
    ``per_chip`` None) -> {"bits": [B, data_bits] gathered onto every
    rank, "ok", "flips": this rank's [B / size]}; rank r decodes rows [r
    B/size, (r + 1) B/size) with ``pipe.decode_batch`` (kernel A at
    list_size 1, B at 2, 4 or 8, C with scl_exact=False).  Raises
    ValueError for a batch of another size."""
    _check_pipeline(pipe, mesh)

    def fn(recordings):
        n = len(recordings)
        if per_chip is not None and n != per_chip * mesh.size:
            raise ValueError(f"a batch of {n}: want {per_chip} a rank on "
                             f"{mesh.size} ranks")
        out = pipe.decode_batch(recordings[_rank_rows(mesh, n)])
        return {"bits": all_gather_rows(out["bits"], mesh),
                "ok": out["ok"], "flips": out["flips"]}

    return fn


def sharded_decode(pipe: BatchPipeline, mesh: Mesh):
    """:func:`sharded_decode_batched` for any batch that divides over the
    ranks (the JAX package's vmapped per-frame path; one body here)."""
    return sharded_decode_batched(pipe, mesh)


def sharded_sync(cfg, mesh: Mesh, kernel=None) -> Synchronizer:
    """A Synchronizer on the rank's device (``mesh.device``) whose chunked
    scan shards the chunk axis over the mesh (context parallelism): each
    rank computes the metrics, Schmitt trigger and collect regions of its
    chunks; only the chunk summaries (ten numbers a chunk) and each
    chunk's first edges cross ranks.  Its candidates are those of the
    single-device scan.  ``kernel``: the MLS0 kernels, as for
    Synchronizer."""
    sync = Synchronizer(cfg, mesh.device, kernel)
    sync.mesh = mesh
    return sync


def sharded_decode_recording(pipe: BatchPipeline, mesh: Mesh, x,
                             max_frames: int = 64):
    """The multi-device path for one long recording (analytic, or an
    ``ingest.PcmRecording`` whose front end runs a chunk at a time on the
    rank's device): the sharded scan, then ``pipe.windows_at``, the frames
    padded with zero windows to a multiple of the mesh's size, decoded by
    :func:`sharded_decode_batched` and trimmed to the real frames.

    Returns (dict {bits, ok, flips}, each gathered onto every rank so that
    ``pipe.payload_bytes`` works on any, or None when no frame was found;
    positions), equal to ``pipe.decode_recording``'s.  The sharded
    synchroniser is cached on the pipeline, keyed by the mesh."""
    _check_pipeline(pipe, mesh)
    cache = pipe.__dict__.setdefault("_sharded_sync", {})
    sync = cache.get(mesh)
    if sync is None:
        sync = cache[mesh] = sharded_sync(pipe.cfg, mesh,
                                          kernel=pipe.state.mls0_kernel)
    x = sync.recording(x)
    cands = [c for c in sync.scan(x, max_candidates=max_frames) if c.ok]
    wins, pos = pipe.windows_at(x, [c.p0 for c in cands])
    n = len(pos)
    if not n:
        return None, pos
    pad = (-n) % mesh.size
    wins = torch.cat([wins, wins.new_zeros((pad, wins.shape[1]))])
    res = sharded_decode_batched(pipe, mesh, len(wins) // mesh.size)(wins)
    return {"bits": res["bits"][:n],
            "ok": all_gather_rows(res["ok"], mesh)[:n],
            "flips": all_gather_rows(res["flips"], mesh)[:n]}, pos


# ---------------------------------------------------------------------------
# The toy configuration (tiny shapes, the pipeline's own code paths)
# ---------------------------------------------------------------------------

def toy_pipeline(list_size: int = 4, device="cuda") -> BatchPipeline:
    """The toy configuration's BatchPipeline (numerology.toy_config)."""
    cfg = toy_config()
    return BatchPipeline(rate=cfg.rate, oper_mode=0, list_size=list_size,
                         mode_spec=cfg.mode,
                         symbol_len_override=cfg.symbol_len, device=device)


def toy_recordings(batch: int, seed: int = 0, device="cuda"):
    """``batch`` toy frames, each one transmission (the port's Encoder on
    ``device``, call sign TOY) between symbol_len samples of silence:
    (split-complex recordings [B, T, 2] f32 numpy, payloads), the payload
    draws of the JAX package's toy_recordings."""
    from .encoder import Encoder

    cfg = toy_config()
    enc = Encoder(cfg, device=device)
    rng = np.random.default_rng(seed)
    sil = np.zeros(cfg.symbol_len, dtype=np.complex64)
    recs, payloads = [], []
    for _ in range(batch):
        payload = rng.integers(0, 256, cfg.mode.data_bytes,
                               dtype=np.uint8).tobytes()
        wave, _ = enc.encode(payload, B.base37_encode("TOY"))
        recs.append(np.concatenate([sil, wave, sil]))
        payloads.append(payload)
    recs = np.stack(recs)
    return np.stack([recs.real, recs.imag], axis=-1).astype(np.float32), \
        payloads


# ---------------------------------------------------------------------------
# Spawning ranks, and the workers they run
# ---------------------------------------------------------------------------

def _to_host(obj):
    """``obj`` with every tensor in it (in dicts, lists, tuples) copied to
    the host, so a result pickles by value."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank, world, backend, device, store_path, job_path,
               results):
    """A spawned rank: load (worker, args) from ``job_path``, join the
    group on the FileStore, run ``worker(mesh, *args)``, report (rank, ok,
    pickled result or traceback) and leave the group."""
    try:
        try:
            with open(job_path, "rb") as f:
                worker, args = pickle.load(f)
            dist.init_process_group(
                backend, store=dist.FileStore(store_path, world), rank=rank,
                world_size=world)
            out = worker(make_mesh(device=device), *args)
            msg = (rank, True, pickle.dumps(_to_host(out)))
        except Exception:
            msg = (rank, False, traceback.format_exc())
        results.put(msg)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world: int, backend: str, device, worker, *args,
              timeout: float = 600.0) -> list:
    """Run ``worker(mesh, *args)`` on ``world`` spawned ranks of one
    ``backend`` group, every rank on ``device``, and return every rank's
    result in rank order (tensors copied to the host); ``device`` None
    gives each rank make_mesh's default, its own card.  The group meets on
    a FileStore in a temporary directory (no TCP port to collide), and
    the ranks read the worker and its arguments from a file there: through
    the spawn pipe, arguments larger than its buffer would hold each rank
    until the one before it had imported torch.  A
    rank's exception raises RuntimeError with its traceback, a rank that
    dies or a world that has not answered within ``timeout`` seconds
    raises too; either way every rank still running is killed.  ``worker``
    must be importable by module (a function of this module).  On a card,
    kernels A, B and C are built here first, and the ranks load them."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    if device is None or torch.device(device).type == "cuda":
        # build kernels A, B and C here: the ranks then only load them
        from .kernels import sc_decode, scl_decode
        sc_decode._library()
        scl_decode._library()
    ctx = torch.multiprocessing.get_context("spawn")
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        job_path = os.path.join(tmp, "job")
        with open(job_path, "wb") as f:
            pickle.dump((worker, args), f)
        results = ctx.Queue()
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(rank, world, backend,
                  None if device is None else str(device),
                  os.path.join(tmp, "store"), job_path, results))
                 for rank in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world)) - set(got))
                    raise TimeoutError(f"ranks {missing} gave no result in "
                                       f"{timeout} s")
                try:
                    rank, ok, body = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    # a rank reports before it exits: one that died
                    # with an error code never will
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and "
                                           "no result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{body}")
                got[rank] = pickle.loads(body)
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]


@functools.lru_cache(maxsize=None)
def _pipeline(spec: tuple, device: str) -> BatchPipeline:
    """The pipeline of a spec, built once a process: ("toy", list_size) or
    (rate, oper_mode, list_size)."""
    if spec[0] == "toy":
        return toy_pipeline(spec[1], device=device)
    rate, mode, list_size = spec
    return BatchPipeline(rate, mode, list_size=list_size, device=device)


def decode_worker(mesh: Mesh, spec: tuple, recordings, per_chip=None):
    """Worker: :func:`sharded_decode_batched` of the ``spec`` pipeline
    (see :func:`_pipeline`) over ``recordings``; the rank's result."""
    pipe = _pipeline(spec, str(mesh.device))
    return sharded_decode_batched(pipe, mesh, per_chip)(recordings)


def scan_worker(mesh: Mesh, spec: tuple, x, max_candidates: int = 8,
                chunk_samples=None):
    """Worker: the sharded scan of ``x`` with the ``spec`` pipeline's
    configuration: (candidates, chunks walked, chunks this rank
    computed)."""
    pipe = _pipeline(spec, str(mesh.device))
    sync = sharded_sync(pipe.cfg, mesh, kernel=pipe.state.mls0_kernel)
    cands = sync.scan(x, max_candidates=max_candidates,
                      chunk_samples=chunk_samples)
    return cands, sync.last_chunks, sync.last_rank_chunks


def recording_worker(mesh: Mesh, spec: tuple, x, max_frames: int = 64):
    """Worker: :func:`sharded_decode_recording` of ``x`` with the ``spec``
    pipeline.  Returns (result, positions, payloads, stats): stats holds
    the wall ms (ending in a device synchronise), the chunks walked and
    this rank's, and the launches of kernels A and B in the call."""
    from .kernels.sc_decode import sc_decode
    from .kernels.scl_decode import scl_decode

    pipe = _pipeline(spec, str(mesh.device))
    launches = sc_decode.launches, scl_decode.launches
    t0 = time.perf_counter()
    res, pos = sharded_decode_recording(pipe, mesh, x, max_frames)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    wall = (time.perf_counter() - t0) * 1e3
    sync = pipe._sharded_sync[mesh]
    payloads = ([] if res is None else
                [pipe.payload_bytes(res, i) for i in range(len(pos))])
    return res, pos, payloads, dict(
        wall_ms=wall, chunks=sync.last_chunks,
        rank_chunks=sync.last_rank_chunks,
        launches_A=sc_decode.launches - launches[0],
        launches_B=scl_decode.launches - launches[1])


def run_jobs(mesh: Mesh, jobs) -> list:
    """Worker: each (worker, args) of ``jobs`` in turn on this rank, so
    one spawned world serves several checks; their results in order."""
    return [worker(mesh, *args) for worker, args in jobs]


def wire_recordings(n_frames: int, device="cuda"):
    """The dry-run's wire-size input: ``n_frames`` mode-6 frames at 8 kHz
    (seed 7, call sign N0CALL) encoded on ``device``, no silence: (complex
    recordings [n, T], payloads)."""
    from .encoder import Encoder
    cfg = make_config(8000, 6, 2000)
    rng = np.random.default_rng(7)
    payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes()
                for _ in range(n_frames)]
    waves, _ = Encoder(cfg, device=device).encode_batch(
        payloads, B.base37_encode("N0CALL"))
    return waves, payloads


def _dryrun_worker(mesh: Mesh) -> dict:
    """:func:`dryrun_multichip` on one rank: raises unless every frame is
    bit-exact; returns the frame counts and this rank's launches of
    kernel B in each drive (the toy's at L = 4 on one frame, then two;
    the wire size's at L = 8 on two)."""
    from .kernels.scl_decode import scl_decode

    n = mesh.size
    device = str(mesh.device)
    pipe = _pipeline(("toy", 4), device)
    launches = scl_decode.launches

    def check(out, payloads, label):
        if not bool(out["ok"].all()):
            raise AssertionError(f"{label}: decode failed on rank "
                                 f"{mesh.rank}: {out['ok']}")
        for i, want in enumerate(payloads):
            if pipe.payload_bytes(out, i) != want:
                raise AssertionError(f"{label}: payload {i} differs")

    recs, payloads = toy_recordings(n, device=device)
    out = sharded_decode(pipe, mesh)(recs)
    if tuple(out["bits"].shape) != (n, pipe.cfg.mode.data_bits):
        raise AssertionError(f"gathered bits {tuple(out['bits'].shape)}")
    check(out, payloads, "toy")
    toy_launches = scl_decode.launches - launches
    recs, payloads = toy_recordings(2 * n, seed=1, device=device)
    check(sharded_decode_batched(pipe, mesh, 2)(recs), payloads,
          "toy batched")
    batched_launches = scl_decode.launches - launches - toy_launches
    launches = scl_decode.launches
    # wire size: two mode-6 frames a rank (polar n = 64,800, list-8
    # kernel B at [2, 65536] on a card)
    waves, payloads = wire_recordings(2 * n, device)
    check(sharded_decode_batched(_pipeline((8000, 6, 8), device), mesh,
                                 2)(waves), payloads, "wire size")
    return {"toy": n, "toy_batched": 2 * n, "wire": 2 * n,
            "toy_launches_B": toy_launches,
            "toy_batched_launches_B": batched_launches,
            "wire_launches_B": scl_decode.launches - launches}


def dryrun_multichip(n_devices: int, backend: str = "gloo",
                     device="cuda") -> list:
    """The JAX package's multichip dry-run on ``n_devices`` spawned ranks:
    toy frames through :func:`sharded_decode` and
    :func:`sharded_decode_batched` (2 a rank), then two wire-size mode-6
    frames a rank through ``BatchPipeline(8000, 6)``, every frame
    bit-exact on every rank (else it raises).  Returns every rank's
    counts and launches."""
    out = run_ranks(n_devices, backend, device, _dryrun_worker)
    print(f"dryrun_multichip: {n_devices} {backend} ranks on {device}: "
          f"{out[0]['toy']} toy frames, {out[0]['toy_batched']} toy frames "
          f"batched ({out[0]['toy_batched'] // n_devices} a rank) and "
          f"{out[0]['wire']} wire-size mode-6 frames decoded bit-exact")
    return out
