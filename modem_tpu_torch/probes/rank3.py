"""Probe E: the primitives of the rank-count fork selection on a [128, 16]
f32 tile, each timed per iteration inside one launch.

Counterpart of ``bench/probe_rank3.py`` (its kernels nest in ``main``,
probe_rank3.py:52-136): five computations, each one template instance of
csrc/probe_rank3.cu looped R times inside one launch, with a plain
PyTorch twin (:func:`plain`) and the probe's own numpy expectation
(:func:`expected`), both composed over the same R iterations.  At R = 1
each is the probe's computation.  Beyond it each iteration works on the
previous one's data: the roll feeds itself (after R, the tile rolled by
-3R rows); the others add their result into the output, then rotate each
row of their tile by one column (x[p][q] <- x[p][q + 1 mod 16]), a
permutation, so the counts stay exact (integers under 2^24: R at most
:data:`MAX_REPS`).  Tolerances: exact, or ``atol`` 1e-5 an iteration for
the slot extract (multi-element sums in another order).  The sublane
roll by P - 3 is a row rotation on the card; the roll-aligned frame rank
is the rank count of the list decoder's ``rank_select`` path
(:func:`kernels.scl_decode.rank_count`, which the twin calls), ranked by
a warp's sort one frame a block (block f ranks frame f, 16 blocks), as
the list decoder runs one frame a block: the probe's strict-less count
on distinct values, ties broken by in-frame index.

Run: ``python3 -m modem_tpu_torch.probes.rank3 [reps]`` (on the card):
every kind held to its twin at R = 1, 4 and 43 on the probe's tile and
on a tile of ties and signed zeros, and to numpy at R = 1 (a failure
raises), then one line each: µs an iteration at ``reps`` (default
:data:`R`) with the bound and its share, the twin and the kernel over
``PLAIN_REPS`` iterations, the one-pass launch (R = 1) on the device (a
CUDA graph, :func:`card.graph_ms`) and as the host dispatches it, and
for the roll the device time of ``torch.roll`` at both.
"""

from __future__ import annotations

import collections
import math
import sys

import numpy as np
import torch

from ..card import cuda_ms, graph_ms, roofline
from ..kernels.scl_decode import rank_count
from . import _common

P, C, L = 128, 16, 8
KINDS = ("rank3_allpairs", "rank3_computed_mask", "rank2_slot_extract",
         "sublane_roll", "frame_rank_rolled")
ATOL = {"rank2_slot_extract": 1e-5}      # an iteration; others exact
R = 20000
MAX_REPS = 2 ** 24 // (L * C - 1)        # the frame rank's counts in f32
CHECK_REPS = (1, 4, 43)                  # 43: the roll wraps past 128 rows
# compares a comparison ranking of a frame's 128 distinct keys needs at
# least: ceil(log2 128!)
FRAME_COMPARES = math.ceil(math.lgamma(L * C + 1) / math.log(2))


def inputs() -> np.ndarray:
    """The probe's tile: standard normal of seed 0, [128, 16] f32."""
    return np.random.default_rng(0).standard_normal((P, C)).astype(
        np.float32)


def ties() -> np.ndarray:
    """A tile of repeated values and signed zeros, [128, 16] f32: halves
    in -2 .. 2 of seed 1, each zero's sign drawn, so that every row and
    frame holds ties, -0.0 beside +0.0 among them."""
    rng = np.random.default_rng(1)
    x = (rng.integers(-4, 5, (P, C)) / 2).astype(np.float32)
    x[(x == 0) & (rng.random((P, C)) < 0.5)] = -0.0
    return x


def out_cols(kind: str) -> int:
    return 8 if kind == "rank2_slot_extract" else C


def _expected_once(kind: str, x: np.ndarray) -> np.ndarray:
    """One iteration as the probe's numpy expectation
    (probe_rank3.py:59-135); the frame rank in (value, in-frame index)
    order, which is the probe's strict-less count on distinct values."""
    if kind == "rank3_allpairs":
        return (x[:, None, :] < x[:, :, None]).sum(axis=2).astype(np.float32)
    if kind == "rank3_computed_mask":
        tri = np.arange(C)[:, None] < np.arange(C)[None, :]
        eq = x[:, :, None] == x[:, None, :]
        return np.where(eq, np.broadcast_to(tri, (P, C, C)), 0.0).sum(
            axis=2).astype(np.float32)
    if kind == "rank2_slot_extract":
        r = np.floor(x * 3.0)
        out = np.zeros((P, 8), np.float32)
        for k in range(8):
            out[:, k] = np.where(r == k, x, 0.0).sum(axis=1)
        return out
    if kind == "frame_rank_rolled":
        out = np.zeros((P, C), np.float32)
        idx = np.arange(L * C)
        for f in range(P // L):
            blk = x[f * L:(f + 1) * L].ravel()
            before = (blk[None, :] < blk[:, None]) | (
                (blk[None, :] == blk[:, None]) & (idx[None, :] < idx[:, None]))
            out[f * L:(f + 1) * L] = before.sum(axis=1).reshape(L, C)
        return out
    raise ValueError(f"unknown computation {kind!r}")


def expected(kind: str, x: np.ndarray, reps: int = 1) -> np.ndarray:
    """The probe's numpy expectation composed over ``reps`` iterations:
    the roll by -3 reps rows, or the sum of each iteration's result on
    the tile rotated by its index (in f64, then f32)."""
    if kind == "sublane_roll":
        return np.roll(x, -3 * reps, axis=0)
    acc = sum(_expected_once(kind, np.roll(x, -i, axis=1)).astype(
        np.float64) for i in range(reps))
    return acc.astype(np.float32)


def _plain_once(kind: str, x: torch.Tensor) -> torch.Tensor:
    dev = x.device
    if kind == "rank3_allpairs":
        return (x[:, None, :] < x[:, :, None]).sum(dim=2).float()
    if kind == "rank3_computed_mask":
        q = torch.arange(C, device=dev)
        tri = (q[:, None] < q[None, :]).float()
        eq = x[:, :, None] == x[:, None, :]
        return torch.where(eq, tri, 0.0).sum(dim=2)
    if kind == "rank2_slot_extract":
        r = torch.floor(x * 3.0)
        k = torch.arange(8, device=dev, dtype=x.dtype)[:, None]
        return torch.where(r[:, None, :] == k, x[:, None, :], 0.0).sum(dim=2)
    if kind == "sublane_roll":
        return torch.roll(x, P - 3, dims=0)     # pltpu.roll(x, P - 3, 0)
    if kind == "frame_rank_rolled":
        frames = x.reshape(P // L, L * C)
        idx = torch.arange(L * C, device=dev).expand_as(frames)
        return rank_count(frames, idx).reshape(P, C).float()
    raise ValueError(f"unknown computation {kind!r}")


def plain(kind: str, x: torch.Tensor, reps: int = 1) -> torch.Tensor:
    """The plain PyTorch twin of ``reps`` iterations of computation
    ``kind`` on x [128, 16]: the roll applied to its own output, or each
    iteration's result on the tile rotated by its index added in
    iteration order (f32)."""
    if kind == "sublane_roll":
        for _ in range(reps):
            x = _plain_once(kind, x)
        return x
    acc = _plain_once(kind, x)
    for _ in range(1, reps):
        x = torch.roll(x, -1, dims=1)
        acc = acc + _plain_once(kind, x)
    return acc


def library():
    """csrc/probe_rank3.cu, built at first use and loaded."""
    return _common.library("probe_rank3", ("i", "p", "p", "i", "p"))


def _valid(kind: str, reps: int) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown computation {kind!r}")
    if not 1 <= reps <= MAX_REPS:
        raise ValueError(f"{reps} iterations: want 1 .. {MAX_REPS}")


def run(kind: str, x: torch.Tensor, reps: int = 1,
        out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel: ``reps`` iterations of computation ``kind`` on x [128,
    16] f32 (not written), one launch on the card (counted in
    ``run.launches[kind]``) into ``out`` ([128, out_cols(kind)] f32 on
    x's device, allocated if None); on a CPU tensor the plain twin."""
    _valid(kind, reps)
    if x.shape != (P, C):
        raise ValueError(f"tile of shape {tuple(x.shape)}: want [{P}, {C}]")
    shape = (P, out_cols(kind))
    if out is not None and (out.shape != shape or out.dtype != torch.float32
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous float32 {list(shape)} on "
                         f"{x.device}")
    if not _common.on_card(x, "probe_rank3"):
        y = plain(kind, x, reps)
        return y if out is None else out.copy_(y)
    lib = library()
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("probe_rank3 takes a 16-byte aligned tile and "
                         "output")
    rc = lib.probe_rank3_launch(KINDS.index(kind), x.data_ptr(),
                                out.data_ptr(), reps,
                                torch.cuda.current_stream(x.device).cuda_stream)
    _common.check_rc(lib, "probe_rank3", rc)
    run.launches[kind] += 1
    return out


run.launches = collections.Counter()


def ops(kind: str) -> int:
    """Operations of one iteration of computation ``kind`` (a compare,
    select or add 1), counted as the least the function needs on these
    inputs, one count for the function:

    - all-pairs rank: a compare and an add for each of a row's 240
      ordered pairs of distinct columns, 2 x 240 x 128 = 61,440;
    - tie count: a compare and an add for each of a row's 120 pairs
      q' > q, 2 x 120 x 128 = 30,720;
    - slot extract: a multiply, a floor, a compare and an add an element,
      each element into its one slot, 4 x 2,048 = 8,192;
    - roll: none (it moves bytes; the bound is the tile in and out);
    - frame rank: a comparison ranking of a frame's 128 keys needs at
      least ceil(log2 128!) = 717 compares (:data:`FRAME_COMPARES`; a
      serial merge sort takes 769), each of two operations: the value
      compare and the equality test that hands a tie to the index order;
      2 x 717 x 16 frames = 22,944.  The bitonic network the kernel runs
      takes 1,792 compare-exchanges a frame, and counting every pair
      128 x 127: neither is what the function needs.
    """
    return {"rank3_allpairs": 2 * P * C * (C - 1),
            "rank3_computed_mask": P * C * (C - 1),
            "rank2_slot_extract": 4 * P * C,
            "sublane_roll": 0,
            "frame_rank_rolled": 2 * FRAME_COMPARES * (P // L)}[kind]


def bound(kind: str, reps: int = 1) -> dict:
    """The roofline bound of one launch of ``reps`` iterations: the tile
    read once and the output written once, :func:`ops` an iteration."""
    return roofline(4 * P * C + 4 * P * out_cols(kind), reps * ops(kind))


def held(kind: str, got: torch.Tensor, want, reps: int, what: str) -> float:
    """Hold an output to ``want`` (a tensor or numpy array) at the kind's
    tolerance for ``reps`` iterations; returns the largest absolute
    difference, raises past the tolerance."""
    got = got.detach().cpu().float()
    want = torch.as_tensor(want).cpu().float()
    err = float((got - want).abs().max())
    if got.shape != want.shape or not torch.allclose(
            got, want, atol=ATOL.get(kind, 0.0) * reps, rtol=0):
        raise RuntimeError(f"probe_rank3 {kind}: {what} differs by {err} at "
                           f"R={reps}")
    return err


def check_one(kind: str, got: torch.Tensor, x: np.ndarray,
              reps: int = 1) -> float:
    """Hold an output to the probe's numpy expectation composed over
    ``reps`` iterations; returns the largest absolute difference, raises
    past the tolerance."""
    return held(kind, got, expected(kind, x, reps), reps, "numpy")


def check(device="cuda", reps=CHECK_REPS, kinds=KINDS) -> dict:
    """Each kind of ``kinds`` against its twin at each R of ``reps``, on
    the probe's tile and the tile of ties, and against the probe's numpy
    expectation at R = 1 on the probe's tile; raises on a mismatch.
    Returns the largest absolute difference a kind."""
    err = dict.fromkeys(kinds, 0.0)
    for tile in (inputs(), ties()):
        tile = torch.from_numpy(tile).to(device)
        for r in reps:
            for kind in kinds:
                err[kind] = max(err[kind], held(
                    kind, run(kind, tile, r), plain(kind, tile, r), r,
                    "kernel against its twin"))
    x = inputs()
    for kind in kinds:
        err[kind] = max(err[kind], check_one(
            kind, run(kind, torch.from_numpy(x).to(device)), x))
    return err


def timings(device="cuda", reps: int = R) -> tuple:
    """({kind: kernel ms of one launch of ``reps`` iterations}, {kind:
    (kernel ms, twin ms) of one call of PLAIN_REPS iterations}): a warm-up
    launch, then the best of two timed launches (each milliseconds long,
    so the device paces it); the pair by :func:`_common.pair_ms`."""
    x = torch.from_numpy(inputs()).to(device)
    ms, pair = {}, {}
    for kind in KINDS:
        run(kind, x, 2)
        ms[kind] = min(cuda_ms(lambda: run(kind, x, reps)) for _ in range(2))
        pair[kind] = _common.pair_ms(lambda r: run(kind, x, r),
                                     lambda r: plain(kind, x, r))
    return ms, pair


def one_pass_us(device="cuda") -> dict:
    """{kind: (device µs, host µs)} of one launch at R = 1: the device's
    time by :func:`card.graph_ms` (the output allocated before the
    capture; ``run.launches`` gets the launches the device ran, from what
    it counted while the capture recorded), and the time of 100 launches
    as the host dispatches them (ctypes), which paces them."""
    x = torch.from_numpy(inputs()).to(device)
    t = {}
    for kind in KINDS:
        out = torch.empty(P, out_cols(kind), device=device)
        before = run.launches[kind]
        ms, ran = graph_ms(lambda: run(kind, x, 1, out),
                           lambda: run.launches[kind])
        run.launches[kind] = before + ran
        t[kind] = (ms * 1e3, cuda_ms(lambda: run(kind, x, 1, out), 100) * 1e3)
    return t


def library_us(device="cuda", reps: int = 1) -> float:
    """µs on the device of ``torch.roll(x, (P - 3) reps mod P, 0)``, the
    one PyTorch call that computes ``reps`` iterations of the roll (R
    rolls by P - 3 compose into one), timed by :func:`card.graph_ms`.  No
    other kind has one call: a rank is an ``argsort`` of an ``argsort``,
    two."""
    x = torch.from_numpy(inputs()).to(device)
    shift = (P - 3) * reps % P
    return graph_ms(lambda: torch.roll(x, shift, 0))[0] * 1e3


def report(ms: dict, pair: dict, one_pass: dict, roll_us: dict,
           reps: int = R) -> list:
    """One line a kind: µs an iteration at ``reps`` with the bound and its
    share, the twin and the kernel over PLAIN_REPS iterations, the
    one-pass launch on the device and as the host dispatches it; for the
    roll ``torch.roll`` ({iterations: device µs}) at R = 1 and at
    PLAIN_REPS."""
    lines = []
    n = _common.PLAIN_REPS
    for kind in KINDS:
        us = ms[kind] * 1e3 / reps
        b_us = bound(kind, reps)["bound_ms"] * 1e3 / reps
        k_ms, p_ms = pair[kind]
        dev_us, host_us = one_pass[kind]
        lines.append(
            f"{kind:20s}: {us:.4f} us/iter (R={reps}; bound {b_us:.6f}, "
            f"share {b_us / us:.2%}); over {n} iterations plain twin "
            f"{p_ms:.3f} ms, kernel {k_ms:.4f} ms; one pass {dev_us:.3f} us "
            "on the device (a CUDA graph), "
            f"{host_us:.2f} us as the host dispatches it (ctypes against "
            "torch's dispatcher)"
            + (f"; torch.roll on the device {roll_us[1]:.3f} us at R = 1, "
               f"{roll_us[n]:.3f} us at R = {n}"
               if kind == "sublane_roll" else ""))
    return lines


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("probe_rank3 runs on the card: no CUDA device")
    reps = int(argv[1]) if len(argv) > 1 else R
    check()
    print(f"every kind equals its twin at R = {CHECK_REPS} on the probe's "
          "tile and the tile of ties, and numpy at R = 1")
    roll_us = {r: library_us(reps=r) for r in (1, _common.PLAIN_REPS)}
    print("\n".join(report(*timings(reps=reps), one_pass_us(), roll_us,
                           reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
