"""Probe F: is the list decoder's serial op cost issue throughput or
dependence latency?

Counterpart of ``bench/probe_interleave.py``: its op mixes ``chain_body``
(:46), ``leaf_body`` (:59) and ``leaf_width_body`` (:187), R serially
dependent iterations in one launch of csrc/probe_interleave.cu, each with
a plain PyTorch twin (:func:`chain_body`, :func:`leaf_body`,
:func:`leaf_width_body`, looped by :func:`run_plain` and
:func:`run_width_plain`).  Three variants per mix, as the probe's:

  single : one chain, R iterations
  dual   : two independent chains, R iterations each (2x work, same depth)
  double : one chain, 2R iterations (2x work, 2x depth)

latency-bound => dual ~= single; throughput-bound => dual ~= double; the
probe's verdict rule: ``dual < 0.6 x double`` is latency-bound.  The
width probe times one leaf-width chain at W = 128 and 256.

Two variants the probe lacks, for the question it was asked for (several
frames in one block): ``shared`` runs a dual whose two chains pass one
set of block barriers together (the leaf's two a chain, as the probe
writes it, are passed chain after chain), and ``narrow`` runs the
leaf-width body at W = :data:`NARROW` columns, one element a thread, the
density of the decoders' rows, as single, dual, shared dual and double.

Every kernel returns (out, pm), each [1, P]: the probe's output (pm plus
the column sums of the states) and the path metrics alone, each held to
its twin at its own tolerance.

Run: ``python3 -m modem_tpu_torch.probes.interleave [reps]`` (default
2000) or ``... interleave width [reps]`` (default 50000), on the card.
Each kernel is first held to its twin at 8 iterations (a failure raises).
"""

from __future__ import annotations

import collections
import sys

import numpy as np
import torch

from ..card import cuda_ms, roofline
from . import _common

P = 128
BIG = 3.0e38
L = 8
F = P // L
BODIES = ("chain", "leaf")
NARROW = 4
CHECK_REPS = 8
# kernel against twin: the rows' states are the same IEEE operations in
# both, so x is exact; the output's column sums are taken in another
# order (RTOL, ATOL), and so are the row sums that go into pm, which is
# held on its own, relative only (PM_RTOL): it is ~1e-6 x the
# iterations, far under ATOL
RTOL, ATOL = 1e-5, 1e-3
PM_RTOL = 1e-5


def chain_body(x: torch.Tensor, pm: torch.Tensor):
    """min-sum F against the columns rolled by 64, the penalty into pm."""
    y = torch.cat([x[:, 64:], x[:, :64]], dim=1)
    out = torch.sign(x) * torch.sign(y) * torch.minimum(x.abs(), y.abs())
    pen = torch.relu(-out).sum(dim=1, keepdim=True)
    pm2 = pm + 1e-6 * pen.T
    out = torch.where(out.abs() > 4.0, out * 0.5, out + 0.125)
    return out, pm2


def leaf_body(x: torch.Tensor, pm: torch.Tensor):
    """One extraction round, the per-frame reduce and the row permute
    (the probe's one-hot matmul, a row gather)."""
    dev = x.device
    i128 = torch.arange(128, device=dev)[None, :]
    lane = torch.arange(P, device=dev)
    colmin = x.min(dim=1, keepdim=True).values                    # [P, 1]
    colat = torch.where(x == colmin, i128, 128).min(
        dim=1, keepdim=True).values                               # [P, 1]
    gmask = lane[None, :] // L == torch.arange(F, device=dev)[:, None]
    rowm = torch.where(gmask, colmin.T.expand(F, P), BIG)         # [F, P]
    m = rowm.min(dim=1, keepdim=True).values                      # [F, 1]
    at = torch.where(rowm == m, lane[None, :], P).min(
        dim=1, keepdim=True).values                               # [F, 1]
    at_p = at[lane // L]                                          # [P, 1]
    perm = (at_p[:, 0] + lane) % P
    x2 = x[perm]
    hit = (lane[:, None] == at_p) & (i128 == colat)
    x2 = torch.where(hit, x2 + 1.0, x2)
    x2 = torch.where(x2.abs() > 4.0, x2 * 0.5, x2 + 0.0625)
    pm2 = pm + 1e-6 * m.min() * torch.ones(1, P, device=dev)
    return x2, pm2


def leaf_width_body(x: torch.Tensor, pm: torch.Tensor, w: int):
    """The leaf's width-axis mix on [P, w]."""
    iw = torch.arange(w, device=x.device)[None, :]
    colmin = x.min(dim=1, keepdim=True).values
    colat = torch.where(x == colmin, iw, w).min(dim=1, keepdim=True).values
    acc = x + colmin * 0.125
    acc = torch.where(iw == colat, acc + 1.0, acc)
    m2 = torch.where(iw == colat, BIG, acc).min(dim=1, keepdim=True).values
    acc = acc + m2 * 0.0625
    x2 = torch.where(acc.abs() > 4.0, acc * 0.5, acc + 0.03125)
    return x2, pm + 1e-6 * colmin.sum() * torch.ones(1, P, device=x.device)


def _output(pm: torch.Tensor, states) -> tuple:
    """(pm + the states' column sums over the first min(W, P) columns,
    pm), as the probe's kernels end."""
    acc = pm
    for st in states:
        cols = min(st.shape[1], P)
        acc = torch.cat([acc[:, :cols] + st[:, :cols].sum(dim=0, keepdim=True),
                         acc[:, cols:]], dim=1)
    return acc, pm


def run_plain(body: str, x: torch.Tensor, n_chains: int, reps: int):
    """The probe's ``make_probe`` kernel as tensor ops: x [2, P, 128] ->
    (out [1, P], pm [1, P])."""
    fn = chain_body if body == "chain" else leaf_body
    xs = [x[c] for c in range(n_chains)]
    pm = torch.zeros(1, P, device=x.device)
    for _ in range(reps):
        for c in range(n_chains):
            xs[c], pm = fn(xs[c], pm)
    return _output(pm, xs)


def run_width_plain(x: torch.Tensor, width: int, reps: int,
                    n_chains: int = 1):
    """The probe's ``make_width_probe`` kernel as tensor ops, pm threaded
    through ``n_chains`` states in turn: x [>= n_chains, P, >= width] ->
    (out [1, P], pm [1, P])."""
    xs = [x[c, :, :width] for c in range(n_chains)]
    pm = torch.zeros(1, P, device=x.device)
    for _ in range(reps):
        for c in range(n_chains):
            xs[c], pm = leaf_width_body(xs[c], pm, width)
    return _output(pm, xs)


def library():
    """csrc/probe_interleave.cu, built at first use and loaded."""
    return _common.library("probe_interleave",
                           ("i", "i", "i", "i", "p", "i", "i", "p", "p"))


def _launch(key: str, body: int, n_chains: int, width: int, shared: bool,
            x: torch.Tensor, reps: int) -> tuple:
    if x.dim() != 3 or x.shape[0] < n_chains or x.shape[1] != P:
        raise ValueError(f"state of shape {tuple(x.shape)}: want "
                         f"[>= {n_chains}, {P}, width]")
    lib = library()
    out = torch.empty(2, P, dtype=torch.float32, device=x.device)
    rc = lib.probe_interleave_launch(
        body, n_chains, width, int(shared), x.data_ptr(), x.shape[2], reps,
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _common.check_rc(lib, "probe_interleave", rc)
    run.launches[key] += 1
    return out[0:1], out[1:2]


def run(body: str, x: torch.Tensor, n_chains: int, reps: int,
        shared: bool = False) -> tuple:
    """The kernel of :func:`run_plain` (counted in ``run.launches[body]``,
    or ``[body + "_shared"]``); ``shared``: the leaf's two chains pass one
    set of barriers together (the same result).  On a CPU tensor the
    plain twin."""
    if shared and (body != "leaf" or n_chains != 2):
        raise ValueError("shared barriers are the leaf's, at two chains")
    if not _common.on_card(x, "probe_interleave"):
        return run_plain(body, x, n_chains, reps)
    return _launch(body + "_shared" * shared, BODIES.index(body), n_chains,
                   128, shared, x, reps)


def run_width(x: torch.Tensor, width: int, reps: int, n_chains: int = 1,
              shared: bool = False) -> tuple:
    """The kernel of :func:`run_width_plain`: one chain at width 128 or
    256 (counted in ``run.launches["width"]``), or 1 or 2 chains at
    :data:`NARROW` (``["narrow"]``, ``["narrow_shared"]`` with
    ``shared``: both chains' row sums before one barrier).  On a CPU
    tensor the plain twin."""
    if not ((width in (128, 256) and n_chains == 1 and not shared)
            or (width == NARROW and n_chains in (1, 2)
                and (n_chains == 2 or not shared))):
        raise ValueError(f"no width kernel for width {width}, {n_chains} "
                         f"chain(s), shared={shared}")
    if not _common.on_card(x, "probe_interleave"):
        return run_width_plain(x, width, reps, n_chains)
    key = ("width" if width != NARROW else "narrow") + "_shared" * shared
    return _launch(key, 2, n_chains, width, shared, x, reps)


run.launches = collections.Counter()


def inputs(seed: int, width: int = 128, chains: int = 2) -> torch.Tensor:
    """The probe's ``mk(seed)``: normal(0, 1), [chains, P, width] f32."""
    return torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, (chains, P, width)).astype(np.float32))


def bound(body: str, n_chains: int, reps: int, width: int = 128) -> dict:
    """The roofline bound of one launch: the states read once and the
    [2, P] output written once; operations per element of an iteration
    counted from the body (chain: 2 signs, 2 products, 2 magnitudes, a
    min, the penalty's negate, max and add, the clamp's magnitude,
    compare, scale, add and select = 15; leaf: the row minimum, its
    column (compare, select, min), the hit (2 compares, an and, an add,
    a select) and the clamp = 14, the row gather moving data only;
    width: the minimum and its column 4, two masked updates 6, the
    second minimum 3, the clamp 5 = 18), plus the output's sums."""
    per = {"chain": 15, "leaf": 14, "width": 18}[body]
    e = P * width * n_chains
    return roofline(4 * e + 8 * P, reps * per * e + e + P)


def _held(name: str, got: tuple, want: tuple) -> float:
    """Hold (out, pm) to its twin's: out at RTOL, ATOL, pm at PM_RTOL;
    raises on a mismatch, returns the largest absolute difference."""
    (out, pm), (out_w, pm_w) = got, want
    d_out = float((out - out_w).abs().max())
    d_pm = float((pm - pm_w).abs().max())
    if not torch.allclose(out, out_w, rtol=RTOL, atol=ATOL):
        raise RuntimeError(f"probe_interleave {name}: output differs from "
                           f"its plain twin by {d_out}")
    if not torch.allclose(pm, pm_w, rtol=PM_RTOL, atol=0.0):
        raise RuntimeError(f"probe_interleave {name}: pm differs from its "
                           f"plain twin by {d_pm}")
    return max(d_out, d_pm)


def check(device="cuda", reps: int = CHECK_REPS) -> float:
    """Every kernel instance against its twin at ``reps`` iterations
    (out at RTOL, ATOL; pm at PM_RTOL); raises on a mismatch, returns
    the largest absolute difference."""
    x = inputs(1).to(device)
    cases = [(f"{b} x{n}", lambda b=b, n=n: run(b, x, n, reps),
              lambda b=b, n=n: run_plain(b, x, n, reps))
             for b in BODIES for n in (1, 2)]
    cases.append(("leaf x2 shared", lambda: run("leaf", x, 2, reps, True),
                  lambda: run_plain("leaf", x, 2, reps)))
    xw = inputs(1, 256, 1).to(device)
    cases += [(f"width {w}", lambda w=w: run_width(xw, w, reps),
               lambda w=w: run_width_plain(xw, w, reps)) for w in (128, 256)]
    xn = inputs(1, NARROW).to(device)
    cases += [(f"narrow x{n}{' shared' * s}",
               lambda n=n, s=s: run_width(xn, NARROW, reps, n, s),
               lambda n=n: run_width_plain(xn, NARROW, reps, n))
              for n, s in ((1, False), (2, False), (2, True))]
    return max(_held(name, kernel(), twin()) for name, kernel, twin in cases)


def time_fn(fn, n: int = 5) -> float:
    """The probe's time_fn: best ms of n - 1 calls after a first one."""
    fn()
    return min(cuda_ms(fn) for _ in range(n - 1))


def verdict(single: float, dual: float, double: float) -> str:
    return ("LATENCY-bound: interleaving is the lever"
            if dual < 0.6 * double else
            "THROUGHPUT-bound: amortisation closed")


def four_ways(fn, reps: int, shared: bool = True) -> dict:
    """ms of single, dual, shared dual (if ``shared``) and double:
    ``fn(n_chains, reps, shared)`` launches one kernel."""
    ways = [("single", 1, reps, False), ("dual", 2, reps, False),
            ("shared", 2, reps, True), ("double", 1, 2 * reps, False)]
    return {k: time_fn(lambda n=n, r=r, s=s: fn(n, r, s))
            for k, n, r, s in ways if shared or k != "shared"}


def report(name: str, t: dict) -> str:
    """One line of ``four_ways``' times and the verdicts of both duals."""
    s = t["single"]
    line = (f"{name}: single {s:8.3f} ms   dual {t['dual']:8.3f} ms "
            f"({t['dual'] / s:.2f}x)")
    if "shared" in t:
        line += (f"   shared dual {t['shared']:8.3f} ms "
                 f"({t['shared'] / s:.2f}x)")
    line += (f"   double {t['double']:8.3f} ms ({t['double'] / s:.2f}x)\n"
             f"       -> {verdict(s, t['dual'], t['double'])}")
    if "shared" in t:
        line += (f"; shared: "
                 f"{verdict(s, t['shared'], t['double']).split(':')[0]}")
    return line


def timings(reps: int, width_reps: int, device="cuda") -> dict:
    """Every timing of the probe on the card: {"chain", "leaf", "narrow":
    the ``four_ways`` dict (chain without "shared"), "width": {128: ms,
    256: ms}}."""
    x = inputs(1).to(device)
    xw = inputs(1, 256, 1).to(device)
    xn = inputs(1, NARROW).to(device)
    return {"chain": four_ways(lambda n, r, s: run("chain", x, n, r), reps,
                               shared=False),
            "leaf": four_ways(lambda n, r, s: run("leaf", x, n, r, s), reps),
            "narrow": four_ways(
                lambda n, r, s: run_width(xn, NARROW, r, n, s), width_reps),
            "width": {w: time_fn(lambda w=w: run_width(xw, w, width_reps))
                      for w in (128, 256)}}


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("probe_interleave runs on the card: no CUDA device")
    check()
    if len(argv) > 1 and argv[1] == "width":
        reps = int(argv[2]) if len(argv) > 2 else 50000
        t = timings(2, reps)
        for w in (128, 256):
            print(f"width {w}: {t['width'][w]:8.2f} ms ({reps} reps)")
        print(report(f"narrow (width {NARROW})", t["narrow"]))
        return 0
    t = timings(int(argv[1]) if len(argv) > 1 else 2000, 2)
    print(report("chain", t["chain"]))
    print(report("leaf", t["leaf"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
