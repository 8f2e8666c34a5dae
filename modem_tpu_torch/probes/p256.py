"""Probe D: which primitive class of the decoder's serial loop costs what
per iteration, at P = 128 and P = 256 rows.

Counterpart of ``bench/probe_p256.py`` (its bodies nest in ``main``,
probe_p256.py:68-109): six bodies, each looped R times inside one launch
of csrc/probe_p256.cu over a [P, 512] f32 state held on chip across a
thread-block cluster of n blocks (:data:`CLUSTERS`), and each with a
plain PyTorch twin (:func:`body`) that runs the same iterations as
separate tensor ops.  The probe prints microseconds per iteration at
each cluster size and the P = 256 / 128 ratio of each body.

Run: ``python3 -m modem_tpu_torch.probes.p256`` (on the card).  It first
holds the kernel to its twin at R = 4 at every cluster size (a failure
raises), then times.
"""

from __future__ import annotations

import collections
import sys

import numpy as np
import torch

from ..card import cuda_ms, roofline
from . import _common

R = 20000
PS = (128, 256)
COLS = 512
BODIES = ("madd", "min_reduce", "transpose", "one_hot", "eye_sum",
          "selector")
LABELS = ("elementwise madd [P,512]", "min-reduce axis1 + bcast",
          "(P,1)->(1,P) transpose", "one-hot [P,P] matmul",
          "[P,P] matmul + eye diag-sum", "[F,2P] masked min (selector)")
# the cluster sizes (blocks, one an SM) the kernel runs at: the first
# is the smallest that holds the state in registers (256 KB of them an
# SM: 128 KB a block), the others double it up to 16, the largest
# cluster the card takes
CLUSTERS = {128: (2, 4, 8, 16), 256: (4, 8, 16)}
# kernel against twin at R = 4, relative: the eye-sum's diagonal and the
# selector's sum of the F minima are summed in another order; every
# other body is exact (min, exact adds, a row broadcast, and the madd
# rounded as two operations in both)
RTOL = {"madd": 0.0, "min_reduce": 0.0, "transpose": 0.0, "one_hot": 0.0,
        "eye_sum": 1e-4, "selector": 1e-6}
CHECK_R = 4


def body(name: str, v: torch.Tensor, i: int) -> torch.Tensor:
    """One iteration of body ``name`` on v [P, 512], as the probe's."""
    P = v.shape[0]
    dev = v.device
    if name == "madd":
        return v * 1.0001 + 0.001
    if name == "min_reduce":
        return v + v.min(dim=1, keepdim=True).values
    if name == "transpose":
        return v + v[:, 0:1].T[0, 0]
    if name == "one_hot":
        perm = torch.full((P, 1), i % P, device=dev)
        m = (torch.arange(P, device=dev)[None, :] == perm).float()
        return m @ v
    if name == "eye_sum":
        a = v[:, :P] @ v[:, :P]
        eye = torch.eye(P, device=dev)
        return v + (a * eye).sum(dim=1, keepdim=True)
    if name == "selector":
        fh = P // 8
        pos = torch.arange(2 * P, device=dev)[None, :]
        cand = torch.cat([v[:, 0:1].T, v[:, 1:2].T], dim=1)      # [1, 2P]
        rows = torch.arange(fh, device=dev)[:, None]
        cf = torch.where((pos % P) // 8 == rows, cand.expand(fh, 2 * P),
                         torch.tensor(3e38, device=dev))
        return v + cf.min(dim=1, keepdim=True).values.sum()
    raise ValueError(f"unknown body {name!r}")


def library():
    """csrc/probe_p256.cu, built at first use and loaded."""
    return _common.library("probe_p256", ("i", "p", "p", "i", "i", "i", "p"))


def run_plain(name: str, x: torch.Tensor, reps: int) -> torch.Tensor:
    """The plain twin: ``reps`` iterations of :func:`body`."""
    for i in range(reps):
        x = body(name, x, i)
    return x


def run(name: str, x: torch.Tensor, reps: int,
        cluster: int | None = None) -> torch.Tensor:
    """The kernel: ``reps`` iterations of body ``name`` on x [P, 512] f32
    (not written) into a new tensor, one launch on the card as a cluster
    of ``cluster`` blocks (one of ``CLUSTERS[P]``, default the smallest;
    counted in ``run.launches[name, P, cluster]``); on a CPU tensor the
    plain twin."""
    P = x.shape[0]
    if x.shape != (P, COLS) or P not in PS:
        raise ValueError(f"state of shape {tuple(x.shape)}: want [128 or "
                         f"256, {COLS}]")
    cluster = CLUSTERS[P][0] if cluster is None else cluster
    if cluster not in CLUSTERS[P]:
        raise ValueError(f"cluster of {cluster} blocks at P={P}: want one "
                         f"of {CLUSTERS[P]}")
    if not _common.on_card(x, "probe_p256"):
        return run_plain(name, x, reps)
    lib = library()
    out = torch.empty_like(x)
    rc = lib.probe_p256_launch(BODIES.index(name), x.data_ptr(),
                               out.data_ptr(), P, cluster, reps,
                               torch.cuda.current_stream(x.device).cuda_stream)
    _common.check_rc(lib, "probe_p256", rc)
    run.launches[name, P, cluster] += 1
    return out


run.launches = collections.Counter()


def inputs(P: int, device) -> torch.Tensor:
    """The probe's input: normal(1, 1) of seed 0, [P, 512] f32."""
    return torch.from_numpy(np.random.default_rng(0).normal(
        1, 1, (P, COLS)).astype(np.float32)).to(device)


def bound(name: str, P: int, reps: int) -> dict:
    """The roofline bound of one launch: the state read once and written
    once, and the operations that ``reps`` iterations of the body need
    (a multiply or an add 1, a compare or min 1): madd 2 an element,
    min-reduce the row's minimum and the add, transpose the add, one-hot
    none (a row copied to every row: bytes alone bound it), eye-sum the
    diagonal of the [P, P] product (2 P^2), the 3 P of its mask and sum
    and the add, selector the 2 P minima of the frames, their F sums and
    the add."""
    e = P * COLS
    fh = P // 8
    per_iter = {"madd": 2 * e,
                "min_reduce": 2 * e,
                "transpose": e,
                "one_hot": 0,
                "eye_sum": 2 * P * P + 3 * P + e,
                "selector": 2 * P + fh + e}[name]
    return roofline(2 * 4 * e, reps * per_iter)


def check(device="cuda", reps: int = CHECK_R, clusters=None) -> dict:
    """Each body's kernel against its twin at ``reps`` iterations at
    :data:`RTOL`, for each P and cluster size of ``clusters`` ({P:
    cluster sizes}, default :data:`CLUSTERS`: P = 128 and 256 at every
    size); raises on a mismatch.  Returns the largest absolute
    difference per body."""
    clusters = CLUSTERS if clusters is None else clusters
    err = {}
    for name in BODIES:
        for P, sizes in clusters.items():
            x = inputs(P, device)
            want = run_plain(name, x, reps)
            for n in sizes:
                got = run(name, x, reps, n)
                if not torch.allclose(got, want, rtol=RTOL[name], atol=0.0):
                    raise RuntimeError(
                        f"probe_p256 {name} at P={P}, cluster {n}: kernel "
                        f"differs from its plain twin by "
                        f"{float((got - want).abs().max())}")
                err[name] = max(err.get(name, 0.0),
                                float((got - want).abs().max()))
    return err


def timings(device="cuda", reps: int = R) -> tuple:
    """({(body, P, cluster): kernel ms a launch of ``reps`` iterations},
    {(body, P): (kernel ms, twin ms) of one call of PLAIN_REPS
    iterations, the kernel at P's smallest cluster}): at each cluster
    size a warm-up launch, then the best of two timed ones on scaled
    inputs (as the probe's best of 4); the pair by
    :func:`_common.pair_ms`."""
    kernel, pair = {}, {}
    for name in BODIES:
        for P in PS:
            x = inputs(P, device)
            for n in CLUSTERS[P]:
                run(name, x, 2, n)
                kernel[name, P, n] = min(
                    cuda_ms(lambda: run(name, x * (1 + 0.003 * k), reps, n))
                    for k in range(2))
            pair[name, P] = _common.pair_ms(
                lambda r: run(name, x, r, CLUSTERS[P][0]),
                lambda r: run_plain(name, x, r))
    return kernel, pair


def report(kernel: dict, pair: dict, reps: int = R) -> list:
    """Lines of µs an iteration a body, P and cluster size, the twin's
    and the kernel's beside it over PLAIN_REPS, and the P = 256 / 128
    ratio at each cluster size both run at."""
    lines = []
    for k, label in enumerate(LABELS):
        name = BODIES[k]
        for P in PS:
            us = ", ".join(f"{n}: {kernel[name, P, n] * 1e3 / reps:.3f}"
                           for n in CLUSTERS[P])
            k_ms, p_ms = pair[name, P]
            lines.append(f"{label:34s} P={P:3d}: us/iter by cluster size "
                         f"{{{us}}}; over {_common.PLAIN_REPS} iterations "
                         f"plain twin {p_ms:.3f} ms, kernel {k_ms:.4f} ms")
        ratios = ", ".join(
            f"{n}: {kernel[name, 256, n] / kernel[name, 128, n]:.2f}x"
            for n in CLUSTERS[256])
        lines.append(f"  ratio P=256 / P=128 by cluster size {{{ratios}}}; "
                     f"at each P's smallest "
                     f"{kernel[name, 256, 4] / kernel[name, 128, 2]:.2f}x")
    return lines


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_p256 runs on the card: no CUDA device")
    check()
    print(f"kernel equals its plain twin at R={CHECK_R} on every body and "
          "cluster size (tolerances in RTOL)")
    print("\n".join(report(*timings())))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
