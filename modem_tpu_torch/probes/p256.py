"""Probe D: which primitive class of the decoder's serial loop costs what
per iteration, at P = 128 and P = 256 rows.

Counterpart of ``bench/probe_p256.py`` (its bodies nest in ``main``,
probe_p256.py:68-109): six bodies, each looped R times inside one launch
of csrc/probe_p256.cu over a [P, 512] f32 state (one thread block), and
each with a plain PyTorch twin (:func:`body`) that runs the same
iterations as separate tensor ops.  The probe prints microseconds per
iteration and the P = 256 / 128 ratio of each body.

Run: ``python3 -m modem_tpu_torch.probes.p256`` (on the card).  It first
holds the kernel to its twin at R = 4 (a failure raises), then times.
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
# kernel against twin at R = 4, relative: the eye-sum's [P, P] product
# and the selector's sum of the F minima are summed in another order;
# every other body is exact (min, exact adds, a one-hot product, and the
# madd rounded as two operations in both)
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
    return _common.library("probe_p256", ("i", "p", "p", "p", "i", "i", "p"))


def run_plain(name: str, x: torch.Tensor, reps: int) -> torch.Tensor:
    """The plain twin: ``reps`` iterations of :func:`body`."""
    for i in range(reps):
        x = body(name, x, i)
    return x


def run(name: str, x: torch.Tensor, reps: int) -> torch.Tensor:
    """The kernel: ``reps`` iterations of body ``name`` on a copy of x
    [P, 512] f32, one launch on the card (counted in
    ``run.launches[name]``); on a CPU tensor the plain twin."""
    P = x.shape[0]
    if x.shape != (P, COLS) or P not in PS:
        raise ValueError(f"state of shape {tuple(x.shape)}: want [128 or "
                         f"256, {COLS}]")
    if not _common.on_card(x, "probe_p256"):
        return run_plain(name, x, reps)
    lib = library()
    out = x.clone()
    work = torch.empty_like(x)
    scratch = torch.empty(P, P, dtype=torch.float32, device=x.device)
    rc = lib.probe_p256_launch(BODIES.index(name), out.data_ptr(),
                               work.data_ptr(), scratch.data_ptr(), P, reps,
                               torch.cuda.current_stream(x.device).cuda_stream)
    _common.check_rc(lib, "probe_p256", rc)
    run.launches[name] += 1
    return out


run.launches = collections.Counter()


def inputs(P: int, device) -> torch.Tensor:
    """The probe's input: normal(1, 1) of seed 0, [P, 512] f32."""
    return torch.from_numpy(np.random.default_rng(0).normal(
        1, 1, (P, COLS)).astype(np.float32)).to(device)


def bound(name: str, P: int, reps: int) -> dict:
    """The roofline bound of one launch: the state read once and written
    once, and the operations of ``reps`` iterations counted from the
    body (a multiply-add 2, a compare, select, min or add 1)."""
    e = P * COLS
    fh = P // 8
    per_iter = {"madd": 2 * e,
                "min_reduce": 2 * e,
                "transpose": e,
                "one_hot": P * P + 2 * P * P * COLS,
                "eye_sum": 2 * P ** 3 + 3 * P * P + e,
                "selector": 3 * fh * 2 * P + fh + e}[name]
    return roofline(2 * 4 * e, reps * per_iter)


def check(device="cuda", reps: int = CHECK_R) -> dict:
    """Each body's kernel against its twin at ``reps`` iterations, P =
    128 and 256, at :data:`RTOL`; raises on a mismatch.  Returns the
    largest absolute difference per body."""
    err = {}
    for name in BODIES:
        for P in PS:
            x = inputs(P, device)
            got = run(name, x, reps)
            want = run_plain(name, x, reps)
            if not torch.allclose(got, want, rtol=RTOL[name], atol=0.0):
                raise RuntimeError(
                    f"probe_p256 {name} at P={P}: kernel differs from its "
                    f"plain twin by {float((got - want).abs().max())}")
            err[name] = max(err.get(name, 0.0),
                            float((got - want).abs().max()))
    return err


def timings(device="cuda", reps: int = R) -> dict:
    """{(body, P): (kernel ms a launch of ``reps`` iterations, plain ms of
    the same iterations)}: a warm-up launch, then the best of two timed
    ones on scaled inputs (as the probe's best of 4); the twin once."""
    out = {}
    for name in BODIES:
        for P in PS:
            x = inputs(P, device)
            run(name, x, 2)
            best = min(cuda_ms(lambda: run(name, x * (1 + 0.003 * k), reps))
                       for k in range(2))
            plain = cuda_ms(lambda: run_plain(name, x, reps))
            out[name, P] = (best, plain)
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_p256 runs on the card: no CUDA device")
    check()
    print(f"kernel equals its plain twin at R={CHECK_R} on every body "
          "(tolerances in RTOL)")
    res = timings()
    for k, label in enumerate(LABELS):
        for P in PS:
            ms, plain = res[BODIES[k], P]
            print(f"{label:34s} P={P:3d}: {ms * 1e3 / R:8.2f} us/iter "
                  f"(plain twin {plain * 1e3 / R:8.2f} us/iter)")
    print("\nratios P=256 / P=128 (2.0 = linear in rows):")
    for name in BODIES:
        print(f"  {name:16s}: {res[name, 256][0] / res[name, 128][0]:5.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
