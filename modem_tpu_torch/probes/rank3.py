"""Probe E: the primitives of the rank-count fork selection on a [128, 16]
f32 tile.

Counterpart of ``bench/probe_rank3.py`` (its kernels nest in ``main``,
probe_rank3.py:52-136): five computations, each a kernel of
csrc/probe_rank3.cu, a plain PyTorch twin (:func:`plain`) and the probe's
own numpy expectation (:func:`expected`), with the probe's tolerance:
exact, or ``atol`` 1e-5 for the slot extract (multi-element sums in
another order).  The sublane roll by P - 3 is a row rotation on the card;
the roll-aligned frame rank is the rank count of the list decoder's
``rank_select`` path (:func:`kernels.scl_decode.rank_count`, which the
twin calls).

Run: ``python3 -m modem_tpu_torch.probes.rank3`` (on the card): one line
per computation, kernel and twin each held to numpy (a failure raises),
with the kernel's and the twin's time.
"""

from __future__ import annotations

import collections
import sys

import numpy as np
import torch

from ..card import cuda_ms, roofline
from ..kernels.scl_decode import rank_count
from . import _common

P, C, L = 128, 16, 8
KINDS = ("rank3_allpairs", "rank3_computed_mask", "rank2_slot_extract",
         "sublane_roll", "frame_rank_rolled")
ATOL = {"rank2_slot_extract": 1e-5}      # others exact


def inputs() -> np.ndarray:
    """The probe's tile: standard normal of seed 0, [128, 16] f32."""
    return np.random.default_rng(0).standard_normal((P, C)).astype(
        np.float32)


def expected(kind: str, x: np.ndarray) -> np.ndarray:
    """The probe's numpy expectation (probe_rank3.py:59-135)."""
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
    if kind == "sublane_roll":
        return np.roll(x, -3, axis=0)
    if kind == "frame_rank_rolled":
        out = np.zeros((P, C), np.float32)
        for f in range(P // L):
            blk = x[f * L:(f + 1) * L].ravel()
            rk = (blk[None, :] < blk[:, None]).sum(axis=1)
            out[f * L:(f + 1) * L] = rk.reshape(L, C)
        return out
    raise ValueError(f"unknown computation {kind!r}")


def plain(kind: str, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch twin of computation ``kind`` on x [128, 16]."""
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
        return torch.stack([torch.where(r == k, x, 0.0).sum(dim=1)
                            for k in range(8)], dim=1)
    if kind == "sublane_roll":
        return torch.roll(x, P - 3, dims=0)     # pltpu.roll(x, P - 3, 0)
    if kind == "frame_rank_rolled":
        frames = x.reshape(P // L, L * C)
        idx = torch.arange(L * C, device=dev).expand_as(frames)
        return rank_count(frames, idx).reshape(P, C).float()
    raise ValueError(f"unknown computation {kind!r}")


def library():
    """csrc/probe_rank3.cu, built at first use and loaded."""
    return _common.library("probe_rank3", ("i", "p", "p", "p"))


def run(kind: str, x: torch.Tensor) -> torch.Tensor:
    """The kernel of computation ``kind`` on x [128, 16] f32 on the card
    (counted in ``run.launches[kind]``); on a CPU tensor the plain
    twin."""
    if x.shape != (P, C):
        raise ValueError(f"tile of shape {tuple(x.shape)}: want [{P}, {C}]")
    if not _common.on_card(x, "probe_rank3"):
        return plain(kind, x)
    lib = library()
    out = torch.empty(P, 8 if kind == "rank2_slot_extract" else C,
                      dtype=torch.float32, device=x.device)
    rc = lib.probe_rank3_launch(KINDS.index(kind), x.data_ptr(),
                                out.data_ptr(),
                                torch.cuda.current_stream(x.device).cuda_stream)
    _common.check_rc(lib, "probe_rank3", rc)
    run.launches[kind] += 1
    return out


run.launches = collections.Counter()


def bound(kind: str) -> dict:
    """The roofline bound of one launch: the tile read once and the
    output written once; operations counted from the computation (a
    compare, select or add 1)."""
    out_cols = 8 if kind == "rank2_slot_extract" else C
    ops = {"rank3_allpairs": 2 * P * C * C,
           "rank3_computed_mask": 4 * P * C * C,
           "rank2_slot_extract": P * C * 2 + 8 * P * C * 3,
           "sublane_roll": 0,
           "frame_rank_rolled": 4 * P * C * L * C}[kind]
    return roofline(4 * P * C + 4 * P * out_cols, ops)


def check_one(kind: str, got: torch.Tensor, x: np.ndarray) -> float:
    """Hold an output to the probe's expectation; returns the largest
    absolute difference, raises past the probe's tolerance."""
    want = expected(kind, x)
    got = got.cpu().numpy()
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or not np.allclose(
            got, want, atol=ATOL.get(kind, 0.0), rtol=0):
        raise RuntimeError(f"probe_rank3 {kind}: max difference {err} from "
                           "numpy")
    return err


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_rank3 runs on the card: no CUDA device")
    x = inputs()
    xt = torch.from_numpy(x).cuda()
    for kind in KINDS:
        err_k = check_one(kind, run(kind, xt), x)
        err_p = check_one(kind, plain(kind, xt), x)
        ms = cuda_ms(lambda: run(kind, xt), 100)
        plain_ms = cuda_ms(lambda: plain(kind, xt), 100)
        print(f"{kind}: PASS (kernel max diff {err_k}, twin {err_p}; "
              f"kernel {ms * 1e3:.2f} us, twin {plain_ms * 1e3:.2f} us)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
