"""The OSD elimination kernel's own CUDA source (csrc/osd_eliminate.cu) run
on the CPU through the stand-in for the CUDA runtime (tests/cuda_emu: a
thread per CUDA thread, barriers for the warp collectives), held byte for
byte to its plain version ``osd_eliminate_reference``: the reduced
matrices and the pivots.  Inputs, the card tests' (``osd_case`` of
tests/test_torch_card.py): the BCH(255,71) generator in the reliability
orders of tests/test_osd.py's blocks and of an all-erased one, and random
0/1 matrices, full rank and rank-deficient (zero and repeated columns,
dependent rows, rank 3, all zero), in random column orders.  This checks
the kernel's logic (the pivot search, the swap, the word ranges, the
early stop, the staging); its speed is the card's
(tests/test_torch_card.py).

Needs g++ with C++20 (std::barrier); the build takes a few seconds."""

import os
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from modem_tpu_torch.kernels.osd_eliminate import osd_eliminate_reference
from test_torch_card import OSD_KINDS, assert_osd_rank, osd_case

ROOT = pathlib.Path(__file__).resolve().parents[1]
EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"
K, N = 71, 255


def emulated_source() -> str:
    """csrc/osd_eliminate.cu with its launch syntax replaced for the
    stand-in, and the harness appended."""
    src = (ROOT / "modem_tpu_torch" / "csrc" / "osd_eliminate.cu").read_text()
    src = re.sub(r"<<<.*?>>>", "", src, flags=re.S)
    assert "asm" not in src
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_runtime.h"')
    return src + (EMU / "osd_harness.cpp").read_text()


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    out = tmp_path_factory.mktemp("osd_emu")
    (out / "osd_emu.cpp").write_text(emulated_source())
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-I{EMU}", "-o",
         str(out / "osd_emu"), str(out / "osd_emu.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out


def run(emulator, g: np.ndarray, perm: np.ndarray, tag: str):
    """The emulated kernel: (reduced [B, 71, 255] uint8, pivots [B, 71])."""
    batch = len(perm)
    src = emulator / f"in_{os.getpid()}_{tag}.bin"
    dst = emulator / f"out_{os.getpid()}_{tag}.bin"
    src.write_bytes(np.int32(batch).tobytes()
                    + np.ascontiguousarray(g, np.uint8).tobytes()
                    + np.ascontiguousarray(perm, np.int64).tobytes())
    subprocess.run([str(emulator / "osd_emu"), str(src), str(dst)],
                   check=True, timeout=600)
    raw = dst.read_bytes()
    red = np.frombuffer(raw[:batch * K * N], np.uint8).reshape(batch, K, N)
    piv = np.frombuffer(raw[batch * K * N:], np.int64).reshape(batch, K)
    return red, piv


@pytest.mark.parametrize("kind", OSD_KINDS)
def test_emulated_elimination_matches_plain(emulator, kind):
    """At 13 headers, tests/test_osd.py's blocks for the BCH generator,
    and at 3 for the others."""
    g, perm = osd_case(kind, 13 if kind == "bch" else 3, seed=2101)
    red, piv = run(emulator, g, perm, kind)
    want_red, want_piv = osd_eliminate_reference(
        torch.from_numpy(g)[:, torch.from_numpy(perm)].permute(1, 0, 2))
    assert np.array_equal(red, want_red.numpy())
    assert np.array_equal(piv, want_piv.numpy())
    assert_osd_rank(red, kind)
