"""The list kernels' own CUDA source (csrc/scl_decode.cu) run on the CPU
through a stand-in for the CUDA runtime (tests/cuda_emu: a thread per CUDA
thread, barriers for __syncthreads and the warp collectives), held to the
plain version: codewords in the same lane order, path metrics within rtol
1e-5, atol 1e-3; the rank and f32-beta instances and every shared depth
bit for bit equal to the default.  This checks the kernel's logic (tiers,
selections, the packed row stream, the lane maps) at toy sizes; its speed
and the hardware's view of it are the card's (tests/test_torch_card.py).

Needs g++ with C++20 (std::barrier); the build takes ~30 s."""

import os
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from modem_tpu_torch.fec.polar import PolarCode
from modem_tpu_torch.kernels.sc_decode import (ScPlan, pack_list_rows,
                                               tiers_of)
from modem_tpu_torch.kernels.scl_decode import (LIST_BUDGET, list_tiers,
                                                scl_decode_reference)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"
# the source's shared-memory accessors, replaced by plain copies
ACCESSORS = ("template <typename T>\n__device__ __forceinline__ T "
             "lds(uint32_t a);", "// A schedule row.")
EMULATED_ACCESSORS = """template <typename T>
inline T lds(uint32_t a) {
  T v;
  std::memcpy(&v, emu_base() + a, sizeof(T));
  return v;
}
inline void sts(uint32_t a, float v) { std::memcpy(emu_base() + a, &v, 4); }
inline void sts(uint32_t a, int8_t v) { std::memcpy(emu_base() + a, &v, 1); }
inline void copy16(uint32_t a, const void* g) {
  std::memcpy(emu_base() + a, g, 16);
}
inline void copy_wait() {}

"""
CODES = {"narrow": (56, 36, 6, 0.8), "toy": (224, 144, 8, 0.75)}


def emulated_source() -> str:
    """csrc/scl_decode.cu with its inline PTX and launch syntax replaced
    for the stand-in, and the harness appended."""
    src = (ROOT / "modem_tpu_torch" / "csrc" / "scl_decode.cu").read_text()
    start, end = (src.index(m) for m in ACCESSORS)
    src = src[:start] + EMULATED_ACCESSORS + src[end:]
    shared = "extern __shared__ __align__(16) unsigned char scl_tier[];"
    assert src.count(shared) == 1
    src = src.replace(shared, "#define scl_tier emu_smem")
    src = re.sub(r"<<<.*?>>>", "", src, flags=re.S)
    assert "asm" not in src
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_runtime.h"')
    return src + (EMU / "scl_harness.cpp").read_text()


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    out = tmp_path_factory.mktemp("scl_emu")
    (out / "scl_emu.cpp").write_text(emulated_source())
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-w", f"-I{EMU}", "-o",
         str(out / "scl_emu"), str(out / "scl_emu.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out


def noisy(n, k, order, sigma, frames=3, seed=9):
    code = PolarCode(n, k, order)
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2, code.mesg_bits, dtype=np.uint8)
    m[code.k:] = 0
    cw = code.encode_systematic(torch.from_numpy(m))
    tx = 1.0 - 2.0 * code.shorten(cw).double()
    noise = torch.from_numpy(rng.standard_normal((frames, code.n)))
    return code, code.lengthen(2.0 * (tx + sigma * noise) / sigma ** 2
                               ).float()


def run(emulator, sched, llrs, lsz, exact, rank=False, f32=False,
        depth=None):
    """The emulated kernel on llrs [B, n]: (codewords, path metrics)."""
    t = (list_tiers(sched, lsz, not f32) if depth is None
         else list_tiers(sched, lsz, not f32, depth))
    hdr = np.array([lsz, exact, rank, f32, sched.n_ops, sched.code_len,
                    sched.d0_len, t.llr_lo, t.beta_lo, t.s_llr_len,
                    t.s_beta_len, sched.out_off, sched.n_depths,
                    len(llrs)], dtype=np.int32)
    tag = f"{os.getpid()}_{lsz}_{exact}_{rank}_{f32}_{depth}"
    src, dst = emulator / f"in_{tag}.bin", emulator / f"out_{tag}.bin"
    src.write_bytes(hdr.tobytes() + pack_list_rows(sched.ops).tobytes()
                    + llrs.numpy().astype(np.float32).tobytes())
    subprocess.run([str(emulator / "scl_emu"), str(src), str(dst)],
                   check=True, timeout=600)
    raw = dst.read_bytes()
    b, n = llrs.shape
    cw = np.frombuffer(raw[:b * lsz * n], dtype=np.uint8)
    pm = np.frombuffer(raw[b * lsz * n:], dtype=np.float32)
    return (torch.from_numpy(cw.reshape(b, lsz, n).copy()),
            torch.from_numpy(pm.reshape(b, lsz).copy()))


CASES = ([("narrow", lsz, exact, True) for lsz in (2, 4, 8)
          for exact in (True, False)]
         + [("narrow", 8, True, False), ("toy", 8, True, True),
            ("toy", 8, False, True), ("toy", 4, True, False)])


@pytest.mark.parametrize("name,lsz,exact,emit_spc", CASES, ids=str)
def test_emulated_kernel_matches_plain(emulator, name, lsz, exact,
                                       emit_spc):
    """B (exact) or C on the SPC-leaf schedule, and B on the decomposed one
    (leaves down to width 1, BIG columns, inf sums): codewords in the
    plain version's lane order, path metrics within rtol 1e-5, atol
    1e-3."""
    code, llrs = noisy(*CODES[name])
    sched = ScPlan.from_frozen(code.frozen, emit_spc=emit_spc).sched
    cw, pm = run(emulator, sched, llrs, lsz, exact)
    cw_r, pm_r = scl_decode_reference(llrs, sched, lsz, exact)
    assert torch.equal(cw, cw_r)
    assert torch.allclose(pm, pm_r, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("exact", [True, False])
def test_emulated_instances_and_depths_equal_default(emulator, exact):
    """At L = 8 on the narrow code: the rank and f32-beta instances, and
    the shared tier from every depth that fits a block, bit for bit the
    default's result."""
    code, llrs = noisy(*CODES["narrow"])
    sched = ScPlan.from_frozen(code.frozen).sched
    want = run(emulator, sched, llrs, 8, exact)
    variants = [dict(f32=True)] + ([dict(rank=True),
                                    dict(rank=True, f32=True)]
                                   if exact else [])
    variants += [dict(depth=d) for d in range(1, sched.n_depths + 1)
                 if tiers_of(sched, True, d, lanes=8, limit=1 << 40)
                 .shared_bytes <= LIST_BUDGET]
    for kw in variants:
        got = run(emulator, sched, llrs, 8, exact, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(
            got[1], want[1]), kw


@pytest.mark.parametrize("spc", [False, True])
def test_emulated_wide_leaf_of_infinite_llrs(emulator, spc):
    """A RATE1 (or SPC) leaf as wide as the block, 512 columns, whose LLRs
    are infinite but for fewer than the 7-8 the exact search takes (none
    on the first frame): with no BIG column left past the width the
    search takes the inf columns, as the plain version does.  B and C
    give the plain version's codewords and path metrics."""
    frozen = np.zeros(512, dtype=bool)
    frozen[0] = spc
    sched = ScPlan.from_frozen(frozen).sched
    assert sched.n_ops == 1 and sched.ops[0][0] == (6 if spc else 5)
    rng = np.random.default_rng(3)
    llrs = torch.from_numpy(
        rng.choice(np.float32([-np.inf, np.inf]), (4, 512)))
    for b in range(1, 4):
        llrs[b, rng.choice(512, 2 * b - 1, replace=False)] = torch.from_numpy(
            rng.standard_normal(2 * b - 1).astype(np.float32))
    for exact in (True, False):
        cw, pm = run(emulator, sched, llrs, 8, exact)
        cw_r, pm_r = scl_decode_reference(llrs, sched, 8, exact)
        assert torch.equal(cw, cw_r), exact
        assert torch.allclose(pm, pm_r, rtol=1e-5, atol=1e-3), (exact, pm,
                                                                pm_r)
