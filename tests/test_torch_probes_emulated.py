"""The probes' own CUDA sources (csrc/probe_p256.cu, csrc/probe_rank3.cu,
csrc/probe_interleave.cu) run on the CPU through a stand-in for the CUDA
runtime and thread-block clusters (tests/cuda_emu/cluster: a thread per
CUDA thread of every block of a cluster, barriers for the cluster barrier
and the warp collectives, each block's shared memory mapped into the
others'; a grid of independent blocks runs block by block), held to their
plain twins at every cluster size the card times:

- D: every body at P = 128 and 256, R = 4, at p256.RTOL; the one-hot
  body exactly at R = P + 3, so that the row it pushes comes from every
  block in turn and wraps to the first;
- E: each of the five kinds at R = 1, 4 and 43 (the roll wraps past the
  128 rows), on the probe's tile and on the tile of ties and signed
  zeros, at rank3's tolerance (counts and the roll exact); the frame
  rank as its grid of 16 blocks of one warp, a frame a block;
- F: every kernel (chain and leaf at one and two chains, the leaf's
  shared dual, width 128 and 256, narrow at one and two chains and
  shared) at 8 and 40 iterations, out and pm each at its tolerance;
- the C interfaces refuse a cluster size, a kind or an R they do not
  take.

This checks the kernels' logic (which block holds which rows, what is
pushed where, the buffers' parity, the launch's geometry and shared
memory attributes) at their real sizes; their speed and the hardware's
view of them are the card's (tests/test_torch_card.py).  Needs g++ with
C++20 (std::barrier); the three builds take ~5 s."""

import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from modem_tpu_torch.probes import interleave, p256, rank3

ROOT = pathlib.Path(__file__).resolve().parents[1]
EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu" / "cluster"
# name: (defines, whether its kernels take dynamic shared memory; E's
# arrays are static)
PROBES = {"probe_p256": (("-DPROBE_P256",), True),
          "probe_rank3": (("-DPROBE_RANK3",), False),
          "probe_interleave": ((), True)}


def emulated_source(name: str) -> str:
    """csrc/<name>.cu with its dynamic shared memory and inline PTX (the
    relaxed cluster barrier) replaced for the stand-in, and the harness
    appended.  Static __shared__ arrays stay: the stand-in makes them
    function-static, one copy for the one block that runs at a time."""
    src = (ROOT / "modem_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    shared = "extern __shared__ float smem[];"
    assert src.count(shared) == int(PROBES[name][1])
    src = src.replace(shared, "float* smem = emu_dynamic_smem<float>();")
    src = re.sub(r"asm volatile\(.*?\);", "cg::this_cluster().sync();", src,
                 flags=re.S)
    return src + (EMU / "probe_harness.cpp").read_text()


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated probes")
    out = tmp_path_factory.mktemp("probe_emu")
    for name, (defines, _) in PROBES.items():
        (out / f"{name}.cpp").write_text(emulated_source(name))
        proc = subprocess.run(
            [gxx, "-std=c++20", "-O1", "-pthread", "-w", *defines,
             f"-I{EMU}", "-o", str(out / name), str(out / f"{name}.cpp")],
            capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
    return out


def launch(emulator, name, x, n_out, *args):
    """The emulated launch function of probe ``name`` on x (f32) with its
    int arguments: (return code, the output's n_out floats)."""
    tag = "_".join(str(a) for a in args)
    src, dst = emulator / f"in_{name}_{tag}.bin", emulator / f"out_{tag}.bin"
    x.numpy().astype(np.float32).tofile(src)
    proc = subprocess.run([str(emulator / name), str(src), str(dst),
                           str(n_out), *map(str, args)], timeout=600)
    if proc.returncode:
        return proc.returncode, None
    return 0, torch.from_numpy(np.fromfile(dst, dtype=np.float32))


def run_d(emulator, body, x, reps, n):
    rc, y = launch(emulator, "probe_p256", x, x.numel(),
                   p256.BODIES.index(body), x.shape[0], n, reps)
    assert rc == 0, (body, x.shape[0], n, rc)
    return y.reshape(x.shape)


@pytest.mark.parametrize("body", p256.BODIES)
@pytest.mark.parametrize("P", p256.PS)
def test_emulated_p256_matches_twin(emulator, body, P):
    x = p256.inputs(P, "cpu")
    want = p256.run_plain(body, x, p256.CHECK_R)
    for n in p256.CLUSTERS[P]:
        got = run_d(emulator, body, x, p256.CHECK_R, n)
        assert torch.allclose(got, want, rtol=p256.RTOL[body], atol=0.0), n


@pytest.mark.parametrize("P", p256.PS)
def test_emulated_p256_one_hot_from_every_block(emulator, P):
    x = p256.inputs(P, "cpu")
    reps = P + 3
    want = p256.run_plain("one_hot", x, reps)
    for n in p256.CLUSTERS[P]:
        assert torch.equal(run_d(emulator, "one_hot", x, reps, n), want), n


def run_e(emulator, kind, x, reps):
    rc, y = launch(emulator, "probe_rank3", x, rank3.P * rank3.out_cols(kind),
                   rank3.KINDS.index(kind), reps)
    assert rc == 0, (kind, reps, rc)
    return y.reshape(rank3.P, rank3.out_cols(kind))


@pytest.mark.parametrize("kind", rank3.KINDS)
def test_emulated_rank3_matches_twin(emulator, kind):
    for tile in (rank3.inputs(), rank3.ties()):
        x = torch.from_numpy(tile)
        for reps in rank3.CHECK_REPS:
            rank3.held(kind, run_e(emulator, kind, x, reps),
                       rank3.plain(kind, x, reps), reps, "emulated kernel")


def test_emulated_rank3_refuses(emulator):
    """E's C interface refuses a kind off its table and R outside 1 ..
    rank3.MAX_REPS, and launches nothing."""
    x = torch.from_numpy(rank3.inputs())
    for kind, reps in ((5, 1), (-1, 1), (0, 0), (3, -2),
                       (4, rank3.MAX_REPS + 1)):
        assert launch(emulator, "probe_rank3", x, rank3.P * rank3.C, kind,
                      reps)[0], (kind, reps)


F_CASES = {  # name: (body, chains, width, shared, input, twin)
    **{f"{b} x{c}": (interleave.BODIES.index(b), c, 128, False, (1, 128, 2),
                     lambda x, r, b=b, c=c: interleave.run_plain(b, x, c, r))
       for b in interleave.BODIES for c in (1, 2)},
    "leaf x2 shared": (1, 2, 128, True, (1, 128, 2),
                       lambda x, r: interleave.run_plain("leaf", x, 2, r)),
    **{f"width {w}": (2, 1, w, False, (1, 256, 1),
                      lambda x, r, w=w: interleave.run_width_plain(x, w, r))
       for w in (128, 256)},
    **{f"narrow x{c}{' shared' * s}": (
        2, c, interleave.NARROW, s, (1, interleave.NARROW, 2),
        lambda x, r, c=c: interleave.run_width_plain(x, interleave.NARROW,
                                                     r, c))
       for c, s in ((1, False), (2, False), (2, True))},
}


@pytest.mark.parametrize("case", sorted(F_CASES))
def test_emulated_interleave_matches_twin(emulator, case):
    body, chains, width, shared, shape, twin = F_CASES[case]
    x = interleave.inputs(*shape)
    for reps in (interleave.CHECK_REPS, 40):
        want = twin(x, reps)
        for n in interleave.CLUSTERS:
            rc, out = launch(emulator, "probe_interleave", x, 2 * interleave.P,
                             body, chains, width, int(shared), x.shape[2],
                             reps, n)
            assert rc == 0, (case, n, rc)
            out = out.reshape(2, interleave.P)
            interleave._held(f"{case} at cluster {n}",
                             (out[0:1], out[1:2]), want)


def test_emulated_refuses_other_clusters(emulator):
    """A cluster size the kernels do not take returns an error and runs
    nothing: D beyond 64 rows a block or past 16 blocks, F off 1, 2, 4,
    8."""
    x = p256.inputs(128, "cpu")
    for n in (1, 3, 32):
        assert launch(emulator, "probe_p256", x, x.numel(), 0, 128, n, 1)[0]
    assert launch(emulator, "probe_p256", p256.inputs(256, "cpu"), 256 * 512,
                  0, 256, 2, 1)[0]
    xi = interleave.inputs(1)
    for n in (0, 3, 16):
        assert launch(emulator, "probe_interleave", xi, 256, 0, 1, 128, 0,
                      128, 1, n)[0]
