"""One schedule expanded into a CUDA kernel of its own: the counterpart of
``make_pallas_decoder(..., unroll=True)`` (scl_pallas.py:96-103, :815).

:func:`generate` writes a CUDA source that embeds the interpreted
kernel's own text (csrc/sc_decode.cu for L = 1, csrc/scl_decode.cu for
L = 2, 4, 8, with the macro that leaves their interpreter out) and then
one kernel whose body is the schedule as straight-line calls of that
text's row body (``unrolled_row`` for A, ``run_row`` for the list
kernels), one ``ROW(...)`` line
per row with the row's 14 columns as literals: opcode, depth, width and
offsets are compile-time constants, so the compiler folds the opcode
dispatch and the tier tests away and reads no table (each kernel with
its interpreter's default tiers of shared memory).  Only the default
instances are unrolled (no rank selection, int8 partial sums).
:func:`library` builds it with nvcc at first use into
``build/modem_tpu_torch/``, keyed by a hash of the generated text and
the flags; :func:`parse_rows` reads the table back out of a generated
source.

The program grows with the schedule (10,252 rows at wire size, each an
inlined row body), and nvcc's time and memory grow faster than the rows:
the list kernels take minutes at 900 rows, and the wire-size builds do
not end in 96 GiB of host memory.  ``PERF.md`` holds the measured
ladder.

Run the ladder on the card: ``python3 -m modem_tpu_torch.kernels.unroll
[sizes...]`` (sizes of ``CODES``, default 1024 4096): for each code, A,
B and C unrolled, every build started at once (one nvcc each), then each
held bit for bit to the interpreter and both timed.  ``--build-only`` builds and
reports each build's seconds as it ends.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import re
import sys
import time

import numpy as np

from ..fec.schedule import Schedule
from . import _build

ROW_RE = re.compile(r"^\s*ROW\(([-0-9, ]+)\);$", re.M)

_HEAD = """// Generated by modem_tpu_torch/kernels/unroll.py: {what}, code length
// {code_len}, {n_ops} schedule rows unrolled.  Do not edit.
#define {guard}
"""

_SC_KERNEL = """
namespace {{

constexpr int kDynSmem = {smem};   // the shared tier's bytes
constexpr int kBlockThreads = kThreads;

__global__ void __launch_bounds__(kThreads, 4)
unrolled_kernel(const float* __restrict__ llr_in, float* llr_scratch,
                int8_t* beta_scratch, uint8_t* __restrict__ cw_out,
                float* __restrict__ pm_out) {{
  __shared__ Shared s;
  // the default int8 tiers (kernels/sc_decode.py tiers_of): shared from
  // depth {depth}
  const Geom g{{{code_len}, {d0_len}, {llr_lo}, {beta_lo}, {s_llr_len},
               {s_beta_len}, {out_off}}};
  Frame<int8_t> f = frame_begin<int8_t>(g, llr_in, llr_scratch,
                                        beta_scratch);
#define ROW(...) unrolled_row<int8_t>(f, s, LitRow{{{{__VA_ARGS__}}}})
{rows}
#undef ROW
  frame_end<int8_t>(f, g, cw_out, pm_out);
}}

}}  // namespace
"""

_SCL_KERNEL = """
namespace {{

constexpr int kDynSmem = {smem};   // every lane's shared tier
constexpr int kBlockThreads = kThreads;

__global__ void __launch_bounds__(kThreads, 1)
unrolled_kernel(const float* __restrict__ llr_in, float* llr_scratch,
                int8_t* beta_scratch, uint8_t* __restrict__ cw_out,
                float* __restrict__ pm_out) {{
  __shared__ Shared<{L}> s;
  // the default int8 tiers (kernels/scl_decode.py list_tiers): shared
  // from depth {depth}
  const Geom g{{{code_len}, {d0_len}, {llr_lo}, {beta_lo}, {s_llr_len},
               {s_beta_len}, {out_off}, {n_depths}}};
  Frame<{L}, int8_t> f = frame_begin<{L}, int8_t>(s, g, llr_in, llr_scratch,
                                                beta_scratch);
#define ROW(...) \\
  run_row<{L}, {exact}, false, int8_t>(f, s, LitRow{{{{__VA_ARGS__}}}})
{rows}
#undef ROW
  frame_end<{L}, int8_t>(f, s, g, cw_out, pm_out);
}}

}}  // namespace
"""

_ENTRY = """
// Plain C interface, loaded with ctypes: device pointers, a cudaStream_t;
// one block per frame on `stream`, no synchronise; returns
// cudaGetLastError() as an int.
extern "C" int unrolled_launch(const void* llrs, void* llr_scratch,
                               void* beta_scratch, void* cw, void* pm,
                               int batch, void* stream) {
  if (batch > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        unrolled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDynSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    unrolled_kernel<<<batch, kBlockThreads, kDynSmem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(llrs), static_cast<float*>(llr_scratch),
        static_cast<int8_t*>(beta_scratch), static_cast<uint8_t*>(cw),
        static_cast<float*>(pm));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* unrolled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def generate(sched: Schedule, list_size: int = 1, exact: bool = True) -> str:
    """The CUDA source of ``sched`` unrolled: kernel A's row body at
    ``list_size=1``, else kernel B's (``exact``) or C's at L =
    ``list_size``."""
    rows = "\n".join("  ROW(" + ", ".join(str(int(v)) for v in r) + ");"
                     for r in np.asarray(sched.ops))
    geom = dict(code_len=sched.code_len, d0_len=sched.d0_len,
                out_off=sched.out_off, n_depths=sched.n_depths,
                n_ops=sched.n_ops, rows=rows)
    if list_size == 1:
        from .sc_decode import tiers_of
        name, guard = "sc_decode", "SC_DECODE_UNROLLED"
        what = "kernel A (plain SC)"
        tiers = tiers_of(sched)
        body = _SC_KERNEL.format(
            depth=tiers.depth, llr_lo=tiers.llr_lo, beta_lo=tiers.beta_lo,
            s_llr_len=tiers.s_llr_len, s_beta_len=tiers.s_beta_len,
            smem=tiers.shared_bytes, **geom)
    else:
        name, guard = "scl_decode", "SCL_DECODE_UNROLLED"
        what = f"kernel {'B' if exact else 'C'}, L = {list_size}"
        from .scl_decode import list_tiers
        tiers = list_tiers(sched, list_size)
        body = _SCL_KERNEL.format(
            L=list_size, exact="true" if exact else "false",
            depth=tiers.depth, llr_lo=tiers.llr_lo, beta_lo=tiers.beta_lo,
            s_llr_len=tiers.s_llr_len, s_beta_len=tiers.s_beta_len,
            smem=tiers.shared_bytes, **geom)
    text = (_build.CSRC / f"{name}.cu").read_text()
    return (_HEAD.format(what=what, code_len=sched.code_len,
                         n_ops=sched.n_ops, guard=guard)
            + f"// ---- csrc/{name}.cu, verbatim ----\n" + text
            + "\n// ---- the schedule, unrolled ----" + body + _ENTRY)


def parse_rows(text: str) -> np.ndarray:
    """The instruction table [n_ops, 14] int32 of a generated source."""
    return np.array([[int(v) for v in m.split(",")]
                     for m in ROW_RE.findall(text)], dtype=np.int32)


_LIBS: dict = {}


def library(sched: Schedule, list_size: int, exact: bool) -> ctypes.CDLL:
    """The built library of ``generate(sched, list_size, exact)`` (built
    at first use, then cached in this process and on disk)."""
    key = (sched.ops.tobytes(), sched.code_len, list_size, bool(exact))
    if key not in _LIBS:
        text = generate(sched, list_size, exact)
        lib = _build.load_generated("unrolled", text)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.unrolled_launch.argtypes = [p, p, p, p, p, i, p]
        lib.unrolled_launch.restype = ctypes.c_int
        lib.unrolled_error_string.argtypes = [ctypes.c_int]
        lib.unrolled_error_string.restype = ctypes.c_char_p
        _LIBS[key] = lib
    return _LIBS[key]


def library_path(sched: Schedule, list_size: int, exact: bool):
    """Where :func:`library` puts (or finds) that library."""
    return _build.generated_path("unrolled",
                                 generate(sched, list_size, exact))


# the longest schedule unrolled and built on the card (n = 4096: B's
# build took 578.7 s); the wire-size schedule (10,252 rows) ran out of
# the card host's 96 GiB (PERF.md)
MAX_ROWS = 900


def check_rows(sched: Schedule) -> None:
    """Raise ValueError for a schedule longer than :data:`MAX_ROWS`: no
    unrolled build of one has been seen to end."""
    if sched.n_ops > MAX_ROWS:
        raise ValueError(
            f"no unrolled kernel for a schedule of {sched.n_ops} rows: the "
            f"longest built is {MAX_ROWS} rows, and the wire-size build ran "
            "out of host memory (PERF.md)")


# the codes of bench/probe_unroll.py:26-30, by padded length
CODES = {1024: (960, 480, 10), 4096: (4032, 2304, 12),
         65536: (64800, 43072, 16)}
# kernel: (list size, exact, batch timed): A at its serving batch, B and
# C at the serving fallback batch
KERNELS = {"A": (1, True, 512), "B": (8, True, 16), "C": (8, False, 16)}


def build_all(jobs, report=None) -> dict:
    """Build the unrolled library of each (schedule, kernel) of ``jobs``,
    one nvcc each, all at once; returns the seconds each took by its
    index in ``jobs`` (a failed build raises).  ``report(index,
    seconds)`` is called as each ends."""
    def one(sched, name):
        lsz, exact, _ = KERNELS[name]
        t0 = time.perf_counter()
        library(sched, lsz, exact)
        return time.perf_counter() - t0
    jobs = list(jobs)
    secs = {}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futs = {pool.submit(one, *job): i for i, job in enumerate(jobs)}
        for f in concurrent.futures.as_completed(futs):
            secs[futs[f]] = f.result()
            if report is not None:
                report(futs[f], secs[futs[f]])
    return secs


def rungs_of(sizes=(1024, 4096), kernels=tuple(KERNELS)) -> list:
    """Every (code size, kernel) pair of ``sizes`` x ``kernels``."""
    return [(size, name) for size in sizes for name in kernels]


def ladder(rungs=None, device="cuda", reps: int = 5) -> list:
    """The unroll ladder on the card.  ``rungs``: (code size of
    :data:`CODES`, kernel of :data:`KERNELS`) pairs, by default A, B and
    C at 1024 and 4096; every rung's build starts at once (one nvcc
    each).  Then each unrolled kernel against the interpreter on the same
    LLRs (normal(2, 1), seed 0, as bench/probe_unroll.py): bit-identical
    codewords and path metrics, or RuntimeError; then ms a batch of each
    (CUDA events, mean of ``reps``, in turns).  Returns one dict a
    rung."""
    import torch

    from ..card import cuda_ms
    from ..fec.polar import PolarCode
    from .sc_decode import ScPlan, sc_decode
    from .scl_decode import scl_decode

    rungs = list(rungs or rungs_of())
    plans = {size: ScPlan.from_frozen(PolarCode(*CODES[size]).frozen)
             for size, _ in rungs}
    build_s = build_all([(plans[size].sched, name) for size, name in rungs])
    rows = []
    for i, (size, name) in enumerate(rungs):
        plan = plans[size]
        lsz, exact, batch = KERNELS[name]
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(2.0, 1.0, (
            batch, plan.sched.code_len)).astype(np.float32)).to(device)

        def decode(unroll, x=x, lsz=lsz, exact=exact, plan=plan):
            if lsz == 1:
                return sc_decode(x, plan, unroll=unroll)
            return scl_decode(x, plan, lsz, exact, unroll=unroll)

        got, want = decode(True), decode(False)
        same = bool(torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1]))
        if not same:
            raise RuntimeError(f"unrolled {name} at n={size} differs "
                               "from the interpreter")
        ms = {}
        for unroll in (False, True, True, False):
            ms.setdefault(unroll, []).append(
                cuda_ms(lambda: decode(unroll), reps))
        rows.append({"size": size, "kernel": name, "rows": plan.sched.n_ops,
                     "batch": batch, "build_s": build_s[i],
                     "ms_unrolled": float(np.mean(ms[True])),
                     "ms_interpreter": float(np.mean(ms[False])),
                     "identical": same})
    return rows


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    args = [a for a in argv[1:] if a != "--build-only"]
    sizes = [int(a) for a in args] or [1024, 4096]
    if "--build-only" in argv:
        # only the builds, each reported as it ends (for codes whose build
        # may not end in the time at hand)
        from ..fec.polar import PolarCode
        from .sc_decode import ScPlan
        rungs = rungs_of(sizes)
        scheds = {size: ScPlan.from_frozen(PolarCode(*CODES[size]).frozen)
                  .sched for size in sizes}
        print(", ".join(f"n={size}: {scheds[size].n_ops} rows"
                        for size in sizes)
              + "; building A, B and C of each at once", flush=True)
        build_all([(scheds[size], name) for size, name in rungs],
                  report=lambda i, sec: print(
                      f"n={rungs[i][0]} {rungs[i][1]}: built in {sec:.1f} s",
                      flush=True))
        return 0
    for row in ladder(rungs_of(sizes)):
        print(f"n={row['size']} {row['kernel']} ({row['rows']} rows, batch "
              f"{row['batch']}): build {row['build_s']:.1f} s, unrolled "
              f"{row['ms_unrolled']:.3f} ms vs interpreter "
              f"{row['ms_interpreter']:.3f} ms a batch, bit-identical "
              f"{row['identical']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
