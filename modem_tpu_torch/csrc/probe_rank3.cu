// Probe E: the primitives of the rank-count fork selection, on a [128, 16]
// f32 tile, each timed per iteration inside one launch.  Replaces the TPU
// capability probe bench/probe_rank3.py (run -> pl.pallas_call,
// probe_rank3.py:33; its kernels :52-136), which checks that Mosaic
// compiles them and gets numpy's values.
//
// The five computations (kKind), one template instance each; at R = 1
// each is the probe's:
//   0 all-pairs rank   out[p][q] = #{q' : x[p][q'] < x[p][q]}
//   1 tie count        out[p][q] = #{q' > q : x[p][q'] == x[p][q]} (the
//                      computed upper-triangle mask of the tie-break)
//   2 slot extract     r = floor(3 x); out[p][k] = sum of x[p][q] over
//                      r[p][q] == k, k < 8, in column order
//   3 row roll         out[p] = x[(p + 3) mod 128]: the sublane roll by
//                      P - 3
//   4 frame rank       frames of 8 rows; out[p][q] = the number of the
//                      frame's 128 candidates before x[p][q] in (value,
//                      in-frame flat index) order, before() below: the
//                      rank count of the list decoder's rank selection
//                      (csrc/scl_decode.cu, kRank), on distinct values the
//                      probe's strict-less count
// R iterations run in one launch, each on the previous one's data, so that
// nvcc can neither hoist an iteration nor drop one (the loop is never
// unrolled): the roll feeds itself (after R, out = x rolled by -3R rows);
// every other computation adds its result into the output and then
// rotates each row of its tile by one column (x[p][q] <- x[p][q + 1 mod
// 16]), a permutation, so values stay distinct and counts exact.  Counts
// are integers, written as f32 at the end: exact while under 2^24, which
// the frame rank (at most 127 an iteration) keeps to R <= 132,104
// (kMaxReps).  The slot extract adds each iteration's sums into its
// output in iteration order, as the plain twin does.
//
// Layouts, and what bounds each: issue and latency, not bytes (16 KB in
// and out a launch) nor the f32 rate.
//   0, 1, 2  one block of 128 threads, thread p holding row p in 16
//            registers: one warp a scheduler.  All-pairs: 240 compares
//            and adds an iteration; tie count: the 120 pairs q' > q.
//            Slot extract: each element added to its one slot, the 8
//            slot sums in registers: a register cannot be indexed at run
//            time without a stack frame, so each slot's add is predicated
//            on the element's slot (an integer compare and a predicated
//            add a slot, one of the 8 taken).  A slot array in shared
//            memory, indexed by the slot, ran 2.3x slower: its 16 read-
//            modify-writes form one dependent chain, since an element may
//            hit the slot the one before hit.
//   3        the roll: row p in thread p; a warp's rows pass down by
//            __shfl_down_sync(..., 3); only the 3 rows a warp that cross
//            into the warp below go through shared memory, double-buffered
//            by iteration, so that an iteration pays one __syncthreads.
//   4        one frame a block, as the list decoder runs one frame a
//            block: a grid of P / 8 = 16 blocks of one warp, each on its
//            own SM with a scheduler to itself.  Lane l holds candidates
//            4l..4l+3 (row l / 4, columns 4 (l mod 4) + j).  A bitonic
//            sort of the frame's 128 (value, in-frame index) keys in
//            registers, comparator before(): 7 stages, 28 dependent
//            compare-exchange steps, 15 across lanes by __shfl_xor_sync and
//            13 within a lane; each key's final position is its rank,
//            written back to its index through shared memory (double-
//            buffered by iteration, one __syncwarp).  The 28-step shuffle
//            chain is its latency: O(n log^2 n) compares, where counting
//            every pair takes n^2.
// Thread and register budgets: 128 threads (rows) or 32 (a frame), one
// block an SM.  A row kernel keeps 16 values and 16 counts (8 slot sums
// and 8 totals) in registers; the frame kernel 4 values, 4 counts and 4
// (value, index) keys: every index a constant once the loops unroll, so
// no stack frame and no spill (chip_smoke.py checks ptxas's report).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 128, kC = 16, kFrame = 8, kSlots = 8;
constexpr int kFrames = kP / kFrame;         // 16
constexpr int kCand = kFrame * kC;           // 128 candidates a frame
constexpr int kMaxReps = (1 << 24) / (kCand - 1);
constexpr int kWarps = kP / 32;              // the row kernels: 4 warps
constexpr int kFrameRank = 4;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int blocks_of(int kind) {
  return kind == kFrameRank ? kFrames : 1;
}
__host__ __device__ constexpr int threads_of(int kind) {
  return kind == kFrameRank ? 32 : kP;
}

// The selection order: smaller value first, lower index on ties (float
// equality: -0.0 == +0.0).
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

// n floats from and to device memory, 16-byte aligned, in n / 4 vector
// accesses: a warp's rows lie 64 bytes apart, so a scalar access would
// touch 16 lines a warp for 4 bytes a lane.
template <int kN>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float (&x)[kN]) {
  const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < kN / 4; ++i) {
    const float4 v = s[i];
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}
template <int kN>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&x)[kN]) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < kN / 4; ++i) {
    d[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  }
}

// x[q] <- x[q + 1 mod 16]
__device__ __forceinline__ void rotate(float (&x)[kC]) {
  const float t = x[0];
#pragma unroll
  for (int q = 0; q + 1 < kC; ++q) x[q] = x[q + 1];
  x[kC - 1] = t;
}

// Kinds 0 and 1: thread p counts over row p's pairs.
template <int kKind>
__device__ __forceinline__ void count_rows(const float* __restrict__ x_in,
                                           float* __restrict__ out, int R) {
  const int p = threadIdx.x;
  float x[kC];
  int acc[kC];
  load_row(x_in + p * kC, x);
#pragma unroll
  for (int q = 0; q < kC; ++q) acc[q] = 0;
#pragma unroll 1
  for (int it = 0; it < R; ++it) {
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      int n = 0;
#pragma unroll
      for (int r = 0; r < kC; ++r) {
        if constexpr (kKind == 0) {
          if (r != q) n += x[r] < x[q];
        } else {
          if (r > q) n += x[r] == x[q];
        }
      }
      acc[q] += n;
    }
    rotate(x);
  }
#pragma unroll
  for (int q = 0; q < kC; ++q) x[q] = static_cast<float>(acc[q]);
  store_row(out + p * kC, x);
}

// Kind 2: each element of row p to its one slot.
__device__ __forceinline__ void slot_rows(const float* __restrict__ x_in,
                                          float* __restrict__ out, int R) {
  const int p = threadIdx.x;
  float x[kC], acc[kSlots];
  load_row(x_in + p * kC, x);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = 0.f;
#pragma unroll 1
  for (int it = 0; it < R; ++it) {
    float s[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) s[k] = 0.f;
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      const int r = static_cast<int>(floorf(__fmul_rn(x[q], 3.f)));
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (r == k) s[k] = __fadd_rn(s[k], x[q]);
      }
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) acc[k] = __fadd_rn(acc[k], s[k]);
    rotate(x);
  }
  store_row(out + p * kSlots, acc);
}

// Kind 3: the rows roll up by 3 a step.
__device__ __forceinline__ void roll_rows(const float* __restrict__ x_in,
                                          float* __restrict__ out, int R) {
  __shared__ __align__(16) float edge[2][kWarps][3][kC];
  const int p = threadIdx.x, lane = p & 31, warp = p >> 5;
  float x[kC];
  load_row(x_in + p * kC, x);
#pragma unroll 1
  for (int it = 0; it < R; ++it) {
    const int b = it & 1;
    if (lane < 3) store_row(edge[b][warp][lane], x);
#pragma unroll
    for (int q = 0; q < kC; ++q) x[q] = __shfl_down_sync(kFull, x[q], 3);
    __syncthreads();
    if (lane >= 29) load_row(edge[b][(warp + 1) % kWarps][lane - 29], x);
  }
  store_row(out + p * kC, x);
}

// The bitonic sort of a frame's 128 (value, index) keys, 4 a lane: element
// e = 4 lane + j; ascending at the end, so element e has rank e.
__device__ __forceinline__ void warp_sort(float (&kv)[4], int (&ki)[4],
                                          int lane) {
#pragma unroll
  for (int ls = 1; ls <= 7; ++ls) {          // sorted runs of 2^ls
    const int size = 1 << ls;
#pragma unroll
    for (int ld = ls - 1; ld >= 0; --ld) {   // partner at distance 2^ld
      const int d = 1 << ld;
      if (d >= 4) {
        const int pl = d >> 2;
        const bool lower = (lane & pl) == 0;
        const bool asc = ((4 * lane) & size) == 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float ov = __shfl_xor_sync(kFull, kv[j], pl);
          const int oi = __shfl_xor_sync(kFull, ki[j], pl);
          // the lower element keeps the smaller in an ascending run
          if (before(ov, oi, kv[j], ki[j]) == (lower == asc)) {
            kv[j] = ov;
            ki[j] = oi;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j & d) continue;
          const bool asc = ((4 * lane + j) & size) == 0;
          const int h = j | d;
          if (before(kv[h], ki[h], kv[j], ki[j]) == asc) {
            const float tv = kv[j];
            const int ti = ki[j];
            kv[j] = kv[h];
            ki[j] = ki[h];
            kv[h] = tv;
            ki[h] = ti;
          }
        }
      }
    }
  }
}

// Kind 4: block f ranks frame f.
__device__ __forceinline__ void frame_rank(const float* __restrict__ x_in,
                                           float* __restrict__ out, int R) {
  __shared__ __align__(16) int ranks[2][kCand];
  const int lane = threadIdx.x, me = 4 * lane;
  const int base = blockIdx.x * kCand + me;
  float v[4];
  int acc[4] = {0, 0, 0, 0};
  load_row(x_in + base, v);
#pragma unroll 1
  for (int it = 0; it < R; ++it) {
    float kv[4];
    int ki[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = v[j];
      ki[j] = me + j;
    }
    warp_sort(kv, ki, lane);
    int* rk = ranks[it & 1];
#pragma unroll
    for (int j = 0; j < 4; ++j) rk[ki[j]] = me + j;
    __syncwarp();
    const int4 r4 = reinterpret_cast<const int4*>(rk)[lane];
    acc[0] += r4.x;
    acc[1] += r4.y;
    acc[2] += r4.z;
    acc[3] += r4.w;
    // rotate the row by one column: 3 registers in the lane, the 4th from
    // the next of the row's 4 lanes
    const float head = __shfl_sync(kFull, v[0], lane + 1, 4);
    v[0] = v[1];
    v[1] = v[2];
    v[2] = v[3];
    v[3] = head;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = static_cast<float>(acc[j]);
  store_row(out + base, v);
}

template <int kKind>
__global__ void __launch_bounds__(threads_of(kKind), 1)
probe_kernel(const float* __restrict__ x, float* __restrict__ out, int R) {
  if constexpr (kKind == kFrameRank) {
    frame_rank(x, out, R);
  } else if constexpr (kKind == 3) {
    roll_rows(x, out, R);
  } else if constexpr (kKind == 2) {
    slot_rows(x, out, R);
  } else {
    count_rows<kKind>(x, out, R);
  }
}

template <int kKind>
cudaError_t launch(const float* x, float* out, int R, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_of(kKind), 1, 1);
  cfg.blockDim = dim3(threads_of(kKind), 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, probe_kernel<kKind>, x, out,
                                           R);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes: device pointers, a cudaStream_t.
// R iterations of computation `kind` (0-4, above) on x [128, 16] f32 (not
// written) into out ([128, 8] for kind 2, else [128, 16]), one launch;
// both 16-byte aligned.
// Returns cudaGetLastError() as an int (cudaErrorInvalidValue, and no
// launch, for another kind or R outside 1 .. 132,104).
extern "C" int probe_rank3_launch(int kind, const void* x, void* out, int R,
                                  void* stream) {
  if (R < 1 || R > kMaxReps) return static_cast<int>(cudaErrorInvalidValue);
  const float* in = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (kind) {
    case 0: e = launch<0>(in, o, R, s); break;
    case 1: e = launch<1>(in, o, R, s); break;
    case 2: e = launch<2>(in, o, R, s); break;
    case 3: e = launch<3>(in, o, R, s); break;
    case 4: e = launch<4>(in, o, R, s); break;
    default: break;
  }
  return static_cast<int>(e);
}

extern "C" const char* probe_rank3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
