// Probe F: is the list decoder's serial op chain bound by issue throughput
// or by dependence latency?  Replaces the TPU probe
// bench/probe_interleave.py (make_probe -> pl.pallas_call :107,
// make_width_probe -> pl.pallas_call :177).  Its op mixes on a [128, W]
// f32 state, R serially dependent iterations in one launch:
//   chain (kBody 0, W = 128): chain_body :46, min-sum F against the
//     columns rolled by 64, the row's penalty sum into pm, a clamp;
//   leaf (kBody 1, W = 128): leaf_body :59, the row minimum and its first
//     column, each frame's (8 rows) minimum and its first row, the rows
//     gathered by perm[p] = (at[frame] + p) mod 128 (the probe's one-hot
//     permute matmul, a row gather, exact in f32), a +1 at the hit, a
//     clamp, pm + 1e-6 x the smallest frame minimum;
//   width (kBody 2, W = 128 or 256, or 4 for the narrow variant):
//     leaf_width_body :187, the row minimum, two masked updates, the
//     second-smallest, a clamp, pm + 1e-6 x the sum of the row minima.
// kChains independent states (each with its own rows, pm threaded through
// them in turn, as the probe's `run`) interleave in one loop: single =
// one chain R iterations, dual = two chains R iterations, double = one
// chain 2R iterations.  Latency-bound means dual ~ single; throughput-
// bound means dual ~ double.  The leaf and width bodies end each chain's
// iteration at a block barrier (the leaf at two); as the probe writes
// them, two chains pass their own barriers one after the other.  kShared
// (two chains only) does both chains' work before one set of barriers
// instead, as a kernel carrying several frames a block would.  At W = 4
// each thread holds one element, the density of the decoders' rows (a
// few columns a thread or fewer).
//
// One block of 512 threads: row p = t / 4 belongs to four threads, W / 4
// columns each in registers (thread j holds columns j*K .. j*K + K - 1),
// so a row reduction is two shuffles, the roll by 64 columns a shuffle
// with the thread two over, and a frame of 8 rows is one warp.  The
// leaf's row gather goes through shared memory, one word of padding after
// every 32 columns, so that a warp's 8 rows x 4 threads fall in 32
// distinct banks.  Output, as the probe's, out[0][c] = pm[c] + sum over
// chains and rows of x[p][c] (c < min(W, 128)); and pm alone in out[1].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 128;          // rows (the probe's P)
constexpr int kThreads = 512;
constexpr int kPer = kThreads / kP;   // threads a row
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

// |v| > 4 ? v / 2 : v + step (the probes' clamp that keeps the chain
// from overflowing)
__device__ __forceinline__ float clamp_step(float v, float step) {
  return fabsf(v) > 4.f ? v * 0.5f : v + step;
}

__device__ __forceinline__ float row_min(float v) {
  v = fminf(v, __shfl_xor_sync(kFull, v, 1));
  return fminf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ int row_min_int(int v) {
  v = min(v, __shfl_xor_sync(kFull, v, 1));
  return min(v, __shfl_xor_sync(kFull, v, 2));
}

// Shared-memory word of (row, column) in a padded [kP][W] tile.
template <int W>
__device__ __forceinline__ int tile_at(int r, int c) {
  return r * (W + W / 32) + c + c / 32;
}

// The row minimum of x[0..K) over the row's four threads, and its first
// column (W if none).
template <int K, int W>
__device__ __forceinline__ void row_argmin(const float (&x)[K], int j,
                                           float& m, int& at) {
  m = x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fminf(m, x[k]);
  m = row_min(m);
  at = W;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    if (x[k] == m) at = j * K + k;
  }
  at = row_min_int(at);
}

// One chain_body iteration (no barrier).
template <int K>
__device__ __forceinline__ void chain_step(float (&x)[K], float& pm) {
  float pen = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // column j*K + k + 64 (mod 128) lives in thread j ^ 2
    const float y = __shfl_xor_sync(kFull, x[k], 2);
    const float o = sign_of(x[k]) * sign_of(y) * fminf(fabsf(x[k]), fabsf(y));
    pen += fmaxf(-o, 0.f);
    x[k] = clamp_step(o, 0.125f);
  }
  pen += __shfl_xor_sync(kFull, pen, 1);
  pen += __shfl_xor_sync(kFull, pen, 2);
  pm = __fadd_rn(pm, __fmul_rn(1e-6f, pen));
}

// leaf_body before its barrier: the row's minimum and first column (ca),
// the frame's first row (at), the rows into the tile and the frame
// minimum into red[warp].
template <int K, int W>
__device__ __forceinline__ void leaf_pre(const float (&x)[K], int p, int j,
                                         int warp, int lane, float* tile,
                                         float* red, int& at, int& ca) {
  float cm;
  row_argmin<K, W>(x, j, cm, ca);
  // the frame (8 rows = this warp): its minimum, its first row
  float m = cm;
  for (int o = kPer; o < 32; o <<= 1) {
    m = fminf(m, __shfl_xor_sync(kFull, m, o));
  }
  at = cm == m ? p : kP;
  for (int o = kPer; o < 32; o <<= 1) {
    at = min(at, __shfl_xor_sync(kFull, at, o));
  }
#pragma unroll
  for (int k = 0; k < K; ++k) tile[tile_at<W>(p, j * K + k)] = x[k];
  if (lane == 0) red[warp] = m;
}

// leaf_body after its barrier: the smallest frame minimum into pm, the
// gathered rows, the hit, the clamp.
template <int K, int W>
__device__ __forceinline__ void leaf_post(float (&x)[K], int p, int j,
                                          const float* tile, const float* red,
                                          int at, int ca, float& pm) {
  float mm = red[0];
  for (int w = 1; w < kWarps; ++w) mm = fminf(mm, red[w]);
  const int perm = (at + p) % kP;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = tile[tile_at<W>(perm, j * K + k)];
    if (p == at && j * K + k == ca) v = v + 1.f;
    x[k] = clamp_step(v, 0.0625f);
  }
  pm = __fadd_rn(pm, __fmul_rn(1e-6f, mm));
}

// leaf_width_body before its barrier: the whole row update, and this
// warp's part of the sum of the row minima into red[warp].
template <int K, int W>
__device__ __forceinline__ void width_pre(float (&x)[K], int j, int warp,
                                          int lane, float* red) {
  float cm;
  int ca;
  row_argmin<K, W>(x, j, cm, ca);
  float m2 = kBig;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float a = __fadd_rn(x[k], __fmul_rn(cm, 0.125f));
    if (j * K + k == ca) a = a + 1.f;
    x[k] = a;
    m2 = fminf(m2, j * K + k == ca ? kBig : a);
  }
  m2 = row_min(m2);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x[k] = clamp_step(__fadd_rn(x[k], __fmul_rn(m2, 0.0625f)), 0.03125f);
  }
  // one thread a row, then a warp sum
  float v = j == 0 ? cm : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (lane == 0) red[warp] = v;
}

// leaf_width_body after its barrier: the 16 warps' partials into pm.
__device__ __forceinline__ void width_post(const float* red, float& pm) {
  float sum = 0.f;
  for (int w = 0; w < kWarps; ++w) sum += red[w];
  pm = __fadd_rn(pm, __fmul_rn(1e-6f, sum));
}

template <int kBody, int kChains, int kW, bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
interleave_kernel(const float* __restrict__ x_in, int in_cols, int reps,
                  float* __restrict__ out) {
  extern __shared__ float tile[];   // [kShared ? kChains : 1] padded tiles
  __shared__ float red[2][kChains][kWarps];
  __shared__ float pm_row[kP];
  constexpr int K = kW / kPer;
  constexpr int kTile = kP * (kW + kW / 32);
  const int t = threadIdx.x, p = t / kPer, j = t % kPer;
  const int warp = t >> 5, lane = t & 31;
  float x[kChains][K];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[c][k] = x_in[(c * kP + p) * in_cols + j * K + k];
    }
  }
  float pm = 0.f;   // pm[p], the same in the row's four threads
  for (int i = 0; i < reps; ++i) {
    if constexpr (kBody == 0) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) chain_step<K>(x[c], pm);
    } else if constexpr (kBody == 1) {
      int at[kChains], ca[kChains];
      if constexpr (kShared) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          leaf_pre<K, kW>(x[c], p, j, warp, lane, tile + c * kTile, red[0][c],
                          at[c], ca[c]);
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          leaf_post<K, kW>(x[c], p, j, tile + c * kTile, red[0][c], at[c],
                           ca[c], pm);
        }
        __syncthreads();
      } else {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          leaf_pre<K, kW>(x[c], p, j, warp, lane, tile, red[0][0], at[c],
                          ca[c]);
          __syncthreads();
          leaf_post<K, kW>(x[c], p, j, tile, red[0][0], at[c], ca[c], pm);
          __syncthreads();
        }
      }
    } else {
      // the partials double-buffered by iteration: a slot is written
      // again only after the next iteration's barrier
      if constexpr (kShared) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          width_pre<K, kW>(x[c], j, warp, lane, red[i & 1][c]);
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < kChains; ++c) width_post(red[i & 1][c], pm);
      } else {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          width_pre<K, kW>(x[c], j, warp, lane, red[i & 1][c]);
          __syncthreads();
          width_post(red[i & 1][c], pm);
        }
      }
    }
  }
  if (j == 0) pm_row[p] = pm;
  constexpr int kCols = kW < kP ? kW : kP;
  float acc = 0.f;
  for (int c = 0; c < kChains; ++c) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) tile[tile_at<kW>(p, j * K + k)] = x[c][k];
    __syncthreads();
    if (t < kCols) {
      float s = 0.f;
      for (int r = 0; r < kP; ++r) s += tile[tile_at<kW>(r, t)];
      acc = c == 0 ? pm_row[t] + s : acc + s;
    }
  }
  if (t < kP) {
    out[t] = t < kCols ? acc : pm_row[t];
    out[kP + t] = pm_row[t];
  }
}

template <int kBody, int kChains, int kW, bool kShared = false>
cudaError_t launch(const float* x, int in_cols, int reps, float* out,
                   cudaStream_t s) {
  auto kernel = interleave_kernel<kBody, kChains, kW, kShared>;
  const int smem = (kShared ? kChains : 1) * kP * (kW + kW / 32) *
                   static_cast<int>(sizeof(float));
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<1, kThreads, smem, s>>>(x, in_cols, reps, out);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes: device pointers, a cudaStream_t.
// body 0 (chain) with n_chains 1 or 2 at width 128; body 1 (leaf) with
// n_chains 1 or 2 at width 128, shared (one set of barriers for both
// chains) with 2; body 2 (width) with one chain at width 128 or 256, or
// at width 4 with 1 or 2 chains, shared or not.  x holds n_chains states
// [128, in_cols] f32 one after the other, of which the first `width`
// columns are used; out [2][128] f32 (the probe's output, then pm).
// Returns cudaGetLastError() as an int (cudaErrorInvalidValue for another
// combination).
extern "C" int probe_interleave_launch(int body, int n_chains, int width,
                                       int shared, const void* x,
                                       int in_cols, int reps, void* out,
                                       void* stream) {
  const float* in = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (in_cols < width || reps < 0 || (shared && n_chains != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaErrorInvalidValue;
  if (body == 0 && width == 128 && !shared) {
    e = n_chains == 1   ? launch<0, 1, 128>(in, in_cols, reps, o, s)
        : n_chains == 2 ? launch<0, 2, 128>(in, in_cols, reps, o, s)
                        : cudaErrorInvalidValue;
  } else if (body == 1 && width == 128) {
    e = shared          ? launch<1, 2, 128, true>(in, in_cols, reps, o, s)
        : n_chains == 1 ? launch<1, 1, 128>(in, in_cols, reps, o, s)
        : n_chains == 2 ? launch<1, 2, 128>(in, in_cols, reps, o, s)
                        : cudaErrorInvalidValue;
  } else if (body == 2 && width == 4) {
    e = shared          ? launch<2, 2, 4, true>(in, in_cols, reps, o, s)
        : n_chains == 1 ? launch<2, 1, 4>(in, in_cols, reps, o, s)
        : n_chains == 2 ? launch<2, 2, 4>(in, in_cols, reps, o, s)
                        : cudaErrorInvalidValue;
  } else if (body == 2 && n_chains == 1) {
    e = width == 128   ? launch<2, 1, 128>(in, in_cols, reps, o, s)
        : width == 256 ? launch<2, 1, 256>(in, in_cols, reps, o, s)
                       : cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* probe_interleave_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
