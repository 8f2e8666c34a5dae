// Probe F: is the list decoder's serial op chain bound by issue throughput
// or by dependence latency, and at which cluster size does the cluster
// barrier, not one SM's issue rate, set its pace?  Replaces the TPU probe
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
// iteration at a barrier (the leaf at two); as the probe writes them, two
// chains pass their own barriers one after the other.  kShared (two
// chains only) does both chains' work before one set of barriers
// instead, as a kernel carrying several frames a block would.  At W = 4
// each thread holds one element, the density of the decoders' rows (a
// few columns a thread or fewer).
//
// The 128 rows are spread over a thread-block cluster of n = 1, 2, 4 or 8
// blocks, one an SM, 128 / n rows and 512 / n threads each: row p = t / 4
// of the cluster's threads belongs to four threads, W / 4 columns each in
// registers (thread j holds columns j*K .. j*K + K - 1; in the chain
// body columns j*K/2 + k and their partners 64 over, k < K/2, so that the
// roll by 64 columns is a rename of the thread's own registers), so a row
// reduction is two shuffles and a frame of 8 rows is one warp, inside one
// block.  The chain body has no dependence across rows, so its blocks
// pass no barrier inside the loop.  The leaf's and the width body's
// barriers are cluster barriers (a block barrier in the one-block
// cluster, an instance of its own).  The one value a warp that crosses
// rows (the frame minima, the partial sums of the row minima) is pushed
// before the barrier into every block's shared memory (distributed
// shared memory, map_shared_rank; a remote store does not wait), so that
// after it each block reads its own shared memory, in the same order in
// every block.  The leaf's row gather depends on the frame's minimum, so
// it is pulled after the barrier: each block's rows go into its own
// padded tile (four words after every 32 columns, so that a thread's
// columns stay 16-byte aligned and the 8 threads of a 16-byte access
// phase, two rows, fall in 32 distinct banks), and each thread reads its
// source row's columns from the block that holds it, 16 bytes a load, all
// loads in flight at once.  The state never leaves the chip inside the
// loop (every index of a thread's state array is a compile-time
// constant, or ptxas puts the array in local memory).  A block of a
// cluster of two or more has at most 256 threads, so its instance may use
// 255 registers a thread.
// Output, as the probe's, out[0][c] = pm[c] + sum over chains and rows of
// x[p][c] (c < min(W, 128)); and pm alone in out[1].

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kP = 128;          // rows (the probe's P)
constexpr int kThreads = 512;    // of the cluster
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

// Shared-memory word of (row, column) in a padded [rows][W] tile.
template <int W>
__host__ __device__ constexpr int tile_at(int r, int c) {
  return r * (W + W / 8) + c + c / 32 * 4;
}

// The cluster's layout, as each thread sees it; kOne: a cluster of one
// block, in an instance of its own that pays no branch for the cluster.
template <bool kOne>
struct Spread {
  cg::cluster_group cluster;
  int n;       // blocks
  int rank;    // this block's
  int rows;    // a block's rows
  int warps;   // a block's warps (frames)
  // block b's copy of this block's shared array at `local`
  __device__ __forceinline__ const float* of(const float* local,
                                            int b) const {
    if constexpr (kOne) return local;
    return b == rank ? local
                     : cluster.map_shared_rank(const_cast<float*>(local), b);
  }
  // v into word g of `local`'s copy in every block
  __device__ __forceinline__ void to_all(float* local, int g,
                                         float v) const {
    if constexpr (kOne) {
      local[g] = v;
    } else {
      for (int b = 0; b < n; ++b) {
        (b == rank ? local : cluster.map_shared_rank(local, b))[g] = v;
      }
    }
  }
  __device__ __forceinline__ void sync() const {
    if (kOne || n == 1) {
      __syncthreads();
    } else {
      cluster.sync();
    }
  }
};

// The sum, in warp order, and the minimum of a value a warp of the
// cluster (kWarps words of this block's shared memory).
__device__ __forceinline__ float warp_sum(const float* red) {
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += red[w];
  return sum;
}

__device__ __forceinline__ float warp_min(const float* red) {
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fminf(m, red[w]);
  return m;
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

// Column of a thread's k-th element: columns j*K .. j*K + K - 1 of its
// row, except in the chain body, where thread j holds columns j*K/2 + k
// and their partners 64 over, k < K/2, so that the roll by 64 columns is
// a rename of its own registers.
template <int kBody, int K>
__device__ __forceinline__ int col_of(int j, int k) {
  if constexpr (kBody == 0) {
    return (k < K / 2 ? 0 : kP / 2) + j * (K / 2) + k % (K / 2);
  } else {
    return j * K + k;
  }
}

// One chain_body iteration (no barrier): element k's rolled partner is
// element (k + K/2) mod K of the same thread.
template <int K>
__device__ __forceinline__ void chain_step(float (&x)[K], float& pm) {
  float pen = 0.f;
#pragma unroll
  for (int k = 0; k < K / 2; ++k) {
    const float a = x[k], b = x[k + K / 2];
    const float o = sign_of(a) * sign_of(b) * fminf(fabsf(a), fabsf(b));
    const float o2 = sign_of(b) * sign_of(a) * fminf(fabsf(b), fabsf(a));
    pen += fmaxf(-o, 0.f);
    pen += fmaxf(-o2, 0.f);
    x[k] = clamp_step(o, 0.125f);
    x[k + K / 2] = clamp_step(o2, 0.125f);
  }
  pen += __shfl_xor_sync(kFull, pen, 1);
  pen += __shfl_xor_sync(kFull, pen, 2);
  pm = __fadd_rn(pm, __fmul_rn(1e-6f, pen));
}

// The K columns of a thread in a tile row, four at a time (K % 4 == 0).
template <int K, int W>
__device__ __forceinline__ void tile_store(float* tile, int r, int j,
                                           const float (&x)[K]) {
  float4* dst = reinterpret_cast<float4*>(tile + tile_at<W>(r, j * K));
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    dst[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  }
}

// leaf_body before its barrier: the row's minimum and first column (ca),
// the frame's first row (at), the block's rows into its tile and the
// frame minimum into every block's red[global warp].
template <int K, int W, class Sp>
__device__ __forceinline__ void leaf_pre(const float (&x)[K], int p, int lp,
                                         int j, int lane, int gw,
                                         const Sp& sp, float* tile,
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
  tile_store<K, W>(tile, lp, j, x);
  if (lane == 0) sp.to_all(red, gw, m);
}

// leaf_body after its barrier: the smallest frame minimum into pm, the
// rows gathered from the cluster's tiles, the hit, the clamp.
template <int K, int W, class Sp>
__device__ __forceinline__ void leaf_post(float (&x)[K], int p, int j,
                                          const Sp& sp, const float* tile,
                                          const float* red, int at, int ca,
                                          float& pm) {
  const float mm = warp_min(red);
  const int perm = (at + p) % kP;
  const float4* src = reinterpret_cast<const float4*>(
      sp.of(tile, perm / sp.rows) + tile_at<W>(perm % sp.rows, j * K));
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const float4 g = src[q];
    x[4 * q] = g.x;
    x[4 * q + 1] = g.y;
    x[4 * q + 2] = g.z;
    x[4 * q + 3] = g.w;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = x[k];
    if (p == at && j * K + k == ca) v = v + 1.f;
    x[k] = clamp_step(v, 0.0625f);
  }
  pm = __fadd_rn(pm, __fmul_rn(1e-6f, mm));
}

// leaf_width_body before its barrier: the whole row update, and this
// warp's part of the sum of the row minima into every block's
// red[global warp].
template <int K, int W, class Sp>
__device__ __forceinline__ void width_pre(float (&x)[K], int j, int lane,
                                          int gw, const Sp& sp,
                                          float* red) {
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
  if (lane == 0) sp.to_all(red, gw, v);
}

// Words of a block's dynamic shared memory: its tiles, every warp's
// partials red[2][kChains][kWarps], pm of its rows.
template <int kChains, int kW, bool kShared>
__host__ __device__ constexpr int smem_words(int rows) {
  return (kShared ? kChains : 1) * tile_at<kW>(rows, 0) +
         2 * kChains * kWarps + rows;
}

template <int kBody, int kChains, int kW, bool kShared, int kBlock>
__global__ void __launch_bounds__(kBlock, 1)
interleave_kernel(const float* __restrict__ x_in, int in_cols, int reps,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  constexpr int K = kW / kPer;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  // branch-free in the one-block cluster; at width 256 (64 floats of
  // state a thread at 128 registers) the cluster path's branches keep
  // ptxas from overlapping iterations past the registers (without them it
  // spills)
  const Spread<kBlock == kThreads && kW <= kP> sp{
      cluster, n, static_cast<int>(cluster.block_rank()), kP / n,
      kWarps / n};
  const int tile_words = tile_at<kW>(sp.rows, 0);
  float* tile = smem;
  float* red = smem + (kShared ? kChains : 1) * tile_words;
  float* pm_row = red + 2 * kChains * kWarps;
  const int t = threadIdx.x, lp = t / kPer, j = t % kPer;
  const int p = sp.rank * sp.rows + lp;
  const int lane = t & 31, gw = sp.rank * sp.warps + (t >> 5);
  float x[kChains][K];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[c][k] = x_in[(c * kP + p) * in_cols + col_of<kBody, K>(j, k)];
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
          leaf_pre<K, kW>(x[c], p, lp, j, lane, gw, sp,
                          tile + c * tile_words, red + c * kWarps, at[c],
                          ca[c]);
        }
        sp.sync();
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          leaf_post<K, kW>(x[c], p, j, sp, tile + c * tile_words,
                           red + c * kWarps, at[c], ca[c], pm);
        }
        sp.sync();
      } else {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          leaf_pre<K, kW>(x[c], p, lp, j, lane, gw, sp, tile, red, at[c],
                          ca[c]);
          sp.sync();
          leaf_post<K, kW>(x[c], p, j, sp, tile, red, at[c], ca[c], pm);
          sp.sync();
        }
      }
    } else {
      // the partials double-buffered by iteration: a slot is written
      // again only after the next iteration's barrier
      float* part = red + (i & 1) * kChains * kWarps;
      if constexpr (kShared) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          width_pre<K, kW>(x[c], j, lane, gw, sp, part + c * kWarps);
        }
        sp.sync();
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          pm = __fadd_rn(pm, __fmul_rn(1e-6f, warp_sum(part + c * kWarps)));
        }
      } else {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          width_pre<K, kW>(x[c], j, lane, gw, sp, part + c * kWarps);
          sp.sync();
          pm = __fadd_rn(pm, __fmul_rn(1e-6f, warp_sum(part + c * kWarps)));
        }
      }
    }
  }
  // the output: thread g of the cluster sums column g over every row
  if (j == 0) pm_row[lp] = pm;
  constexpr int kCols = kW < kP ? kW : kP;
  const int g = sp.rank * static_cast<int>(blockDim.x) + t;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    sp.sync();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      tile[tile_at<kW>(lp, col_of<kBody, K>(j, k))] = x[c][k];
    }
    sp.sync();
    if (g < kCols) {
      float s = 0.f;
      for (int r = 0; r < kP; ++r) {
        s += sp.of(tile, r / sp.rows)[tile_at<kW>(r % sp.rows, g)];
      }
      acc = c == 0 ? *sp.of(pm_row + g % sp.rows, g / sp.rows) + s : acc + s;
    }
  }
  if (g < kP) {
    const float pm_g = *sp.of(pm_row + g % sp.rows, g / sp.rows);
    out[g] = g < kCols ? acc : pm_g;
    out[kP + g] = pm_g;
  }
  // no block leaves while another may still read its shared memory
  sp.sync();
}

// Launches `kernel` as one cluster of n blocks of `threads` threads with
// `smem` bytes of dynamic shared memory each.  A cluster the card cannot
// hold is refused before the launch (cudaErrorLaunchOutOfResources).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int n, int threads,
                           size_t smem, cudaStream_t s, Args&&... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess && n > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int kBody, int kChains, int kW, bool kShared = false>
cudaError_t launch(const float* x, int in_cols, int reps, float* out, int n,
                   cudaStream_t s) {
  const size_t smem =
      smem_words<kChains, kW, kShared>(kP / n) * sizeof(float);
  return n == 1
             ? launch_cluster(
                   interleave_kernel<kBody, kChains, kW, kShared, kThreads>,
                   n, kThreads, smem, s, x, in_cols, reps, out)
             : launch_cluster(
                   interleave_kernel<kBody, kChains, kW, kShared,
                                     kThreads / 2>,
                   n, kThreads / n, smem, s, x, in_cols, reps, out);
}

}  // namespace

// Plain C interface, loaded with ctypes: device pointers, a cudaStream_t.
// body 0 (chain) with n_chains 1 or 2 at width 128; body 1 (leaf) with
// n_chains 1 or 2 at width 128, shared (one set of barriers for both
// chains) with 2; body 2 (width) with one chain at width 128 or 256, or
// at width 4 with 1 or 2 chains, shared or not.  x holds n_chains states
// [128, in_cols] f32 one after the other, of which the first `width`
// columns are used; out [2][128] f32 (the probe's output, then pm).  The
// rows are spread over a cluster of n = 1, 2, 4 or 8 blocks.  Returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for another
// combination; cudaErrorLaunchOutOfResources for a cluster the card cannot
// hold).
extern "C" int probe_interleave_launch(int body, int n_chains, int width,
                                       int shared, const void* x,
                                       int in_cols, int reps, void* out,
                                       int n, void* stream) {
  const float* in = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (in_cols < width || reps < 0 || (shared && n_chains != 2) ||
      (n != 1 && n != 2 && n != 4 && n != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaErrorInvalidValue;
  if (body == 0 && width == 128 && !shared) {
    e = n_chains == 1   ? launch<0, 1, 128>(in, in_cols, reps, o, n, s)
        : n_chains == 2 ? launch<0, 2, 128>(in, in_cols, reps, o, n, s)
                        : cudaErrorInvalidValue;
  } else if (body == 1 && width == 128) {
    e = shared          ? launch<1, 2, 128, true>(in, in_cols, reps, o, n, s)
        : n_chains == 1 ? launch<1, 1, 128>(in, in_cols, reps, o, n, s)
        : n_chains == 2 ? launch<1, 2, 128>(in, in_cols, reps, o, n, s)
                        : cudaErrorInvalidValue;
  } else if (body == 2 && width == 4) {
    e = shared          ? launch<2, 2, 4, true>(in, in_cols, reps, o, n, s)
        : n_chains == 1 ? launch<2, 1, 4>(in, in_cols, reps, o, n, s)
        : n_chains == 2 ? launch<2, 2, 4>(in, in_cols, reps, o, n, s)
                        : cudaErrorInvalidValue;
  } else if (body == 2 && n_chains == 1) {
    e = width == 128   ? launch<2, 1, 128>(in, in_cols, reps, o, n, s)
        : width == 256 ? launch<2, 1, 256>(in, in_cols, reps, o, n, s)
                       : cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* probe_interleave_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
