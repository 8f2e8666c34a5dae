// Probe D: the cost of one primitive class per iteration of a serial loop,
// at P = 128 and P = 256 rows.  Replaces the TPU microprobe
// bench/probe_p256.py (timeit -> pl.pallas_call, probe_p256.py:45): each
// of its six bodies, looped R times inside one launch over a [P, 512] f32
// state, so the launch cost cancels and the loop models the decoder's
// serial schedule.
//
// The state lives on chip for the whole loop: in registers, spread over a
// thread-block cluster of n blocks (one an SM), never in global memory
// between the launch's one read and one write.  The [P, 512] state is
// 256 KB at P = 128 and 512 KB at P = 256; an SM has 256 KB of registers,
// so the smallest cluster that holds it is 2 blocks at P = 128 and 4 at
// P = 256, each block holding P / n rows (64 at those sizes).  Row r of a
// block belongs to one warp (kRpw rows a warp), lane l holding columns
// l + 32 j, j < 16, of it: a row reduction is a warp's shuffles, with no
// block barrier.  What crosses rows goes through shared memory and the
// cluster barrier: a value every block reads is pushed, its writers
// storing it into every block's shared memory (distributed shared memory,
// map_shared_rank; a remote store does not wait), so that after the
// barrier each block reads its own; eye-sum's transposed block, which
// each block reads a different part of, is pulled after the barrier in
// coalesced loads (pushed, it was 32 scattered remote stores a warp
// instruction, 2.6-3.6x slower on the card).  The writers fill one of two
// buffers, alternating by iteration; a buffer is written again only after
// the next iteration's barrier, which every reader of it has passed.
// Every iteration holds exactly one cluster barrier: with release and
// acquire semantics where the body exchanges data, relaxed (the iterations
// kept in step, no memory ordering) in madd and min-reduce, which exchange
// nothing; the difference of the two prices the barrier's release.  The
// bodies, each the probe's function without its TPU workaround (kBody):
//   0 madd       x = x * 1.0001 + 0.001, rounded as two operations
//   1 min-reduce x = x + min over the row (in the row's warp)
//   2 transpose  x = x + x[0][0]: column 0 staged in shared memory as a
//                row (the (P,1) -> (1,P) transpose), its first word read
//                by every block (one word: pulled)
//   3 one-hot    x = M x with M[p][q] = (q == i mod P): every row becomes
//                row i mod P, which its warp pushes to every block: a
//                broadcast of one row, with no product (the loop is
//                unrolled by a warp's rows, so that the pushed row's
//                registers are named at compile time)
//   4 eye-sum    x = x + d per row, d[p] = sum_q a[p][q] (p == q) for a =
//                x[:, :P] x[:, :P], which is sum_k x[p][k] x[k][p]: only
//                the diagonal, 2 P^2 operations; the first P columns are
//                staged transposed (one word of padding a column) and
//                column p read across the cluster
//   5 selector   the [F, 2P] masked-min selector, F = P / 8: each row's
//                minimum of x[p][0] and x[p][1] pushed to every block,
//                each frame's minimum over its 8 rows, the F minima summed
//                in frame order, x = x + the sum
// What bounds it: per-iteration latency (the cluster barrier, shuffles),
// not bytes or operations; the probe reads the P = 256 / 128 ratio of
// each body and the cost against the cluster's size.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 512;          // columns of the state
constexpr int kPerLane = kCols / 32;   // a lane's columns: lane + 32 j
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A cluster barrier without memory ordering, for bodies that exchange
// nothing.
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Words of one of the two exchange buffers of a block of `rows` rows.
template <int kBody, int kP>
__host__ __device__ constexpr int buffer_words(int rows) {
  return kBody == 2 || kBody == 5 ? kP
         : kBody == 3             ? kCols
         : kBody == 4             ? kP * (rows + 1)
                                  : 0;
}

template <int kBody, int kP, int kRpw>
__global__ void __launch_bounds__(kMaxThreads, 1)
probe_kernel(const float* __restrict__ x, float* __restrict__ y, int R) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = static_cast<int>(blockDim.x >> 5) * kRpw;
  const int lrow0 = warp * kRpw;        // the warp's first row in the block
  const int row0 = rank * rows + lrow0;  // ... in the state
  const int words = buffer_words<kBody, kP>(rows);
  float v[kRpw][kPerLane];
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      v[r][j] = x[(row0 + r) * kCols + lane + 32 * j];
    }
  }
  // eye-sum: where column p of row k = lane + 32 j lies, less p's offset
  constexpr int kStaged = kBody == 4 ? kP / 32 : 1;
  const float* col_of[kStaged];
  if constexpr (kBody == 4) {
#pragma unroll
    for (int j = 0; j < kStaged; ++j) {
      const int k = lane + 32 * j;
      col_of[j] = cluster.map_shared_rank(smem, k / rows) + k % rows;
    }
  }
  const int n = static_cast<int>(cluster.num_blocks());
  // one-hot: the row pushed in iteration i is (i mod P) mod kRpw of its
  // warp, q below, a constant of the unrolled loop
  constexpr int kUnroll = kBody == 3 ? kRpw : 1;
  for (int i0 = 0; i0 < R; i0 += kUnroll) {
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int i = i0 + q;
      if (i >= R) break;
      const int off = (i & 1) * words;
      float* buf = smem + off;
      if constexpr (kBody == 0) {
#pragma unroll
        for (int r = 0; r < kRpw; ++r) {
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) {
            v[r][j] = __fadd_rn(__fmul_rn(v[r][j], 1.0001f), 0.001f);
          }
        }
        cluster_sync_relaxed();
      } else if constexpr (kBody == 1) {
#pragma unroll
        for (int r = 0; r < kRpw; ++r) {
          float m = v[r][0];
#pragma unroll
          for (int j = 1; j < kPerLane; ++j) m = fminf(m, v[r][j]);
          m = warp_min(m);
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) v[r][j] = __fadd_rn(v[r][j], m);
        }
        cluster_sync_relaxed();
      } else if constexpr (kBody == 2) {
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kRpw; ++r) buf[lrow0 + r] = v[r][0];
        }
        cluster.sync();
        const float s = *cluster.map_shared_rank(buf, 0);
#pragma unroll
        for (int r = 0; r < kRpw; ++r) {
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) v[r][j] = __fadd_rn(v[r][j], s);
        }
      } else if constexpr (kBody == 3) {
        const int perm = i % kP;
        if (rank == perm / rows && perm % rows / kRpw == warp) {
          for (int b = 0; b < n; ++b) {
            float* dst = cluster.map_shared_rank(buf, b) + lane;
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) dst[32 * j] = v[q][j];
          }
        }
        cluster.sync();
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const float t = buf[lane + 32 * j];
#pragma unroll
          for (int r = 0; r < kRpw; ++r) v[r][j] = t;
        }
      } else if constexpr (kBody == 4) {
        // columns < P staged transposed: buf[c * (rows + 1) + local row]
#pragma unroll
        for (int r = 0; r < kRpw; ++r) {
#pragma unroll
          for (int j = 0; j < kStaged; ++j) {
            buf[(lane + 32 * j) * (rows + 1) + lrow0 + r] = v[r][j];
          }
        }
        cluster.sync();
#pragma unroll
        for (int r = 0; r < kRpw; ++r) {
          const int at = off + (row0 + r) * (rows + 1);
          float d = 0.f;
#pragma unroll
          for (int j = 0; j < kStaged; ++j) d = fmaf(v[r][j], col_of[j][at], d);
          d = warp_sum(d);
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) v[r][j] = __fadd_rn(v[r][j], d);
        }
      } else {
        // each row's min of columns 0 and 1 (lanes 0 and 1) to every block,
        // then lane f takes frame f's minimum over its 8 rows
#pragma unroll
        for (int r = 0; r < kRpw; ++r) {
          const float o = __shfl_down_sync(kFull, v[r][0], 1);
          if (lane == 0) {
            const float m = fminf(v[r][0], o);
            for (int b = 0; b < n; ++b) {
              cluster.map_shared_rank(buf, b)[row0 + r] = m;
            }
          }
        }
        cluster.sync();
        float m = 3e38f;
        if (lane < kP / 8) {
#pragma unroll
          for (int k = 0; k < 8; ++k) m = fminf(m, buf[lane * 8 + k]);
        }
        float s = 0.f;
#pragma unroll
        for (int f = 0; f < kP / 8; ++f) s += __shfl_sync(kFull, m, f);
#pragma unroll
        for (int r = 0; r < kRpw; ++r) {
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) v[r][j] = __fadd_rn(v[r][j], s);
        }
      }
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      y[(row0 + r) * kCols + lane + 32 * j] = v[r][j];
    }
  }
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

template <int kBody, int kP, int kRpw>
cudaError_t launch(const float* x, float* y, int n, int R, cudaStream_t s) {
  const int rows = kP / n;
  const size_t smem = 2 * sizeof(float) * buffer_words<kBody, kP>(rows);
  return launch_cluster(probe_kernel<kBody, kP, kRpw>, n, rows / kRpw * 32,
                        smem, s, x, y, R);
}

// rows a block: 64 and 32 as 16 warps of 4 and 2 rows, 16 and 8 as 16 and
// 8 warps of one row
template <int kBody, int kP>
cudaError_t launch_rows(const float* x, float* y, int n, int R,
                        cudaStream_t s) {
  switch (kP / n) {
    case 64: return launch<kBody, kP, 4>(x, y, n, R, s);
    case 32: return launch<kBody, kP, 2>(x, y, n, R, s);
    case 16:
    case 8: return launch<kBody, kP, 1>(x, y, n, R, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int kBody>
cudaError_t launch_body(const float* x, float* y, int P, int n, int R,
                        cudaStream_t s) {
  return P == 128 ? launch_rows<kBody, 128>(x, y, n, R, s)
                  : launch_rows<kBody, 256>(x, y, n, R, s);
}

}  // namespace

// Plain C interface, loaded with ctypes: device pointers, a cudaStream_t.
// Runs body `body` (0-5, above) R times on x [P, 512] f32 into y [P, 512]
// (x is not written), as one cluster of n blocks: P = 128 with n in {2,
// 4, 8, 16}, P = 256 with n in {4, 8, 16}.  Returns cudaGetLastError() as
// an int (cudaErrorInvalidValue for another body, P or n;
// cudaErrorLaunchOutOfResources for a cluster the card cannot hold).
extern "C" int probe_p256_launch(int body, const void* x, void* y, int P,
                                 int n, int R, void* stream) {
  if ((P != 128 && P != 256) || n < 1 || n > 16 || P % n || P / n > 64 ||
      R < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* a = static_cast<const float*>(x);
  float* b = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (body) {
    case 0: e = launch_body<0>(a, b, P, n, R, s); break;
    case 1: e = launch_body<1>(a, b, P, n, R, s); break;
    case 2: e = launch_body<2>(a, b, P, n, R, s); break;
    case 3: e = launch_body<3>(a, b, P, n, R, s); break;
    case 4: e = launch_body<4>(a, b, P, n, R, s); break;
    case 5: e = launch_body<5>(a, b, P, n, R, s); break;
    default: break;
  }
  return static_cast<int>(e);
}

extern "C" const char* probe_p256_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
