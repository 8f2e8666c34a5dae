// Probe D: the cost of one primitive class per iteration of a serial loop,
// at P = 128 and P = 256 rows.  Replaces the TPU microprobe
// bench/probe_p256.py (timeit -> pl.pallas_call, probe_p256.py:45): each
// of its six bodies, looped R times inside one launch over a [P, 512] f32
// state, so the launch cost cancels and the loop models the decoder's
// serial schedule.
//
// On the card the state is one thread block's: 512 threads, thread t
// owning column t of every row, the [P, 512] state in global memory
// (256 KB at P = 128, 512 KB at P = 256: more than a block's 227 KB of
// shared memory, so it lives in L1 / L2), and the loop inside the block.
// The bodies, as the probe's (kBody):
//   0 madd       x = x * 1.0001 + 0.001
//   1 min-reduce x = x + min over the row, per row
//   2 transpose  x = x + x[0][0], column 0 staged through shared memory
//                as a row (the (P,1) -> (1,P) transpose)
//   3 one-hot    x = M x with M[p][q] = (q == i mod P): the [P, P] x
//                [P, 512] product written out in the body, one FMA a
//                (p, q) pair per column (no library matmul: the product is
//                what is measured)
//   4 eye-sum    a = x[:, :P] x[:, :P] (the [P, P] product, written out,
//                into global scratch), d[p] = sum_q a[p][q] * (p == q),
//                x = x + d per row
//   5 selector   the [F, 2P] masked-min selector view, F = P / 8: cand =
//                [x[:, 0] | x[:, 1]] as a row, cf[f][j] = cand[j] where
//                (j mod P) / 8 == f else 3e38, m[f] = min_j cf[f][j],
//                x = x + sum_f m[f]
// Every iteration ends in a block barrier.  What bounds it: per-iteration
// latency (barriers, reductions, L1 / L2 round trips), not bytes or
// operations; the probe reads the P = 256 / 128 ratio of each body.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 512;       // columns of the state; one thread each
constexpr int kWarps = kCols / 32;
constexpr int kMaxP = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int kBody>
__global__ void __launch_bounds__(kCols, 1)
probe_kernel(float* x, float* x2, float* scratch, int P, int R) {
  __shared__ float part[kMaxP * kWarps];   // per-row, per-warp partials
  __shared__ float row_val[2 * kMaxP];     // a value per row / candidate
  __shared__ float one;                    // a block-wide scalar
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  float* a = x;
  float* b = x2;
  for (int i = 0; i < R; ++i) {
    if constexpr (kBody == 0) {
      // rounded as the plain version's separate multiply and add
      for (int p = 0; p < P; ++p) {
        a[p * kCols + t] = __fadd_rn(__fmul_rn(a[p * kCols + t], 1.0001f),
                                     0.001f);
      }
    } else if constexpr (kBody == 1) {
      for (int p = 0; p < P; ++p) {
        const float m = warp_min(a[p * kCols + t]);
        if (lane == 0) part[p * kWarps + warp] = m;
      }
      __syncthreads();
      if (t < P) {
        float m = part[t * kWarps];
        for (int w = 1; w < kWarps; ++w) m = fminf(m, part[t * kWarps + w]);
        row_val[t] = m;
      }
      __syncthreads();
      for (int p = 0; p < P; ++p) a[p * kCols + t] += row_val[p];
    } else if constexpr (kBody == 2) {
      if (t < P) row_val[t] = a[t * kCols];
      __syncthreads();
      const float s = row_val[0];
      for (int p = 0; p < P; ++p) a[p * kCols + t] += s;
    } else if constexpr (kBody == 3) {
      const int perm = i % P;
      for (int p0 = 0; p0 < P; p0 += 32) {
        float acc[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[k] = 0.f;
        for (int q = 0; q < P; ++q) {
          const float xq = a[q * kCols + t];
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const float m = q == perm ? 1.f : 0.f;   // M[p0 + k][q]
            acc[k] = fmaf(m, xq, acc[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < 32; ++k) b[(p0 + k) * kCols + t] = acc[k];
      }
      float* tmp = a;
      a = b;
      b = tmp;
    } else if constexpr (kBody == 4) {
      for (int e = t; e < P * P; e += kCols) {
        const int p = e / P, q = e % P;
        float acc = 0.f;
        for (int k = 0; k < P; ++k) {
          acc = fmaf(a[p * kCols + k], a[k * kCols + q], acc);
        }
        scratch[e] = acc;
      }
      __syncthreads();
      if (t < P) {
        float d = 0.f;
        for (int q = 0; q < P; ++q) {
          d += scratch[t * P + q] * (t == q ? 1.f : 0.f);
        }
        row_val[t] = d;
      }
      __syncthreads();
      for (int p = 0; p < P; ++p) a[p * kCols + t] += row_val[p];
    } else {
      const int F = P / 8;
      if (t < 2 * P) row_val[t] = t < P ? a[t * kCols] : a[(t - P) * kCols + 1];
      __syncthreads();
      for (int e = t; e < F * 2 * P; e += kCols) {
        const int f = e / (2 * P), j = e % (2 * P);
        const float v = (j % P) / 8 == f ? row_val[j] : 3e38f;
        const float m = warp_min(v);       // a warp lies in one row f
        if (lane == 0) part[e / 32] = m;
      }
      __syncthreads();
      if (t < F) {
        const int per = 2 * P / 32;
        float m = part[t * per];
        for (int w = 1; w < per; ++w) m = fminf(m, part[t * per + w]);
        row_val[t] = m;                    // cand is no longer read
      }
      __syncthreads();
      if (t == 0) {
        float s = 0.f;
        for (int f = 0; f < F; ++f) s += row_val[f];
        one = s;
      }
      __syncthreads();
      const float s = one;
      for (int p = 0; p < P; ++p) a[p * kCols + t] += s;
    }
    __syncthreads();
  }
  // the result in x: copy back if the last iteration wrote the other one
  if (a != x) {
    for (int p = 0; p < P; ++p) x[p * kCols + t] = a[p * kCols + t];
  }
}

template <int kBody>
void launch(float* x, float* x2, float* scratch, int P, int R,
            cudaStream_t s) {
  probe_kernel<kBody><<<1, kCols, 0, s>>>(x, x2, scratch, P, R);
}

}  // namespace

// Plain C interface, loaded with ctypes: device pointers, a cudaStream_t.
// Runs body `body` (0-5, above) R times on x [P, 512] f32 in place, one
// block, P in {128, 256}; x2 [P, 512] and scratch [P, P] f32 are work
// buffers.  Returns cudaGetLastError() as an int
// (cudaErrorInvalidValue for another body or P).
extern "C" int probe_p256_launch(int body, void* x, void* x2, void* scratch,
                                 int P, int R, void* stream) {
  if ((P != 128 && P != 256) || R < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* a = static_cast<float*>(x);
  float* b = static_cast<float*>(x2);
  float* sc = static_cast<float*>(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0: launch<0>(a, b, sc, P, R, s); break;
    case 1: launch<1>(a, b, sc, P, R, s); break;
    case 2: launch<2>(a, b, sc, P, R, s); break;
    case 3: launch<3>(a, b, sc, P, R, s); break;
    case 4: launch<4>(a, b, sc, P, R, s); break;
    case 5: launch<5>(a, b, sc, P, R, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_p256_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
