// Probe E: the primitives of the rank-count fork selection, on a [128, 16]
// f32 tile.  Replaces the TPU capability probe bench/probe_rank3.py (run
// -> pl.pallas_call, probe_rank3.py:33), which checks that Mosaic compiles
// them and gets numpy's values.  One block of 128 threads, thread p owning
// row p's 16 values in registers; rows meet through shared memory.  The
// five computations (kKind):
//   0 all-pairs rank   out[p][q] = #{q' : x[p][q'] < x[p][q]}
//   1 tie count        out[p][q] = #{q' > q : x[p][q'] == x[p][q]} (the
//                      computed upper-triangle mask of the tie-break)
//   2 slot extract     r = floor(3 x); out[p][k] = sum of x[p][q] over
//                      r[p][q] == k, k < 8, in column order
//   3 row roll         out[p] = x[(p + 3) mod 128]: the sublane roll by
//                      P - 3, through shared memory
//   4 frame rank       frames of 8 rows; out[p][q] = the number of the
//                      frame's 128 candidates before x[p][q] in (value,
//                      in-frame flat index) order: the rank count of the
//                      list decoder's rank selection (csrc/scl_decode.cu,
//                      kRank), which on distinct values is the probe's
//                      strict-less count
// What bounds it: one launch of a few hundred instructions a thread; the
// time is the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 128, kC = 16, kFrame = 8;

// The selection order: smaller value first, lower index on ties.
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

template <int kKind>
__global__ void __launch_bounds__(kP, 1)
probe_kernel(const float* __restrict__ x_in, float* __restrict__ out) {
  __shared__ float tile[kP][kC + 1];
  const int p = threadIdx.x;
  float x[kC];
#pragma unroll
  for (int q = 0; q < kC; ++q) x[q] = x_in[p * kC + q];
  if constexpr (kKind == 0) {
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      float n = 0.f;
#pragma unroll
      for (int r = 0; r < kC; ++r) n += x[r] < x[q] ? 1.f : 0.f;
      out[p * kC + q] = n;
    }
  } else if constexpr (kKind == 1) {
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      float n = 0.f;
#pragma unroll
      for (int r = 0; r < kC; ++r) n += (x[r] == x[q] && q < r) ? 1.f : 0.f;
      out[p * kC + q] = n;
    }
  } else if constexpr (kKind == 2) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kC; ++q) {
        s += floorf(__fmul_rn(x[q], 3.f)) == k ? x[q] : 0.f;
      }
      out[p * 8 + k] = s;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kC; ++q) tile[p][q] = x[q];
    __syncthreads();
    if constexpr (kKind == 3) {
      const int src = (p + 3) % kP;
#pragma unroll
      for (int q = 0; q < kC; ++q) out[p * kC + q] = tile[src][q];
    } else {
      const int f0 = p / kFrame * kFrame;
#pragma unroll
      for (int q = 0; q < kC; ++q) {
        const int me = (p - f0) * kC + q;
        int n = 0;
        for (int r = 0; r < kFrame; ++r) {
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            n += before(tile[f0 + r][c], r * kC + c, x[q], me);
          }
        }
        out[p * kC + q] = static_cast<float>(n);
      }
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: device pointers, a cudaStream_t.
// Computation `kind` (0-4, above) of x [128, 16] f32 into out ([128, 8]
// for kind 2, else [128, 16]).  Returns cudaGetLastError() as an int
// (cudaErrorInvalidValue for another kind).
extern "C" int probe_rank3_launch(int kind, const void* x, void* out,
                                  void* stream) {
  const float* in = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: probe_kernel<0><<<1, kP, 0, s>>>(in, o); break;
    case 1: probe_kernel<1><<<1, kP, 0, s>>>(in, o); break;
    case 2: probe_kernel<2><<<1, kP, 0, s>>>(in, o); break;
    case 3: probe_kernel<3><<<1, kP, 0, s>>>(in, o); break;
    case 4: probe_kernel<4><<<1, kP, 0, s>>>(in, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_rank3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
