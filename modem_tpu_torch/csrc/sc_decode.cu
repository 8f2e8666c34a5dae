// Plain successive-cancellation (SC) decode of a polar code, one thread
// block per frame, interpreting the schedule of fec/schedule.py.
//
// Replaces the list_size=1 specialisation of the TPU Pallas kernel
// modem_tpu/kernels/scl_pallas.py (make_pallas_decoder(frozen, 1,
// exact=True) -> decode -> pl.pallas_call, scl_pallas.py:1732).  It
// computes the same thing: min-sum F/G updates, the COMBINE of partial
// sums, and the RATE0 / REP / RATE1 / SPC leaves in their L=1 closed
// forms, with the min-sum path metric.
//
// What bounds it on an H100: the schedule is a chain of ~10k dependent
// micro-ops per wire-size frame (10,252 rows for the mode-6 code), each
// at most 512 columns wide and most of them narrow.  The work per op is
// a few flops per column, so one frame is latency-bound: every op costs
// a barrier plus the latency of its loads.  The design answers with
// parallelism across frames instead of within one: a block per frame,
// 512 threads (one per column of the widest op) and __launch_bounds__
// sized so that four blocks share an SM, so a 512-frame batch runs in
// one wave over the card's 132 SMs and each SM hides one block's stall
// behind the others' work.
//
// State: a wire-size frame has 135,168 LLR slots (65,536 of them the
// channel LLRs) and 204,800 partial-sum slots, more than a block's
// 227 KB of shared memory.  Depth 0 is read straight from the input,
// the deeper LLRs live in a per-frame f32 global scratch, and partial
// sums, which are always +1 or -1, in a per-frame int8 scratch.  Both
// scratches are allocated by the caller; the kernel allocates nothing.
//
// Leaf rules at L=1 (as the Pallas kernel's rate0_core, rep_core and
// spc_core for L == 1):
//   RATE0: beta = +1, pm += sum relu(-a).
//   REP:   beta = -1 only if sum relu(a) < sum relu(-a) strictly;
//          pm += the smaller sum.
//   RATE1: beta = -1 iff a < 0, no penalty.
//   SPC:   hard decisions; on odd parity flip the lowest-index minimum
//          |a| and pm += that |a|.
// Output: codeword bit = (beta < 0) over the root slot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 512;      // widest op; one thread per column
constexpr int kWarps = kChunk / 32;
constexpr int kCols = 14;        // schedule row width

enum Op { OP_F, OP_G, OP_COMBINE, OP_RATE0, OP_REP, OP_RATE1, OP_SPC };
enum Col { C_OP, C_D, C_SRC, C_SRC2, C_DST, C_BSRC, C_BSRC2, C_BDST,
           C_SIDR, C_SIDR2, C_SIDW, C_WIDTH, C_LAST, C_SUB };

__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of two values; every thread gets both results.
__device__ __forceinline__ float2 block_sum2(float x, float y,
                                             float2* red) {
  x = warp_sum(x);
  y = warp_sum(y);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = make_float2(x, y);
  __syncthreads();
  float2 p = lane < kWarps ? red[lane] : make_float2(0.f, 0.f);
  p.x = warp_sum(p.x);
  p.y = warp_sum(p.y);
  __syncthreads();  // red is reused by the next reduction
  return p;
}

// Block-wide (count of negatives, min |a|, its lowest index).
struct SpcAcc {
  int neg;
  float mag;
  int idx;
};

__device__ __forceinline__ SpcAcc spc_merge(SpcAcc a, SpcAcc b) {
  SpcAcc r;
  r.neg = a.neg + b.neg;
  const bool take_b = b.mag < a.mag || (b.mag == a.mag && b.idx < a.idx);
  r.mag = take_b ? b.mag : a.mag;
  r.idx = take_b ? b.idx : a.idx;
  return r;
}

__device__ __forceinline__ SpcAcc warp_spc(SpcAcc v) {
  for (int o = 16; o > 0; o >>= 1) {
    SpcAcc w;
    w.neg = __shfl_xor_sync(0xffffffffu, v.neg, o);
    w.mag = __shfl_xor_sync(0xffffffffu, v.mag, o);
    w.idx = __shfl_xor_sync(0xffffffffu, v.idx, o);
    v = spc_merge(v, w);
  }
  return v;
}

__device__ __forceinline__ SpcAcc block_spc(SpcAcc v, SpcAcc* red) {
  v = warp_spc(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  SpcAcc p = lane < kWarps ? red[lane]
                           : SpcAcc{0, __int_as_float(0x7f800000), kChunk};
  p = warp_spc(p);
  __syncthreads();
  return p;
}

__global__ void __launch_bounds__(kChunk, 4)
sc_decode_kernel(const float* __restrict__ llr_in,
                 const int* __restrict__ ops, int n_ops, int code_len,
                 int d0_len, int llr_len, int beta_len, int out_off,
                 float* llr_scratch, int8_t* beta_scratch,
                 uint8_t* __restrict__ cw_out, float* __restrict__ pm_out) {
  __shared__ float2 red2[kWarps];
  __shared__ SpcAcc red_spc[kWarps];

  const int t = threadIdx.x;
  const size_t frame = blockIdx.x;
  const float* in = llr_in + frame * code_len;
  float* llr = llr_scratch + frame * llr_len;   // offset d0_len and up
  int8_t* beta = beta_scratch + frame * beta_len;

  // LLR read at schedule offset `off`: depth 0 is the input itself.
  auto rd = [&](int off) -> float {
    return off < d0_len ? in[off] : llr[off - d0_len];
  };

  float pm = 0.f;  // path metric, kept by thread 0
  for (int i = 0; i < n_ops; ++i) {
    const int* row = ops + i * kCols;
    const int op = __ldg(row + C_OP);
    const int width = __ldg(row + C_WIDTH);
    const bool act = t < width;
    switch (op) {
      case OP_F: {
        if (act) {
          const float a = rd(__ldg(row + C_SRC) + t);
          const float b = rd(__ldg(row + C_SRC2) + t);
          llr[__ldg(row + C_DST) - d0_len + t] =
              sign_of(a) * sign_of(b) * fminf(fabsf(a), fabsf(b));
        }
        break;
      }
      case OP_G: {
        if (act) {
          const float a = rd(__ldg(row + C_SRC) + t);
          const float b = rd(__ldg(row + C_SRC2) + t);
          const float bl = beta[__ldg(row + C_BSRC) + t];
          llr[__ldg(row + C_DST) - d0_len + t] = b + bl * a;
        }
        break;
      }
      case OP_COMBINE: {
        if (act) {
          const int8_t bl = beta[__ldg(row + C_BSRC) + t];
          const int8_t br = beta[__ldg(row + C_BSRC2) + t];
          beta[__ldg(row + C_BDST) + t] = static_cast<int8_t>(bl * br);
          beta[__ldg(row + C_DST) + t] = br;
        }
        break;
      }
      case OP_RATE0: {
        const float a = act ? rd(__ldg(row + C_SRC) + t) : 0.f;
        const float2 s = block_sum2(fmaxf(-a, 0.f), 0.f, red2);
        if (act) beta[__ldg(row + C_BDST) + t] = 1;
        if (t == 0) pm += s.x;
        break;
      }
      case OP_REP: {
        const float a = act ? rd(__ldg(row + C_SRC) + t) : 0.f;
        const float2 s = block_sum2(fmaxf(-a, 0.f), fmaxf(a, 0.f), red2);
        // s.x = cost of all +1 (m0), s.y = cost of all -1 (m1)
        if (act) beta[__ldg(row + C_BDST) + t] = s.y < s.x ? -1 : 1;
        if (t == 0) pm += fminf(s.x, s.y);
        break;
      }
      case OP_RATE1: {
        if (act) {
          const float a = rd(__ldg(row + C_SRC) + t);
          beta[__ldg(row + C_BDST) + t] = a < 0.f ? -1 : 1;
        }
        break;
      }
      case OP_SPC: {
        const float a = act ? rd(__ldg(row + C_SRC) + t) : 0.f;
        SpcAcc v;
        v.neg = act && a < 0.f;
        v.mag = act ? fabsf(a) : __int_as_float(0x7f800000);
        v.idx = act ? t : kChunk;
        const SpcAcc s = block_spc(v, red_spc);
        const bool odd = s.neg & 1;
        if (act) {
          int8_t b = a < 0.f ? -1 : 1;
          if (odd && t == s.idx) b = -b;
          beta[__ldg(row + C_BDST) + t] = b;
        }
        if (t == 0 && odd) pm += s.mag;
        break;
      }
      default:
        break;
    }
    __syncthreads();
  }

  uint8_t* cw = cw_out + frame * code_len;
  for (int j = t; j < code_len; j += kChunk) cw[j] = beta[out_off + j] < 0;
  if (t == 0) pm_out[frame] = pm;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t.  Launches one block per frame on `stream`
// without synchronising, and returns cudaGetLastError() as an int.
extern "C" int sc_decode_launch(const void* llrs, const void* ops, int n_ops,
                                int code_len, int d0_len, int llr_len,
                                int beta_len, int out_off, void* llr_scratch,
                                void* beta_scratch, void* cw, void* pm,
                                int batch, void* stream) {
  if (batch > 0) {
    sc_decode_kernel<<<batch, kChunk, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(llrs), static_cast<const int*>(ops), n_ops,
        code_len, d0_len, llr_len, beta_len, out_off,
        static_cast<float*>(llr_scratch),
        static_cast<int8_t*>(beta_scratch), static_cast<uint8_t*>(cw),
        static_cast<float*>(pm));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sc_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
