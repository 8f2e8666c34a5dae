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
// sums, which are always +1 or -1, in a per-frame int8 (or f32) scratch.  Both
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
//
// The options of that call (kernel C'): the partial sums' element type
// is a template parameter (int8, or f32 for beta_bf16=False), and
// kernels/unroll.py embeds this file, with -DSC_DECODE_UNROLLED defined
// first, to expand one schedule into straight-line calls of run_row
// (unroll=True); the interpreter and its entry points are then left out.

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

// A schedule row: the interpreter reads its columns from the table as it
// needs them; an unrolled kernel passes each row as literals, which the
// compiler folds into the inlined body.
struct TableRow {
  const int* p;
  __device__ __forceinline__ int operator[](int c) const {
    return __ldg(p + c);
  }
};

struct LitRow {
  int v[kCols];
  __device__ __forceinline__ int operator[](int c) const { return v[c]; }
};

struct Shared {
  float2 red2[kWarps];
  SpcAcc red_spc[kWarps];
};

// One frame's view of the global buffers; pm is kept by thread 0.
template <typename BetaT>
struct Frame {
  const float* in;
  float* llr;   // offset d0_len and up
  BetaT* beta;
  int d0_len;
  float pm;

  // LLR read at schedule offset `off`: depth 0 is the input itself.
  __device__ __forceinline__ float rd(int off) const {
    return off < d0_len ? in[off] : llr[off - d0_len];
  }
};

template <typename BetaT>
__device__ __forceinline__ Frame<BetaT> frame_begin(
    const float* llr_in, int code_len, int d0_len, int llr_len,
    int beta_len, float* llr_scratch, BetaT* beta_scratch) {
  const size_t frame = blockIdx.x;
  return Frame<BetaT>{llr_in + frame * code_len,
                      llr_scratch + frame * llr_len,
                      beta_scratch + frame * beta_len, d0_len, 0.f};
}

template <typename BetaT>
__device__ __forceinline__ void frame_end(const Frame<BetaT>& f,
                                          int code_len, int out_off,
                                          uint8_t* __restrict__ cw_out,
                                          float* __restrict__ pm_out) {
  const int t = threadIdx.x;
  const size_t frame = blockIdx.x;
  uint8_t* cw = cw_out + frame * code_len;
  for (int j = t; j < code_len; j += kChunk) cw[j] = f.beta[out_off + j] < 0;
  if (t == 0) pm_out[frame] = f.pm;
}

// One schedule row, ending in a block barrier.
template <typename BetaT, typename Row>
__device__ __forceinline__ void run_row(Frame<BetaT>& f, Shared& s,
                                        const Row& row) {
  const int t = threadIdx.x;
  const int op = row[C_OP];
  const int width = row[C_WIDTH];
  const bool act = t < width;
  BetaT* beta = f.beta;
  switch (op) {
    case OP_F: {
      if (act) {
        const float a = f.rd(row[C_SRC] + t);
        const float b = f.rd(row[C_SRC2] + t);
        f.llr[row[C_DST] - f.d0_len + t] =
            sign_of(a) * sign_of(b) * fminf(fabsf(a), fabsf(b));
      }
      break;
    }
    case OP_G: {
      if (act) {
        const float a = f.rd(row[C_SRC] + t);
        const float b = f.rd(row[C_SRC2] + t);
        const float bl = static_cast<float>(beta[row[C_BSRC] + t]);
        f.llr[row[C_DST] - f.d0_len + t] = b + bl * a;
      }
      break;
    }
    case OP_COMBINE: {
      if (act) {
        const BetaT bl = beta[row[C_BSRC] + t];
        const BetaT br = beta[row[C_BSRC2] + t];
        beta[row[C_BDST] + t] = static_cast<BetaT>(bl * br);
        beta[row[C_DST] + t] = br;
      }
      break;
    }
    case OP_RATE0: {
      const float a = act ? f.rd(row[C_SRC] + t) : 0.f;
      const float2 sum = block_sum2(fmaxf(-a, 0.f), 0.f, s.red2);
      if (act) beta[row[C_BDST] + t] = static_cast<BetaT>(1);
      if (t == 0) f.pm += sum.x;
      break;
    }
    case OP_REP: {
      const float a = act ? f.rd(row[C_SRC] + t) : 0.f;
      const float2 sum = block_sum2(fmaxf(-a, 0.f), fmaxf(a, 0.f), s.red2);
      // sum.x = cost of all +1 (m0), sum.y = cost of all -1 (m1)
      if (act) beta[row[C_BDST] + t] = static_cast<BetaT>(sum.y < sum.x ? -1 : 1);
      if (t == 0) f.pm += fminf(sum.x, sum.y);
      break;
    }
    case OP_RATE1: {
      if (act) {
        const float a = f.rd(row[C_SRC] + t);
        beta[row[C_BDST] + t] = static_cast<BetaT>(a < 0.f ? -1 : 1);
      }
      break;
    }
    case OP_SPC: {
      const float a = act ? f.rd(row[C_SRC] + t) : 0.f;
      SpcAcc v;
      v.neg = act && a < 0.f;
      v.mag = act ? fabsf(a) : __int_as_float(0x7f800000);
      v.idx = act ? t : kChunk;
      const SpcAcc r = block_spc(v, s.red_spc);
      const bool odd = r.neg & 1;
      if (act) {
        int b = a < 0.f ? -1 : 1;
        if (odd && t == r.idx) b = -b;
        beta[row[C_BDST] + t] = static_cast<BetaT>(b);
      }
      if (t == 0 && odd) f.pm += r.mag;
      break;
    }
    default:
      break;
  }
  __syncthreads();
}

#ifndef SC_DECODE_UNROLLED

template <typename BetaT>
__global__ void __launch_bounds__(kChunk, 4)
sc_decode_kernel(const float* __restrict__ llr_in,
                 const int* __restrict__ ops, int n_ops, int code_len,
                 int d0_len, int llr_len, int beta_len, int out_off,
                 float* llr_scratch, BetaT* beta_scratch,
                 uint8_t* __restrict__ cw_out, float* __restrict__ pm_out) {
  __shared__ Shared s;
  Frame<BetaT> f = frame_begin<BetaT>(llr_in, code_len, d0_len, llr_len,
                                      beta_len, llr_scratch, beta_scratch);
  for (int i = 0; i < n_ops; ++i) {
    run_row<BetaT>(f, s, TableRow{ops + i * kCols});
  }
  frame_end<BetaT>(f, code_len, out_off, cw_out, pm_out);
}

template <typename BetaT>
void launch(const void* llrs, const void* ops, int n_ops, int code_len,
            int d0_len, int llr_len, int beta_len, int out_off,
            void* llr_scratch, void* beta_scratch, void* cw, void* pm,
            int batch, cudaStream_t stream) {
  sc_decode_kernel<BetaT><<<batch, kChunk, 0, stream>>>(
      static_cast<const float*>(llrs), static_cast<const int*>(ops), n_ops,
      code_len, d0_len, llr_len, beta_len, out_off,
      static_cast<float*>(llr_scratch), static_cast<BetaT*>(beta_scratch),
      static_cast<uint8_t*>(cw), static_cast<float*>(pm));
}

#endif  // SC_DECODE_UNROLLED

}  // namespace

#ifndef SC_DECODE_UNROLLED

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t.  `beta_f32` nonzero keeps the partial sums
// in f32 (the beta scratch is then float, else int8).  Launches one block
// per frame on `stream` without synchronising, and returns
// cudaGetLastError() as an int.
extern "C" int sc_decode_launch(const void* llrs, const void* ops, int n_ops,
                                int code_len, int d0_len, int llr_len,
                                int beta_len, int out_off, int beta_f32,
                                void* llr_scratch, void* beta_scratch,
                                void* cw, void* pm, int batch,
                                void* stream) {
  if (batch > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (beta_f32) {
      launch<float>(llrs, ops, n_ops, code_len, d0_len, llr_len, beta_len,
                    out_off, llr_scratch, beta_scratch, cw, pm, batch, s);
    } else {
      launch<int8_t>(llrs, ops, n_ops, code_len, d0_len, llr_len, beta_len,
                     out_off, llr_scratch, beta_scratch, cw, pm, batch, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sc_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // SC_DECODE_UNROLLED
