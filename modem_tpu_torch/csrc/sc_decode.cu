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
// rows per wire-size frame (10,252 for the mode-6 code), each at most 512
// columns wide and most of them narrow (7,458 of 10,252 are at most 32
// columns, in 294 runs; the mean is 94).  A row does a few flops a
// column, so one frame is latency-bound: each row costs the latency of its
// loads and stores, of fetching it, of its barriers and of its dispatch.
// Frames run in parallel instead: a block per frame, four blocks to an SM
// (__launch_bounds__ and the shared budget below), so a 512-frame batch
// runs in one wave over the 132 SMs.  What is left is the latency of one
// frame's chain of rows, and the design shortens each link:
//
// - Tiered state.  A wire-size frame has 135,168 LLR slots (65,536 of them
//   the channel LLRs) and 204,800 partial-sum slots, more than a block's
//   shared memory.  But the 960 rows at depths < 5 are the only ones that
//   touch the large regions; the other 9,292 touch depths >= 5 only, 8,192
//   LLR slots and 16,384 beta slots (48 KB with int8 betas).  So the
//   regions of depths >= D_s (LLR offsets from llr_lo, beta offsets from
//   beta_lo: regions grow with depth, so each tier is one range) live in
//   the block's dynamic shared memory, zeroed at the start, and the
//   depths below in a per-frame global scratch; depth 0 is read from the
//   input and the root codeword is written to the global betas.  The host
//   picks D_s (kernels/sc_decode.py tiers_of) so the int8 instance keeps
//   four blocks to an SM (mode 6: D_s = 5, 48 KB); the f32-beta instance
//   takes the D_s that fits the same budget (mode 6: 8, 54 KB).  Every
//   access picks its tier by comparing its offset with the threshold, so
//   any table (override tables too) lands in the right tier; nothing is
//   copied between tiers.  The shared tier is reached by ld/st.shared on
//   32-bit addresses held in registers (lds, sts below).
// - Narrow rows on one warp.  The host marks each run of consecutive
//   rows of width <= 32 that lie wholly in the shared tier (cut at
//   kRunRows rows) at its first row; warp 0 stages the run's rows in
//   shared memory with one load a lane, then runs them alone through a
//   code path with no global tier, __syncwarp between rows and leaf
//   reductions by shuffles, while the other warps wait at one block
//   barrier that closes the run.
// - Wide rows on a block of kThreads = 256 threads, kPer = 2 columns a
//   thread, both columns' loads in flight before either store; one block
//   barrier ends a row, and a leaf's reduction adds one (double-buffered
//   partials).  256 threads, not 512, leave 64 registers a thread at four
//   blocks an SM (512 threads have 32) and halve the warps that contend
//   for an SM when four frames share it.
// - A packed row stream.  The table (pack_rows) holds a row in 16 bytes
//   (offsets in 18 bits, width in 10, opcode in 3, the run length in 7),
//   164 KB for mode 6 instead of 574; a wide row loads the next row
//   while it runs.
// What the card measured for each choice, by row class, is in PERF.md
// (profile_card.py --rows).

// Leaf rules at L=1 (as the Pallas kernel's rate0_core, rep_core and
// spc_core for L == 1):
//   RATE0: beta = +1, pm += sum relu(-a).
//   REP:   beta = -1 only if sum relu(a) < sum relu(-a) strictly;
//          pm += the smaller sum.
//   RATE1: beta = -1 iff a < 0, no penalty.
//   SPC:   hard decisions; on odd parity flip the lowest-index minimum
//          |a| and pm += that |a|.
// Output: codeword bit = (beta < 0) over the root slot.  A narrow row's
// sums equal the block's bit for bit (the other warps add exact zeros),
// so the codewords do not depend on which group ran a row.
//
// The options of that call (kernel C'): the partial sums' element type
// is a template parameter (int8, or f32 for beta_bf16=False), and
// kernels/unroll.py embeds this file, with -DSC_DECODE_UNROLLED defined
// first, to expand one schedule into straight-line unrolled_row calls on
// rows of literals (unroll=True); the interpreter and its entry points
// are then left out.

#include <cuda_runtime.h>
#include <stdint.h>

// Per-row profile hook: profile_card.py --rows defines both macros ahead of
// this file (the clock64() cycles of each row by key, thread 0 of block
// 0; here the key is profile_key's); everywhere else they expand to
// nothing.
#ifndef ROW_PROFILE_BEGIN
#define ROW_PROFILE_BEGIN()
#define ROW_PROFILE_END(key)
#endif

// The block's dynamic shared memory: the shared tier, Geom's LLR slots
// then its beta slots.
extern __shared__ __align__(16) unsigned char sc_tier[];

namespace {

constexpr int kChunk = 512;      // widest row (columns)
constexpr int kThreads = 256;    // a block: kPer columns a thread
constexpr int kPer = kChunk / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kChunk / 32;   // 32-column groups of a row
constexpr int kRunRows = 64;     // the longest narrow run (RUN_MAX)
constexpr unsigned kFull = 0xffffffffu;

enum Op { OP_F, OP_G, OP_COMBINE, OP_RATE0, OP_REP, OP_RATE1, OP_SPC };
enum Col { C_OP, C_D, C_SRC, C_SRC2, C_DST, C_BSRC, C_BSRC2, C_BDST,
           C_SIDR, C_SIDR2, C_SIDW, C_WIDTH, C_LAST, C_SUB };

__device__ __forceinline__ float inf_f() {
  return __int_as_float(0x7f800000);
}

// sign(a) * sign(b) * m for m >= 0: m with the sign bit of a * b (a
// zero a or b has m = 0, and the zero's sign is never read).
__device__ __forceinline__ float signed_min(float a, float b, float m) {
  return __uint_as_float(
      ((__float_as_uint(a) ^ __float_as_uint(b)) & 0x80000000u) |
      __float_as_uint(m));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// warp_sum of x and, if `two`, of y, their steps side by side.  Only the
// lanes below `span` hold values (the others zeros), so the steps that
// would pair a lane below it with a zero are left out: v + 0 is v, and
// the lanes below get the full butterfly's sums bit for bit.
__device__ __forceinline__ float2 warp_sum2(float x, float y, bool two,
                                            int span) {
  for (int o = 16; o > 0; o >>= 1) {
    if (o >= span) continue;
    x += __shfl_xor_sync(kFull, x, o);
    if (two) y += __shfl_xor_sync(kFull, y, o);
  }
  return make_float2(x, y);
}

// Block-wide sums of two values a column, x[k] and y[k] of column t + k *
// kThreads, through one half of the double-buffered partials; every
// thread gets both results after one barrier.  Each 32-column group is
// summed by one warp's butterfly and the kGroups group sums by another,
// so the sums do not depend on kThreads.
template <int K>
__device__ __forceinline__ float2 block_sum2(const float (&x)[K],
                                             const float (&y)[K],
                                             float2* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float sx = warp_sum(x[k]), sy = warp_sum(y[k]);
    if (lane == 0) red[warp + k * kWarps] = make_float2(sx, sy);
  }
  __syncthreads();
  float2 p = lane < kGroups ? red[lane] : make_float2(0.f, 0.f);
  p.x = warp_sum(p.x);
  p.y = warp_sum(p.y);
  return p;
}

// (count of negatives, min |a|, its lowest index).
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

// Merged over the warp; `span` as warp_sum's, with the merge's identity
// in the lanes from it on.
__device__ __forceinline__ SpcAcc warp_spc(SpcAcc v, int span = 32) {
  for (int o = 16; o > 0; o >>= 1) {
    if (o >= span) continue;
    SpcAcc w;
    w.neg = __shfl_xor_sync(kFull, v.neg, o);
    w.mag = __shfl_xor_sync(kFull, v.mag, o);
    w.idx = __shfl_xor_sync(kFull, v.idx, o);
    v = spc_merge(v, w);
  }
  return v;
}

// The merge is exact in any order, so a thread merges its own columns
// first.
__device__ __forceinline__ SpcAcc block_spc(SpcAcc v, SpcAcc* red) {
  v = warp_spc(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const SpcAcc p = lane < kWarps ? red[lane] : SpcAcc{0, inf_f(), kChunk};
  return warp_spc(p);
}

// A schedule row.  The interpreter unpacks its columns from the packed
// table (kernels/sc_decode.py pack_rows), 16 bytes a row:
//   lo = SRC | SRC2 << 18 | DST << 36 | WIDTH << 54
//   hi = BSRC | BSRC2 << 18 | BDST << 36 | OP << 54 | RUN << 57
// where RUN > 0 marks the first row of a run of RUN narrow rows for warp
// 0, all in the shared tier.  An unrolled kernel passes each row as 14
// literals, which the compiler folds into the inlined body.
constexpr uint64_t kField = (1u << 18) - 1;

struct PackedRow {
  uint64_t lo, hi;

  __device__ __forceinline__ explicit PackedRow(uint4 q)
      : lo(q.x | static_cast<uint64_t>(q.y) << 32),
        hi(q.z | static_cast<uint64_t>(q.w) << 32) {}

  __device__ __forceinline__ int operator[](int c) const {
    switch (c) {
      case C_OP: return static_cast<int>((hi >> 54) & 7);
      case C_SRC: return static_cast<int>(lo & kField);
      case C_SRC2: return static_cast<int>((lo >> 18) & kField);
      case C_DST: return static_cast<int>((lo >> 36) & kField);
      case C_WIDTH: return static_cast<int>(lo >> 54);
      case C_BSRC: return static_cast<int>(hi & kField);
      case C_BSRC2: return static_cast<int>((hi >> 18) & kField);
      case C_BDST: return static_cast<int>((hi >> 36) & kField);
      default: return 0;  // depth, slot ids, flags: not read at L = 1
    }
  }
  __device__ __forceinline__ int run() const {
    return static_cast<int>(hi >> 57);
  }
};

#ifdef SC_DECODE_UNROLLED
constexpr int kCols = 14;        // schedule row width

struct LitRow {
  int v[kCols];
  __device__ __forceinline__ int operator[](int c) const { return v[c]; }
};
#endif

struct Shared {
  float2 red2[2][kGroups];
  SpcAcc red_spc[2][kWarps];
  uint4 run_rows[kRunRows];   // the narrow run warp 0 is in, staged
};
// the host's shared budget (kernels/sc_decode.py STATIC_SHARED) holds it
static_assert(sizeof(Shared) <= 2048, "static shared memory over budget");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint4 lds_row(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ void sts_row(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The shared tier is read and written by ld.shared / st.shared on 32-bit
// shared-window addresses kept in registers.  Through a C++ pointer or
// the array itself, nvcc rebuilds the window address before every access
// the tier branch guards (S2R SR_CgaCtaId and three more instructions on
// the row's critical path).  Stores clobber memory, so no load moves
// across them.
template <typename T>
__device__ __forceinline__ T lds(uint32_t a);

template <>
__device__ __forceinline__ float lds<float>(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

template <>
__device__ __forceinline__ int8_t lds<int8_t>(uint32_t a) {
  int v;
  asm volatile("ld.shared.s8 %0, [%1];" : "=r"(v) : "r"(a));
  return static_cast<int8_t>(v);
}

__device__ __forceinline__ void sts(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}

__device__ __forceinline__ void sts(uint32_t a, int8_t v) {
  asm volatile("st.shared.s8 [%0], %1;" ::"r"(a), "r"(static_cast<int>(v))
               : "memory");
}

// Where a frame's state lives (computed on the host, tiers_of).
struct Geom {
  int code_len;    // channel LLRs a frame
  int d0_len;      // LLR offsets below this are depth 0: the input
  int llr_lo;      // LLR offsets from here on are in shared memory
  int beta_lo;     // beta offsets from here on are in shared memory
  int s_llr_len;   // shared LLR slots (f32), first in shared memory
  int s_beta_len;  // shared beta slots (BetaT), after them
  int out_off;     // beta offset of the root codeword (global tier)
};

// One frame's view of its state; pm is kept by thread 0.
template <typename BetaT>
struct Frame {
  const float* in;    // depth 0
  float* g_llr;       // global tier, LLR offsets [d0_len, llr_lo)
  BetaT* g_beta;      // global tier, beta offsets [0, beta_lo)
  int d0_len, llr_lo, beta_lo;
  uint32_t s_llr;     // shared tier, LLR offsets [llr_lo, ...): address
  uint32_t s_beta;    // shared tier, beta offsets [beta_lo, ...): address
  int red;            // the half of Shared's partials the next reduction takes
  float pm;

  __device__ __forceinline__ uint32_t s_llr_at(int off) const {
    return s_llr + static_cast<uint32_t>(off - llr_lo) * sizeof(float);
  }
  __device__ __forceinline__ uint32_t s_beta_at(int off) const {
    return s_beta + static_cast<uint32_t>(off - beta_lo) * sizeof(BetaT);
  }
};

// A frame's LLR and partial sum at a schedule offset, read and written in
// the tier the offset lies in; kShared when the caller knows it is the
// shared one, which leaves the test and the global path out.
template <bool kShared, typename BetaT>
__device__ __forceinline__ float rd(const Frame<BetaT>& f, int off) {
  if (kShared || off >= f.llr_lo) return lds<float>(f.s_llr_at(off));
  return off < f.d0_len ? __ldg(f.in + off) : f.g_llr[off - f.d0_len];
}

template <bool kShared, typename BetaT>
__device__ __forceinline__ void wr(const Frame<BetaT>& f, int off, float v) {
  if (kShared || off >= f.llr_lo) {
    sts(f.s_llr_at(off), v);
  } else {
    f.g_llr[off - f.d0_len] = v;
  }
}

template <bool kShared, typename BetaT>
__device__ __forceinline__ BetaT rb(const Frame<BetaT>& f, int off) {
  if (kShared || off >= f.beta_lo) return lds<BetaT>(f.s_beta_at(off));
  return f.g_beta[off];
}

template <bool kShared, typename BetaT>
__device__ __forceinline__ void wb(const Frame<BetaT>& f, int off, BetaT v) {
  if (kShared || off >= f.beta_lo) {
    sts(f.s_beta_at(off), v);
  } else {
    f.g_beta[off] = v;
  }
}

// Whether every slot a row reads or writes lies in the shared tier (the
// row's offsets are where its ranges start, and tiers are single ranges;
// kernels/sc_decode.py in_shared_tier is the host's copy).
template <typename BetaT, typename Row>
__device__ __forceinline__ bool in_shared(const Frame<BetaT>& f,
                                          const Row& row) {
  const int op = row[C_OP];
  if (op == OP_COMBINE) {
    return row[C_BSRC] >= f.beta_lo && row[C_BSRC2] >= f.beta_lo &&
           row[C_BDST] >= f.beta_lo && row[C_DST] >= f.beta_lo;
  }
  if (row[C_SRC] < f.llr_lo) return false;
  if (op == OP_F) return row[C_SRC2] >= f.llr_lo && row[C_DST] >= f.llr_lo;
  if (op == OP_G) {
    return row[C_SRC2] >= f.llr_lo && row[C_DST] >= f.llr_lo &&
           row[C_BSRC] >= f.beta_lo;
  }
  return row[C_BDST] >= f.beta_lo;
}

// sc_tier must hold Geom's shared bytes.
template <typename BetaT>
__device__ __forceinline__ Frame<BetaT> frame_begin(
    const Geom& g, const float* llr_in, float* llr_scratch,
    BetaT* beta_scratch) {
  const size_t frame = blockIdx.x;
  Frame<BetaT> f;
  f.in = llr_in + frame * g.code_len;
  f.g_llr = llr_scratch + frame * (g.llr_lo - g.d0_len);
  f.g_beta = beta_scratch + frame * g.beta_lo;
  f.d0_len = g.d0_len;
  f.llr_lo = g.llr_lo;
  f.beta_lo = g.beta_lo;
  f.s_llr = static_cast<uint32_t>(__cvta_generic_to_shared(sc_tier));
  f.s_beta = f.s_llr + static_cast<uint32_t>(sizeof(float) * g.s_llr_len);
  f.red = 0;
  f.pm = 0.f;
  // the shared tier starts from zeros, as the plain version's buffers do
  const int words = static_cast<int>(
      (sizeof(float) * g.s_llr_len + sizeof(BetaT) * g.s_beta_len) / 16);
  for (int e = threadIdx.x; e < words; e += kThreads) {
    reinterpret_cast<uint4*>(sc_tier)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  return f;
}

template <typename BetaT>
__device__ __forceinline__ void frame_end(const Frame<BetaT>& f,
                                          const Geom& g,
                                          uint8_t* __restrict__ cw_out,
                                          float* __restrict__ pm_out) {
  const int t = threadIdx.x;
  const size_t frame = blockIdx.x;
  uint8_t* cw = cw_out + frame * g.code_len;
  for (int j = t; j < g.code_len; j += kThreads) {
    cw[j] = f.g_beta[g.out_off + j] < 0;
  }
  if (t == 0) pm_out[frame] = f.pm;
}

// A leaf's sums of x and y: by shuffles on warp 0 (kWarp: one column a
// lane, `width` of them; y only if `two`), else over the block.
template <bool kWarp, int K, typename BetaT>
__device__ __forceinline__ float2 leaf_sum2(Frame<BetaT>& f, Shared& s,
                                            const float (&x)[K],
                                            const float (&y)[K], bool two,
                                            int width) {
  if constexpr (kWarp) return warp_sum2(x[0], y[0], two, width);
  const float2 r = block_sum2<K>(x, y, s.red2[f.red]);
  f.red ^= 1;
  return r;
}

template <bool kWarp, typename BetaT>
__device__ __forceinline__ SpcAcc leaf_spc(Frame<BetaT>& f, Shared& s,
                                           SpcAcc v, int width) {
  if constexpr (kWarp) return warp_spc(v, width);
  const SpcAcc r = block_spc(v, s.red_spc[f.red]);
  f.red ^= 1;
  return r;
}

// One schedule row, on the whole block (thread t holds columns t + k *
// kThreads) or (kWarp) on warp 0 alone, which then holds every column
// (width <= 32); kShared if the row lies in the shared tier, as the rows
// of a narrow run do (the host marks no others).  A thread loads all its
// columns before it stores any, so their loads are in flight together.
// The caller places the barrier that ends the row.
template <bool kWarp, bool kShared, typename BetaT, typename Row>
__device__ __forceinline__ void run_row(Frame<BetaT>& f, Shared& s,
                                        const Row& row) {
  constexpr int K = kWarp ? 1 : kPer;
  const int t = threadIdx.x;
  const int op = row[C_OP];
  const int width = row[C_WIDTH];
  int col[K];
  bool act[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    col[k] = t + k * kThreads;
    act[k] = col[k] < width;
  }
  switch (op) {
    case OP_F: {
      float a[K], b[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!act[k]) continue;
        a[k] = rd<kShared>(f, row[C_SRC] + col[k]);
        b[k] = rd<kShared>(f, row[C_SRC2] + col[k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!act[k]) continue;
        wr<kShared>(f, row[C_DST] + col[k],
                    signed_min(a[k], b[k], fminf(fabsf(a[k]), fabsf(b[k]))));
      }
      break;
    }
    case OP_G: {
      float a[K], b[K], bl[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!act[k]) continue;
        a[k] = rd<kShared>(f, row[C_SRC] + col[k]);
        b[k] = rd<kShared>(f, row[C_SRC2] + col[k]);
        bl[k] = static_cast<float>(rb<kShared>(f, row[C_BSRC] + col[k]));
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!act[k]) continue;
        wr<kShared>(f, row[C_DST] + col[k], b[k] + bl[k] * a[k]);
      }
      break;
    }
    case OP_COMBINE: {
      BetaT bl[K], br[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!act[k]) continue;
        bl[k] = rb<kShared>(f, row[C_BSRC] + col[k]);
        br[k] = rb<kShared>(f, row[C_BSRC2] + col[k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!act[k]) continue;
        wb<kShared>(f, row[C_BDST] + col[k],
                    static_cast<BetaT>(bl[k] * br[k]));
        wb<kShared>(f, row[C_DST] + col[k], br[k]);
      }
      break;
    }
    case OP_RATE0:
    case OP_REP: {
      // x = cost of all +1 (m0), y = cost of all -1 (m1)
      float x[K], y[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float a = act[k] ? rd<kShared>(f, row[C_SRC] + col[k]) : 0.f;
        x[k] = fmaxf(-a, 0.f);
        y[k] = op == OP_REP ? fmaxf(a, 0.f) : 0.f;
      }
      const float2 sum =
          leaf_sum2<kWarp, K>(f, s, x, y, op == OP_REP, width);
      const bool flip = op == OP_REP && sum.y < sum.x;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (act[k]) {
          wb<kShared>(f, row[C_BDST] + col[k],
                      static_cast<BetaT>(flip ? -1 : 1));
        }
      }
      if (t == 0) f.pm += op == OP_REP ? fminf(sum.x, sum.y) : sum.x;
      break;
    }
    case OP_RATE1: {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!act[k]) continue;
        const float a = rd<kShared>(f, row[C_SRC] + col[k]);
        wb<kShared>(f, row[C_BDST] + col[k],
                    static_cast<BetaT>(a < 0.f ? -1 : 1));
      }
      break;
    }
    case OP_SPC: {
      float a[K];
      SpcAcc v{0, inf_f(), kChunk};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a[k] = act[k] ? rd<kShared>(f, row[C_SRC] + col[k]) : 0.f;
        if (act[k]) {
          v = spc_merge(v, SpcAcc{a[k] < 0.f, fabsf(a[k]), col[k]});
        }
      }
      const SpcAcc r = leaf_spc<kWarp>(f, s, v, width);
      const bool odd = r.neg & 1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!act[k]) continue;
        int b = a[k] < 0.f ? -1 : 1;
        if (odd && col[k] == r.idx) b = -b;
        wb<kShared>(f, row[C_BDST] + col[k], static_cast<BetaT>(b));
      }
      if (t == 0 && odd) f.pm += r.mag;
      break;
    }
    default:
      break;
  }
}

// The key the row profile files a row under: its opcode, + 8 if warp 0
// ran it alone, + 16 if it touches the global tier (or the input).
template <bool kWarp, typename BetaT, typename Row>
__device__ __forceinline__ int profile_key(const Frame<BetaT>& f,
                                           const Row& row) {
  return row[C_OP] + (kWarp ? 8 : 0) + (in_shared(f, row) ? 0 : 16);
}

// One row on the whole block, then the block barrier: a wide row of the
// interpreter.
template <typename BetaT, typename Row>
__device__ __forceinline__ void block_row(Frame<BetaT>& f, Shared& s,
                                          const Row& row) {
  run_row<false, false, BetaT>(f, s, row);
  __syncthreads();
}

#ifdef SC_DECODE_UNROLLED
// A row of an unrolled kernel, on the whole block, then the block
// barrier.  Its offsets are literals, so in_shared folds and the row
// compiles to one tier's code.
template <typename BetaT>
__device__ __forceinline__ void unrolled_row(Frame<BetaT>& f, Shared& s,
                                             const LitRow& row) {
  if (in_shared(f, row)) {
    run_row<false, true, BetaT>(f, s, row);
  } else {
    run_row<false, false, BetaT>(f, s, row);
  }
  __syncthreads();
}
#endif

#ifndef SC_DECODE_UNROLLED

template <typename BetaT>
__global__ void __launch_bounds__(kThreads, 4)
sc_decode_kernel(const float* __restrict__ llr_in,
                 const uint4* __restrict__ rows, int n_rows, Geom g,
                 float* llr_scratch, BetaT* beta_scratch,
                 uint8_t* __restrict__ cw_out, float* __restrict__ pm_out) {
  __shared__ Shared s;
  Frame<BetaT> f = frame_begin<BetaT>(g, llr_in, llr_scratch, beta_scratch);
  const bool warp0 = threadIdx.x < 32;
  uint4 cur = __ldg(rows);
  for (int i = 0; i < n_rows;) {
    const int run = PackedRow(cur).run();
    if (run == 0) {
      const uint4 next = __ldg(rows + i + 1);
      const PackedRow row(cur);
      ROW_PROFILE_BEGIN();
      block_row<BetaT>(f, s, row);
      ROW_PROFILE_END((profile_key<false, BetaT>(f, row)));
      cur = next;
      ++i;
      continue;
    }
    // a run of narrow rows: warp 0 alone, the others wait at its end.
    // Warp 0 stages the run's rows in shared memory, one load a lane, so
    // that a row is a shared load away, not a global one.
    const uint4 after = __ldg(rows + i + run);
    if (warp0) {
      const uint32_t staged = smem_addr(s.run_rows);
      for (int r = threadIdx.x; r < run; r += 32) {
        sts_row(staged + 16u * r, __ldg(rows + i + r));
      }
      __syncwarp();
      uint4 next = lds_row(staged);
      for (int j = 0; j < run; ++j) {
        const PackedRow row(next);
        if (j + 1 < run) next = lds_row(staged + 16u * (j + 1));
        ROW_PROFILE_BEGIN();
        run_row<true, true, BetaT>(f, s, row);
        __syncwarp();
        ROW_PROFILE_END((profile_key<true, BetaT>(f, row)));
      }
    }
    cur = after;
    i += run;
    __syncthreads();
  }
  frame_end<BetaT>(f, g, cw_out, pm_out);
}

template <typename BetaT>
size_t shared_bytes(const Geom& g) {
  return sizeof(float) * g.s_llr_len + sizeof(BetaT) * g.s_beta_len;
}

// The kernel's shared-memory attributes for `bytes` of dynamic shared
// memory: the limit raised past the 48 KB default, and the carve-out at
// its most so that four blocks fit an SM.
template <typename BetaT>
cudaError_t prepare(size_t bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      sc_decode_kernel<BetaT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(sc_decode_kernel<BetaT>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename BetaT>
cudaError_t launch(const void* llrs, const void* rows, int n_rows,
                   const Geom& g, void* llr_scratch, void* beta_scratch,
                   void* cw, void* pm, int batch, cudaStream_t stream) {
  const size_t bytes = shared_bytes<BetaT>(g);
  const cudaError_t e = prepare<BetaT>(bytes);
  if (e != cudaSuccess) return e;
  sc_decode_kernel<BetaT><<<batch, kThreads, bytes, stream>>>(
      static_cast<const float*>(llrs), static_cast<const uint4*>(rows),
      n_rows, g, static_cast<float*>(llr_scratch),
      static_cast<BetaT*>(beta_scratch), static_cast<uint8_t*>(cw),
      static_cast<float*>(pm));
  return cudaGetLastError();
}

template <typename BetaT>
cudaError_t occupancy(const Geom& g, int* blocks) {
  const size_t bytes = shared_bytes<BetaT>(g);
  const cudaError_t e = prepare<BetaT>(bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sc_decode_kernel<BetaT>, kThreads, bytes);
}

#endif  // SC_DECODE_UNROLLED

}  // namespace

#ifndef SC_DECODE_UNROLLED

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t; `rows` is the packed table, n_rows rows
// plus the padding.  `beta_f32` nonzero keeps the partial sums in f32
// (the beta scratch and the shared tier's betas are then float, else
// int8).  The geometry is tiers_of's: the global scratch holds
// llr_lo - d0_len LLRs and beta_lo betas a frame.  Launches one block per
// frame on `stream` without synchronising, and returns cudaGetLastError()
// (or the error of setting the shared-memory attributes) as an int.
extern "C" int sc_decode_launch(const void* llrs, const void* rows,
                                int n_rows, int code_len, int d0_len,
                                int llr_lo, int beta_lo, int s_llr_len,
                                int s_beta_len, int out_off, int beta_f32,
                                void* llr_scratch, void* beta_scratch,
                                void* cw, void* pm, int batch,
                                void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  const Geom g{code_len, d0_len, llr_lo, beta_lo,
               s_llr_len, s_beta_len, out_off};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      beta_f32 ? launch<float>(llrs, rows, n_rows, g, llr_scratch,
                               beta_scratch, cw, pm, batch, s)
               : launch<int8_t>(llrs, rows, n_rows, g, llr_scratch,
                                beta_scratch, cw, pm, batch, s));
}

// The blocks of the kernel an SM holds at once for that shared tier
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int sc_decode_occupancy(int s_llr_len, int s_beta_len,
                                   int beta_f32, int* blocks) {
  const Geom g{0, 0, 0, 0, s_llr_len, s_beta_len, 0};
  return static_cast<int>(beta_f32 ? occupancy<float>(g, blocks)
                                   : occupancy<int8_t>(g, blocks));
}

extern "C" const char* sc_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // SC_DECODE_UNROLLED
