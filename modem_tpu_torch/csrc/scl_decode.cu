// Successive-cancellation list (SCL) decode of a polar code, one thread
// block per frame, interpreting the schedule of fec/schedule.py over L
// list lanes.  Template parameters: L = 2, 4 or 8; kExact, which picks
// the RATE1 / SPC leaf rule; kRank, which picks how the exact leaf
// selects; BetaT, the element type of the partial sums (int8 or f32).
//
// Replaces the list_size > 1 instances of the TPU Pallas kernel
// modem_tpu/kernels/scl_pallas.py (make_pallas_decoder(frozen, L, exact)
// -> decode -> pl.pallas_call, scl_pallas.py:1732).  kExact = true is
// kernel B, exact=True (selections make_select_l_smallest :425,
// make_select_flat :512, oneshot_core :1271); kExact = false is kernel C,
// the Fast-SSC-List approximation exact=False (rate1_core's fast branch
// :1231-1269, spc_core_serial :1384-1447).  The options of that call
// (kernel C'): kRank is rank_select=True (make_select_flat_rank :716),
// BetaT = float is beta_bf16=False (:85-87, :130: betas in the wide
// type), and kernels/unroll.py embeds this file to expand one schedule
// into straight-line calls of run_row (unroll=True, :96-103).  Each
// computes what the VM the Pallas kernel is pinned against computes,
// modem_tpu/fec/scl_vm.py make_decoder(frozen, L, exact):
//   F, G, COMBINE: read through the lane maps refs[depth][lane] (LLRs)
//     and brefs[slot][lane] (partial sums), write lane-dense to the
//     physical rows; at a node's last chunk reset the written map row to
//     the identity (Tal-Vardy lazy copy: forks permute the maps only).
//   RATE0: pm[l] += sum relu(-a), beta = +1.  No fork.
//   REP: candidates [pm + m0 | pm + m1] (keep all +1 | flip to all -1);
//     new lane k takes the candidate of rank k.
//   RATE1 / SPC, exact (one shot): per lane the t = 7 (RATE1) or 8 (SPC)
//     least reliable columns; candidate (lane, pattern p) flips the
//     columns of p's set bits among the 7 (SPC: the 7 after the first,
//     whose flip is then forced by the parity); new lane k takes the
//     candidate of rank k among the L x 128.
//   RATE1, fast: per lane the kFastRounds = 4 least reliable columns
//     (T_RATE1); round r offers [pm | pm + vals[r]] per lane and keeps
//     the best L of 2L, as REP; a path that took the flip negates its
//     own source lane's column idxs[r].
//   SPC, fast: parity-fix (pm += odd ? v0 : 0, column i0 flips on odd
//     parity), then rounds r = 1..3 offer the exclusive pair flip
//     {i0, i_r} at delta = odd ? v_r - v0 : v_r + v0, or BIG on a path
//     already switched; best L of 2L each round.
//   Every selection orders candidates by (value, index), lowest index
//   first on ties, as lax.top_k does; the sums of a candidate are taken
//   in the VM's order, plain IEEE f32 (no fast math: clones start at
//   BIG / 2 and invalid columns are BIG, so sums reach inf; infinite
//   LLRs make NaN, which orders last, as in torch.sort).  Leaves
//   narrower than the 7-8 enumerated columns (in decomposed-SPC
//   schedules, down to width 1) take BIG for the missing columns, so
//   their candidates sum to inf and tie; the index order still decides.
//
// What bounds it on an H100: a serial chain of 10,252 schedule rows per
// wire-size frame, 2,132 of them forks (786 REP, 204 RATE1, 1,142 SPC),
// each fork a reduction, a selection and a map permutation separated by
// block barriers.  At the serving fallback batch of 16 frames only 16 of
// the 132 SMs hold a block, so the time is one frame's latency: the
// latency of each row's loads and stores, its barriers and its fetch.
// The design shortens each link:
//
// - Tiered state, as kernel A's (csrc/sc_decode.cu).  The regions of
//   depths >= D_s, every lane's copy, live in the block's dynamic shared
//   memory (LLR offsets from llr_lo, beta offsets from beta_lo; regions
//   grow with depth, so each tier is one range), zeroed at the start;
//   the depths below in a per-frame global scratch; depth 0 is read from
//   the input and the root codeword is written to the global betas.  The
//   host picks D_s (kernels/scl_decode.py list_tiers) as the shallowest
//   depth whose tier fits one block an SM (mode 6, L = 8, int8 betas:
//   D_s = 8, 221,184 bytes; 8,622 of 10,252 rows lie wholly in it).
//   Every access picks its tier by comparing its offset with the
//   threshold, so any table lands in the right tier; F, G and COMBINE
//   rows wholly in the shared tier take a path with no test.  The shared
//   tier is reached by ld/st.shared on 32-bit addresses in registers.
// - Every lane's loads before any store.  A row's L lanes read through
//   the lane maps and write lane-dense; a thread issues all its loads
//   (all lanes, all its columns) before its first store, so they are in
//   flight together (a store may alias a later lane's load, so the
//   compiler would otherwise keep them in program order).
// - Leaf selections bounded by the width.  A lane's least reliable
//   columns come from one warp: at width <= 32 one column a lane and one
//   rank count by shuffles gives all 7-8 at once; wider, the argmin
//   rounds scan only ceil(width / 32) columns a lane.  Each round, and
//   each of the exact leaf's rounds over a lane's 128 candidates, is two
//   integer reductions (redux.sync) over non-negative floats' bits.  The
//   exact merge ranks each of the L x L survivors by binary searches in
//   the other lanes' sorted lists, side by side.  The warps that hold
//   the row's columns (warp 0 alone at width <= 32) then run the merge,
//   REP's rank or the fast rounds themselves, in registers, write their
//   columns' betas, and warp 0 permutes the maps: a fork crosses two
//   block barriers, a narrow REP one.
// - A staged row stream: 32 bytes a row (pack_list_rows); warp 0 copies
//   the next kStage rows into shared memory (cp.async) while the current
//   ones run, so a row is a shared load away (each thread loading row
//   i + 1 into registers while row i ran measured 10-16 % slower:
//   PERF.md, profile_card.py --list).
// - The lane maps and the path metrics double-buffer in shared memory,
//   so a fork's permutation needs no extra barrier.
// - A block of 512 threads, one column a thread, one block an SM (256
//   threads, two columns a thread, measured slower: PERF.md).
//
// kRank replaces the L serial warp-argmin rounds that pick a lane's best
// L of its 128 one-shot candidates by one rank count over the 13 patterns
// that can reach a top 8 (codes 0-9, 16, 32, 64: any other pattern has
// at least 8 strict dominators of lower code in its own lane, removing a
// flip or moving one to a more reliable column never raises an f32 sum
// taken in order, scl_pallas.py:706-713); the L x L merge is unchanged,
// so the result is bit-identical.  REP and the fast rounds already rank
// in one pass, so kRank changes nothing there.
//
// Output: codeword bit = (beta < 0) over the physical rows of the root
// slot, path metrics in lane order (the VM's semantics).  refs, brefs and
// pm live in static shared memory (Shared, at most kStaticShared bytes,
// which the host's budget holds).
//
// Built three ways from this one file: the default library (B and C with
// int8 betas), the options library (-DSCL_DECODE_OPTIONS: kRank and f32
// betas) and, embedded by kernels/unroll.py with -DSCL_DECODE_UNROLLED
// defined first, a kernel of straight-line run_row calls for one
// schedule (then the interpreter and its entry points are left out).
// What the card measured for each choice is in PERF.md (profile_card.py
// --rows).

#include <cuda_runtime.h>
#include <stdint.h>

// Per-row profile hook: profile_card.py --rows defines these macros ahead
// of this file (the clock64() cycles of each row by key, thread 0 of block
// 0; here the key is the opcode, + kTierKey if the row touches the global
// tier; ROW_PROFILE_PHASE files the cycles since the row's start or the
// last phase under a fork phase's key, past the opcodes); everywhere else
// they expand to nothing.
#ifndef ROW_PROFILE_BEGIN
#define ROW_PROFILE_BEGIN()
#define ROW_PROFILE_END(key)
#define ROW_PROFILE_PHASES()
#define ROW_PROFILE_PHASE(key)
#endif

// The block's dynamic shared memory: the shared tier, every lane's LLR
// slots (lane-major) then every lane's beta slots.
extern __shared__ __align__(16) unsigned char scl_tier[];

namespace {

constexpr int kChunk = 512;      // widest op (columns)
constexpr int kThreads = kChunk;   // a block: one column a thread
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = kChunk / 32;       // columns a lane of a leaf warp
constexpr int kMaxDepths = 20;   // codes up to 2^19
constexpr int kMapRows = 3 * kMaxDepths;  // refs (by depth), brefs (slot)
constexpr int kPatterns = 128;   // subsets of the 7 least reliable
constexpr int kLive = 13;        // patterns that can reach a top 8
constexpr int kFastRounds = 4;   // T_RATE1: fast-mode fork rounds
constexpr int kStaticShared = 8192;   // LIST_STATIC_SHARED on the host
constexpr int kStage = 32;       // rows staged in shared memory at a time
constexpr float kBig = 3.0e38f;
constexpr int kNoIndex = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
// profile keys: a row's opcode + kTierKey if it touches the global tier;
// a fork's phases from kPhaseKey + (op - OP_REP) * 8 + phase (0 load and
// search, 1 per-lane top L, 5 the leaf's first barrier, 2 merge or rank,
// 3 beta write, 4 map permute and the row's barrier)
constexpr int kTierKey = 16;
constexpr int kPhaseKey = 32;

enum Op { OP_F, OP_G, OP_COMBINE, OP_RATE0, OP_REP, OP_RATE1, OP_SPC };
enum Col { C_OP, C_D, C_SRC, C_SRC2, C_DST, C_BSRC, C_BSRC2, C_BDST,
           C_SIDR, C_SIDR2, C_SIDW, C_WIDTH, C_LAST, C_SUB };

__device__ __forceinline__ float inf_f() {
  return __int_as_float(0x7f800000);
}

// A value after every other in the selection order (before): all bits set.
__device__ __forceinline__ float last_f() { return __uint_as_float(~0u); }

__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

// The selection order: smaller value first, lower index on ties.  The
// values ordered are non-negative floats or NaN (the VM's inf * 0 and
// inf - inf at leaves of infinite LLRs), so their bits order them as
// torch.sort does, NaN last.
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  const unsigned a = __float_as_uint(v), b = __float_as_uint(w);
  return (a < b) | ((a == b) & (i < j));
}

// The warp's sum (xor butterfly) of each of v[0..N), their steps side by
// side (N independent chains).  Where only the lanes below `span` hold
// values (the others zeros), the steps that would pair a lane below it
// with a zero are left out: v + 0 is v, so the lanes below get the full
// butterfly's sums bit for bit.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N], int span = 32) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o >= span) continue;
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] += __shfl_xor_sync(kFull, v[j], o);
  }
}

// Warp-wide minimum of (v, i) in selection order, every lane gets it,
// for v >= 0 (never -0): magnitudes and path metrics, BIG and inf
// included.  Such floats order as their bit patterns do, so two integer
// reductions (redux.sync) find it: the least value, then the least index
// among the lanes that hold it.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  const unsigned m = __reduce_min_sync(kFull, __float_as_uint(v));
  i = static_cast<int>(__reduce_min_sync(
      kFull, __float_as_uint(v) == m ? static_cast<unsigned>(i) : ~0u));
  v = __uint_as_float(m);
}

// Pattern code of live candidate q < kLive: 0..9, then 16, 32, 64.
__device__ __forceinline__ int live_pattern(int q) {
  return q < 10 ? q : 16 << (q - 10);
}

// x[k] for a k the compiler does not know: a chain of selects over the
// unrolled array, so x stays in registers.
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&x)[N], int k) {
  T v = x[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = k == j ? x[j] : v;
  return v;
}

// The shared tier is read and written by ld.shared / st.shared on 32-bit
// shared-window addresses kept in registers (through a C++ pointer nvcc
// rebuilds the window address before every tier-guarded access; PERF.md,
// kernel A).  Stores clobber memory, so no load moves across them.
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

// Asynchronous 16-byte copies from global into shared memory (cp.async),
// and the wait for a thread's own copies to land.
__device__ __forceinline__ void copy16(uint32_t saddr, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(saddr),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// A schedule row.  The interpreter unpacks it from the packed table
// (kernels/sc_decode.py pack_list_rows), 32 bytes a row, two uint4:
//   SRC, SRC2, DST, BSRC | BSRC2, BDST,
//   OP | D << 3 | WIDTH << 8 | LAST << 18, SIDR | SIDR2 << 8 | SIDW << 16.
// An unrolled kernel passes each row as 14 literals (LitRow), which the
// compiler folds into the inlined body.
struct ListRow {
  uint4 a, b;

  __device__ __forceinline__ int operator[](int c) const {
    switch (c) {
      case C_SRC: return static_cast<int>(a.x);
      case C_SRC2: return static_cast<int>(a.y);
      case C_DST: return static_cast<int>(a.z);
      case C_BSRC: return static_cast<int>(a.w);
      case C_BSRC2: return static_cast<int>(b.x);
      case C_BDST: return static_cast<int>(b.y);
      case C_OP: return static_cast<int>(b.z & 7u);
      case C_D: return static_cast<int>((b.z >> 3) & 31u);
      case C_WIDTH: return static_cast<int>((b.z >> 8) & 1023u);
      case C_LAST: return static_cast<int>((b.z >> 18) & 1u);
      case C_SIDR: return static_cast<int>(b.w & 255u);
      case C_SIDR2: return static_cast<int>((b.w >> 8) & 255u);
      case C_SIDW: return static_cast<int>((b.w >> 16) & 255u);
      default: return 0;   // SUB: not read
    }
  }
};

struct LitRow {
  int v[14];
  __device__ __forceinline__ int operator[](int c) const { return v[c]; }
};

template <int L>
struct Shared {
  // the lane maps, double-buffered: rows [0, kMaxDepths) are refs (LLRs,
  // by depth), the rest brefs (partial sums, by slot)
  alignas(16) int maps[2][kMapRows][L];
  alignas(16) float pm_buf[2][L];
  float red[kWarps][2 * L];       // per warp (32 columns): partial sums
  int os_idx[L][8];               // least reliable columns per lane
  float os_val[L][8];             //   their |a| (BIG past the width)
  int os_odd[L];                  // SPC parity per lane
  float top_v[L * L];             // each lane's best L
  int top_i[L * L];               //   (value, lane * 128 + p)
  uint4 stage[2][2 * kStage];     // the row stream, double-buffered

  __device__ __forceinline__ int& ref(int cur, int d, int l) {
    return maps[cur][d][l];
  }
  __device__ __forceinline__ int ref(int cur, int d, int l) const {
    return maps[cur][d][l];
  }
  __device__ __forceinline__ int& bref(int cur, int slot, int l) {
    return maps[cur][kMaxDepths + slot][l];
  }
  __device__ __forceinline__ int bref(int cur, int slot, int l) const {
    return maps[cur][kMaxDepths + slot][l];
  }
};

// Where a frame's state lives (computed on the host, list_tiers).
struct Geom {
  int code_len;    // channel LLRs a frame
  int d0_len;      // LLR offsets below this are depth 0: the input
  int llr_lo;      // LLR offsets from here on are in shared memory
  int beta_lo;     // beta offsets from here on are in shared memory
  int s_llr_len;   // shared LLR slots a lane (f32)
  int s_beta_len;  // shared beta slots a lane (BetaT)
  int out_off;     // beta offset of the root codeword (global tier)
  int n_depths;
};

// One frame's view of its state and which half of the double-buffered
// maps is live.  Physical row (lane) p of the global tier is at p *
// g_*_len, of the shared tier at p * s_*_len.
template <int L, typename BetaT>
struct Frame {
  const float* in;    // depth 0
  float* g_llr;       // global tier, LLR offsets [d0_len, llr_lo)
  BetaT* g_beta;      // global tier, beta offsets [0, beta_lo)
  int d0_len, llr_lo, beta_lo, s_llr_len, s_beta_len, n_depths;
  uint32_t s_llr;     // shared tier, LLR offsets [llr_lo, ...): address
  uint32_t s_beta;    // shared tier, beta offsets [beta_lo, ...): address
  int cur;

  __device__ __forceinline__ int g_llr_len() const { return llr_lo - d0_len; }

  // LLR of physical row p at schedule offset off, and so on, in the tier
  // the offset lies in; kShared when the caller knows it is the shared
  // one, which leaves the test and the global path out.
  template <bool kShared = false>
  __device__ __forceinline__ float rd(int p, int off) const {
    if (kShared || off >= llr_lo) {
      return lds<float>(s_llr + static_cast<uint32_t>(
                                    p * s_llr_len + off - llr_lo) * 4u);
    }
    if (off < d0_len) return __ldg(in + off);
    return g_llr[static_cast<size_t>(p) * g_llr_len() + off - d0_len];
  }
  // The LLR of physical row p at column c of a row starting at src, zero
  // past the width, in the row's tier (sh: the shared one).  Lanes past
  // the width load the last column, so the warp does not diverge.
  __device__ __forceinline__ float rd_col(int p, int src, int c, int width,
                                          bool sh) const {
    const int off = src + (c < width ? c : width - 1);
    const float v = sh ? rd<true>(p, off) : rd<false>(p, off);
    return c < width ? v : 0.f;
  }
  template <bool kShared = false>
  __device__ __forceinline__ void wr(int p, int off, float v) const {
    if (kShared || off >= llr_lo) {
      sts(s_llr + static_cast<uint32_t>(p * s_llr_len + off - llr_lo) * 4u,
          v);
    } else {
      g_llr[static_cast<size_t>(p) * g_llr_len() + off - d0_len] = v;
    }
  }
  template <bool kShared = false>
  __device__ __forceinline__ BetaT rb(int p, int off) const {
    if (kShared || off >= beta_lo) {
      return lds<BetaT>(s_beta + static_cast<uint32_t>(
                                     p * s_beta_len + off - beta_lo) *
                                     static_cast<uint32_t>(sizeof(BetaT)));
    }
    return g_beta[static_cast<size_t>(p) * beta_lo + off];
  }
  template <bool kShared = false>
  __device__ __forceinline__ void wb(int p, int off, BetaT v) const {
    if (kShared || off >= beta_lo) {
      sts(s_beta + static_cast<uint32_t>(p * s_beta_len + off - beta_lo) *
                       static_cast<uint32_t>(sizeof(BetaT)),
          v);
    } else {
      g_beta[static_cast<size_t>(p) * beta_lo + off] = v;
    }
  }
};

// Whether every slot a row reads or writes lies in the shared tier (the
// row's offsets are where its ranges start, and tiers are single ranges;
// kernels/sc_decode.py in_shared_tier is the host's copy).
template <typename Fr, typename Row>
__device__ __forceinline__ bool in_shared(const Fr& f, const Row& row) {
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

template <typename Fr, typename Row>
__device__ __forceinline__ int profile_key(const Fr& f, const Row& row) {
  return row[C_OP] + (in_shared(f, row) ? 0 : kTierKey);
}

// scl_tier must hold the geometry's shared bytes.
template <int L, typename BetaT>
__device__ __forceinline__ Frame<L, BetaT> frame_begin(
    Shared<L>& s, const Geom& g, const float* llr_in, float* llr_scratch,
    BetaT* beta_scratch) {
  static_assert(sizeof(Shared<L>) <= kStaticShared,
                "static shared memory over the host's budget");
  const int t = threadIdx.x;
  const size_t frame = blockIdx.x;
  Frame<L, BetaT> f;
  f.in = llr_in + frame * g.code_len;
  f.g_llr = llr_scratch + frame * L * static_cast<size_t>(g.llr_lo - g.d0_len);
  f.g_beta = beta_scratch + frame * L * static_cast<size_t>(g.beta_lo);
  f.d0_len = g.d0_len;
  f.llr_lo = g.llr_lo;
  f.beta_lo = g.beta_lo;
  f.s_llr_len = g.s_llr_len;
  f.s_beta_len = g.s_beta_len;
  f.n_depths = g.n_depths;
  f.s_llr = static_cast<uint32_t>(__cvta_generic_to_shared(scl_tier));
  f.s_beta = f.s_llr + static_cast<uint32_t>(sizeof(float) * L * g.s_llr_len);
  f.cur = 0;
  for (int e = t; e < kMapRows * L; e += kThreads) {
    s.maps[0][e / L][e % L] = e % L;
  }
  if (t < L) s.pm_buf[0][t] = t == 0 ? 0.f : kBig * 0.5f;  // clones die
  // the shared tier starts from zeros, as the plain version's buffers do
  const int words = static_cast<int>(
      L * (sizeof(float) * g.s_llr_len + sizeof(BetaT) * g.s_beta_len) / 16);
  for (int e = t; e < words; e += kThreads) {
    reinterpret_cast<uint4*>(scl_tier)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  return f;
}

template <int L, typename BetaT>
__device__ __forceinline__ void frame_end(const Frame<L, BetaT>& f,
                                          const Shared<L>& s, const Geom& g,
                                          uint8_t* __restrict__ cw_out,
                                          float* __restrict__ pm_out) {
  const int t = threadIdx.x;
  const size_t frame = blockIdx.x;
  uint8_t* cw = cw_out + frame * L * static_cast<size_t>(g.code_len);
  for (int k = 0; k < L; ++k) {
    for (int j = t; j < g.code_len; j += kThreads) {
      cw[static_cast<size_t>(k) * g.code_len + j] =
          f.rb(k, g.out_off + j) < 0;
    }
  }
  if (t < L) pm_out[frame * L + t] = s.pm_buf[f.cur][t];
}

// F or G (kG): thread t holds column t; it loads every lane's operands,
// then computes and stores.
template <int L, bool kShared, bool kG, typename BetaT, typename Row>
__device__ __forceinline__ void fg_body(const Frame<L, BetaT>& f,
                                        const Shared<L>& s, const Row& row) {
  const int c = threadIdx.x;
  if (c >= row[C_WIDTH]) return;
  const int d = row[C_D];
  const int src = row[C_SRC], src2 = row[C_SRC2], dst = row[C_DST];
  const int bsrc = row[C_BSRC];
  float a[L], b[L], bl[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int p = s.ref(f.cur, d, l);
    a[l] = f.template rd<kShared>(p, src + c);
    b[l] = f.template rd<kShared>(p, src2 + c);
    if (kG) {
      bl[l] = static_cast<float>(
          f.template rb<kShared>(s.bref(f.cur, row[C_SIDR], l), bsrc + c));
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float out = kG ? b[l] + bl[l] * a[l]
                         : sign_of(a[l]) * sign_of(b[l]) *
                               fminf(fabsf(a[l]), fabsf(b[l]));
    f.template wr<kShared>(l, dst + c, out);
  }
}

template <int L, bool kShared, typename BetaT, typename Row>
__device__ __forceinline__ void combine_body(const Frame<L, BetaT>& f,
                                             const Shared<L>& s,
                                             const Row& row) {
  const int c = threadIdx.x;
  if (c >= row[C_WIDTH]) return;
  const int bsrc = row[C_BSRC], bsrc2 = row[C_BSRC2];
  const int bdst = row[C_BDST], dst = row[C_DST];
  BetaT bl[L], br[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    bl[l] = f.template rb<kShared>(s.bref(f.cur, row[C_SIDR], l), bsrc + c);
    br[l] = f.template rb<kShared>(s.bref(f.cur, row[C_SIDR2], l), bsrc2 + c);
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    f.template wb<kShared>(l, bdst + c, static_cast<BetaT>(bl[l] * br[l]));
    f.template wb<kShared>(l, dst + c, br[l]);
  }
}

// A fork's maps, by warp 0: new lane k continues source lane src[k]
// with metric pm[k]; every map row is permuted into the other half (lane
// j takes column j % L, so one source lane, of every (32 / L)-th row;
// all its loads before its stores), the leaf's own slot becoming
// identity at its last chunk.  The caller ends the row with the barrier
// and flips f.cur.
template <int L, typename BetaT, typename Row>
__device__ __forceinline__ void permute(const Frame<L, BetaT>& f,
                                        Shared<L>& s, const Row& row,
                                        const int (&src)[L],
                                        const float (&pm)[L]) {
  constexpr int kRowsPer = 32 / L;   // map rows one pass of the warp covers
  constexpr int kPasses = (kMapRows + kRowsPer - 1) / kRowsPer;
  const int lane = threadIdx.x & 31;
  const int k = lane & (L - 1);
  const int from = pick(src, k);
  const int ident = row[C_LAST] ? kMaxDepths + row[C_SIDW] : -1;
  int v[kPasses];
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = lane / L + i * kRowsPer;
    v[i] = r < kMapRows ? s.maps[f.cur][r][from] : 0;
  }
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = lane / L + i * kRowsPer;
    if (r < kMapRows) s.maps[f.cur ^ 1][r][k] = r == ident ? k : v[i];
  }
  if (lane < L) s.pm_buf[f.cur ^ 1][lane] = pick(pm, lane);
}

// The warps that hold a row's columns (at least warp 0): those that run a
// fork's selection and write its betas.
__device__ __forceinline__ int column_warps(int width) {
  const int w = (width + 31) >> 5;
  return w < kWarps ? w : kWarps;
}

// RATE0 (no fork) and REP: per lane the cost of all +1 (m0) and of all -1
// (m1).  At width <= 32 warp 0 alone sums its columns, one a lane, and
// the other warps go to the row's barrier; wider, each 32-column group's
// sum goes through shared memory and a barrier, and the group sums are
// added in group order (the same sums either way).  REP's fork then runs
// in each warp that holds columns.
template <int L, typename BetaT, typename Row>
__device__ __forceinline__ void rep_row(Frame<L, BetaT>& f, Shared<L>& s,
                                        const Row& row) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int op = row[C_OP], d = row[C_D], width = row[C_WIDTH];
  const bool rep = op == OP_REP;
  const int src = row[C_SRC], bdst = row[C_BDST];
  const int nw = column_warps(width);
  const bool sh = src >= f.llr_lo;   // the LLRs read lie in one tier
  const float* pm = s.pm_buf[f.cur];
  ROW_PROFILE_PHASES();
  [[maybe_unused]] const int phase_key = kPhaseKey + (op - OP_REP) * 8;
  // lane j < 2L: candidate j's sum (keep lane j, or flip lane j - L)
  float sum = 0.f;
  if (width <= 32) {
    if (warp == 0) {
      // m[l] = m0 of lane l, m[L + l] = m1; lane 0's sums (the lanes from
      // the width on hold partial ones), as a group's sum is taken below
      float a[L], m[2 * L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        a[l] = f.rd_col(s.ref(f.cur, d, l), src, lane, width, sh);
      }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        m[l] = fmaxf(-a[l], 0.f);
        m[L + l] = rep ? fmaxf(a[l], 0.f) : 0.f;
      }
      warp_sums(m, width);
#pragma unroll
      for (int j = 0; j < 2 * L; ++j) {
        const float mj = __shfl_sync(kFull, m[j], 0);
        if (lane == j) sum = mj;
      }
    }
  } else {
    if (warp < nw) {
      float a[L], m[2 * L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        a[l] = f.rd_col(s.ref(f.cur, d, l), src, t, width, sh);
      }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        m[l] = fmaxf(-a[l], 0.f);
        m[L + l] = rep ? fmaxf(a[l], 0.f) : 0.f;
      }
      warp_sums(m);
      if (lane == 0) {
#pragma unroll
        for (int l = 0; l < 2 * L; ++l) s.red[warp][l] = m[l];
      }
    }
    __syncthreads();
    if (warp < nw && lane < 2 * L) {
      const int groups = (width + 31) >> 5;
      for (int g = 0; g < groups; ++g) sum += s.red[g][lane];
    }
  }
  if (rep) ROW_PROFILE_PHASE(phase_key + 0);
  if (!rep) {
    if (t < width) {
#pragma unroll
      for (int l = 0; l < L; ++l) f.wb(l, bdst + t, static_cast<BetaT>(1));
    }
    if (t < L) s.pm_buf[f.cur][t] += sum;
    if (row[C_LAST] && t < L) s.bref(f.cur, row[C_SIDW], t) = t;
    __syncthreads();
    return;
  }
  if (warp < nw) {
    // REP's fork: candidate j's rank among the 2L is its new lane
    const float c = lane < 2 * L ? pm[lane & (L - 1)] + sum : inf_f();
    int rank = 0;
#pragma unroll
    for (int j = 0; j < 2 * L; ++j) {
      rank += before(__shfl_sync(kFull, c, j), j, c, lane);
    }
    int src_k[L], flip_k[L];
    float pm_k[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int j =
          __ffs(__ballot_sync(kFull, lane < 2 * L && rank == k)) - 1;
      src_k[k] = j & (L - 1);
      flip_k[k] = j >= L;
      pm_k[k] = __shfl_sync(kFull, c, j);
    }
    ROW_PROFILE_PHASE(phase_key + 2);
    if (t < width) {
#pragma unroll
      for (int k = 0; k < L; ++k) {
        f.wb(k, bdst + t, static_cast<BetaT>(flip_k[k] ? -1 : 1));
      }
    }
    ROW_PROFILE_PHASE(phase_key + 3);
    if (warp == 0) permute<L, BetaT>(f, s, row, src_k, pm_k);
  }
  __syncthreads();
  f.cur ^= 1;
  ROW_PROFILE_PHASE(phase_key + 4);
}

// RATE1 / SPC: warp w < L finds logical lane w's least reliable columns
// (and, exact, its best L one-shot candidates) into shared memory; one
// barrier; then each warp that holds columns (warp 0 alone at width <=
// 32) merges them (exact) or runs the fast rounds in its registers,
// writes its columns' betas and, with the others, permutes the maps.
template <int L, bool kExact, bool kRank, typename BetaT, typename Row>
__device__ __forceinline__ void leaf_row(Frame<L, BetaT>& f, Shared<L>& s,
                                         const Row& row) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int op = row[C_OP], d = row[C_D], width = row[C_WIDTH];
  const bool spc = op == OP_SPC;
  const int src = row[C_SRC];
  const float* pm = s.pm_buf[f.cur];
  // least reliable columns a lane needs: exact 7 (RATE1) or 8 (SPC),
  // fast kFastRounds
  const int n_least = kExact ? (spc ? 8 : 7) : kFastRounds;
  constexpr int kLeast = kExact ? 8 : kFastRounds;
  const int fl0 = spc ? 1 : 0;   // first of the 7 enumerated columns
  const bool sh = src >= f.llr_lo;   // the LLRs read lie in one tier
  ROW_PROFILE_PHASES();
  [[maybe_unused]] const int phase_key = kPhaseKey + (op - OP_REP) * 8;
  if (warp < L) {
    const int p = s.ref(f.cur, d, warp);
    const float pml = pm[warp];
    float vals[kLeast];
    int cols[kLeast];
    int odd;
    if (width <= 32) {
      // one column a lane, the rest of the 512 at BIG: the rank of each
      // lane's column gives the n_least smallest at once.  Past the m
      // columns at most BIG (inf |a| aside, all of them), the next in
      // order are the BIG columns from 32 on.
      const bool in = lane < width;
      const float a = f.rd_col(p, src, lane, width, sh);
      const float mag = in ? fabsf(a) : kBig;
      odd = __popc(__ballot_sync(kFull, in && a < 0.f)) & 1;
      int rank = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        rank += before(__shfl_sync(kFull, mag, j), j, mag, lane);
      }
      const int m = __popc(__ballot_sync(kFull, mag <= kBig));
      if (rank < n_least) {
        s.os_val[warp][rank] = mag <= kBig ? mag : kBig;
        s.os_idx[warp][rank] = mag <= kBig ? lane : 32 + rank - m;
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kLeast; ++r) {
        vals[r] = r < n_least ? s.os_val[warp][r] : inf_f();
        cols[r] = r < n_least ? s.os_idx[warp][r] : kNoIndex;
      }
    } else {
      // ceil(width / 32) columns a lane, those past the width at BIG;
      // n_least argmin rounds.  A round whose least is over BIG (an inf
      // |a|) takes a BIG column past the scanned ones instead, where the
      // 512 have them (32 or more, past fewer than 16 slots); at 16 slots
      // it takes the inf column, as the plain version does.
      const int slots = (width + 31) >> 5;
      float mag[kSlots];
      int neg = 0;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int c = lane + 32 * j;
        mag[j] = kBig;
        if (j < slots) {
          const float a = f.rd_col(p, src, c, width, sh);
          mag[j] = c < width ? fabsf(a) : kBig;
          neg += a < 0.f;
        }
      }
      odd = static_cast<int>(__reduce_add_sync(kFull, neg)) & 1;
      unsigned taken = 0;
#pragma unroll
      for (int r = 0; r < kLeast; ++r) {
        float bv = inf_f();
        int bi = kNoIndex;
        if (r < n_least) {
#pragma unroll
          for (int j = 0; j < kSlots; ++j) {
            if (j < slots && !((taken >> j) & 1u) &&
                before(mag[j], lane + 32 * j, bv, bi)) {
              bv = mag[j];
              bi = lane + 32 * j;
            }
          }
          warp_argmin(bv, bi);
          if (bv > kBig && slots < kSlots) {
            bv = kBig;
            bi = 32 * slots + r;
          } else if ((bi & 31) == lane) {
            taken |= 1u << (bi >> 5);
          }
        }
        vals[r] = bv;
        cols[r] = bi;
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kLeast; ++r) {
          s.os_idx[warp][r] = cols[r];
          s.os_val[warp][r] = vals[r];
        }
      }
    }
    if (lane == 0) s.os_odd[warp] = odd;
    ROW_PROFILE_PHASE(phase_key + 0);
    if constexpr (kExact) {
      // a pattern's candidate: its flip penalties summed in the VM's
      // order, then pm, then (SPC) the forced parity flip of the least
      // reliable column
      float ev[7];  // the enumerated 7, in order
#pragma unroll
      for (int j = 0; j < 7; ++j) ev[j] = spc ? vals[j + 1] : vals[j];
      auto candidate = [&](int pat) -> float {
        float subs = 0.f;
#pragma unroll
        for (int j = 0; j < 7; ++j) {
          subs = subs + ev[j] * static_cast<float>((pat >> j) & 1);
        }
        float c = pml + subs;
        if (spc) c = c + ((odd ^ (__popc(pat) & 1)) ? vals[0] : 0.f);
        return c;
      };
      if constexpr (kRank) {
        // one rank count over the lane's 13 live patterns, one a
        // thread: rank k < L is the lane's k-th best
        const int pat = live_pattern(lane < kLive ? lane : 0);
        const float c = lane < kLive ? candidate(pat) : inf_f();
        int rank = 0;
#pragma unroll
        for (int j = 0; j < kLive; ++j) {
          const float cj = __shfl_sync(kFull, c, j);
          rank += before(cj, live_pattern(j), c, pat);
        }
        if (lane < kLive && rank < L) {
          s.top_v[warp * L + rank] = c;
          s.top_i[warp * L + rank] = warp * kPatterns + pat;
        }
      } else {
        // the 128 candidates of this lane, 4 a thread; its best L of
        // them in L serial rounds
        float cand[kPatterns / 32];
#pragma unroll
        for (int q = 0; q < kPatterns / 32; ++q) {
          cand[q] = candidate(lane + 32 * q);
        }
        unsigned used = 0;
        for (int r = 0; r < L; ++r) {
          float bv = last_f();
          int bi = kNoIndex;
#pragma unroll
          for (int q = 0; q < kPatterns / 32; ++q) {
            if (!((used >> q) & 1u) &&
                before(cand[q], lane + 32 * q, bv, bi)) {
              bv = cand[q];
              bi = lane + 32 * q;
            }
          }
          warp_argmin(bv, bi);
          if ((bi & 31) == lane) used |= 1u << (bi >> 5);
          if (lane == 0) {
            s.top_v[warp * L + r] = bv;
            s.top_i[warp * L + r] = warp * kPatterns + bi;
          }
        }
      }
    }
    ROW_PROFILE_PHASE(phase_key + 1);
  }
  __syncthreads();
  ROW_PROFILE_PHASE(phase_key + 5);
  // then, in each warp that holds columns, the selection: new lane k
  // continues src_k[k] with the flips of code_k[k] (exact: a one-shot
  // pattern; fast: the rounds taken) and metric pm_k[k]; the betas of the
  // warp's columns; its share of the map permutation
  const int nw = column_warps(width);
  if (warp < nw) {
    int src_k[L], code_k[L];
    float pm_k[L];
    if constexpr (kExact) {
      // the global best L lie among the lanes' best L.  Candidate (a, i)
      // of lane a's sorted list has i before it in its own list and, in
      // lane b's, the entries at a smaller value or (ids lane * 128 + p
      // are distinct) at the same value if b < a: a binary search each.
      constexpr int kQ = (L * L + 31) / 32;
      int rank_q[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int cand = lane + 32 * q;
        const int a = cand / L;
        const float v = cand < L * L ? s.top_v[cand] : inf_f();
        // n[b]: lane b's entries ahead, its L searches side by side
        auto ahead = [&](int b, int e) {
          return before(s.top_v[b * L + e], b, v, a);
        };
        int n[L];
#pragma unroll
        for (int b = 0; b < L; ++b) n[b] = 0;
#pragma unroll
        for (int step = L / 2; step > 0; step >>= 1) {
#pragma unroll
          for (int b = 0; b < L; ++b) {
            n[b] += step & -static_cast<int>(ahead(b, n[b] + step - 1));
          }
        }
        int rank = cand % L;
#pragma unroll
        for (int b = 0; b < L; ++b) {
          rank += (n[b] + ahead(b, n[b])) & -static_cast<int>(b != a);
        }
        rank_q[q] = cand < L * L ? rank : L;
      }
#pragma unroll
      for (int k = 0; k < L; ++k) {
        int cand = 0;
#pragma unroll
        for (int q = kQ - 1; q >= 0; --q) {
          const unsigned hit = __ballot_sync(kFull, rank_q[q] == k);
          if (hit) cand = 32 * q + __ffs(hit) - 1;
        }
        const int id = s.top_i[cand];
        src_k[k] = id / kPatterns;
        code_k[k] = id % kPatterns;
        pm_k[k] = s.top_v[cand];
      }
    } else {
      // the serial fork rounds: lane k < L holds path k's source lane g (at
      // the leaf's start), the rounds whose flip it took (bit r of fm), its
      // switched flag and metric
      const int k = lane & (L - 1);
      int g = k;
      unsigned fm = 0;
      int sw = 0;
      float p = pm[k];
      if (spc) p = p + (s.os_odd[k] ? s.os_val[k][0] : 0.f);
      for (int r = spc ? 1 : 0; r < kFastRounds; ++r) {
        // lane j < 2L holds candidate j: keep (j < L) or flip of path
        // j % L; its rank among the 2L is its new path
        const float pk = __shfl_sync(kFull, p, k);
        const int gk = __shfl_sync(kFull, g, k);
        const int swk = __shfl_sync(kFull, sw, k);
        float c = inf_f();
        if (lane < 2 * L) {
          if (lane < L) {
            c = pk;
          } else {
            const float vr = s.os_val[gk][r];
            float delta = vr;
            if (spc) {
              const float v0 = s.os_val[gk][0];
              delta = s.os_odd[gk] ? vr - v0 : vr + v0;
              if (swk) delta = kBig;
            }
            c = pk + delta;
          }
        }
        int rank = 0;
#pragma unroll
        for (int j = 0; j < 2 * L; ++j) {
          const float cj = __shfl_sync(kFull, c, j);
          rank += before(cj, j, c, lane);
        }
        int pick_j = 0;  // the candidate of rank `lane`
#pragma unroll
        for (int j = 0; j < 2 * L; ++j) {
          if (__shfl_sync(kFull, rank, j) == lane) pick_j = j;
        }
        const float c_new = __shfl_sync(kFull, c, pick_j);
        const int from = pick_j & (L - 1);
        const bool flip = pick_j >= L;
        g = __shfl_sync(kFull, g, from);
        fm = __shfl_sync(kFull, fm, from) | (flip ? 1u << r : 0u);
        sw = __shfl_sync(kFull, sw, from) | flip;
        p = c_new;
      }
#pragma unroll
      for (int j = 0; j < L; ++j) {
        src_k[j] = __shfl_sync(kFull, g, j);
        code_k[j] = static_cast<int>(__shfl_sync(kFull, fm, j));
        pm_k[j] = __shfl_sync(kFull, p, j);
      }
    }
    ROW_PROFILE_PHASE(phase_key + 2);

    // the new lanes' betas: hard decisions of the source lane, flipped at
    // its chosen columns.  Lane j < 8 of a warp holds least-reliable column
    // j of the source lane and whether it flips; the OR of lanes 0-7,
    // restricted to the warp's 32 columns, is a mask of its flips.
    const int bdst = row[C_BDST];
    {
      const int col0 = warp * 32;   // below the width: warp < nw
      const int col = col0 + lane;
      const bool act = col < width;
      float a[L];
      int idx[L], odd_k[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int sl = src_k[k];
        a[k] = f.rd_col(s.ref(f.cur, d, sl), src, col, width, sh);
        idx[k] = lane < 8 ? s.os_idx[sl][lane] : kNoIndex;
        odd_k[k] = s.os_odd[sl];
      }
      unsigned mask[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int pat = code_k[k];
        int fbit;
        if constexpr (kExact) {
          fbit = lane >= fl0 && lane < fl0 + 7 ? (pat >> (lane - fl0)) & 1
                                               : 0;
          if (spc && lane == 0) fbit = odd_k[k] ^ (__popc(pat) & 1);
        } else {
          fbit = lane < kFastRounds ? (pat >> lane) & 1 : 0;
          if (spc && lane == 0) fbit = odd_k[k] ^ (__popc(pat & 14) & 1);
        }
        const bool here = fbit & ((idx[k] >> 5) == (col0 >> 5));
        mask[k] = here ? 1u << (idx[k] & 31) : 0u;
      }
      // the OR over lanes 0-7 (each 8-lane group ORs its own), then lane
      // 0's to every lane
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < L; ++k) {
          mask[k] |= __shfl_xor_sync(kFull, mask[k], o);
        }
      }
#pragma unroll
      for (int k = 0; k < L; ++k) mask[k] = __shfl_sync(kFull, mask[k], 0);
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (act) {
          const bool flip = (mask[k] >> lane) & 1u;
          const BetaT b = static_cast<BetaT>(a[k] < 0.f ? -1 : 1);
          f.wb(k, bdst + col, flip ? static_cast<BetaT>(-b) : b);
        }
      }
    }
    ROW_PROFILE_PHASE(phase_key + 3);
    if (warp == 0) permute<L, BetaT>(f, s, row, src_k, pm_k);
  }
  __syncthreads();
  f.cur ^= 1;
  ROW_PROFILE_PHASE(phase_key + 4);
}


// One schedule row, ending in a block barrier.
template <int L, bool kExact, bool kRank, typename BetaT, typename Row>
__device__ __forceinline__ void run_row(Frame<L, BetaT>& f, Shared<L>& s,
                                        const Row& row) {
  const int t = threadIdx.x;
  const int op = row[C_OP];
  const bool last = row[C_LAST] != 0;
  if (op == OP_F || op == OP_G) {
    const bool sh = in_shared(f, row);
    if (op == OP_F) {
      if (sh) {
        fg_body<L, true, false>(f, s, row);
      } else {
        fg_body<L, false, false>(f, s, row);
      }
    } else if (sh) {
      fg_body<L, true, true>(f, s, row);
    } else {
      fg_body<L, false, true>(f, s, row);
    }
    if (last && t < L) s.ref(f.cur, row[C_D] + 1, t) = t;
    __syncthreads();
  } else if (op == OP_COMBINE) {
    if (in_shared(f, row)) {
      combine_body<L, true>(f, s, row);
    } else {
      combine_body<L, false>(f, s, row);
    }
    if (last && t < L) s.bref(f.cur, row[C_SIDW], t) = t;
    __syncthreads();
  } else if (op == OP_RATE0 || op == OP_REP) {
    rep_row<L, BetaT>(f, s, row);
  } else if (op == OP_RATE1 || op == OP_SPC) {
    leaf_row<L, kExact, kRank, BetaT>(f, s, row);
  } else {
    __syncthreads();
  }
}

#ifndef SCL_DECODE_UNROLLED

template <int L, bool kExact, bool kRank, typename BetaT>
__global__ void __launch_bounds__(kThreads, 1)
scl_decode_kernel(const float* __restrict__ llr_in,
                  const uint4* __restrict__ rows, int n_rows, Geom g,
                  float* llr_scratch, BetaT* beta_scratch,
                  uint8_t* __restrict__ cw_out, float* __restrict__ pm_out) {
  __shared__ Shared<L> s;
  Frame<L, BetaT> f =
      frame_begin<L, BetaT>(s, g, llr_in, llr_scratch, beta_scratch);
  // row i is rows[2i], rows[2i + 1].  Warp 0 stages the stream in shared
  // memory kStage rows at a time, one stage ahead (cp.async, two 16-byte
  // copies a lane), so a row is a shared load away; a barrier every
  // kStage rows publishes the next stage.
  const int lane = threadIdx.x & 31;
  const bool warp0 = threadIdx.x < 32;
  const uint32_t staged =
      static_cast<uint32_t>(__cvta_generic_to_shared(s.stage));
  auto stage = [&](int i0, int buf) {
#pragma unroll
    for (int q = lane; q < 2 * kStage; q += 32) {
      if (2 * i0 + q < 2 * n_rows) {
        copy16(staged + 16u * (buf * 2 * kStage + q), rows + 2 * i0 + q);
      }
    }
  };
  if (warp0) stage(0, 0);
  for (int i = 0; i < n_rows; ++i) {
    const int slot = i % kStage, buf = (i / kStage) & 1;
    if (slot == 0) {
      if (warp0) copy_wait();
      __syncthreads();
      if (warp0) stage(i + kStage, buf ^ 1);
    }
    const ListRow row{s.stage[buf][2 * slot], s.stage[buf][2 * slot + 1]};
    ROW_PROFILE_BEGIN();
    run_row<L, kExact, kRank, BetaT>(f, s, row);
    ROW_PROFILE_END(profile_key(f, row));
  }
  frame_end<L, BetaT>(f, s, g, cw_out, pm_out);
}

struct Args {
  const void* llrs;
  const void* rows;
  int n_rows;
  Geom g;
  void* llr_scratch;
  void* beta_scratch;
  void* cw;
  void* pm;
  int batch;
  cudaStream_t stream;
};

template <int L, typename BetaT>
size_t shared_bytes(const Geom& g) {
  return L * (sizeof(float) * g.s_llr_len + sizeof(BetaT) * g.s_beta_len);
}

// Launch, or (blocks != nullptr) ask the occupancy calculator how many
// blocks an SM holds with that shared tier.  The dynamic shared memory
// limit is raised to the tier's bytes first; a tier the card refuses is
// an error, never a smaller tier.
template <int L, bool kExact, bool kRank, typename BetaT>
cudaError_t launch(const Args& a, int* blocks) {
  const auto kernel = scl_decode_kernel<L, kExact, kRank, BetaT>;
  const size_t bytes = shared_bytes<L, BetaT>(a.g);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  if (blocks != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         kThreads, bytes);
  }
  kernel<<<a.batch, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.llrs), static_cast<const uint4*>(a.rows),
      a.n_rows, a.g, static_cast<float*>(a.llr_scratch),
      static_cast<BetaT*>(a.beta_scratch), static_cast<uint8_t*>(a.cw),
      static_cast<float*>(a.pm));
  return cudaGetLastError();
}

// The instances this library holds.  The default library: B and C with
// int8 betas.  The options library: B with kRank and/or f32 betas, C
// with f32 betas (kRank does not apply to C).  Anything else is
// cudaErrorInvalidValue.
template <int L>
cudaError_t launch_variant(bool exact, bool rank, bool f32, const Args& a,
                           int* blocks) {
  if (rank && !exact) return cudaErrorInvalidValue;
#ifndef SCL_DECODE_OPTIONS
  if (rank || f32) return cudaErrorInvalidValue;
  return exact ? launch<L, true, false, int8_t>(a, blocks)
               : launch<L, false, false, int8_t>(a, blocks);
#else
  if (!rank && !f32) return cudaErrorInvalidValue;
  if (!exact) return launch<L, false, false, float>(a, blocks);
  if (!f32) return launch<L, true, true, int8_t>(a, blocks);
  return rank ? launch<L, true, true, float>(a, blocks)
              : launch<L, true, false, float>(a, blocks);
#endif
}

cudaError_t dispatch(int list_size, bool exact, bool rank, bool f32,
                     const Args& a, int* blocks) {
  switch (list_size) {
    case 2:
      return launch_variant<2>(exact, rank, f32, a, blocks);
    case 4:
      return launch_variant<4>(exact, rank, f32, a, blocks);
    case 8:
      return launch_variant<8>(exact, rank, f32, a, blocks);
    default:
      return cudaErrorInvalidValue;
  }
}

#endif  // SCL_DECODE_UNROLLED

}  // namespace

#ifndef SCL_DECODE_UNROLLED

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t; `rows` is the packed table (pack_list_rows:
// n_rows rows and a zero row).  The geometry is list_tiers': the global
// scratch holds, per frame and lane, llr_lo - d0_len LLRs and beta_lo
// betas; the shared tier s_llr_len LLRs and s_beta_len betas a lane.
// `exact` nonzero runs the exact one-shot leaves (kernel B), zero the
// Fast-SSC-List leaves (kernel C); `rank` nonzero the rank-count one-shot
// selection (exact only); `beta_f32` nonzero partial sums in f32 (the
// beta scratch is then float, else int8).  Launches one block per frame
// on `stream` without synchronising, and returns cudaGetLastError() (or
// the error of setting the shared-memory limit) as an int
// (cudaErrorInvalidValue for a list size other than 2, 4 or 8, a code
// deeper than kMaxDepths, or a variant this library does not hold).
extern "C" int scl_decode_launch(const void* llrs, const void* rows,
                                 int n_rows, int code_len, int d0_len,
                                 int llr_lo, int beta_lo, int s_llr_len,
                                 int s_beta_len, int out_off, int n_depths,
                                 int list_size, int exact, int rank,
                                 int beta_f32, void* llr_scratch,
                                 void* beta_scratch, void* cw, void* pm,
                                 int batch, void* stream) {
  if (n_depths > kMaxDepths) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{llrs, rows, n_rows,
               Geom{code_len, d0_len, llr_lo, beta_lo, s_llr_len, s_beta_len,
                    out_off, n_depths},
               llr_scratch, beta_scratch, cw, pm, batch,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(list_size, exact != 0, rank != 0,
                                   beta_f32 != 0, a, nullptr));
}

// The blocks of that instance an SM holds at once with that shared tier
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int scl_decode_occupancy(int list_size, int exact, int rank,
                                    int beta_f32, int s_llr_len,
                                    int s_beta_len, int* blocks) {
  Args a{};
  a.g.s_llr_len = s_llr_len;
  a.g.s_beta_len = s_beta_len;
  return static_cast<int>(dispatch(list_size, exact != 0, rank != 0,
                                   beta_f32 != 0, a, blocks));
}

extern "C" const char* scl_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // SCL_DECODE_UNROLLED
