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
//   BIG / 2 and invalid columns are BIG, so sums reach inf).  Leaves
//   narrower than the 7-8 enumerated columns (in decomposed-SPC
//   schedules, down to width 1) take BIG for the missing columns, so
//   their candidates sum to inf and tie; the index order still decides.
//
// What bounds it on an H100: a serial chain of 10,252 schedule rows per
// wire-size frame, 2,132 of them forks (786 REP, 204 RATE1, 1,142 SPC),
// each fork a reduction, a selection and a map permutation separated by
// block barriers.  At the serving fallback batch of 16 frames only 16 of
// the 132 SMs hold a block, so the time is one frame's latency.  The
// design keeps the selections off the block barriers where it can: each
// lane's least-reliable columns (and, exact, its best L of 128 one-shot
// candidates) come from one warp with shuffles; the fast rounds run in
// warp 0's registers, one rank count over 2L candidates a round, and
// only their composed result goes through shared memory; the merge of
// the exact L x L survivors (a rank count) and the REP rank (warp 0)
// touch the whole block.  The L lanes of a column are one thread's
// unrolled loop, so their loads are in flight together.  The lane maps
// double-buffer in shared memory so a fork's permutation needs no extra
// barrier.
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
// State (about 3.8 MB a wire-size frame at L = 8 with int8 betas,
// caller-allocated): LLRs of depth >= 1 as f32 [L, sz_llr - d0_len] and
// partial sums as BetaT +/-1 [L, sz_beta] in global scratch; depth 0 is
// the same in every lane and is read from the input.  refs, brefs and pm
// live in shared memory.  Output: codeword bit = (beta < 0) over the
// physical rows of the root slot, path metrics in lane order (the VM's
// semantics).
//
// Built three ways from this one file: the default library (B and C with
// int8 betas), the options library (-DSCL_DECODE_OPTIONS: kRank and f32
// betas) and, embedded by kernels/unroll.py with -DSCL_DECODE_UNROLLED
// defined first, a kernel of straight-line run_row calls for one
// schedule (then the interpreter and its entry points are left out).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 512;      // widest op; one thread per column
constexpr int kWarps = kChunk / 32;
constexpr int kPerThread = kChunk / 32;   // columns per lane of a warp
constexpr int kCols = 14;        // schedule row width
constexpr int kMaxDepths = 20;   // codes up to 2^19
constexpr int kPatterns = 128;   // subsets of the 7 least reliable
constexpr int kLive = 13;        // patterns that can reach a top 8
constexpr int kFastRounds = 4;   // T_RATE1: fast-mode fork rounds
constexpr float kBig = 3.0e38f;
constexpr int kNoIndex = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

enum Op { OP_F, OP_G, OP_COMBINE, OP_RATE0, OP_REP, OP_RATE1, OP_SPC };
enum Col { C_OP, C_D, C_SRC, C_SRC2, C_DST, C_BSRC, C_BSRC2, C_BDST,
           C_SIDR, C_SIDR2, C_SIDW, C_WIDTH, C_LAST, C_SUB };

__device__ __forceinline__ float inf_f() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

// The selection order: smaller value first, lower index on ties.
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Warp-wide minimum of (v, i) in selection order; every lane gets it.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    const int j = __shfl_xor_sync(kFull, i, o);
    if (before(w, j, v, i)) {
      v = w;
      i = j;
    }
  }
}

// Pattern code of live candidate q < kLive: 0..9, then 16, 32, 64.
__device__ __forceinline__ int live_pattern(int q) {
  return q < 10 ? q : 16 << (q - 10);
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

template <int L>
struct Shared {
  int refs_buf[2][kMaxDepths][L];
  int brefs_buf[2][2 * kMaxDepths][L];
  float pm[L];
  float red[kWarps][2 * L];       // per-warp partial sums
  int os_idx[L][8];               // least reliable columns per lane
  int os_odd[L];                  // SPC parity per lane
  float os_val[L][kFastRounds];   // fast: their |a|
  float top_v[L * L];             // each lane's best L
  int top_i[L * L];               //   (value, lane * 128 + p)
  int sel_src[L];                 // new lane k: source lane,
  int sel_code[L];                //   REP flip / one-shot p / fast mask,
  float sel_pm[L];                //   path metric
};

// One frame's view of the global buffers and which half of the double-
// buffered lane maps is live.
template <int L, typename BetaT>
struct Frame {
  const float* in;
  float* llr;
  BetaT* beta;
  int d0_len, llr_len, beta_len, n_depths;
  int cur;

  // LLR of physical row `phys` at schedule offset `off` (depth 0 is the
  // input itself, the same in every lane); partial sum likewise.
  __device__ __forceinline__ float rd(int phys, int off) const {
    return off < d0_len ? in[off]
                        : llr[static_cast<size_t>(phys) * llr_len + off -
                              d0_len];
  }
  __device__ __forceinline__ BetaT* bptr(int phys, int off) const {
    return beta + static_cast<size_t>(phys) * beta_len + off;
  }
};

template <int L, typename BetaT>
__device__ __forceinline__ Frame<L, BetaT> frame_begin(
    Shared<L>& s, const float* llr_in, int code_len, int d0_len,
    int llr_len, int beta_len, int n_depths, float* llr_scratch,
    BetaT* beta_scratch) {
  const int t = threadIdx.x;
  const size_t frame = blockIdx.x;
  Frame<L, BetaT> f;
  f.in = llr_in + frame * code_len;
  f.llr = llr_scratch + frame * L * static_cast<size_t>(llr_len);
  f.beta = beta_scratch + frame * L * static_cast<size_t>(beta_len);
  f.d0_len = d0_len;
  f.llr_len = llr_len;
  f.beta_len = beta_len;
  f.n_depths = n_depths;
  f.cur = 0;
  for (int e = t; e < n_depths * L; e += kChunk) {
    s.refs_buf[0][e / L][e % L] = e % L;
  }
  for (int e = t; e < 2 * n_depths * L; e += kChunk) {
    s.brefs_buf[0][e / L][e % L] = e % L;
  }
  if (t < L) s.pm[t] = t == 0 ? 0.f : kBig * 0.5f;  // clones die at a fork
  __syncthreads();
  return f;
}

template <int L, typename BetaT>
__device__ __forceinline__ void frame_end(const Frame<L, BetaT>& f,
                                          const Shared<L>& s, int code_len,
                                          int out_off,
                                          uint8_t* __restrict__ cw_out,
                                          float* __restrict__ pm_out) {
  const int t = threadIdx.x;
  const size_t frame = blockIdx.x;
  uint8_t* cw = cw_out + frame * L * static_cast<size_t>(code_len);
  for (int k = 0; k < L; ++k) {
    for (int j = t; j < code_len; j += kChunk) {
      cw[static_cast<size_t>(k) * code_len + j] = *f.bptr(k, out_off + j) < 0;
    }
  }
  if (t < L) pm_out[frame * L + t] = s.pm[t];
}

// One schedule row, ending in a block barrier.
template <int L, bool kExact, bool kRank, typename BetaT, typename Row>
__device__ __forceinline__ void run_row(Frame<L, BetaT>& f, Shared<L>& s,
                                        const Row& row) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int n_depths = f.n_depths, n_slots = 2 * n_depths;
  const int op = row[C_OP];
  const int d = row[C_D];
  const int width = row[C_WIDTH];
  const bool last = row[C_LAST] != 0;
  const bool act = t < width;
  int(*refs)[L] = s.refs_buf[f.cur];
  int(*brefs)[L] = s.brefs_buf[f.cur];
  bool fork = false;

  if (op == OP_F || op == OP_G) {
    if (act) {
      const int src = row[C_SRC] + t;
      const int src2 = row[C_SRC2] + t;
      const int dst = row[C_DST] - f.d0_len + t;
      const int bsrc = row[C_BSRC] + t;
      const int sidr = row[C_SIDR];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int p = refs[d][l];
        const float a = f.rd(p, src), b = f.rd(p, src2);
        float out;
        if (op == OP_F) {
          out = sign_of(a) * sign_of(b) * fminf(fabsf(a), fabsf(b));
        } else {
          out = b + static_cast<float>(*f.bptr(brefs[sidr][l], bsrc)) * a;
        }
        f.llr[static_cast<size_t>(l) * f.llr_len + dst] = out;
      }
    }
    if (last && t < L) refs[d + 1][t] = t;
  } else if (op == OP_COMBINE) {
    if (act) {
      const int bsrc = row[C_BSRC] + t;
      const int bsrc2 = row[C_BSRC2] + t;
      const int bdst = row[C_BDST] + t;
      const int dst = row[C_DST] + t;
      const int sidr = row[C_SIDR], sidr2 = row[C_SIDR2];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const BetaT bl = *f.bptr(brefs[sidr][l], bsrc);
        const BetaT br = *f.bptr(brefs[sidr2][l], bsrc2);
        *f.bptr(l, bdst) = static_cast<BetaT>(bl * br);
        *f.bptr(l, dst) = br;
      }
    }
    if (last && t < L) brefs[row[C_SIDW]][t] = t;
  } else if (op == OP_RATE0 || op == OP_REP) {
    const int src = row[C_SRC] + t;
    const int bdst = row[C_BDST] + t;
    float m0[L], m1[L];  // per lane: cost of all +1, of all -1
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float a = act ? f.rd(refs[d][l], src) : 0.f;
      m0[l] = warp_sum(fmaxf(-a, 0.f));
      m1[l] = op == OP_REP ? warp_sum(fmaxf(a, 0.f)) : 0.f;
    }
    if (lane == 0) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        s.red[warp][l] = m0[l];
        s.red[warp][L + l] = m1[l];
      }
    }
    if (op == OP_RATE0) {
      if (act) {
#pragma unroll
        for (int l = 0; l < L; ++l) *f.bptr(l, bdst) = static_cast<BetaT>(1);
      }
      if (last && t < L) brefs[row[C_SIDW]][t] = t;
      __syncthreads();
      if (t < L) {
        float sum = 0.f;
        for (int w = 0; w < kWarps; ++w) sum += s.red[w][t];
        s.pm[t] += sum;
      }
    } else {
      __syncthreads();
      if (warp == 0) {
        // lane j < 2L holds candidate j: keep (j < L) or flip of lane
        // j % L; its rank among the 2L is its new lane
        float c = inf_f();
        if (lane < 2 * L) {
          float sum = 0.f;
          for (int w = 0; w < kWarps; ++w) sum += s.red[w][lane];
          c = s.pm[lane % L] + sum;
        }
        int rank = 0;
#pragma unroll
        for (int j = 0; j < 2 * L; ++j) {
          const float cj = __shfl_sync(kFull, c, j);
          rank += before(cj, j, c, lane);
        }
        if (lane < 2 * L && rank < L) {
          s.sel_src[rank] = lane % L;
          s.sel_code[rank] = lane >= L;
          s.sel_pm[rank] = c;
        }
      }
      __syncthreads();
      if (act) {
#pragma unroll
        for (int k = 0; k < L; ++k) {
          *f.bptr(k, bdst) = static_cast<BetaT>(s.sel_code[k] ? -1 : 1);
        }
      }
      fork = true;
    }
  } else if (op == OP_RATE1 || op == OP_SPC) {
    const bool spc = op == OP_SPC;
    // least reliable columns a lane needs: exact 7 (RATE1) or 8 (SPC),
    // fast kFastRounds
    const int n_least = kExact ? (spc ? 8 : 7) : kFastRounds;
    constexpr int kLeast = kExact ? 8 : kFastRounds;
    const int fl0 = spc ? 1 : 0;   // first of the 7 enumerated columns
    const int src = row[C_SRC];
    if (warp < L) {
      // warp w: logical lane w.  Its 512 columns, 16 a thread, with
      // the columns past the width at BIG as in the VM.
      const int p = refs[d][warp];
      float mag[kPerThread];
      int neg = 0;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int c = lane + 32 * j;
        if (c < width) {
          const float a = f.rd(p, src + c);
          mag[j] = fabsf(a);
          neg += a < 0.f;
        } else {
          mag[j] = kBig;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        neg += __shfl_xor_sync(kFull, neg, o);
      }
      const int odd = neg & 1;
      // the n_least smallest |a|, lowest column first on ties
      float vals[kLeast];
      int cols[kLeast];
      unsigned taken = 0;
#pragma unroll
      for (int r = 0; r < kLeast; ++r) {
        float bv = inf_f();
        int bi = kNoIndex;
        if (r < n_least) {
#pragma unroll
          for (int j = 0; j < kPerThread; ++j) {
            if (!((taken >> j) & 1u) &&
                before(mag[j], lane + 32 * j, bv, bi)) {
              bv = mag[j];
              bi = lane + 32 * j;
            }
          }
          warp_argmin(bv, bi);
          if ((bi & 31) == lane) taken |= 1u << (bi >> 5);
        }
        vals[r] = bv;
        cols[r] = bi;
      }
      if constexpr (kExact) {
        // a pattern's candidate: its flip penalties summed in the VM's
        // order, then pm, then (SPC) the forced parity flip of the least
        // reliable column
        float ev[7];  // the enumerated 7, in order
#pragma unroll
        for (int j = 0; j < 7; ++j) ev[j] = spc ? vals[j + 1] : vals[j];
        const float pml = s.pm[warp];
        auto candidate = [&](int pat) -> float {
          float subs = 0.f;
#pragma unroll
          for (int j = 0; j < 7; ++j) {
            if ((pat >> j) & 1) subs = subs + ev[j];
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
            float bv = inf_f();
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
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kLeast; ++r) {
          s.os_idx[warp][r] = cols[r];
          if constexpr (!kExact) s.os_val[warp][r] = vals[r];
        }
        s.os_odd[warp] = odd;
      }
    }
    __syncthreads();
    if constexpr (kExact) {
      // the global best L lie among the lanes' best L: rank in the union
      if (t < L * L) {
        const float v = s.top_v[t];
        const int id = s.top_i[t];
        int rank = 0;
        for (int j = 0; j < L * L; ++j) {
          rank += before(s.top_v[j], s.top_i[j], v, id);
        }
        if (rank < L) {
          s.sel_src[rank] = id / kPatterns;
          s.sel_code[rank] = id % kPatterns;
          s.sel_pm[rank] = v;
        }
      }
    } else if (warp == 0) {
      // the serial fork rounds, in warp 0's registers: lane k < L holds
      // path k's source lane g (at the leaf's start), the rounds whose
      // flip it took (bit r of fm), its switched flag and metric
      const int k = lane & (L - 1);
      int g = k;
      unsigned fm = 0;
      int sw = 0;
      float p = s.pm[k];
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
        int pick = 0;  // the candidate of rank `lane`
#pragma unroll
        for (int j = 0; j < 2 * L; ++j) {
          if (__shfl_sync(kFull, rank, j) == lane) pick = j;
        }
        const float c_new = __shfl_sync(kFull, c, pick);
        const int from = pick & (L - 1);
        const bool flip = pick >= L;
        g = __shfl_sync(kFull, g, from);
        fm = __shfl_sync(kFull, fm, from) | (flip ? 1u << r : 0u);
        sw = __shfl_sync(kFull, sw, from) | flip;
        p = c_new;
      }
      if (lane < L) {
        s.sel_src[lane] = g;
        s.sel_code[lane] = static_cast<int>(fm);
        s.sel_pm[lane] = p;
      }
    }
    __syncthreads();
    if (act) {
      const int bdst = row[C_BDST] + t;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int sl = s.sel_src[k], pat = s.sel_code[k];
        const float a = f.rd(refs[d][sl], src + t);
        bool flip = false;
        if constexpr (kExact) {
#pragma unroll
          for (int j = 0; j < 7; ++j) {
            flip |= ((pat >> j) & 1) && s.os_idx[sl][fl0 + j] == t;
          }
          if (spc) {
            flip |= (s.os_odd[sl] ^ (__popc(pat) & 1)) && s.os_idx[sl][0] == t;
          }
        } else if (spc) {
          // parity fix of i0, then each pair flip {i0, i_r} taken
          const bool at0 = s.os_idx[sl][0] == t;
          flip = s.os_odd[sl] && at0;
#pragma unroll
          for (int r = 1; r < kFastRounds; ++r) {
            if ((pat >> r) & 1) flip ^= at0 ^ (s.os_idx[sl][r] == t);
          }
        } else {
#pragma unroll
          for (int r = 0; r < kFastRounds; ++r) {
            if ((pat >> r) & 1) flip ^= s.os_idx[sl][r] == t;
          }
        }
        const BetaT b = static_cast<BetaT>(a < 0.f ? -1 : 1);
        *f.bptr(k, bdst) = flip ? static_cast<BetaT>(-b) : b;
      }
    }
    fork = true;
  }

  if (fork) {
    // new lane k continues source lane sel_src[k]: permute every map
    // row into the other half; the leaf's own slot becomes identity
    const int sidw = row[C_SIDW];
    int(*refs2)[L] = s.refs_buf[f.cur ^ 1];
    int(*brefs2)[L] = s.brefs_buf[f.cur ^ 1];
    for (int e = t; e < (n_depths + n_slots) * L; e += kChunk) {
      const int k = e % L;
      const int r = e / L;
      if (r < n_depths) {
        refs2[r][k] = refs[r][s.sel_src[k]];
      } else {
        const int sl = r - n_depths;
        brefs2[sl][k] = (last && sl == sidw) ? k : brefs[sl][s.sel_src[k]];
      }
    }
    if (t < L) s.pm[t] = s.sel_pm[t];
  }
  __syncthreads();
  if (fork) f.cur ^= 1;
}

#ifndef SCL_DECODE_UNROLLED

template <int L, bool kExact, bool kRank, typename BetaT>
__global__ void __launch_bounds__(kChunk, 1)
scl_decode_kernel(const float* __restrict__ llr_in,
                  const int* __restrict__ ops, int n_ops, int code_len,
                  int d0_len, int llr_len, int beta_len, int out_off,
                  int n_depths, float* llr_scratch, BetaT* beta_scratch,
                  uint8_t* __restrict__ cw_out, float* __restrict__ pm_out) {
  __shared__ Shared<L> s;
  Frame<L, BetaT> f =
      frame_begin<L, BetaT>(s, llr_in, code_len, d0_len, llr_len, beta_len,
                            n_depths, llr_scratch, beta_scratch);
  for (int i = 0; i < n_ops; ++i) {
    run_row<L, kExact, kRank, BetaT>(f, s, TableRow{ops + i * kCols});
  }
  frame_end<L, BetaT>(f, s, code_len, out_off, cw_out, pm_out);
}

struct Args {
  const void* llrs;
  const void* ops;
  int n_ops, code_len, d0_len, llr_len, beta_len, out_off, n_depths;
  void* llr_scratch;
  void* beta_scratch;
  void* cw;
  void* pm;
  int batch;
  cudaStream_t stream;
};

template <int L, bool kExact, bool kRank, typename BetaT>
cudaError_t launch(const Args& a) {
  scl_decode_kernel<L, kExact, kRank, BetaT><<<a.batch, kChunk, 0, a.stream>>>(
      static_cast<const float*>(a.llrs), static_cast<const int*>(a.ops),
      a.n_ops, a.code_len, a.d0_len, a.llr_len, a.beta_len, a.out_off,
      a.n_depths, static_cast<float*>(a.llr_scratch),
      static_cast<BetaT*>(a.beta_scratch), static_cast<uint8_t*>(a.cw),
      static_cast<float*>(a.pm));
  return cudaGetLastError();
}

// The instances this library holds.  The default library: B and C with
// int8 betas.  The options library: B with kRank and/or f32 betas, C
// with f32 betas (kRank does not apply to C).  Anything else is
// cudaErrorInvalidValue.
template <int L>
cudaError_t launch_variant(bool exact, bool rank, bool f32, const Args& a) {
  if (rank && !exact) return cudaErrorInvalidValue;
#ifndef SCL_DECODE_OPTIONS
  if (rank || f32) return cudaErrorInvalidValue;
  return exact ? launch<L, true, false, int8_t>(a)
               : launch<L, false, false, int8_t>(a);
#else
  if (!rank && !f32) return cudaErrorInvalidValue;
  if (!exact) return launch<L, false, false, float>(a);
  if (!f32) return launch<L, true, true, int8_t>(a);
  return rank ? launch<L, true, true, float>(a)
              : launch<L, true, false, float>(a);
#endif
}

#endif  // SCL_DECODE_UNROLLED

}  // namespace

#ifndef SCL_DECODE_UNROLLED

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t.  `exact` nonzero runs the exact one-shot
// leaves (kernel B), zero the Fast-SSC-List leaves (kernel C); `rank`
// nonzero the rank-count one-shot selection (exact only); `beta_f32`
// nonzero partial sums in f32 (the beta scratch is then float, else
// int8).  Launches one block per frame on `stream` without
// synchronising, and returns cudaGetLastError() as an int
// (cudaErrorInvalidValue for a list size other than 2, 4 or 8, a code
// deeper than kMaxDepths, or a variant this library does not hold).
extern "C" int scl_decode_launch(const void* llrs, const void* ops,
                                 int n_ops, int code_len, int d0_len,
                                 int llr_len, int beta_len, int out_off,
                                 int n_depths, int list_size, int exact,
                                 int rank, int beta_f32, void* llr_scratch,
                                 void* beta_scratch, void* cw, void* pm,
                                 int batch, void* stream) {
  if (n_depths > kMaxDepths) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{llrs,        ops,          n_ops, code_len, d0_len,
               llr_len,     beta_len,     out_off, n_depths, llr_scratch,
               beta_scratch, cw,          pm,    batch,
               static_cast<cudaStream_t>(stream)};
  const bool ex = exact != 0, rk = rank != 0, f32 = beta_f32 != 0;
  switch (list_size) {
    case 2:
      return static_cast<int>(launch_variant<2>(ex, rk, f32, a));
    case 4:
      return static_cast<int>(launch_variant<4>(ex, rk, f32, a));
    case 8:
      return static_cast<int>(launch_variant<8>(ex, rk, f32, a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* scl_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // SCL_DECODE_UNROLLED
