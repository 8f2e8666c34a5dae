// Successive-cancellation list (SCL) decode of a polar code, one thread
// block per frame, interpreting the schedule of fec/schedule.py over L
// list lanes.  Two template parameters: L = 2, 4 or 8, and kExact, which
// picks the RATE1 / SPC leaf rule.
//
// Replaces the list_size > 1 instances of the TPU Pallas kernel
// modem_tpu/kernels/scl_pallas.py (make_pallas_decoder(frozen, L, exact)
// -> decode -> pl.pallas_call, scl_pallas.py:1732).  kExact = true is
// kernel B, exact=True (selections make_select_l_smallest :425,
// make_select_flat :512, oneshot_core :1271); kExact = false is kernel C,
// the Fast-SSC-List approximation exact=False (rate1_core's fast branch
// :1231-1269, spc_core_serial :1384-1447).  Each computes what the VM the
// Pallas kernel is pinned against computes, modem_tpu/fec/scl_vm.py
// make_decoder(frozen, L, exact):
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
//   BIG / 2 and invalid columns are BIG, so sums reach inf).
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
// State (about 3.8 MB a wire-size frame at L = 8, caller-allocated):
// LLRs of depth >= 1 as f32 [L, sz_llr - d0_len] and partial sums as
// int8 +/-1 [L, sz_beta] in global scratch; depth 0 is the same in every
// lane and is read from the input.  refs, brefs and pm live in shared
// memory.  Output: codeword bit = (beta < 0) over the physical rows of
// the root slot, path metrics in lane order (the VM's semantics).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 512;      // widest op; one thread per column
constexpr int kWarps = kChunk / 32;
constexpr int kPerThread = kChunk / 32;   // columns per lane of a warp
constexpr int kCols = 14;        // schedule row width
constexpr int kMaxDepths = 20;   // codes up to 2^19
constexpr int kPatterns = 128;   // subsets of the 7 least reliable
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

template <int L, bool kExact>
__global__ void __launch_bounds__(kChunk, 1)
scl_decode_kernel(const float* __restrict__ llr_in,
                  const int* __restrict__ ops, int n_ops, int code_len,
                  int d0_len, int llr_len, int beta_len, int out_off,
                  int n_depths, float* llr_scratch, int8_t* beta_scratch,
                  uint8_t* __restrict__ cw_out, float* __restrict__ pm_out) {
  __shared__ int refs_buf[2][kMaxDepths][L];
  __shared__ int brefs_buf[2][2 * kMaxDepths][L];
  __shared__ float pm[L];
  __shared__ float red[kWarps][2 * L];     // per-warp partial sums
  __shared__ int os_idx[L][8];             // one-shot: least reliable
                                           //   columns per lane
  __shared__ int os_odd[L];                //   SPC parity per lane
  __shared__ float os_val[L][kFastRounds]; //   fast: their |a|
  __shared__ float top_v[L * L];           // each lane's best L
  __shared__ int top_i[L * L];             //   (value, lane * 128 + p)
  __shared__ int sel_src[L];               // new lane k: source lane,
  __shared__ int sel_code[L];              //   REP flip / one-shot p,
  __shared__ float sel_pm[L];              //   path metric

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const size_t frame = blockIdx.x;
  const float* in = llr_in + frame * code_len;
  float* llr = llr_scratch + frame * L * static_cast<size_t>(llr_len);
  int8_t* beta = beta_scratch + frame * L * static_cast<size_t>(beta_len);
  const int n_slots = 2 * n_depths;

  // LLR of physical row `phys` at schedule offset `off` (depth 0 is the
  // input itself, the same in every lane); partial sum likewise.
  auto rd = [&](int phys, int off) -> float {
    return off < d0_len ? in[off]
                        : llr[static_cast<size_t>(phys) * llr_len + off -
                              d0_len];
  };
  auto bptr = [&](int phys, int off) -> int8_t* {
    return beta + static_cast<size_t>(phys) * beta_len + off;
  };

  for (int e = t; e < n_depths * L; e += kChunk) {
    refs_buf[0][e / L][e % L] = e % L;
  }
  for (int e = t; e < n_slots * L; e += kChunk) {
    brefs_buf[0][e / L][e % L] = e % L;
  }
  if (t < L) pm[t] = t == 0 ? 0.f : kBig * 0.5f;  // clones die at a fork
  __syncthreads();

  int cur = 0;  // live half of the double-buffered lane maps
  for (int i = 0; i < n_ops; ++i) {
    const int* row = ops + i * kCols;
    const int op = __ldg(row + C_OP);
    const int d = __ldg(row + C_D);
    const int width = __ldg(row + C_WIDTH);
    const bool last = __ldg(row + C_LAST) != 0;
    const bool act = t < width;
    int(*refs)[L] = refs_buf[cur];
    int(*brefs)[L] = brefs_buf[cur];
    bool fork = false;

    if (op == OP_F || op == OP_G) {
      if (act) {
        const int src = __ldg(row + C_SRC) + t;
        const int src2 = __ldg(row + C_SRC2) + t;
        const int dst = __ldg(row + C_DST) - d0_len + t;
        const int bsrc = __ldg(row + C_BSRC) + t;
        const int sidr = __ldg(row + C_SIDR);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const int p = refs[d][l];
          const float a = rd(p, src), b = rd(p, src2);
          float out;
          if (op == OP_F) {
            out = sign_of(a) * sign_of(b) * fminf(fabsf(a), fabsf(b));
          } else {
            out = b + static_cast<float>(*bptr(brefs[sidr][l], bsrc)) * a;
          }
          llr[static_cast<size_t>(l) * llr_len + dst] = out;
        }
      }
      if (last && t < L) refs[d + 1][t] = t;
    } else if (op == OP_COMBINE) {
      if (act) {
        const int bsrc = __ldg(row + C_BSRC) + t;
        const int bsrc2 = __ldg(row + C_BSRC2) + t;
        const int bdst = __ldg(row + C_BDST) + t;
        const int dst = __ldg(row + C_DST) + t;
        const int sidr = __ldg(row + C_SIDR), sidr2 = __ldg(row + C_SIDR2);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const int8_t bl = *bptr(brefs[sidr][l], bsrc);
          const int8_t br = *bptr(brefs[sidr2][l], bsrc2);
          *bptr(l, bdst) = static_cast<int8_t>(bl * br);
          *bptr(l, dst) = br;
        }
      }
      if (last && t < L) brefs[__ldg(row + C_SIDW)][t] = t;
    } else if (op == OP_RATE0 || op == OP_REP) {
      const int src = __ldg(row + C_SRC) + t;
      const int bdst = __ldg(row + C_BDST) + t;
      float m0[L], m1[L];  // per lane: cost of all +1, of all -1
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float a = act ? rd(refs[d][l], src) : 0.f;
        m0[l] = warp_sum(fmaxf(-a, 0.f));
        m1[l] = op == OP_REP ? warp_sum(fmaxf(a, 0.f)) : 0.f;
      }
      if (lane == 0) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
          red[warp][l] = m0[l];
          red[warp][L + l] = m1[l];
        }
      }
      if (op == OP_RATE0) {
        if (act) {
#pragma unroll
          for (int l = 0; l < L; ++l) *bptr(l, bdst) = 1;
        }
        if (last && t < L) brefs[__ldg(row + C_SIDW)][t] = t;
        __syncthreads();
        if (t < L) {
          float s = 0.f;
          for (int w = 0; w < kWarps; ++w) s += red[w][t];
          pm[t] += s;
        }
      } else {
        __syncthreads();
        if (warp == 0) {
          // lane j < 2L holds candidate j: keep (j < L) or flip of lane
          // j % L; its rank among the 2L is its new lane
          float c = inf_f();
          if (lane < 2 * L) {
            float s = 0.f;
            for (int w = 0; w < kWarps; ++w) s += red[w][lane];
            c = pm[lane % L] + s;
          }
          int rank = 0;
#pragma unroll
          for (int j = 0; j < 2 * L; ++j) {
            const float cj = __shfl_sync(kFull, c, j);
            rank += before(cj, j, c, lane);
          }
          if (lane < 2 * L && rank < L) {
            sel_src[rank] = lane % L;
            sel_code[rank] = lane >= L;
            sel_pm[rank] = c;
          }
        }
        __syncthreads();
        if (act) {
#pragma unroll
          for (int k = 0; k < L; ++k) *bptr(k, bdst) = sel_code[k] ? -1 : 1;
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
      const int src = __ldg(row + C_SRC);
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
            const float a = rd(p, src + c);
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
          // the 128 candidates of this lane, 4 a thread: pattern q's flip
          // penalties summed in the VM's order, then pm, then (SPC) the
          // forced parity flip of the least reliable column
          float ev[7];  // the enumerated 7, in order
#pragma unroll
          for (int j = 0; j < 7; ++j) ev[j] = spc ? vals[j + 1] : vals[j];
          float cand[kPatterns / 32];
          const float pml = pm[warp];
#pragma unroll
          for (int q = 0; q < kPatterns / 32; ++q) {
            const int pat = lane + 32 * q;
            float subs = 0.f;
#pragma unroll
            for (int j = 0; j < 7; ++j) {
              if ((pat >> j) & 1) subs = subs + ev[j];
            }
            float c = pml + subs;
            if (spc) c = c + ((odd ^ (__popc(pat) & 1)) ? vals[0] : 0.f);
            cand[q] = c;
          }
          // this lane's best L of its 128, in selection order
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
              top_v[warp * L + r] = bv;
              top_i[warp * L + r] = warp * kPatterns + bi;
            }
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kLeast; ++r) {
            os_idx[warp][r] = cols[r];
            if constexpr (!kExact) os_val[warp][r] = vals[r];
          }
          os_odd[warp] = odd;
        }
      }
      __syncthreads();
      if constexpr (kExact) {
        // the global best L lie among the lanes' best L: rank in the union
        if (t < L * L) {
          const float v = top_v[t];
          const int id = top_i[t];
          int rank = 0;
          for (int j = 0; j < L * L; ++j) {
            rank += before(top_v[j], top_i[j], v, id);
          }
          if (rank < L) {
            sel_src[rank] = id / kPatterns;
            sel_code[rank] = id % kPatterns;
            sel_pm[rank] = v;
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
        float p = pm[k];
        if (spc) p = p + (os_odd[k] ? os_val[k][0] : 0.f);
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
              const float vr = os_val[gk][r];
              float delta = vr;
              if (spc) {
                const float v0 = os_val[gk][0];
                delta = os_odd[gk] ? vr - v0 : vr + v0;
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
          sel_src[lane] = g;
          sel_code[lane] = static_cast<int>(fm);
          sel_pm[lane] = p;
        }
      }
      __syncthreads();
      if (act) {
        const int bdst = __ldg(row + C_BDST) + t;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          const int s = sel_src[k], pat = sel_code[k];
          const float a = rd(refs[d][s], src + t);
          bool flip = false;
          if constexpr (kExact) {
#pragma unroll
            for (int j = 0; j < 7; ++j) {
              flip |= ((pat >> j) & 1) && os_idx[s][fl0 + j] == t;
            }
            if (spc) {
              flip |= (os_odd[s] ^ (__popc(pat) & 1)) && os_idx[s][0] == t;
            }
          } else if (spc) {
            // parity fix of i0, then each pair flip {i0, i_r} taken
            const bool at0 = os_idx[s][0] == t;
            flip = os_odd[s] && at0;
#pragma unroll
            for (int r = 1; r < kFastRounds; ++r) {
              if ((pat >> r) & 1) flip ^= at0 ^ (os_idx[s][r] == t);
            }
          } else {
#pragma unroll
            for (int r = 0; r < kFastRounds; ++r) {
              if ((pat >> r) & 1) flip ^= os_idx[s][r] == t;
            }
          }
          const int8_t b = a < 0.f ? -1 : 1;
          *bptr(k, bdst) = flip ? static_cast<int8_t>(-b) : b;
        }
      }
      fork = true;
    }

    if (fork) {
      // new lane k continues source lane sel_src[k]: permute every map
      // row into the other half; the leaf's own slot becomes identity
      const int sidw = __ldg(row + C_SIDW);
      int(*refs2)[L] = refs_buf[cur ^ 1];
      int(*brefs2)[L] = brefs_buf[cur ^ 1];
      for (int e = t; e < (n_depths + n_slots) * L; e += kChunk) {
        const int k = e % L;
        const int r = e / L;
        if (r < n_depths) {
          refs2[r][k] = refs[r][sel_src[k]];
        } else {
          const int s = r - n_depths;
          brefs2[s][k] = (last && s == sidw) ? k : brefs[s][sel_src[k]];
        }
      }
      if (t < L) pm[t] = sel_pm[t];
    }
    __syncthreads();
    if (fork) cur ^= 1;
  }

  uint8_t* cw = cw_out + frame * L * static_cast<size_t>(code_len);
  for (int k = 0; k < L; ++k) {
    for (int j = t; j < code_len; j += kChunk) {
      cw[static_cast<size_t>(k) * code_len + j] = *bptr(k, out_off + j) < 0;
    }
  }
  if (t < L) pm_out[frame * L + t] = pm[t];
}

template <int L, bool kExact>
cudaError_t launch(const void* llrs, const void* ops, int n_ops,
                   int code_len, int d0_len, int llr_len, int beta_len,
                   int out_off, int n_depths, void* llr_scratch,
                   void* beta_scratch, void* cw, void* pm, int batch,
                   cudaStream_t stream) {
  scl_decode_kernel<L, kExact><<<batch, kChunk, 0, stream>>>(
      static_cast<const float*>(llrs), static_cast<const int*>(ops), n_ops,
      code_len, d0_len, llr_len, beta_len, out_off, n_depths,
      static_cast<float*>(llr_scratch), static_cast<int8_t*>(beta_scratch),
      static_cast<uint8_t*>(cw), static_cast<float*>(pm));
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_mode(bool exact, const void* llrs, const void* ops,
                        int n_ops, int code_len, int d0_len, int llr_len,
                        int beta_len, int out_off, int n_depths,
                        void* llr_scratch, void* beta_scratch, void* cw,
                        void* pm, int batch, cudaStream_t stream) {
  return exact ? launch<L, true>(llrs, ops, n_ops, code_len, d0_len,
                                 llr_len, beta_len, out_off, n_depths,
                                 llr_scratch, beta_scratch, cw, pm, batch,
                                 stream)
               : launch<L, false>(llrs, ops, n_ops, code_len, d0_len,
                                  llr_len, beta_len, out_off, n_depths,
                                  llr_scratch, beta_scratch, cw, pm, batch,
                                  stream);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// `stream` is a cudaStream_t.  `exact` nonzero runs the exact one-shot
// leaves (kernel B), zero the Fast-SSC-List leaves (kernel C).  Launches
// one block per frame on `stream` without synchronising, and returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for a list size
// other than 2, 4 or 8, or a code deeper than kMaxDepths).
extern "C" int scl_decode_launch(const void* llrs, const void* ops,
                                 int n_ops, int code_len, int d0_len,
                                 int llr_len, int beta_len, int out_off,
                                 int n_depths, int list_size, int exact,
                                 void* llr_scratch, void* beta_scratch,
                                 void* cw, void* pm, int batch,
                                 void* stream) {
  if (n_depths > kMaxDepths) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const bool ex = exact != 0;
  switch (list_size) {
    case 2:
      return static_cast<int>(launch_mode<2>(
          ex, llrs, ops, n_ops, code_len, d0_len, llr_len, beta_len, out_off,
          n_depths, llr_scratch, beta_scratch, cw, pm, batch, s));
    case 4:
      return static_cast<int>(launch_mode<4>(
          ex, llrs, ops, n_ops, code_len, d0_len, llr_len, beta_len, out_off,
          n_depths, llr_scratch, beta_scratch, cw, pm, batch, s));
    case 8:
      return static_cast<int>(launch_mode<8>(
          ex, llrs, ops, n_ops, code_len, d0_len, llr_len, beta_len, out_off,
          n_depths, llr_scratch, beta_scratch, cw, pm, batch, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* scl_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
