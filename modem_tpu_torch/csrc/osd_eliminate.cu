// The OSD header's GF(2) elimination: the BCH(255,71) generator's columns
// taken in each header's reliability order and reduced to row echelon
// form over GF(2), one launch for a batch of headers.  Replaces no
// pl.pallas_call: it stands in for the lax.scan over the 255 columns in
// modem_tpu/fec/osd.py:_rref_gf2, which the port first ran as a Python
// loop of ~15 small ops a column (kernels/osd_eliminate.py:
// osd_eliminate_reference, still the plain version of this kernel and
// what CPU tensors take).
//
// For header b, with m = g[:, perm[b]] (a [71, 255] 0/1 matrix), the
// columns in order:
//   the pivot row is the lowest row index >= rank whose bit in this
//   column is set; if there is one and rank < 71, swap it with row rank,
//   XOR it into every other row (above and below) with the bit set,
//   record the column as row rank's pivot and add one to rank; else
//   change nothing.
// Outputs, byte for byte the plain loop's: the reduced matrix [B, 71,
// 255] uint8 0/1 and the pivot column of each row [B, 71] int64 (0 for a
// row past the final rank).  The pivots are the first 71 independent
// columns, as cand.min() finds them in the loop and in the JAX scan.
//
// Bound and design.  The work is tiny: 18 KB of g read (from L2 after the
// first block), 255 perm values and ~18 KB written a header, a few
// nanoseconds of HBM time at 3.35 TB/s.  Its real limit is the chain of
// up to 255 dependent column steps.  So one warp takes one header (one
// block of 32 threads, B blocks) and keeps the matrix in registers: lane l
// holds rows l, l + 32 and l + 64 (the third only for l < 7), each as four
// 64-bit words of packed bits, bit c of word w being column 64 w + c.  A
// column step is a ballot a row slot and __ffs (the pivot), up to eight
// 64-bit shuffles (the pivot row to every lane, row rank to the pivot's
// lane), and a predicated XOR of the pivot row into each held row: no
// shared memory and no barrier inside the chain.  Two facts shorten it:
//   * rows >= rank are zero in every column before the current one (a
//     found pivot is cleared from all other rows; a column with no pivot
//     had no bit set at rows >= rank; later pivots come from those rows),
//     so the swap and the XOR touch only the words from the current
//     column's word on (a template parameter, so every register index is
//     a constant and nothing goes to local memory);
//   * once rank reaches 71 no later column changes anything, so the walk
//     stops there (72.4 columns on average for the BCH generator in 64
//     random reliability orders, 79 at most, not 255).
// Shared memory only stages the input and the output: g, read by
// independent 16-byte loads, with a row stride of 260 bytes (65 words, so
// lane r's row starts on bank r mod 32 and a warp's column reads and
// 4-byte writes are free of bank conflicts) and the header's permutation
// as bytes (values 0..254), then the reduced rows unpacked for coalesced
// byte writes.  Staged by byte loads, with the gather and output loops
// not unrolled, the kernel took 0.088 ms a launch, against 0.044 so (one
// H100 at 700 W, [1] to [128] alike).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 71;            // rows (information bits)
constexpr int kN = 255;           // columns (code bits)
constexpr int kWords = 4;         // 64-bit words a row
constexpr int kSlots = 3;         // rows a lane: l, l + 32, l + 64
constexpr int kStride = 260;      // shared bytes a staged row
constexpr int kVecs = kK * kN / 16;   // whole 16-byte vectors of g
constexpr unsigned kFull = 0xffffffffu;

typedef uint64_t Rows[kSlots][kWords];

// Row slot s's word w, for a slot s the same on every lane.
__device__ __forceinline__ uint64_t slot_word(const Rows& row, int s,
                                              int w) {
  return s == 0 ? row[0][w] : (s == 1 ? row[1][w] : row[2][w]);
}

// Columns 64 W .. 64 W + n - 1, in order; returns false once rank is kK
// (nothing later changes).
template <int W>
__device__ __forceinline__ bool eliminate_word(Rows& row, int (&piv)[kSlots],
                                               int& rank, int lane) {
  constexpr int n = W == kWords - 1 ? kN - 64 * W : 64;
  for (int bit = 0; bit < n; ++bit) {
    if (rank == kK) return false;
    // the lowest row >= rank with the bit set; rows past kK are all zero
    unsigned cand[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const bool set = (row[s][W] >> bit) & 1u;
      cand[s] = __ballot_sync(kFull, set && lane + 32 * s >= rank);
    }
    int prow;
    if (cand[0]) {
      prow = __ffs(cand[0]) - 1;
    } else if (cand[1]) {
      prow = 31 + __ffs(cand[1]);
    } else if (cand[2]) {
      prow = 63 + __ffs(cand[2]);
    } else {
      continue;                       // no pivot: the column changes nothing
    }
    const int ps = prow >> 5, pl = prow & 31;
    const int rs = rank >> 5, rl = rank & 31;
    uint64_t pv[kWords], rv[kWords];
#pragma unroll
    for (int w = W; w < kWords; ++w) {
      pv[w] = __shfl_sync(kFull, slot_word(row, ps, w), pl);
      rv[w] = __shfl_sync(kFull, slot_word(row, rs, w), rl);
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      // swap rows prow and rank (the same row when prow == rank)
      const bool at_piv = s == ps && lane == pl;
      const bool at_rank = s == rs && lane == rl;
#pragma unroll
      for (int w = W; w < kWords; ++w) {
        row[s][w] = at_rank ? pv[w] : (at_piv ? rv[w] : row[s][w]);
      }
      // clear the column from every other row
      const bool hit = ((row[s][W] >> bit) & 1u) && !at_rank;
      const uint64_t mask = 0ull - static_cast<uint64_t>(hit);
#pragma unroll
      for (int w = W; w < kWords; ++w) row[s][w] ^= pv[w] & mask;
      if (at_rank) piv[s] = 64 * W + bit;
    }
    ++rank;
  }
  return true;
}

__global__ void __launch_bounds__(32)
    osd_eliminate_kernel(const uint8_t* __restrict__ g,
                         const int64_t* __restrict__ perm,
                         uint8_t* __restrict__ red,
                         int64_t* __restrict__ pivots) {
  __shared__ __align__(16) uint32_t stage[kK * kStride / 4];
  __shared__ uint8_t order[kN + 1];
  uint8_t* const bytes = reinterpret_cast<uint8_t*>(stage);
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;

  // stage g by 16-byte loads, independent so that many are in flight
  // (the wrapper hands g over 16-byte aligned); byte j goes to row
  // j / 255, column j % 255
  const uint4* const gv = reinterpret_cast<const uint4*>(g);
#pragma unroll 6
  for (int i = lane; i < kVecs; i += 32) {
    const uint4 v = __ldg(gv + i);
    const uint32_t part[4] = {v.x, v.y, v.z, v.w};
    int r = 16 * i / kN, c = 16 * i - r * kN;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      bytes[r * kStride + c] =
          static_cast<uint8_t>(part[t >> 2] >> (8 * (t & 3)));
      if (++c == kN) {
        c = 0;
        ++r;
      }
    }
  }
  for (int j = 16 * kVecs + lane; j < kK * kN; j += 32) {
    bytes[j / kN * kStride + j % kN] = g[j];
  }
  for (int c = lane; c < kN; c += 32) {
    order[c] = static_cast<uint8_t>(perm[b * kN + c]);
  }
  __syncwarp();

  // gather: bit c of row r is g[r][perm[c]]
  Rows row;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int n = w == kWords - 1 ? kN - 64 * w : 64;
    uint64_t acc[kSlots] = {0, 0, 0};
#pragma unroll 8
    for (int bit = 0; bit < n; ++bit) {
      const int p = order[64 * w + bit];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int r = lane + 32 * s;
        if (r < kK) {
          acc[s] |= static_cast<uint64_t>(bytes[r * kStride + p] != 0)
                    << bit;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) row[s][w] = acc[s];
  }

  int piv[kSlots] = {0, 0, 0};
  int rank = 0;
  if (eliminate_word<0>(row, piv, rank, lane) &&
      eliminate_word<1>(row, piv, rank, lane) &&
      eliminate_word<2>(row, piv, rank, lane)) {
    eliminate_word<3>(row, piv, rank, lane);
  }
  __syncwarp();

  // unpack into the staging rows, four columns a 4-byte store
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int r = lane + 32 * s;
    if (r >= kK) continue;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const uint32_t x = static_cast<uint32_t>(row[s][w] >> (4 * q)) & 15u;
        stage[(r * kStride + 64 * w + 4 * q) / 4] =
            (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
      }
    }
    pivots[b * kK + r] = piv[s];
  }
  __syncwarp();
  uint8_t* const out = red + b * kK * kN;
  for (int r = 0; r < kK; ++r) {
#pragma unroll
    for (int c = lane; c < kN; c += 32) {
      out[r * kN + c] = bytes[r * kStride + c];
    }
  }
}

}  // namespace

// g [71, 255] uint8 0/1 (16-byte aligned), perm [batch, 255] int64 (each
// row a permutation of 0..254), red [batch, 71, 255] uint8, pivots
// [batch, 71] int64, all contiguous on the card; launches on `stream` and
// returns cudaGetLastError() (0 when the launch was taken).
extern "C" int osd_eliminate_launch(const void* g, const void* perm,
                                    void* red, void* pivots, int batch,
                                    void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  osd_eliminate_kernel<<<batch, 32, 0, s>>>(
      static_cast<const uint8_t*>(g), static_cast<const int64_t*>(perm),
      static_cast<uint8_t*>(red), static_cast<int64_t*>(pivots));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* osd_eliminate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
