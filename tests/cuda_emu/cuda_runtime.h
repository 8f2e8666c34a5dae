// A CPU stand-in for the CUDA features csrc/scl_decode.cu uses, so that the
// kernel's own source runs on a machine without a GPU (see
// tests/test_torch_scl_emulated.py).  One std::thread per CUDA thread of a
// block; __syncthreads is a std::barrier over the block, each warp
// collective (shuffle, ballot, redux) a deposit and a std::barrier over
// its 32 lanes.  Blocks run one after another.  It checks the kernel's
// logic (indices, tiers, selections, barriers that the code calls), not
// its timing or what the hardware would do with a missing barrier.
#pragma once
#include <math.h>

#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n)

struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
struct EmuIdx {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local EmuIdx threadIdx;
inline EmuIdx blockIdx;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }

// The block's dynamic shared memory.  Shared-window addresses are 32-bit
// offsets from 2 GB below it, so the static Shared objects (in .bss
// beside it) have addresses too.
alignas(16) inline unsigned char emu_smem[232448];
inline unsigned char* emu_base() { return emu_smem - 0x80000000ull; }
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<size_t>(static_cast<const unsigned char*>(p) -
                             emu_base());
}

struct EmuBlock {
  std::barrier<>* block;
  std::vector<std::barrier<>*> warps;
  std::vector<uint64_t> slots;  // one a thread
};
inline EmuBlock* emu;

inline void __syncthreads() { emu->block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu->warps[threadIdx.x / 32]->arrive_and_wait();
}

// Every lane of the warp deposits v; f reads the warp's 32 deposits.
template <class F>
inline auto emu_exchange(uint64_t v, F f) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu->slots[w * 32 + l] = v;
  emu->warps[w]->arrive_and_wait();
  auto r = f(&emu->slots[w * 32]);
  emu->warps[w]->arrive_and_wait();
  return r;
}
template <class T>
inline uint64_t emu_bits(T v) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  return u;
}
template <class T>
inline T emu_from(uint64_t u) {
  T v;
  std::memcpy(&v, &u, sizeof(T));
  return v;
}

template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  return emu_exchange(emu_bits(v), [&](const uint64_t* s) {
    return emu_from<T>(s[src & 31]);
  });
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int o) {
  const int l = threadIdx.x % 32;
  return emu_exchange(emu_bits(v), [&](const uint64_t* s) {
    return emu_from<T>(s[(l ^ o) & 31]);
  });
}
inline unsigned __ballot_sync(unsigned, int p) {
  return emu_exchange(p != 0, [](const uint64_t* s) {
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m |= (s[i] ? 1u : 0u) << i;
    return m;
  });
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return emu_exchange(v, [](const uint64_t* s) {
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m |= static_cast<unsigned>(s[i]);
    return m;
  });
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  return emu_exchange(v, [](const uint64_t* s) {
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m += static_cast<unsigned>(s[i]);
    return m;
  });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return emu_exchange(v, [](const uint64_t* s) {
    unsigned m = ~0u;
    for (int i = 0; i < 32; ++i) m = std::min(m, static_cast<unsigned>(s[i]));
    return m;
  });
}

template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, F, int,
                                                          size_t) {
  *b = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

// Runs fn() as block `block` of `threads` threads.
template <class F>
inline void emu_block(int threads, int block, F fn) {
  EmuBlock b;
  b.block = new std::barrier<>(threads);
  for (int w = 0; w < threads / 32; ++w) {
    b.warps.push_back(new std::barrier<>(32));
  }
  b.slots.assign(threads, 0);
  emu = &b;
  blockIdx.x = block;
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t) {
    ts.emplace_back([&, t] {
      threadIdx.x = t;
      fn();
    });
  }
  for (auto& th : ts) th.join();
  delete b.block;
  for (auto* w : b.warps) delete w;
}
