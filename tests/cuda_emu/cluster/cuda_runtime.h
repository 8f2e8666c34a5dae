// A CPU stand-in for the CUDA features the probes csrc/probe_p256.cu,
// csrc/probe_rank3.cu and csrc/probe_interleave.cu use, thread-block
// clusters included, so that their own sources run on a machine without a
// GPU (see tests/test_torch_probes_emulated.py).  One std::thread per CUDA
// thread of every block of a cluster, all at once, the grid's clusters one
// after another (a grid of independent blocks is a grid of clusters of
// one); a cluster barrier is a std::barrier over them all, each warp
// collective (__syncwarp too) a deposit and a std::barrier over its 32
// lanes; each block has its own dynamic shared memory, which
// map_shared_rank maps into another block's.  A static __shared__ array is
// a function-static one, shared by every thread of the process: right
// while one block runs at a time, which is how E launches (its grids are
// of independent blocks).  It checks the kernels' logic (indices, which
// block holds what, the barriers the code calls, the launch's geometry and
// attributes), not their timing or what the hardware would do with a
// missing barrier.
#pragma once
#include <math.h>

#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim;

struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct alignas(16) int4 {
  int x, y, z, w;
};

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchOutOfResources = 7,
  cudaErrorInvalidConfiguration = 9,
};
enum {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 11,
};
enum { cudaLaunchAttributeClusterDimension = 4 };

struct cudaLaunchAttribute {
  int id;
  union {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

inline constexpr size_t kEmuSmemMax = 232448;    // a block's, on the card
inline constexpr size_t kEmuSmemDefault = 49152;  // without the attribute

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline int min(int a, int b) { return a < b ? a : b; }

struct EmuBlock {
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<uint64_t> slots;  // one a thread
  std::vector<unsigned char> smem;
};
struct EmuCluster {
  std::unique_ptr<std::barrier<>> all;
  std::vector<EmuBlock> blocks;
};
inline thread_local EmuCluster* emu_cl;
inline thread_local int emu_rank;

template <class T>
inline T* emu_dynamic_smem() {
  return reinterpret_cast<T*>(emu_cl->blocks[emu_rank].smem.data());
}

inline void __syncthreads() {
  emu_cl->blocks[emu_rank].block->arrive_and_wait();
}

// Every lane of the warp deposits v; f reads the warp's 32 deposits.
template <class F>
inline auto emu_exchange(uint64_t v, F f) {
  EmuBlock& b = emu_cl->blocks[emu_rank];
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  b.slots[w * 32 + l] = v;
  b.warps[w]->arrive_and_wait();
  auto r = f(&b.slots[w * 32]);
  b.warps[w]->arrive_and_wait();
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
// The shuffles' width: lanes fall in segments of `width` lanes; a source
// is taken mod width within the lane's own segment, and a lane whose
// source (down, xor) lies past its segment keeps its own value.
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int seg = threadIdx.x % 32 & ~(width - 1);
  return emu_exchange(emu_bits(v), [&](const uint64_t* s) {
    return emu_from<T>(s[seg + (src & (width - 1))]);
  });
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int o, int width = 32) {
  const int l = threadIdx.x % 32, seg = l & ~(width - 1);
  return emu_exchange(emu_bits(v), [&](const uint64_t* s) {
    const int t = (l ^ o) & 31;
    return emu_from<T>(s[t < seg + width ? t : l]);
  });
}
template <class T>
inline T __shfl_down_sync(unsigned, T v, int d, int width = 32) {
  const int l = threadIdx.x % 32;
  return emu_exchange(emu_bits(v), [&](const uint64_t* s) {
    return emu_from<T>(s[l % width + d < width ? l + d : l]);
  });
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_cl->blocks[emu_rank].warps[threadIdx.x / 32]->arrive_and_wait();
}

namespace cooperative_groups {
class cluster_group {
 public:
  static void sync() { emu_cl->all->arrive_and_wait(); }
  static unsigned block_rank() { return static_cast<unsigned>(emu_rank); }
  static unsigned num_blocks() {
    return static_cast<unsigned>(emu_cl->blocks.size());
  }
  // addr, in this block's shared memory, in block `rank`'s
  template <class T>
  static T* map_shared_rank(T* addr, int rank) {
    const auto* mine = emu_cl->blocks[emu_rank].smem.data();
    const auto off = reinterpret_cast<const unsigned char*>(addr) - mine;
    if (off < 0 || static_cast<size_t>(off) >
                       emu_cl->blocks[emu_rank].smem.size() ||
        rank < 0 || rank >= static_cast<int>(emu_cl->blocks.size())) {
      std::abort();
    }
    return reinterpret_cast<T*>(emu_cl->blocks[rank].smem.data() + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

// The attributes set on each kernel, checked at its launch.
inline std::map<const void*, std::map<int, int>>& emu_attrs() {
  static std::map<const void*, std::map<int, int>> a;
  return a;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F* kernel, int attr, int value) {
  if (attr == cudaFuncAttributeMaxDynamicSharedMemorySize &&
      (value < 0 || static_cast<size_t>(value) > kEmuSmemMax)) {
    return cudaErrorInvalidValue;
  }
  emu_attrs()[reinterpret_cast<const void*>(kernel)][attr] = value;
  return cudaSuccess;
}

inline unsigned emu_cluster_size(const cudaLaunchConfig_t* cfg) {
  for (unsigned i = 0; i < cfg->numAttrs; ++i) {
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      return cfg->attrs[i].val.clusterDim.x * cfg->attrs[i].val.clusterDim.y *
             cfg->attrs[i].val.clusterDim.z;
    }
  }
  return 1;
}

// One cluster at a time fits if its blocks' shared memory is within what
// each kernel was allowed, a block has at most 1024 threads, and the
// cluster at most 8 blocks (16 with the non-portable attribute).
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, F* kernel,
                                           const cudaLaunchConfig_t* cfg) {
  auto& a = emu_attrs()[reinterpret_cast<const void*>(kernel)];
  const size_t smem_max =
      a.count(cudaFuncAttributeMaxDynamicSharedMemorySize)
          ? a[cudaFuncAttributeMaxDynamicSharedMemorySize]
          : kEmuSmemDefault;
  const unsigned cmax =
      a.count(cudaFuncAttributeNonPortableClusterSizeAllowed) &&
              a[cudaFuncAttributeNonPortableClusterSizeAllowed]
          ? 16
          : 8;
  const unsigned c = emu_cluster_size(cfg);
  *n = cfg->dynamicSmemBytes <= smem_max && cfg->blockDim.x <= 1024 &&
               c <= cmax
           ? 1
           : 0;
  return cudaSuccess;
}

inline cudaError_t& emu_last_error() {
  static cudaError_t e = cudaSuccess;
  return e;
}
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_last_error();
  emu_last_error() = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

// Runs the grid one cluster after another, each cluster's threads all
// at once.
template <class... Params, class... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(Params...), Args&&... args) {
  int fits = 0;
  cudaOccupancyMaxActiveClusters(&fits, kernel, cfg);
  const unsigned c = emu_cluster_size(cfg);
  const unsigned threads = cfg->blockDim.x;
  if (!fits || cfg->gridDim.x % c || threads % 32 || cfg->blockDim.y != 1 ||
      cfg->gridDim.y != 1) {
    return cudaErrorInvalidConfiguration;
  }
  for (unsigned first = 0; first < cfg->gridDim.x; first += c) {
    EmuCluster cl;
    cl.all = std::make_unique<std::barrier<>>(c * threads);
    cl.blocks.resize(c);
    for (auto& b : cl.blocks) {
      b.block = std::make_unique<std::barrier<>>(threads);
      for (unsigned w = 0; w < threads / 32; ++w) {
        b.warps.push_back(std::make_unique<std::barrier<>>(32));
      }
      b.slots.assign(threads, 0);
      // not zeroed on the card: fill with a value a kernel must not read
      b.smem.assign(cfg->dynamicSmemBytes, 0xff);
    }
    std::vector<std::thread> ts;
    for (unsigned r = 0; r < c; ++r) {
      for (unsigned t = 0; t < threads; ++t) {
        ts.emplace_back([&, r, t] {
          emu_cl = &cl;
          emu_rank = static_cast<int>(r);
          threadIdx = dim3(t);
          blockIdx = dim3(first + r);
          blockDim = cfg->blockDim;
          kernel(args...);
        });
      }
    }
    for (auto& th : ts) th.join();
  }
  return cudaSuccess;
}
