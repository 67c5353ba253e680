// Host stand-in for <cuda_runtime.h>, for tests on a machine without a GPU:
// a kernel's source is compiled as plain C++ and every launch runs here,
// each block's threads as host threads, so that __syncthreads(),
// __syncwarp() and shared memory keep their meaning.
//
//   * `k<<<grid, block, smem, stream>>>(args)` is rewritten by the test into
//     `shim_launch(grid, block, smem, [&] { k(args); })`: blocks run one
//     after another, as any launch may run them; a dim3 grid runs its
//     x blocks for each y in turn.
//   * `cudaLaunchKernelEx` (used with `cudaLaunchAttributeCooperative`) runs
//     ALL blocks' threads at once, so that a grid-wide barrier
//     (`cooperative_groups::this_grid().sync()`, <cooperative_groups.h>
//     beside this file) can be met.
//   * `extern __shared__ T name[];` is rewritten by the test into a pointer
//     to the block's own dynamic shared memory (`shim_dyn_smem`, per
//     thread).  `__shared__` arrays with a static size are `static` here:
//     shared by every block, so they are right only for blocks run one
//     after another.
//   * The device queries report a small card: $SHIM_SMS multiprocessors
//     (3 if unset), one co-resident block each, and $SHIM_SMEM_OPTIN bytes
//     (kShimSmemOptin if unset) of shared memory per block (1 KB more per
//     multiprocessor, 1 KB of it reserved, as on an H100), so that a small
//     mesh already exercises both sides of a kernel's shared-memory budget
//     and, on one multiprocessor, blocks that own more columns than threads.
//   * As on a card, a `<<<>>>` launch may take more dynamic shared memory
//     than the default ($SHIM_SMEM_DEFAULT bytes, 48 KB if unset) only
//     after `cudaFuncSetAttribute(kernel,
//     cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)` allowed it, and
//     never more than the opt-in limit; a launch refused so runs nothing
//     and leaves its error for `cudaGetLastError()`.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdlib>
#include <map>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __align__(n) alignas(n)
#define __launch_bounds__(...)
using std::max;
using std::min;

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

// per thread: its block's barrier, its warp's barrier, its block's
// dynamic shared memory; per launch: the grid's barrier
inline thread_local std::barrier<>* shim_block_barrier = nullptr;
inline thread_local std::barrier<>* shim_warp_barrier = nullptr;
inline thread_local unsigned char* shim_dyn_smem = nullptr;
inline std::barrier<>* shim_grid_barrier = nullptr;

inline void __syncthreads() { shim_block_barrier->arrive_and_wait(); }
// a load with a cache hint is a load
template <class T> inline T __ldcs(const T* p) { return *p; }
inline long long clock64() { return 0; }
// every lane of the warp must arrive, as the kernels here use it
inline void __syncwarp(unsigned = 0xffffffffu) { shim_warp_barrier->arrive_and_wait(); }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorCooperativeLaunchTooLarge = 720,
};
inline cudaError_t shim_last_error = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = shim_last_error;
  shim_last_error = cudaSuccess;
  return e;
}

constexpr int kShimSmemOptin = 32768;
inline int shim_env(const char* name, int fallback) {
  const char* s = std::getenv(name);
  return s ? std::atoi(s) : fallback;
}
inline int shim_sms() { return shim_env("SHIM_SMS", 3); }
inline int shim_smem_optin() { return shim_env("SHIM_SMEM_OPTIN", kShimSmemOptin); }
inline int shim_smem_default() { return shim_env("SHIM_SMEM_DEFAULT", 49152); }
// the dynamic shared memory each kernel was allowed by cudaFuncSetAttribute
inline std::map<const void*, int> shim_smem_allowed;

enum cudaDeviceAttr {
  cudaDevAttrMaxSharedMemoryPerBlock = 8,
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerMultiprocessor = 81,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97,
  cudaDevAttrReservedSharedMemoryPerBlock = 111,
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaLaunchAttributeID { cudaLaunchAttributeCooperative = 2 };

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? shim_sms()
       : a == cudaDevAttrMaxSharedMemoryPerBlock ? shim_smem_default()
       : a == cudaDevAttrReservedSharedMemoryPerBlock ? 1024
       : a == cudaDevAttrMaxSharedMemoryPerMultiprocessor ? shim_smem_optin() + 1024
       : shim_smem_optin();
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F f, cudaFuncAttribute, int bytes) {
  if (bytes > shim_smem_optin()) return cudaErrorInvalidValue;
  shim_smem_allowed[reinterpret_cast<const void*>(f)] = bytes;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t smem) {
  *n = smem <= (size_t)shim_smem_optin() ? 1 : 0;
  return cudaSuccess;
}

struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union { int cooperative; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};

// Runs `grid` blocks of `block` threads; all at once if `together` (a
// one-dimensional grid).
template <class F>
void shim_run(dim3 grid3, int block, size_t smem, bool together, F kernel_call) {
  gridDim = grid3;
  blockDim.x = block;
  const int gx = grid3.x;
  const int grid = grid3.x * grid3.y;
  const int nw = (block + 31) / 32;
  auto run_blocks = [&](int b0, int b1) {
    std::vector<std::unique_ptr<std::barrier<>>> bars, warps;
    std::vector<std::vector<unsigned char>> mem;
    for (int b = b0; b < b1; ++b) {
      bars.emplace_back(new std::barrier<>(block));
      for (int w = 0; w < nw; ++w)
        warps.emplace_back(new std::barrier<>(std::min(32, block - 32 * w)));
      mem.emplace_back(smem + 16);
    }
    std::vector<std::thread> threads;
    for (int b = b0; b < b1; ++b)
      for (int t = 0; t < block; ++t)
        threads.emplace_back([&, b, t] {
          threadIdx.x = t;
          blockIdx.x = b % gx;
          blockIdx.y = b / gx;
          shim_block_barrier = bars[b - b0].get();
          shim_warp_barrier = warps[(b - b0) * nw + t / 32].get();
          shim_dyn_smem = mem[b - b0].data();
          kernel_call();
        });
    for (auto& th : threads) th.join();
  };
  if (together) {
    std::barrier<> grid_bar(grid * block);
    shim_grid_barrier = &grid_bar;
    run_blocks(0, grid);
    shim_grid_barrier = nullptr;
  } else {
    for (int b = 0; b < grid; ++b) run_blocks(b, b + 1);
  }
}

template <class K, class F>
void shim_launch(K kernel, dim3 grid, int block, size_t smem, F kernel_call) {
  const auto it = shim_smem_allowed.find(reinterpret_cast<const void*>(kernel));
  const size_t allowed = std::max<size_t>(
      shim_smem_default(), it == shim_smem_allowed.end() ? 0 : it->second);
  if (smem > allowed) {
    shim_last_error = cudaErrorInvalidValue;
    return;
  }
  shim_run(grid, block, smem, false, kernel_call);
}

template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Exp...),
                               Act&&... args) {
  if (cfg->dynamicSmemBytes > (size_t)shim_smem_optin() ||
      cfg->gridDim.x > (unsigned)shim_sms())
    return cudaErrorCooperativeLaunchTooLarge;
  shim_run(cfg->gridDim.x, cfg->blockDim.x, cfg->dynamicSmemBytes, true,
           [&] { kernel(args...); });
  return cudaSuccess;
}
