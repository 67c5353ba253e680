// Incremental-remapping edge-flux integration, for Hopper: the whole
// integration in one kernel.
//
// Replaces the TPU kernel of seaice_tpu/transport/pallas_flux.py
// (_build_kernel, reached through integrate_fluxes_fused).  For every edge
// it sums, over the edge's departure-triangle slots, the triangle's 6-point
// quadrature of each tracer product, times the signed triangle area, and
// masks the edge:
//   2D tracer column o:  sum_q w_q V_o(x_q, y_q),
//     V_o = L_o * V_parent(o), L = c + gx*x + gy*y (the reconstruction's
//     linear factor of that tracer and category), V of the root = L_root;
//   3D (layered) column:  sum_q w_q V_parent(x_q, y_q) * L(x_q, y_q).
// By linearity this is the plain version's contraction of the expanded
// product polynomials with the triangle monomial integrals
// (remap.integrate_fluxes), evaluated pointwise: so the kernel reads only
// the reconstruction's LINEAR coefficients, one table [nCells, 3W] (per
// tracer a c block, a gx block and a gy block; W = 95 columns for the
// standard tree at 5 categories and 7 + 1 layers), and no monomial table or
// product table is built before it.  Everything is plain FMA in the working
// type: no tensor cores, no reduced precision.
//
// A warp owns one edge.  An edge whose mask is zero writes zeros; for every
// slot whose area is not zero the warp evaluates each 2D column's chain of
// linear factors at the six points into shared memory (once per slot and
// category: item = (column, point) over the lanes), then each 3D column
// multiplies its parent's six values by its own factor (the 7 layers share
// the parent's evaluation).  A lane owns its output columns' running sums
// over the slots.  The column metadata (table column of c, distance to gx
// and to gy, parent 2D column) is one small int32 array built once per tree.
//
// What bounds it: bytes (the table rows that non-empty slots touch, the
// quadrature points, the fluxes out); the arithmetic is ~6 x (4 x chain
// length + 1) flops a column and slot, three orders of magnitude below the
// f32 peak.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
// returned when a block of this tree needs more shared memory than the
// card lets a block opt in to (not a CUDA error code)
constexpr int kSharedTooLarge = -2;

template <typename T>
__global__ void ir_flux_kernel(
    int nE, int S, int F, int T2, int T3,
    const T* __restrict__ table,       // [nCells, F] linear coefficients
    const T* __restrict__ xq,          // [nE, S, 6] quadrature points
    const T* __restrict__ yq,          // [nE, S, 6]
    const T* __restrict__ wq,          // [6] quadrature weights
    const T* __restrict__ area,        // [nE, S] signed, 0 = empty slot
    const long long* __restrict__ cell,// [nE, S] source cell of each slot
    const T* __restrict__ mask_edge,   // [nE]
    const int* __restrict__ meta,      // [3, T2 + T3]: table column of c,
                                       // distance c -> gx -> gy, parent 2D
                                       // column (-1: the root)
    T* __restrict__ out2,              // [nE, T2]
    T* __restrict__ out3)              // [nE, T3]
{
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * WARPS + warp;
  if (e >= nE) return;                 // whole warp leaves together

  const int nT = T2 + T3;
  T* vsh = reinterpret_cast<T*>(smem_raw) + (size_t)warp * (6 * T2 + nT + 18);
  T* acc = vsh + 6 * T2;               // [T2 + T3] running sums, lane-owned
  T* pts = acc + nT;                   // x[6], y[6], w[6]
  const int* mcol = meta;
  const int* mst = meta + nT;
  const int* mpar = meta + 2 * nT;

  const T me = mask_edge[e];
  if (me == T(0)) {
    for (int o = lane; o < T2; o += 32) out2[(size_t)e * T2 + o] = T(0);
    for (int o = lane; o < T3; o += 32) out3[(size_t)e * T3 + o] = T(0);
    return;
  }
  for (int o = lane; o < T2; o += 32) acc[o] = T(0);
  for (int o = lane; o < T3; o += 32) acc[T2 + o] = T(0);
  if (lane < 6) pts[12 + lane] = wq[lane];

  for (int s = 0; s < S; ++s) {
    const size_t es = (size_t)e * S + s;
    const T a = area[es];
    if (a == T(0)) continue;           // the same for every lane
    const T* row = table + (size_t)cell[es] * F;
    if (lane < 6) pts[lane] = xq[es * 6 + lane];
    else if (lane < 12) pts[lane] = yq[es * 6 + lane - 6];
    __syncwarp();
    // 2D chains at the six points
    for (int it = lane; it < 6 * T2; it += 32) {
      const int o = it / 6, q = it - 6 * (it / 6);
      const T x = pts[q], y = pts[6 + q];
      T v = T(1);
      for (int k = o; k >= 0; k = mpar[k]) {
        const int c = mcol[k], st = mst[k];
        v *= row[c] + row[c + st] * x + row[c + 2 * st] * y;
      }
      vsh[it] = v;
    }
    __syncwarp();
    for (int o = lane; o < T2; o += 32) {
      T integral = T(0);
#pragma unroll
      for (int q = 0; q < 6; ++q) integral += pts[12 + q] * vsh[6 * o + q];
      acc[o] += integral * a;
    }
    for (int o = lane; o < T3; o += 32) {
      const int m = T2 + o;
      const int c = mcol[m], st = mst[m], p = mpar[m];
      const T c3 = row[c], gx3 = row[c + st], gy3 = row[c + 2 * st];
      T integral = T(0);
#pragma unroll
      for (int q = 0; q < 6; ++q)
        integral += pts[12 + q] * vsh[6 * p + q] * (c3 + gx3 * pts[q] + gy3 * pts[6 + q]);
      acc[m] += integral * a;
    }
    __syncwarp();                      // before the next slot's points
  }
  for (int o = lane; o < T2; o += 32) out2[(size_t)e * T2 + o] = acc[o] * me;
  for (int o = lane; o < T3; o += 32) out3[(size_t)e * T3 + o] = acc[T2 + o] * me;
}

template <typename T>
int run_flux(int nE, int S, int F, int T2, int T3, const void* table, const void* xq,
             const void* yq, const void* wq, const void* area, const long long* cell,
             const void* mask_edge, const int* meta, void* out2, void* out3,
             void* stream_v)
{
  cudaStream_t stream = (cudaStream_t)stream_v;
  if (nE <= 0) return 0;
  if (S <= 0 || T2 <= 0 || T3 < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (nE + WARPS - 1) / WARPS;
  const size_t shmem = (size_t)WARPS * (6 * T2 + T2 + T3 + 18) * sizeof(T);
  // past the default per-block budget (48 KB) the kernel must opt in to
  // the larger one, as K1, K3 and K4 do; past the opt-in limit it cannot
  // run this tree at all
  cudaError_t err;
  int dev = 0, fallback = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&fallback, cudaDevAttrMaxSharedMemoryPerBlock, dev)) !=
      cudaSuccess)
    return (int)err;
  if (shmem > (size_t)fallback) {
    if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
        cudaSuccess)
      return (int)err;
    if (shmem > (size_t)optin) return kSharedTooLarge;
    if ((err = cudaFuncSetAttribute(ir_flux_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)shmem)) != cudaSuccess)
      return (int)err;
  }
  ir_flux_kernel<T><<<blocks, WARPS * 32, shmem, stream>>>(
      nE, S, F, T2, T3, (const T*)table, (const T*)xq, (const T*)yq, (const T*)wq,
      (const T*)area, cell, (const T*)mask_edge, meta, (T*)out2, (T*)out3);
  return (int)cudaGetLastError();
}

}  // namespace

#define FLUX_ARGS                                                                  \
  int nE, int S, int F, int T2, int T3, const void* table, const void* xq,         \
  const void* yq, const void* wq, const void* area, const long long* cell,         \
  const void* mask_edge, const int* meta, void* out2, void* out3, void* stream
#define FLUX_PASS                                                                  \
  nE, S, F, T2, T3, table, xq, yq, wq, area, cell, mask_edge, meta, out2, out3,    \
  stream

// Returns the CUDA error of the launch (0 = none), or kSharedTooLarge (-2).
extern "C" int ir_flux_f32(FLUX_ARGS) { return run_flux<float>(FLUX_PASS); }
extern "C" int ir_flux_f64(FLUX_ARGS) { return run_flux<double>(FLUX_PASS); }
