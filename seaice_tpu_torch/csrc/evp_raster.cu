// EVP elastic-subcycle loop on a planar raster-ordered quad mesh with a
// cell-constant basis, for Hopper.
//
// Replaces the TPU kernel of seaice_tpu/dynamics/pallas_evp.py
// (build_pallas_subcycle): all n_sub subcycles of
//   corner reads at raster offsets -> strain -> EVP stress relaxation
//   -> stress-divergence partials -> vertex-side sum -> ocean drag
//   -> 2x2 momentum solve
// run inside ONE cooperative launch per call of the C function below.  On a
// regular quad grid the Wachspress basis is the same for every cell, so the
// four 4x4 tables gx, gy, bu, bv travel as kernel arguments (constant
// memory) and no basis is streamed at all; corner b of cell (i, j) is vertex
// (i+oi_b, j+oj_b).
//
// The TPU kernel is one sequential program that accumulates the divergence
// with four shifted slice-adds.  Here the vertices are cut into rectangular
// tiles, one tile per block of a co-resident grid (as many tiles as the card
// has SMs; a larger mesh gives a block several tiles in turn), and one
// persistent launch runs the loop.  A block computes every cell that touches
// its tile, one thread a cell: its own cells and the one-cell ring below and
// left of the tile that a neighbouring tile owns, from the same inputs and
// with the same arithmetic as the owner, so the copies are equal.  The
// partials then stay in shared memory and only u and v cross between
// blocks, double-buffered: ONE grid barrier a subcycle.  (On an H100 at 168
// x 168 cells this measured 0.57 ms a solve against 0.75 with each cell
// computed once, its partials through global memory and two barriers a
// subcycle, and against 1.19 and 2.41 ms on grids of 66 and 33 blocks.)  A
// cell's stresses, pressure and mask and a vertex's velocity and fields
// stay in registers for the loop.  The vertex sums the partials of the up
// to four cells that own it in slot order 0..3 (as the slice-adds; boundary
// vertices have fewer): a gather, no atomics, so a run repeats bitwise.
// Stresses of a block's second and later tiles, and of an owned cell that
// another block's later tile reads as its ring, go through global memory
// (double-buffered) between subcycles.
//
// What bounds it: nothing on the card's rooflines.  All state (about 4 MB in
// f32 at 168 x 168 cells) stays in the L2; the loop is bound by its n_sub
// grid barriers and the latency of a subcycle's few dependent loads and
// divisions.

#include <algorithm>
#include <cmath>

#include <cooperative_groups.h>

#include "evp_panel_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;     // a tile's cells at most (one a thread)

template <typename T>
struct RasterLoop {
  T gx[16], gy[16], bu[16], bv[16];   // [4(b or s), 4(g or j)] tables
  int oi[4], oj[4];                   // corner slot -> vertex offset
  int nxc, nyc, nxv, nyv, n_sub;
  int tx, ty, nty, ntiles;            // vertex tiles tx x ty, nty a tile row
  EvpParams<T> P;
  // written during the launch: plain pointers, plain loads
  T* u[2]; T* v[2];                   // [nxv*nyv]; [0] the caller's, in place
  T* s[2][3];                         // [4, nc] s11, s22, s12; [0] the caller's
  const T* __restrict__ pressure;     // [nc]
  const T* __restrict__ solve_stress; // [nc]
  const T* __restrict__ inv[13];      // [nv] each: uo, vo, mass_v, mass_f, air_u,
                                      // air_v, tilt_u, tilt_v, ocn_u, ocn_v,
                                      // solve_velocity, area_v, denom
};

// Tile t: vertex rows [a0, a1) x columns [b0, b1), and the cells it
// computes, rows [ci0, ci1) x columns [cj0, cj1); it owns the cells whose
// vertex (i, j) is its own.
struct Tile {
  int a0, a1, b0, b1, ci0, ci1, cj0, cj1;
  __device__ __forceinline__ int ncj() const { return max(0, cj1 - cj0); }
  __device__ __forceinline__ int ncell() const { return max(0, ci1 - ci0) * ncj(); }
};

template <typename T>
__device__ __forceinline__ Tile tile_of(int t, const RasterLoop<T>& A)
{
  Tile w;
  w.a0 = (t / A.nty) * A.tx;
  w.b0 = (t % A.nty) * A.ty;
  w.a1 = min(w.a0 + A.tx, A.nxv);
  w.b1 = min(w.b0 + A.ty, A.nyv);
  w.ci0 = max(w.a0 - 1, 0);
  w.cj0 = max(w.b0 - 1, 0);
  w.ci1 = min(w.a1, A.nxc);
  w.cj1 = min(w.b1, A.nyc);
  return w;
}

// One cell's state across subcycles.
template <typename T>
struct RCell {
  T s11[4], s22[4], s12[4];
};

template <typename T>
__device__ __forceinline__ void load_stresses(RCell<T>& rc, const T* const s[3], size_t n,
                                              int c)
{
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    rc.s11[g] = s[0][g * n + c];
    rc.s22[g] = s[1][g * n + c];
    rc.s12[g] = s[2][g * n + c];
  }
}

template <typename T>
__device__ __forceinline__ void store_stresses(const RCell<T>& rc, T* const s[3], size_t n,
                                               int c)
{
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    s[0][g * n + c] = rc.s11[g];
    s[1][g * n + c] = rc.s22[g];
    s[2][g * n + c] = rc.s12[g];
  }
}

// Cell (i, j): strain, stress (updated in rc), partials pu, pv per slot.
template <typename T>
__device__ __forceinline__ void raster_cell(int i, int j, const T* u, const T* v,
                                            T press, bool ss, RCell<T>& rc,
                                            const RasterLoop<T>& A, T pu[4], T pv[4])
{
  T uc[4], vc[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int at = (i + A.oi[b]) * A.nyv + (j + A.oj[b]);
    uc[b] = u[at];
    vc[b] = v[at];
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    T e11 = T(0), e22 = T(0), eA = T(0), eB = T(0);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      e11 += uc[b] * A.gx[b * 4 + g];
      e22 += vc[b] * A.gy[b * 4 + g];
      eA += uc[b] * A.gy[b * 4 + g];
      eB += vc[b] * A.gx[b * 4 + g];
    }
    const T e12 = T(0.5) * (eA + eB);
    T n11, n22, n12;
    evp_relax<T>(e11, e22, e12, press, rc.s11[g], rc.s22[g], rc.s12[g], A.P, n11, n22, n12);
    if (ss) { rc.s11[g] = n11; rc.s22[g] = n22; rc.s12[g] = n12; }
  }
#pragma unroll
  for (int j2 = 0; j2 < 4; ++j2) {
    T a = T(0), b2 = T(0), c2 = T(0), d2 = T(0);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      a += rc.s11[s] * A.bu[s * 4 + j2];
      b2 += rc.s12[s] * A.bv[s * 4 + j2];
      c2 += rc.s22[s] * A.bv[s * 4 + j2];
      d2 += rc.s12[s] * A.bu[s * 4 + j2];
    }
    pu[j2] = a + b2;
    pv[j2] = c2 + d2;
  }
}

// What a vertex keeps across subcycles.
template <typename T>
struct VInv {
  T uo, vo, mass_v, mass_f, rhs_u0, rhs_v0, ocn_u, ocn_v, area, denom;
  bool sv;
};

template <typename T>
__device__ __forceinline__ VInv<T> load_vinv(int k, const RasterLoop<T>& A)
{
  VInv<T> x;
  x.uo = A.inv[0][k];
  x.vo = A.inv[1][k];
  x.mass_v = A.inv[2][k];
  x.mass_f = A.inv[3][k];
  x.rhs_u0 = A.inv[4][k] + A.inv[6][k];     // air stress + surface tilt
  x.rhs_v0 = A.inv[5][k] + A.inv[7][k];
  x.ocn_u = A.inv[8][k];
  x.ocn_v = A.inv[9][k];
  x.sv = A.inv[10][k] > T(0);
  x.area = A.inv[11][k];
  x.denom = A.inv[12][k];
  return x;
}

// Vertex (iv, jv) with velocity (uu, vv): the partials of its cells in slot
// order, then drag and the 2x2 solve; writes the new velocity into un, vn
// and buffer 1 - rb.  The partial of slot b of cell (ci, cj) is
// part(b, ci, cj).
template <typename T, class Part>
__device__ __forceinline__ void raster_vertex(int iv, int jv, int rb, const RasterLoop<T>& A,
                                              const VInv<T>& x, const Part& part, T uu,
                                              T vv, T& un, T& vn)
{
  const int k = iv * A.nyv + jv;
  un = uu;                                   // u, v keep their values
  vn = vv;
  if (x.sv) {
    T du = T(0), dv = T(0);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int ci = iv - A.oi[b], cj = jv - A.oj[b];
      if (ci >= 0 && ci < A.nxc && cj >= 0 && cj < A.nyc) {
        T px, py;
        part(b, ci, cj, px, py);
        du += px;
        dv += py;
      }
    }
    evp_momentum<T>(du, dv, x.denom, uu, vv, x.uo, x.vo, x.mass_v, x.mass_f, x.rhs_u0,
                    x.rhs_v0, x.ocn_u, x.ocn_v, x.area, A.P, un, vn);
  }
  A.u[1 - rb][k] = un;
  A.v[1 - rb][k] = vn;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) raster_loop_kernel(RasterLoop<T> A)
{
  extern __shared__ __align__(16) unsigned char k4_smem[];
  T* part = reinterpret_cast<T*>(k4_smem);   // [2 (pu, pv)][4][cells]
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, nth = blockDim.x;
  const size_t n = (size_t)A.nxc * A.nyc;
  // every owned cell's stresses go to global memory each subcycle only
  // where a later tile of some block reads them as its ring
  const bool publish = A.ntiles > (int)gridDim.x;

  // ---- prologue: the first tile's cell and vertex (one each a thread),
  // and what they keep across subcycles, in registers ----
  RCell<T> rc;
  T press0 = T(0);
  bool ss0 = false;
  VInv<T> x0;
  T u0 = T(0), v0 = T(0);
  {
    const Tile w = tile_of((int)blockIdx.x, A);
    if (tid < w.ncell()) {
      const int c = (w.ci0 + tid / w.ncj()) * A.nyc + w.cj0 + tid % w.ncj();
      load_stresses(rc, A.s[0], n, c);
      press0 = A.pressure[c];
      ss0 = A.solve_stress[c] > T(0);
    }
    const int nvj = w.b1 - w.b0;
    if (tid < (w.a1 - w.a0) * nvj) {
      const int k0 = (w.a0 + tid / nvj) * A.nyv + w.b0 + tid % nvj;
      x0 = load_vinv(k0, A);
      u0 = A.u[0][k0];
      v0 = A.v[0][k0];
    }
  }
  // vertex (iv, jv) of the block's tile s, its lv-th: the thread's own
  // vertex of the first tile from registers, any other from global memory
  auto vertex = [&](int s, int lv, int iv, int jv, int rb, const auto& part) {
    if (s == 0 && lv == tid) {
      raster_vertex(iv, jv, rb, A, x0, part, u0, v0, u0, v0);
    } else {
      const int k = iv * A.nyv + jv;
      T un, vn;
      raster_vertex(iv, jv, rb, A, load_vinv(k, A), part, A.u[rb][k], A.v[rb][k], un, vn);
    }
  };

  DevPhaseTimer timer;   // tile work, barrier
  for (int k = 0; k < A.n_sub; ++k) {
    timer.mark(-1);
    const int rb = k & 1;
    for (int s = 0, t = blockIdx.x; t < A.ntiles; ++s, t += gridDim.x) {
      const Tile w = tile_of(t, A);
      const int ncell = w.ncell();
      // ---- cell phase ----
      if (tid < ncell) {
        const int i = w.ci0 + tid / w.ncj(), j = w.cj0 + tid % w.ncj();
        const int c = i * A.nyc + j;
        const bool owned = i >= w.a0 && j >= w.b0;
        T pu[4], pv[4];
        if (s == 0) {
          raster_cell(i, j, A.u[rb], A.v[rb], press0, ss0, rc, A, pu, pv);
          if (owned && publish) store_stresses(rc, A.s[1 - rb], n, c);
        } else {
          RCell<T> o;
          load_stresses(o, A.s[rb], n, c);
          raster_cell(i, j, A.u[rb], A.v[rb], A.pressure[c], A.solve_stress[c] > T(0), o,
                      A, pu, pv);
          if (owned) store_stresses(o, A.s[1 - rb], n, c);
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          part[b * ncell + tid] = pu[b];
          part[(4 + b) * ncell + tid] = pv[b];
        }
      }
      // ---- vertex phase of this tile, from the block's own partials ----
      __syncthreads();
      const int ncj = w.ncj(), nvj = w.b1 - w.b0;
      auto from_smem = [&](int b, int ci, int cj, T& px, T& py) {
        const int lc = (ci - w.ci0) * ncj + (cj - w.cj0);
        px = part[b * ncell + lc];
        py = part[(4 + b) * ncell + lc];
      };
      for (int lv = tid; lv < (w.a1 - w.a0) * nvj; lv += nth)
        vertex(s, lv, w.a0 + lv / nvj, w.b0 + lv % nvj, rb, from_smem);
      __syncthreads();
    }
    timer.mark(0);
    grid.sync();
    timer.mark(1);
  }

  // ---- epilogue: owned cells' stresses and the tile's u, v into buffer 0 ----
  const int fb = A.n_sub & 1;
  for (int s = 0, t = blockIdx.x; t < A.ntiles; ++s, t += gridDim.x) {
    const Tile w = tile_of(t, A);
    if (tid < w.ncell()) {
      const int i = w.ci0 + tid / w.ncj(), j = w.cj0 + tid % w.ncj();
      const int c = i * A.nyc + j;
      if (i >= w.a0 && j >= w.b0) {
        if (s == 0) store_stresses(rc, A.s[0], n, c);
        else if (fb) {
          RCell<T> o;
          load_stresses(o, A.s[1], n, c);
          store_stresses(o, A.s[0], n, c);
        }
      }
    }
    const int nvj = w.b1 - w.b0;
    if (fb)
      for (int lv = tid; lv < (w.a1 - w.a0) * nvj; lv += nth) {
        const int kk = (w.a0 + lv / nvj) * A.nyv + w.b0 + lv % nvj;
        A.u[0][kk] = A.u[1][kk];
        A.v[0][kk] = A.v[1][kk];
      }
  }
}

// Cuts the vertices into tiles, sizes the grid, then launches.  info[0..5]:
// launches, grid, threads per block, dynamic shared memory bytes per block,
// tile rows, tile columns (of vertices).
template <typename T>
int run_loop(int nxc, int nyc, int n_sub, const int* offsets, const double* tables,
             void* u, void* v, void* s11, void* s22, void* s12,
             const void* pressure, const void* solve_stress,
             const void* uo, const void* vo, const void* mass_v, const void* mass_f,
             const void* air_u, const void* air_v, const void* tilt_u,
             const void* tilt_v, const void* ocn_u, const void* ocn_v,
             const void* solve_velocity, const void* area_v, const void* denom,
             void* work, double dte, double damping, double ecc2, double puny,
             double cosw, double sinw, double drag, void* stream, int* info)
{
  for (int k = 0; k < 6; ++k) info[k] = 0;
  if (nxc < 1 || nyc < 1 || n_sub < 0) return (int)cudaErrorInvalidValue;
  RasterLoop<T> A;
  for (int k = 0; k < 16; ++k) {
    A.gx[k] = (T)tables[k];
    A.gy[k] = (T)tables[16 + k];
    A.bu[k] = (T)tables[32 + k];
    A.bv[k] = (T)tables[48 + k];
  }
  for (int b = 0; b < 4; ++b) {
    A.oi[b] = offsets[2 * b];
    A.oj[b] = offsets[2 * b + 1];
    if (A.oi[b] < 0 || A.oi[b] > 1 || A.oj[b] < 0 || A.oj[b] > 1)
      return (int)cudaErrorInvalidValue;
  }
  A.nxc = nxc; A.nyc = nyc; A.nxv = nxc + 1; A.nyv = nyc + 1; A.n_sub = n_sub;
  A.P = make_params<T>(dte, damping, ecc2, puny, cosw, sinw, drag);
  const size_t nc = (size_t)nxc * nyc, nv = (size_t)A.nxv * A.nyv;
  T* wk = (T*)work;          // [2 nv (u, v)] [12 nc (stresses)]: the second buffers
  A.u[0] = (T*)u; A.v[0] = (T*)v;
  A.u[1] = wk; A.v[1] = wk + nv;
  A.s[0][0] = (T*)s11; A.s[0][1] = (T*)s22; A.s[0][2] = (T*)s12;
  for (int f = 0; f < 3; ++f) A.s[1][f] = wk + 2 * nv + 4 * nc * f;
  A.pressure = (const T*)pressure;
  A.solve_stress = (const T*)solve_stress;
  const void* inv[13] = {uo, vo, mass_v, mass_f, air_u, air_v, tilt_u, tilt_v, ocn_u,
                         ocn_v, solve_velocity, area_v, denom};
  for (int k = 0; k < 13; ++k) A.inv[k] = (const T*)inv[k];

  cudaError_t err;
  int dev = 0, sms = 0, budget = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  // near-square tiles, one an SM, at most kMaxThreads cells each and their
  // partials within the shared memory
  const int gx = std::max(1, std::min(sms, (int)std::lround(
      std::sqrt((double)sms * A.nxv / A.nyv))));
  const int gy = std::max(1, sms / gx);
  int tx = (A.nxv + gx - 1) / gx, ty = (A.nyv + gy - 1) / gy;
  auto cells = [](int x, int y) { return (x + 1) * (y + 1); };
  const int max_cells = std::min<int>(kMaxThreads, budget / (8 * sizeof(T)));
  while (cells(tx, ty) > max_cells && (tx > 1 || ty > 1)) {
    if (tx >= ty) tx = (tx + 1) / 2;
    else ty = (ty + 1) / 2;
  }
  A.tx = tx; A.ty = ty;
  A.nty = (A.nyv + ty - 1) / ty;
  A.ntiles = ((A.nxv + tx - 1) / tx) * A.nty;
  const int threads = std::max(64, (cells(tx, ty) + 31) / 32 * 32);
  const size_t smem = (size_t)8 * cells(tx, ty) * sizeof(T);
  auto kernel = raster_loop_kernel<T>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = std::min(A.ntiles, sms);
  info[1] = grid;
  info[2] = threads;
  info[3] = (int)smem;
  info[4] = tx;
  info[5] = ty;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, A);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  info[0] = 1;
  return 0;
}

}  // namespace

#define RASTER_ARGS                                                                 \
  int nxc, int nyc, int n_sub, const int* offsets, const double* tables, void* u,   \
  void* v, void* s11, void* s22, void* s12, const void* pressure,                   \
  const void* solve_stress, const void* uo, const void* vo, const void* mass_v,     \
  const void* mass_f, const void* air_u, const void* air_v, const void* tilt_u,     \
  const void* tilt_v, const void* ocn_u, const void* ocn_v,                         \
  const void* solve_velocity, const void* area_v, const void* denom, void* work,    \
  double dte, double damping, double ecc2, double puny, double cosw, double sinw,   \
  double drag, void* stream, int* info
#define RASTER_PASS                                                                 \
  nxc, nyc, n_sub, offsets, tables, u, v, s11, s22, s12, pressure, solve_stress,    \
  uo, vo, mass_v, mass_f, air_u, air_v, tilt_u, tilt_v, ocn_u, ocn_v,               \
  solve_velocity, area_v, denom, work, dte, damping, ecc2, puny, cosw, sinw, drag,  \
  stream, info

// offsets: 8 host ints (oi, oj per corner slot); tables: 64 host doubles
// (gx, gy, bu, bv, each [4, 4] row-major).  u, v [nxv*nyv] and s11, s22, s12
// [4, nc] are updated in place; work is scratch of 2*nxv*nyv + 12*nc values.
// info: int[6], as run_loop says.
// Returns the first CUDA error (0 = none; a refused cooperative launch
// returns its error and nothing runs).  Nothing is allocated and nothing
// synchronises.
extern "C" int evp_raster_loop_f32(RASTER_ARGS) { return run_loop<float>(RASTER_PASS); }
extern "C" int evp_raster_loop_f64(RASTER_ARGS) { return run_loop<double>(RASTER_PASS); }
