// EVP elastic-subcycle loop on any MPAS-style connectivity, for Hopper.
//
// Replaces the TPU kernels of seaice_tpu/dynamics/pallas_unstructured.py:
//   build_unstructured_solver (K1): all n_sub subcycles of
//     corner-velocity gather -> Wachspress strain (+ tan(lat)/r metric)
//     -> EVP stress relaxation -> stress-divergence partials
//     -> vertex-side gather-sum -> ocean drag -> 2x2 momentum solve
//   run inside ONE call of evp_subcycle_loop_* below;
//   build_unstructured_loop_solver (K6): the same body one subcycle per
//   call, evp_subcycle_step_*, for every block of a partitioned mesh at
//   once, so that the caller refreshes the vertex velocity halo between
//   calls (the reference exchanges it after every subcycle,
//   mpas_seaice_velocity_solver.F:2546-2584), two launches a call.  Both
//   entries do the same arithmetic in the same order, as the TPU K6 runs
//   K1's pallas_call with n_subcycles=1.
//
// The TPU kernel is one sequential program that holds the basis and the
// state in its fast memory for the loop.  K1 here is ONE persistent,
// cooperative launch per solve (the shape of evp_panel_fused.cu): a grid of
// co-resident blocks (the occupancy query at the opt-in shared-memory
// budget, times the SM count: 132 blocks of 768 threads on an H100), each
// owning fixed cells and a fixed run of vertices for the whole loop.  Per
// subcycle: cell phase -> grid barrier -> vertex phase -> grid barrier
// (cooperative_groups::this_grid().sync()).  Only u, v and the partials
// pu, pv go through global memory (L2) between phases; they are written
// during the launch and read with plain loads, never through the
// read-only path.
//
// Cell phase, spread over the corners (the design of evp_panel_cell.cu): a
// cell belongs to maxEdges lanes of one warp (5 cells a warp at maxEdges 6,
// the last two lanes idle), lane g owning corner g: its corner vertex, mask
// and tan(lat)/r, its three stresses (in registers across subcycles for
// the first passes, about 360 cells a block; in place in the caller's
// stress arrays for the rest), and its 5*maxEdges basis values (strain
// weights of corner g, divergence weights of dual slot g).  The corner
// velocities and then the new stresses cross between a cell's lanes through
// shared memory, ordered by __syncwarp.  The basis of the block's cells
// sits in dynamic shared memory as far as the budget goes (310 of the 315
// cell slots a block has at 40,962 cells, me = 6, f32 with metric: 180
// values a cell), per corner, so that the lanes of a warp read neighbouring
// words; the rest (f64, larger meshes) is read from global memory.  The
// cells are dealt to the blocks in warp-sized runs, in turn, so that every
// block takes cells from all over the mesh (contiguous runs left the
// blocks' cell work 12k to 23k cycles apart on an H100, and the barrier
// waited for the slowest).  A block takes its cells in passes of 24 warps'
// worth (120 cells at maxEdges 6); a mesh larger than one resident grid
// takes more passes.  Every sum keeps evp_cell_body's order (strain over
// b, partials over s, the vertex gather over d), so a loop equals n calls
// of K6 on the mesh as one block where the compiler contracts alike
// (bitwise on the host; on the card a few f32 multiply-adds are contracted
// differently).  The divergence is a vertex-side GATHER of the cells'
// partials, never an atomic scatter: runs repeat bitwise.
//
// What bounds it: read once, the inputs take ~0.01 ms and the ~1,100 flops
// per cell and subcycle ~0.08 ms at the f32 peak; what the design cannot
// remove is 2*n_sub grid barriers (about 1.5 us each on an H100) and, per
// subcycle, u, v and the partials through L2.  Measured on an H100 (PERF.md):
// a subcycle's cell work runs at about one instruction a cycle per SM, seven
// IEEE divisions and a square root a corner.
//
// K6 on a partitioned mesh: every block of the card in one call.  A block
// of a sphere in four is a quarter of the mesh, so one launch per block
// fills under one wave of the 132 SMs and four blocks cost four launch
// latencies and four host calls a phase.  evp_subcycle_step_* takes a
// device table of the blocks' sizes and pointers (`BlockArgs`, one row a
// block, built once per solve by the wrapper) and launches each phase once
// with the block as blockIdx.y: two launches per subcycle whatever the
// number of blocks.  Each block runs `evp_cell_body` and `evp_vertex_body`,
// so a block's result is bitwise what it is alone.

#include <algorithm>

#include <cooperative_groups.h>

#include "evp_panel_common.cuh"

namespace cg = cooperative_groups;

namespace {

// ---- cell phase: strain, stress update (in place), divergence partials ----
template <typename T, int ME>
__device__ __forceinline__ void evp_cell_body(
    int c, int nc, int metric,
    const T* __restrict__ u, const T* __restrict__ v,
    const int* __restrict__ voc,        // [ME, nc]
    const T* __restrict__ vmask,        // [ME, nc]
    const T* __restrict__ bgrad,        // [ME(b), 2, ME(g), nc]
    const T* __restrict__ bint,         // [ME(s), 2, ME(j), nc]
    const T* __restrict__ bmet,         // [ME(s), ME(j), nc]
    const T* __restrict__ tanlat,       // [nv]
    const T* __restrict__ pressure,     // [nc]
    const T* __restrict__ solve_stress, // [nc]
    T* __restrict__ s11, T* __restrict__ s22, T* __restrict__ s12,  // [ME, nc]
    T* __restrict__ pu_out, T* __restrict__ pv_out,                 // [nc*ME]
    const EvpParams<T>& P)
{
  const size_t n = (size_t)nc;

  T uc[ME], vc[ME], tl[ME];
#pragma unroll
  for (int b = 0; b < ME; ++b) {
    const int idx = voc[b * n + c];
    const T m = vmask[b * n + c];
    uc[b] = u[idx] * m;
    vc[b] = v[idx] * m;
    tl[b] = metric ? tanlat[idx] * m : T(0);
  }

  // strain at corner g: e[g] = sum_b vel[b] * grad[b, d, g]
  T e11[ME], e22[ME], eA[ME], eB[ME];
#pragma unroll
  for (int g = 0; g < ME; ++g) { e11[g] = T(0); e22[g] = T(0); eA[g] = T(0); eB[g] = T(0); }
#pragma unroll
  for (int b = 0; b < ME; ++b) {
#pragma unroll
    for (int g = 0; g < ME; ++g) {
      const T gx = bgrad[((size_t)(b * 2 + 0) * ME + g) * n + c];
      const T gy = bgrad[((size_t)(b * 2 + 1) * ME + g) * n + c];
      e11[g] += uc[b] * gx;
      e22[g] += vc[b] * gy;
      eA[g] += uc[b] * gy;
      eB[g] += vc[b] * gx;
    }
  }

  const T press = pressure[c];
  const bool ss = solve_stress[c] > T(0);
  T r11[ME], r22[ME], r12[ME];
#pragma unroll
  for (int g = 0; g < ME; ++g) {
    T x11 = e11[g], x22 = e22[g], x12 = T(0.5) * (eA[g] + eB[g]);
    if (metric) {
      x11 = x11 - vc[g] * tl[g];
      x12 = x12 + T(0.5) * uc[g] * tl[g];
    }
    const T o11 = s11[g * n + c], o22 = s22[g * n + c], o12 = s12[g * n + c];
    T n11, n22, n12;
    evp_relax<T>(x11, x22, x12, press, o11, o22, o12, P, n11, n22, n12);
    r11[g] = ss ? n11 : o11;
    r22[g] = ss ? n22 : o22;
    r12[g] = ss ? n12 : o12;
    if (ss) {
      s11[g * n + c] = n11;
      s22[g * n + c] = n22;
      s12[g * n + c] = n12;
    }
  }

  // divergence partials per dual slot j; the metric factor of the corner's
  // own vertex is folded in here (same products as a multiply after the
  // vertex-side gather): pu + mu*tl, pv - mv*tl
#pragma unroll
  for (int j = 0; j < ME; ++j) {
    T a = T(0), b2 = T(0), c2 = T(0), d2 = T(0), mu = T(0), mv = T(0);
#pragma unroll
    for (int s = 0; s < ME; ++s) {
      const T bu = bint[((size_t)(s * 2 + 0) * ME + j) * n + c];
      const T bv = bint[((size_t)(s * 2 + 1) * ME + j) * n + c];
      a += r11[s] * bu;
      b2 += r12[s] * bv;
      c2 += r22[s] * bv;
      d2 += r12[s] * bu;
      if (metric) {
        const T bm = bmet[((size_t)s * ME + j) * n + c];
        mu += r12[s] * bm;
        mv += r11[s] * bm;
      }
    }
    T pu = a + b2;
    T pv = c2 + d2;
    if (metric) {
      pu = pu + mu * tl[j];
      pv = pv - mv * tl[j];
    }
    pu_out[(size_t)c * ME + j] = pu;
    pv_out[(size_t)c * ME + j] = pv;
  }
}

// ---- vertex phase: gather-sum of partials, drag, 2x2 momentum solve ----
// pu, pv, u and v are written during the whole-loop launch, so they are
// read with plain loads (never through the read-only path).
template <typename T>
__device__ __forceinline__ void evp_vertex_body(
    int i, int nv, int vd,
    const int* __restrict__ fci,     // [vd, nv] flat corner index cell*me + slot
    const T* __restrict__ cmask,     // [vd, nv]
    const T* pu, const T* pv,
    const T* __restrict__ denom,
    const T* __restrict__ uo, const T* __restrict__ vo,
    const T* __restrict__ mass_v, const T* __restrict__ mass_f,
    const T* __restrict__ rhs_u0, const T* __restrict__ rhs_v0,
    const T* __restrict__ ocn_u, const T* __restrict__ ocn_v,
    const T* __restrict__ solve_velocity, const T* __restrict__ area_v,
    T* u, T* v,
    const EvpParams<T>& P)
{
  const size_t n = (size_t)nv;
  T du = T(0), dv = T(0);
  for (int d = 0; d < vd; ++d) {
    const int idx = fci[d * n + i];
    const T m = cmask[d * n + i];
    du += pu[idx] * m;
    dv += pv[idx] * m;
  }
  if (!(solve_velocity[i] > T(0))) return;   // u, v keep their values
  evp_momentum<T>(du, dv, denom[i], u[i], v[i], uo[i], vo[i], mass_v[i], mass_f[i],
                  rhs_u0[i], rhs_v0[i], ocn_u[i], ocn_v[i], area_v[i], P, u[i], v[i]);
}

// ---- K6: one subcycle of every block of the card, the block as blockIdx.y ----
// One row of the wrapper's int64 table [B, 30]: the block's sizes, then its
// 28 pointers in the order of the C entries' arguments.  Every field is 8
// bytes, so the struct has no padding and a row maps onto it as it is.
struct BlockArgs {
  long long nc, nv;
  const int* voc; const void* vmask; const void* bgrad; const void* bint;
  const void* bmet; const int* fci; const void* cmask; const void* denom;
  const void* tanlat; void* u; void* v; void* s11; void* s22; void* s12;
  const void* pressure; const void* solve_stress; const void* uo; const void* vo;
  const void* mass_v; const void* mass_f; const void* rhs_u0; const void* rhs_v0;
  const void* ocn_u; const void* ocn_v; const void* solve_velocity;
  const void* area_v; void* pu; void* pv;
};
static_assert(sizeof(BlockArgs) == 30 * 8, "BlockArgs is a row of 30 int64");

template <typename T, int ME>
__global__ void evp_cell_blocks_kernel(const BlockArgs* __restrict__ tab, int metric,
                                       EvpParams<T> P)
{
  const BlockArgs& A = tab[blockIdx.y];
  const int nc = (int)A.nc;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  evp_cell_body<T, ME>(c, nc, metric, (const T*)A.u, (const T*)A.v, A.voc,
                       (const T*)A.vmask, (const T*)A.bgrad, (const T*)A.bint,
                       (const T*)A.bmet, (const T*)A.tanlat, (const T*)A.pressure,
                       (const T*)A.solve_stress, (T*)A.s11, (T*)A.s22, (T*)A.s12,
                       (T*)A.pu, (T*)A.pv, P);
}

template <typename T>
__global__ void evp_vertex_blocks_kernel(const BlockArgs* __restrict__ tab, int vd,
                                         EvpParams<T> P)
{
  const BlockArgs& A = tab[blockIdx.y];
  const int nv = (int)A.nv;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nv) return;
  evp_vertex_body<T>(i, nv, vd, A.fci, (const T*)A.cmask, (const T*)A.pu,
                     (const T*)A.pv, (const T*)A.denom, (const T*)A.uo,
                     (const T*)A.vo, (const T*)A.mass_v, (const T*)A.mass_f,
                     (const T*)A.rhs_u0, (const T*)A.rhs_v0, (const T*)A.ocn_u,
                     (const T*)A.ocn_v, (const T*)A.solve_velocity,
                     (const T*)A.area_v, (T*)A.u, (T*)A.v, P);
}

// ---- K1: the whole loop as ONE persistent cooperative launch ----
#ifndef EVP_K1_THREADS
#define EVP_K1_THREADS 768
#endif
constexpr int kLoopThreads = EVP_K1_THREADS;

// A cell takes ME lanes of one warp, one corner a lane: 32/ME cells a warp,
// the last 32 % ME lanes idle; a block takes the cells of a pass at once.
template <int ME> constexpr int kCellsPerWarp = 32 / ME;
template <int ME> constexpr int kCellsPerPass = kLoopThreads / 32 * kCellsPerWarp<ME>;

template <typename T>
struct LoopArgs {
  int nc, nv, vd, metric, n_sub;
  int cpb;        // cell slots per block (the last run of cells may be short)
  int n_smem;     // cell slots per block whose basis is in shared memory
  int vpb;        // vertices per block
  const int* __restrict__ voc;          // [ME, nc]
  const T* __restrict__ vmask;          // [ME, nc]
  const T* __restrict__ bgrad;          // [ME(b), 2, ME(g), nc]
  const T* __restrict__ bint;           // [ME(s), 2, ME(j), nc]
  const T* __restrict__ bmet;           // [ME(s), ME(j), nc]
  const int* __restrict__ fci;          // [vd, nv]
  const T* __restrict__ cmask;          // [vd, nv]
  const T* __restrict__ denom;          // [nv]
  const T* __restrict__ tanlat;         // [nv]
  const T* __restrict__ pressure;       // [nc]
  const T* __restrict__ solve_stress;   // [nc]
  const T* __restrict__ inv[10];        // [nv] each: uo, vo, mass_v, mass_f, rhs_u0,
                                        // rhs_v0, ocn_u, ocn_v, solve_velocity, area_v
  // written during the launch: plain pointers, plain loads
  T* u; T* v;                           // [nv], in place
  T* s11; T* s22; T* s12;               // [ME, nc], in place (the overflow cells'
                                        // store between subcycles)
  T* pu; T* pv;                         // [nc*ME] partials
  EvpParams<T> P;
};

// The corner a lane owns (corner g of cell c) and what it keeps across
// subcycles.
template <typename T>
struct Corner {
  int c;                        // cell, -1 = none
  int idx;                      // corner vertex
  bool ss;
  T press, m, tlm;              // pressure; corner mask, tan(lat)/r there (x mask)
  T s11, s22, s12;
};

template <typename T, int ME>
__device__ __forceinline__ void load_corner(Corner<T>& k, int c, int g, const LoopArgs<T>& A)
{
  k.c = c;
  if (c < 0) return;
  const size_t n = A.nc;
  k.ss = A.solve_stress[c] > T(0);
  k.press = A.pressure[c];
  k.idx = A.voc[g * n + c];
  k.m = A.vmask[g * n + c];
  k.tlm = A.metric ? A.tanlat[k.idx] * k.m : T(0);
  k.s11 = A.s11[g * n + c];
  k.s22 = A.s22[g * n + c];
  k.s12 = A.s12[g * n + c];
}

template <typename T>
__device__ __forceinline__ void store_corner(const Corner<T>& k, int g, const LoopArgs<T>& A)
{
  if (k.c < 0) return;
  const size_t n = A.nc;
  A.s11[g * n + k.c] = k.s11;
  A.s22[g * n + k.c] = k.s22;
  A.s12[g * n + k.c] = k.s12;
}

// The basis of corner g of one cell: bg[k * stride] (k = b*2 + d),
// bi[k * stride] (k = s*2 + d) and bm[k * stride] (k = s), from shared
// memory ([5*ME][slot jl][corner g]) for the block's first n_smem slots,
// else from the caller's [.., ME, nc] tensors.
template <typename T>
struct CornerBasis {
  const T* bg; const T* bi; const T* bm;
  int stride;
};

template <typename T, int ME>
__device__ __forceinline__ CornerBasis<T> corner_basis(int jl, int c, int g, const T* bs,
                                                       const LoopArgs<T>& A)
{
  if (jl < A.n_smem) {
    const int S = A.n_smem * ME;
    const T* col = bs + jl * ME + g;
    return {col, col + 2 * ME * S, col + 4 * ME * S, S};
  }
  const size_t at = (size_t)g * A.nc + c;
  return {A.bgrad + at, A.bint + at, A.bmet + at, ME * A.nc};
}

// Cell phase of one corner g (= the lane) of cell k.c, the sums in the
// order of evp_cell_body: strain over b, partials over s.  uc, vc: the
// corner's velocity (masked).  sh: the cell's ME exchange slots in three
// arrays of stride shs; the ME lanes of a cell are part of one warp, so
// __syncwarp orders the exchange.  Every lane of the warp takes part.
template <typename T, int ME>
__device__ __forceinline__ void corner_step(Corner<T>& k, int g, T uc, T vc,
                                            const CornerBasis<T>& B, T* sh, int shs,
                                            const LoopArgs<T>& A)
{
  const bool live = k.c >= 0;
  __syncwarp();
  if (live) { sh[g] = uc; sh[shs + g] = vc; }
  __syncwarp();
  if (live) {
    T e11 = T(0), e22 = T(0), eA = T(0), eB = T(0);
#pragma unroll
    for (int b = 0; b < ME; ++b) {
      const T gx = B.bg[(b * 2 + 0) * B.stride];
      const T gy = B.bg[(b * 2 + 1) * B.stride];
      const T ub = sh[b], vb = sh[shs + b];
      e11 += ub * gx;
      e22 += vb * gy;
      eA += ub * gy;
      eB += vb * gx;
    }
    T x11 = e11, x22 = e22, x12 = T(0.5) * (eA + eB);
    if (A.metric) {
      x11 = x11 - vc * k.tlm;
      x12 = x12 + T(0.5) * uc * k.tlm;
    }
    T n11, n22, n12;
    evp_relax<T>(x11, x22, x12, k.press, k.s11, k.s22, k.s12, A.P, n11, n22, n12);
    if (k.ss) { k.s11 = n11; k.s22 = n22; k.s12 = n12; }
  }
  __syncwarp();
  if (live) { sh[g] = k.s11; sh[shs + g] = k.s22; sh[2 * shs + g] = k.s12; }
  __syncwarp();
  if (!live) return;
  // the divergence partials of dual slot j = g
  T a = T(0), b2 = T(0), c2 = T(0), d2 = T(0), mu = T(0), mv = T(0);
#pragma unroll
  for (int s = 0; s < ME; ++s) {
    const T bu = B.bi[(s * 2 + 0) * B.stride];
    const T bv = B.bi[(s * 2 + 1) * B.stride];
    const T q11 = sh[s], q22 = sh[shs + s], q12 = sh[2 * shs + s];
    a += q11 * bu;
    b2 += q12 * bv;
    c2 += q22 * bv;
    d2 += q12 * bu;
    if (A.metric) {
      const T w = B.bm[s * B.stride];
      mu += q12 * w;
      mv += q11 * w;
    }
  }
  T pu = a + b2;
  T pv = c2 + d2;
  if (A.metric) {
    pu = pu + mu * k.tlm;
    pv = pv - mv * k.tlm;
  }
  A.pu[(size_t)k.c * ME + g] = pu;
  A.pv[(size_t)k.c * ME + g] = pv;
}

template <typename T, int ME>
__global__ void __launch_bounds__(kLoopThreads, 1) evp_loop_kernel(LoopArgs<T> A)
{
  constexpr int CW = kCellsPerWarp<ME>;
  constexpr int CP = kCellsPerPass<ME>;
  // passes held in registers: about 360 cells a block (311 on the subdiv-6
  // sphere on an H100); further passes keep their state in global memory
  constexpr int KREG = (360 + CP - 1) / CP;
  extern __shared__ __align__(16) unsigned char k1_smem[];
  T* sh = reinterpret_cast<T*>(k1_smem);        // [3][CP*ME] exchange
  T* bs = sh + 3 * CP * ME;                      // [5*ME][n_smem][ME] basis
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  // corner g of the pass's cell l; the last 32 % ME lanes of a warp idle
  const int wl = tid % 32;
  const bool lane_live = wl < CW * ME;
  const int g = wl % ME, l = lane_live ? (tid / 32) * CW + wl / ME : 0;
  // the block's jl-th cell: runs of CW cells (one warp's) dealt to the
  // blocks in turn, so that every block takes cells from all over the mesh
  auto cell_of = [&](int jl) {
    if (!lane_live || jl >= A.cpb) return -1;
    const int c = ((jl / CW) * (int)gridDim.x + (int)blockIdx.x) * CW + jl % CW;
    return c < A.nc ? c : -1;
  };
  const int npass = (A.cpb + CP - 1) / CP;
  const int v0 = blockIdx.x * A.vpb;
  const int v1 = min(A.nv, v0 + A.vpb);
  const int shs = CP * ME;
  T* shc = sh + l * ME;                          // this cell's exchange slots
  const size_t n = A.nc;

  // ---- prologue: the basis of the block's first n_smem cells ----
  const int nkc = (A.metric ? 5 : 4) * ME * ME;  // values a cell
  const int ns = min(A.n_smem, A.cpb);
  for (int e = tid; e < nkc * ns; e += kLoopThreads) {
    const int jl = e % ns, kg = e / ns;
    const int k = kg / ME, gk = kg % ME;         // k < 5*ME, corner gk
    const int c = ((jl / CW) * (int)gridDim.x + (int)blockIdx.x) * CW + jl % CW;
    if (c >= A.nc) continue;
    T val;
    if (k < 2 * ME) val = A.bgrad[((size_t)k * ME + gk) * n + c];
    else if (k < 4 * ME) val = A.bint[((size_t)(k - 2 * ME) * ME + gk) * n + c];
    else val = A.bmet[((size_t)(k - 4 * ME) * ME + gk) * n + c];
    bs[(size_t)k * A.n_smem * ME + jl * ME + gk] = val;
  }
  Corner<T> reg[KREG];
#pragma unroll
  for (int p = 0; p < KREG; ++p) load_corner<T, ME>(reg[p], cell_of(p * CP + l), g, A);
  __syncthreads();

  DevPhaseTimer timer;   // cell work, barrier, vertex work, barrier
  for (int k = 0; k < A.n_sub; ++k) {
    timer.mark(-1);
    // ---- cell phase: the velocities of every pass first, then the passes ----
    T uc[KREG], vc[KREG];
#pragma unroll
    for (int p = 0; p < KREG; ++p) {
      const bool on = reg[p].c >= 0;
      uc[p] = on ? A.u[reg[p].idx] * reg[p].m : T(0);
      vc[p] = on ? A.v[reg[p].idx] * reg[p].m : T(0);
    }
#pragma unroll
    for (int p = 0; p < KREG; ++p) {
      if (p >= npass) break;                     // uniform over the block
      const int jl = p * CP + l;
      corner_step<T, ME>(reg[p], g, uc[p], vc[p],
                         corner_basis<T, ME>(jl, reg[p].c, g, bs, A), shc, shs, A);
    }
    for (int p = KREG; p < npass; ++p) {         // overflow passes: state in global
      const int jl = p * CP + l;
      Corner<T> o;
      load_corner<T, ME>(o, cell_of(jl), g, A);
      const bool on = o.c >= 0;
      corner_step<T, ME>(o, g, on ? A.u[o.idx] * o.m : T(0), on ? A.v[o.idx] * o.m : T(0),
                         corner_basis<T, ME>(jl, o.c, g, bs, A), shc, shs, A);
      store_corner(o, g, A);
    }
    timer.mark(0);
    grid.sync();
    timer.mark(1);
    // ---- vertex phase ----
    for (int i = v0 + tid; i < v1; i += kLoopThreads)
      evp_vertex_body<T>(i, A.nv, A.vd, A.fci, A.cmask, A.pu, A.pv, A.denom,
                         A.inv[0], A.inv[1], A.inv[2], A.inv[3], A.inv[4], A.inv[5],
                         A.inv[6], A.inv[7], A.inv[8], A.inv[9], A.u, A.v, A.P);
    timer.mark(2);
    grid.sync();
    timer.mark(3);
  }

  // ---- epilogue: the register passes' stresses ----
#pragma unroll
  for (int p = 0; p < KREG; ++p) store_corner(reg[p], g, A);
}

// Sizes the grid and the shared-memory basis, then launches.  info[0..6]:
// launches, grid, threads per block, dynamic shared memory bytes per block,
// cells per block, cells per block with the basis in shared memory, cells
// of the whole mesh with the basis in shared memory.
template <typename T, int ME>
int launch_loop(LoopArgs<T>& A, void* stream, int* info)
{
  constexpr int CW = kCellsPerWarp<ME>;
  constexpr int CP = kCellsPerPass<ME>;
  cudaError_t err;
  int dev = 0, sms = 0, budget = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  auto kernel = evp_loop_kernel<T, ME>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  budget)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLoopThreads,
                                                           (size_t)budget)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // the co-resident grid, cut to one pass of cells per block on small meshes
  const int grid = std::min(per_sm * sms, std::max(1, (A.nc + CP - 1) / CP));
  const int runs = (A.nc + CW - 1) / CW;       // warp-sized runs of cells
  A.cpb = (runs + grid - 1) / grid * CW;
  A.vpb = (A.nv + grid - 1) / grid;
  const size_t scratch = (size_t)3 * CP * ME * sizeof(T);
  const size_t per_cell = (size_t)(A.metric ? 5 : 4) * ME * ME * sizeof(T);
  const size_t room = (size_t)budget > scratch ? budget - scratch : 0;
  A.n_smem = (int)std::min<size_t>(A.cpb, room / per_cell);
  const size_t smem = scratch + A.n_smem * per_cell;
  info[1] = grid;
  info[2] = kLoopThreads;
  info[3] = (int)smem;
  info[4] = A.cpb;
  info[5] = A.n_smem;
  info[6] = 0;                                 // cells with the basis in shared memory
  for (int q = 0; q < runs; ++q)               // run q is slot q / grid of its block
    info[6] += std::max(0, std::min(std::min(CW, A.nc - q * CW),
                                    A.n_smem - (q / grid) * CW));

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kLoopThreads);
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

template <typename T>
int run_loop(int nc, int nv, int me, int vd, int n_sub, int metric,
             const int* voc, const void* vmask, const void* bgrad, const void* bint,
             const void* bmet, const int* fci, const void* cmask, const void* denom,
             const void* tanlat, void* u, void* v, void* s11, void* s22, void* s12,
             const void* pressure, const void* solve_stress,
             const void* uo, const void* vo, const void* mass_v, const void* mass_f,
             const void* rhs_u0, const void* rhs_v0, const void* ocn_u, const void* ocn_v,
             const void* solve_velocity, const void* area_v, void* pu, void* pv,
             double dte, double damping, double ecc2, double puny, double cosw,
             double sinw, double drag, void* stream, int* info)
{
  for (int k = 0; k < 7; ++k) info[k] = 0;
  if (nc < 1 || nv < 1 || vd < 1 || n_sub < 0) return (int)cudaErrorInvalidValue;
  LoopArgs<T> A;
  A.nc = nc; A.nv = nv; A.vd = vd; A.metric = metric; A.n_sub = n_sub;
  A.voc = voc; A.vmask = (const T*)vmask;
  A.bgrad = (const T*)bgrad; A.bint = (const T*)bint; A.bmet = (const T*)bmet;
  A.fci = fci; A.cmask = (const T*)cmask; A.denom = (const T*)denom;
  A.tanlat = (const T*)tanlat;
  A.pressure = (const T*)pressure; A.solve_stress = (const T*)solve_stress;
  const void* inv[10] = {uo, vo, mass_v, mass_f, rhs_u0, rhs_v0, ocn_u, ocn_v,
                         solve_velocity, area_v};
  for (int k = 0; k < 10; ++k) A.inv[k] = (const T*)inv[k];
  A.u = (T*)u; A.v = (T*)v;
  A.s11 = (T*)s11; A.s22 = (T*)s22; A.s12 = (T*)s12;
  A.pu = (T*)pu; A.pv = (T*)pv;
  A.P = make_params<T>(dte, damping, ecc2, puny, cosw, sinw, drag);
  switch (me) {
#define EVP_LOOP(MEV) \
  case MEV: return launch_loop<T, MEV>(A, stream, info);
    EVP_LOOP(3) EVP_LOOP(4) EVP_LOOP(5) EVP_LOOP(6) EVP_LOOP(7) EVP_LOOP(8)
    EVP_LOOP(9) EVP_LOOP(10)
#undef EVP_LOOP
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6: one subcycle of n_blocks blocks, two launches (cells, then vertices),
// each over the largest block with the block as blockIdx.y.
template <typename T>
int run_blocks(int n_blocks, int max_nc, int max_nv, int me, int vd, int metric,
               const void* table, double dte, double damping, double ecc2,
               double puny, double cosw, double sinw, double drag, void* stream_v,
               int* n_launches)
{
  cudaStream_t stream = (cudaStream_t)stream_v;
  const EvpParams<T> P = make_params<T>(dte, damping, ecc2, puny, cosw, sinw, drag);
  const BlockArgs* tab = (const BlockArgs*)table;
  *n_launches = 0;
  const int threads = 128;
  const dim3 cgrid((max_nc + threads - 1) / threads, n_blocks);
  const dim3 vgrid((max_nv + threads - 1) / threads, n_blocks);
  switch (me) {
#define EVP_CELL_BLOCKS(MEV)                                                       \
  case MEV:                                                                        \
    evp_cell_blocks_kernel<T, MEV><<<cgrid, threads, 0, stream>>>(tab, metric, P); \
    break;
    EVP_CELL_BLOCKS(3) EVP_CELL_BLOCKS(4) EVP_CELL_BLOCKS(5) EVP_CELL_BLOCKS(6)
    EVP_CELL_BLOCKS(7) EVP_CELL_BLOCKS(8) EVP_CELL_BLOCKS(9) EVP_CELL_BLOCKS(10)
#undef EVP_CELL_BLOCKS
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*n_launches;
  evp_vertex_blocks_kernel<T><<<vgrid, threads, 0, stream>>>(tab, vd, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*n_launches;
  return 0;
}

}  // namespace

#define EVP_TAIL_ARGS                                                               \
  const int* voc, const void* vmask, const void* bgrad, const void* bint,           \
  const void* bmet, const int* fci, const void* cmask, const void* denom,           \
  const void* tanlat, void* u, void* v, void* s11, void* s22, void* s12,            \
  const void* pressure, const void* solve_stress, const void* uo, const void* vo,   \
  const void* mass_v, const void* mass_f, const void* rhs_u0, const void* rhs_v0,   \
  const void* ocn_u, const void* ocn_v, const void* solve_velocity,                 \
  const void* area_v, void* pu, void* pv, double dte, double damping, double ecc2,  \
  double puny, double cosw, double sinw, double drag, void* stream, int* info
#define EVP_TAIL_PASS                                                               \
  voc, vmask, bgrad, bint, bmet, fci, cmask, denom, tanlat, u, v, s11, s22, s12,    \
  pressure, solve_stress, uo, vo, mass_v, mass_f, rhs_u0, rhs_v0, ocn_u, ocn_v,     \
  solve_velocity, area_v, pu, pv, dte, damping, ecc2, puny, cosw, sinw, drag,       \
  stream, info

// K1: all n_sub subcycles in ONE cooperative launch.  u, v [nv] and
// s11, s22, s12 [me, nc] are updated in place; pu, pv are [nc*me] scratch.
// info: int[7], launch_loop's.  Returns the first CUDA error (0 = none; a
// refused cooperative launch returns its error and nothing runs).  Nothing
// is allocated and nothing synchronises.
extern "C" int evp_subcycle_loop_f32(int nc, int nv, int me, int vd, int n_sub,
                                     int metric, EVP_TAIL_ARGS) {
  return run_loop<float>(nc, nv, me, vd, n_sub, metric, EVP_TAIL_PASS);
}
extern "C" int evp_subcycle_loop_f64(int nc, int nv, int me, int vd, int n_sub,
                                     int metric, EVP_TAIL_ARGS) {
  return run_loop<double>(nc, nv, me, vd, n_sub, metric, EVP_TAIL_PASS);
}
#define EVP_BLOCKS_ARGS                                                             \
  int n_blocks, int max_nc, int max_nv, int me, int vd, int metric,                 \
  const void* table, double dte, double damping, double ecc2, double puny,          \
  double cosw, double sinw, double drag, void* stream, int* n_launches
#define EVP_BLOCKS_PASS                                                             \
  n_blocks, max_nc, max_nv, me, vd, metric, table, dte, damping, ecc2, puny, cosw,  \
  sinw, drag, stream, n_launches

// K6: one subcycle of every block in `table` (device memory, [n_blocks, 30]
// int64: nc, nv and the 28 pointers of EVP_TAIL_ARGS from voc to pv, each
// block's u, v and stresses updated in place, pu, pv its scratch); max_nc,
// max_nv the largest block's sizes.  Two launches whatever n_blocks is.
extern "C" int evp_subcycle_step_f32(EVP_BLOCKS_ARGS) {
  return run_blocks<float>(EVP_BLOCKS_PASS);
}
extern "C" int evp_subcycle_step_f64(EVP_BLOCKS_ARGS) {
  return run_blocks<double>(EVP_BLOCKS_PASS);
}
