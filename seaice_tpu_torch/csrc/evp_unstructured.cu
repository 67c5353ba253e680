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
//   mpas_seaice_velocity_solver.F:2546-2584).  Both entries run the same
//   two kernel bodies, as the TPU K6 runs K1's pallas_call with
//   n_subcycles=1.
//
// The TPU kernel is one sequential program.  Here the vertex phase of
// subcycle k needs every cell's partials and the cell phase of k+1 needs
// every vertex's new velocity, so a subcycle is two launches:
//   evp_cell_kernel   one thread per cell
//   evp_vertex_kernel one thread per vertex
// launched alternately from a host loop on the caller's stream, 2*n_sub
// launches, no synchronisation.  All corner arrays are [maxEdges, nCells]
// (cell axis fastest), so a warp's loads of every basis and stress array
// are contiguous; only the two index gathers (u,v by voc; partials by
// flat_corner_idx) are scattered reads.  The divergence is a vertex-side
// GATHER of the cells' partial sums, never an atomic scatter: the result
// is deterministic and keeps the plain version's sum order.
//
// What bounds it: each subcycle streams the five basis tensors
// (5*me*me*nCells values; 29.5 MB in f32 at 40,962 cells, me=6, which the
// 50 MB L2 holds) plus the stresses; the arithmetic is about 1,100 flops
// per cell per subcycle.  Read once from device memory the inputs take
// ~0.01 ms, the flops ~0.08 ms at the f32 peak: the loop is bound by L2
// bandwidth and by 2*n_sub launch latencies, not by either roofline term.
// One cooperative launch with a grid-wide barrier per phase is the later
// optimisation of the whole loop.
//
// K6 on a partitioned mesh: every block of the card in one call.  A block
// of a sphere in four is a quarter of the mesh, so one launch per block
// fills under one wave of the 132 SMs and four blocks cost four launch
// latencies and four host calls a phase.  evp_subcycle_step_* takes a
// device table of the blocks' sizes and pointers (`BlockArgs`, one row a
// block, built once per solve by the wrapper) and launches each phase once
// with the block as blockIdx.y: two launches per subcycle whatever the
// number of blocks.  Each block's arithmetic is K1's (`evp_cell_body`,
// `evp_vertex_body`), so a block's result is bitwise what it is alone.

#include <cuda_runtime.h>

namespace {

template <typename T>
struct EvpParams {
  T dte;        // elastic time step
  T two_damp;   // 2 * damping time scale
  T denom;      // 1 + 0.5*dte/damping
  T ecc2;       // yield-curve eccentricity squared
  T puny;
  T cosw, sinw; // ocean turning angle
  T drag;       // ice-ocean drag coefficient * sea-water density
};

template <typename T> __device__ __forceinline__ T t_sqrt(T x);
template <> __device__ __forceinline__ float t_sqrt<float>(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double t_sqrt<double>(double x) { return sqrt(x); }

template <typename T> __device__ __forceinline__ T t_max(T a, T b) { return a > b ? a : b; }

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
    // EVP stress relaxation with replacement pressure
    const T div = x11 + x22;
    const T tension = x11 - x22;
    const T shearing = T(2) * x12;
    const T delta = t_sqrt<T>(div * div + (tension * tension + shearing * shearing) / P.ecc2);
    T stress1 = o11 + o22;
    T stress2 = o11 - o22;
    T pc = press / t_max<T>(delta, P.puny);
    pc = (pc * P.dte) / P.two_damp;
    stress1 = (stress1 + pc * (div - delta)) / P.denom;
    stress2 = (stress2 + (pc / P.ecc2) * tension) / P.denom;
    const T n12 = (o12 + (pc / P.ecc2) * shearing * T(0.5)) / P.denom;
    const T n11 = T(0.5) * (stress1 + stress2);
    const T n22 = T(0.5) * (stress1 - stress2);
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

template <typename T, int ME>
__global__ void evp_cell_kernel(
    int nc, int metric,
    const T* __restrict__ u, const T* __restrict__ v,
    const int* __restrict__ voc, const T* __restrict__ vmask,
    const T* __restrict__ bgrad, const T* __restrict__ bint,
    const T* __restrict__ bmet, const T* __restrict__ tanlat,
    const T* __restrict__ pressure, const T* __restrict__ solve_stress,
    T* __restrict__ s11, T* __restrict__ s22, T* __restrict__ s12,
    T* __restrict__ pu_out, T* __restrict__ pv_out,
    EvpParams<T> P)
{
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  evp_cell_body<T, ME>(c, nc, metric, u, v, voc, vmask, bgrad, bint, bmet, tanlat,
                       pressure, solve_stress, s11, s22, s12, pu_out, pv_out, P);
}

// ---- vertex phase: gather-sum of partials, drag, 2x2 momentum solve ----
template <typename T>
__device__ __forceinline__ void evp_vertex_body(
    int i, int nv, int vd,
    const int* __restrict__ fci,     // [vd, nv] flat corner index cell*me + slot
    const T* __restrict__ cmask,     // [vd, nv]
    const T* __restrict__ pu, const T* __restrict__ pv,
    const T* __restrict__ denom,
    const T* __restrict__ uo, const T* __restrict__ vo,
    const T* __restrict__ mass_v, const T* __restrict__ mass_f,
    const T* __restrict__ rhs_u0, const T* __restrict__ rhs_v0,
    const T* __restrict__ ocn_u, const T* __restrict__ ocn_v,
    const T* __restrict__ solve_velocity, const T* __restrict__ area_v,
    T* __restrict__ u, T* __restrict__ v,
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
  const bool sv = solve_velocity[i] > T(0);
  if (!sv) return;                       // u, v keep their values
  const T div_u = -du / denom[i];
  const T div_v = -dv / denom[i];
  const T uu = u[i], vv = v[i];
  const T dux = uo[i] - uu, dvy = vo[i] - vv;
  const T oc = P.drag * area_v[i] * t_sqrt<T>(dux * dux + dvy * dvy);
  const T mf = mass_f[i];
  const T sgn = mf < T(0) ? T(-1) : T(1);            // sign(0) -> +1
  const T mv = mass_v[i];
  const T a11 = mv / P.dte + oc * P.cosw;
  const T a12 = -mf - oc * P.sinw * sgn;
  const T a21 = mf + oc * P.sinw * sgn;
  const T rhs1 = div_u + rhs_u0[i] + oc * ocn_u[i] + mv * uu / P.dte;
  const T rhs2 = div_v + rhs_v0[i] + oc * ocn_v[i] + mv * vv / P.dte;
  T det = a11 * a11 - a12 * a21;
  if (det == T(0)) det = T(1);
  u[i] = (a11 * rhs1 - a12 * rhs2) / det;
  v[i] = (a11 * rhs2 - a21 * rhs1) / det;
}

template <typename T>
__global__ void evp_vertex_kernel(
    int nv, int vd,
    const int* __restrict__ fci, const T* __restrict__ cmask,
    const T* __restrict__ pu, const T* __restrict__ pv,
    const T* __restrict__ denom,
    const T* __restrict__ uo, const T* __restrict__ vo,
    const T* __restrict__ mass_v, const T* __restrict__ mass_f,
    const T* __restrict__ rhs_u0, const T* __restrict__ rhs_v0,
    const T* __restrict__ ocn_u, const T* __restrict__ ocn_v,
    const T* __restrict__ solve_velocity, const T* __restrict__ area_v,
    T* __restrict__ u, T* __restrict__ v,
    EvpParams<T> P)
{
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nv) return;
  evp_vertex_body<T>(i, nv, vd, fci, cmask, pu, pv, denom, uo, vo, mass_v, mass_f,
                     rhs_u0, rhs_v0, ocn_u, ocn_v, solve_velocity, area_v, u, v, P);
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

template <typename T>
EvpParams<T> make_params(double dte, double damping, double ecc2, double puny,
                         double cosw, double sinw, double drag)
{
  EvpParams<T> P;
  P.dte = (T)dte;
  P.two_damp = (T)(2.0 * damping);
  P.denom = (T)(1.0 + (0.5 * dte) / damping);
  P.ecc2 = (T)ecc2;
  P.puny = (T)puny;
  P.cosw = (T)cosw;
  P.sinw = (T)sinw;
  P.drag = (T)drag;
  return P;
}

template <typename T, int ME>
cudaError_t launch_cell(int nc, int metric, const T* u, const T* v, const int* voc,
                        const T* vmask, const T* bgrad, const T* bint, const T* bmet,
                        const T* tanlat, const T* pressure, const T* solve_stress,
                        T* s11, T* s22, T* s12, T* pu, T* pv, EvpParams<T> P,
                        cudaStream_t stream)
{
  const int threads = 128;
  const int blocks = (nc + threads - 1) / threads;
  evp_cell_kernel<T, ME><<<blocks, threads, 0, stream>>>(
      nc, metric, u, v, voc, vmask, bgrad, bint, bmet, tanlat, pressure,
      solve_stress, s11, s22, s12, pu, pv, P);
  return cudaGetLastError();
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
             double sinw, double drag, void* stream_v, int* n_launches)
{
  cudaStream_t stream = (cudaStream_t)stream_v;
  const EvpParams<T> P = make_params<T>(dte, damping, ecc2, puny, cosw, sinw, drag);
  *n_launches = 0;
  const int vthreads = 128;
  const int vblocks = (nv + vthreads - 1) / vthreads;
  for (int k = 0; k < n_sub; ++k) {
    cudaError_t err;
#define EVP_CELL(MEV)                                                              \
  case MEV:                                                                        \
    err = launch_cell<T, MEV>(nc, metric, (const T*)u, (const T*)v, voc,           \
                              (const T*)vmask, (const T*)bgrad, (const T*)bint,    \
                              (const T*)bmet, (const T*)tanlat, (const T*)pressure,\
                              (const T*)solve_stress, (T*)s11, (T*)s22, (T*)s12,   \
                              (T*)pu, (T*)pv, P, stream);                          \
    break;
    switch (me) {
      EVP_CELL(3) EVP_CELL(4) EVP_CELL(5) EVP_CELL(6) EVP_CELL(7)
      EVP_CELL(8) EVP_CELL(9) EVP_CELL(10)
      default: return (int)cudaErrorInvalidValue;
    }
#undef EVP_CELL
    if (err != cudaSuccess) return (int)err;
    ++*n_launches;
    evp_vertex_kernel<T><<<vblocks, vthreads, 0, stream>>>(
        nv, vd, fci, (const T*)cmask, (const T*)pu, (const T*)pv, (const T*)denom,
        (const T*)uo, (const T*)vo, (const T*)mass_v, (const T*)mass_f,
        (const T*)rhs_u0, (const T*)rhs_v0, (const T*)ocn_u, (const T*)ocn_v,
        (const T*)solve_velocity, (const T*)area_v, (T*)u, (T*)v, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*n_launches;
  }
  return 0;
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
  double puny, double cosw, double sinw, double drag, void* stream, int* n_launches
#define EVP_TAIL_PASS                                                               \
  voc, vmask, bgrad, bint, bmet, fci, cmask, denom, tanlat, u, v, s11, s22, s12,    \
  pressure, solve_stress, uo, vo, mass_v, mass_f, rhs_u0, rhs_v0, ocn_u, ocn_v,     \
  solve_velocity, area_v, pu, pv, dte, damping, ecc2, puny, cosw, sinw, drag,       \
  stream, n_launches

// u, v [nv] and s11, s22, s12 [me, nc] are updated in place; pu, pv are
// [nc*me] scratch.  Returns the first CUDA error (0 = none) and the number
// of kernel launches made.  Nothing is allocated and nothing synchronises.
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
