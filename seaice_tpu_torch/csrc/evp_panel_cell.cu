// Cell side of ONE elastic subcycle on the panel-reordered icosahedral
// sphere, for Hopper.
//
// Replaces the TPU kernel of seaice_tpu/dynamics/pallas_panel.py
// (build_panel_cell_kernel): corner reads -> Wachspress strain (+ tan(lat)/r
// metric) -> EVP stress relaxation -> stress-divergence partials pu, pv
// (mu, mv with metric), one launch per subcycle.  The seam-ghost refresh, the
// dual sum, the 12 exception cells and the momentum solve stay in PyTorch
// between two launches (dynamics/evp.py); the mask the kernel is given has
// the exception columns zeroed, so it copies their stress unchanged.
//
// The TPU kernel is handed six pre-shifted copies of the vertex planes,
// because its compiler takes no load at an unaligned offset.  Here a thread
// reads the vertex planes at the static offsets itself (`corner_position` of
// evp_panel_common.cuh), in the layout variational_panel.velocity_planes
// builds, [2(t), npp, F] with the field (u, v, tan(lat)/r) last and the seam
// ghosts filled by the caller.  The kernel reads the stresses from one
// buffer of a pair and writes them into the other, and writes the partials
// [6(j), npc, F'] in the layout the caller's dual sum reads, the two pole
// columns included (zero): the wrapper makes no copy and no torch call.
//
// Design for Hopper.  One thread per column (the whole-loop kernel's cell
// body) holds six corners' velocities, 18 stresses and the strain sums at
// once and is bound by registers.  Here a column is spread over six
// threads: thread g of a column owns corner g, so it reads its corner's
// velocities, the 12 gradient weights of corner g, the three old stresses
// of slot g, and later the 12 (18 with metric) divergence weights of dual
// slot g.  The six corner velocities and the six new stresses cross between
// the column's threads through shared memory, between two block barriers.
// A block is 6 x 64 threads: warps 2g and 2g+1 hold corner g of 64
// neighbouring columns, so each warp's loads are one contiguous run of
// addresses.  (On an H100 at N = 64, 64 columns a block measured 15% faster
// than 32, and loading the divergence weights before the first barrier 7%
// slower: 40 registers a thread already leave the loads enough warps.)
//
// What bounds it: bytes.  One launch reads the three basis tensors (30.4 MB
// in f32 at N = 64) and reads and writes about 4 MB of stresses and
// partials: ~0.010 ms at 3.35 TB/s, against ~0.0007 ms for its ~46 MFLOP at
// the f32 peak.  The basis fits the 50 MB L2, so a launch that follows
// another may read most of it from there.

#include "evp_panel_common.cuh"

namespace {

constexpr int kCols = 64;      // columns a block; warps 2g, 2g+1 their corner g

template <typename T>
__global__ void __launch_bounds__(6 * kCols)
panel_cell_kernel(int N, int npp, int npc, int metric,
                  const T* __restrict__ planes,     // [2(t), npp, 2 or 3]
                  const T* __restrict__ bgrad,      // [6(b), 2, 6(g), npc]
                  const T* __restrict__ bint,       // [6(s), 2, 6(j), npc]
                  const T* __restrict__ bmet,       // [6(s), 6(j), npc]
                  const T* __restrict__ pressure,   // [npc]
                  const T* __restrict__ ss_mask,    // [npc], exceptions zeroed
                  const T* __restrict__ src,        // [3(s11, s22, s12), 6, npc]
                  T* __restrict__ dst,              // [3, 6, npc]
                  T* __restrict__ part,             // [6(j), npc, 2 or 4]
                  EvpParams<T> P)
{
  __shared__ T sh_u[6][kCols], sh_v[6][kCols];
  __shared__ T sh_s[3][6][kCols];
  const int g = threadIdx.x / kCols;     // corner, stress slot and dual slot
  const int c = threadIdx.x % kCols;
  const int q = blockIdx.x * kCols + c;
  const bool live = q < npc;
  const bool lattice = q < npp;          // npp, npp + 1: the pole columns
  const int nf = metric ? 3 : 2;
  const size_t n = (size_t)npc;

  // this thread's corner of the column
  T uk = T(0), vk = T(0), tk = T(0);
  if (lattice) {
    const int R = N + 1;
    const int pa = q / R;
    const int at = corner_position(g, q, pa / R, pa % R, q % R, N, npp,
                                   nullptr, nullptr);
    if (at >= 0) {
      const T* pl = planes + (size_t)at * nf;
      uk = pl[0];
      vk = pl[1];
      if (metric) tk = pl[2];
    }
  }
  sh_u[g][c] = uk;
  sh_v[g][c] = vk;
  T r11 = T(0), r22 = T(0), r12 = T(0);
  if (live) {
    r11 = src[(0 * 6 + g) * n + q];
    r22 = src[(1 * 6 + g) * n + q];
    r12 = src[(2 * 6 + g) * n + q];
  }
  __syncthreads();

  // strain at corner g: e = sum_b vel[b] * grad[b, d, g]; then the stress
  // relaxation of slot g where the column is solved
  if (lattice) {
    T e11 = T(0), e22 = T(0), eA = T(0), eB = T(0);
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      const T gx = bgrad[((size_t)(b * 2 + 0) * 6 + g) * n + q];
      const T gy = bgrad[((size_t)(b * 2 + 1) * 6 + g) * n + q];
      const T ub = sh_u[b][c], vb = sh_v[b][c];
      e11 += ub * gx;
      e22 += vb * gy;
      eA += ub * gy;
      eB += vb * gx;
    }
    T x11 = e11, x22 = e22, x12 = T(0.5) * (eA + eB);
    if (metric) {
      x11 = x11 - vk * tk;
      x12 = x12 + T(0.5) * uk * tk;
    }
    if (ss_mask[q] > T(0)) {
      T n11, n22, n12;
      evp_relax<T>(x11, x22, x12, pressure[q], r11, r22, r12, P, n11, n22, n12);
      r11 = n11;
      r22 = n22;
      r12 = n12;
    }
  }
  if (live) {
    dst[(0 * 6 + g) * n + q] = r11;
    dst[(1 * 6 + g) * n + q] = r22;
    dst[(2 * 6 + g) * n + q] = r12;
  }
  sh_s[0][g][c] = r11;
  sh_s[1][g][c] = r22;
  sh_s[2][g][c] = r12;
  __syncthreads();

  // divergence partials of dual slot j = g from the column's six stresses
  if (!live) return;
  T pu = T(0), pv = T(0), mu = T(0), mv = T(0);
  if (lattice) {
    T a = T(0), b2 = T(0), c2 = T(0), d2 = T(0);
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      const T bu = bint[((size_t)(s * 2 + 0) * 6 + g) * n + q];
      const T bv = bint[((size_t)(s * 2 + 1) * 6 + g) * n + q];
      const T t11 = sh_s[0][s][c], t22 = sh_s[1][s][c], t12 = sh_s[2][s][c];
      a += t11 * bu;
      b2 += t12 * bv;
      c2 += t22 * bv;
      d2 += t12 * bu;
      if (metric) {
        const T w = bmet[((size_t)s * 6 + g) * n + q];
        mu += t12 * w;
        mv += t11 * w;
      }
    }
    pu = a + b2;
    pv = c2 + d2;
  }
  T* out = part + ((size_t)g * n + q) * (metric ? 4 : 2);
  out[0] = pu;
  out[1] = pv;
  if (metric) {
    out[2] = mu;
    out[3] = mv;
  }
}

template <typename T>
int run_cell(int N, int metric, const void* planes, const void* bgrad,
             const void* bint, const void* bmet, const void* pressure,
             const void* ss_mask, const void* src, void* dst, void* part,
             double dte, double damping, double ecc2, double puny, void* stream_v)
{
  cudaStream_t stream = (cudaStream_t)stream_v;
  const EvpParams<T> P = make_params<T>(dte, damping, ecc2, puny, 0.0, 0.0, 0.0);
  const int R = N + 1;
  const int npp = 10 * R * R;
  const int npc = npp + 2;
  const int blocks = (npc + kCols - 1) / kCols;
  panel_cell_kernel<T><<<blocks, 6 * kCols, 0, stream>>>(
      N, npp, npc, metric, (const T*)planes, (const T*)bgrad, (const T*)bint,
      (const T*)bmet, (const T*)pressure, (const T*)ss_mask, (const T*)src,
      (T*)dst, (T*)part, P);
  return (int)cudaGetLastError();
}

}  // namespace

#define CELL_ARGS                                                                  \
  int N, int metric, const void* planes, const void* bgrad, const void* bint,      \
  const void* bmet, const void* pressure, const void* ss_mask, const void* src,    \
  void* dst, void* part, double dte, double damping, double ecc2, double puny,     \
  void* stream
#define CELL_PASS                                                                  \
  N, metric, planes, bgrad, bint, bmet, pressure, ss_mask, src, dst, part, dte,    \
  damping, ecc2, puny, stream

// planes [2, npp, 2 or 3 (u, v, tan(lat)/r)]; src, dst [3 (s11, s22, s12),
// 6, npc]: every column of dst is written (the old stress where the column
// is not solved); part [6, npc, 2 or 4 (pu, pv, mu, mv)], every column.
// One launch.  Returns its CUDA error (0 = none).
extern "C" int panel_cell_f32(CELL_ARGS) { return run_cell<float>(CELL_PASS); }
extern "C" int panel_cell_f64(CELL_ARGS) { return run_cell<double>(CELL_PASS); }
