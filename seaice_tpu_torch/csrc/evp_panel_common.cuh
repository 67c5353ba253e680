// Shared by the EVP kernels: the EVP constants, the stress relaxation of one
// corner and the drag and 2x2 momentum solve of one vertex (every EVP
// kernel); the corner positions on the 10-panel padded lattice and the
// arithmetic of the cell side of one elastic subcycle on a column's
// stresses (the two panel kernels, evp_panel_fused.cu and
// evp_panel_cell.cu).
//
// Layout (seaice_tpu_torch/dynamics/variational_panel.py): one flat padded
// index q = (p*(N+1) + a)*(N+1) + b per panel position, npp = 10*(N+1)^2 of
// them, npc = npp + 2 with the two pole columns; cells at (a=i+1, b=j),
// vertices at (a=i, b=j+1) of the two vertex planes t = 0, 1.  Every array
// keeps the padded axis last, so the threads of a warp (one per column q)
// read neighbouring addresses of every basis, stress and plane array.

#pragma once
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

template <typename T> __device__ __forceinline__ T t_sqrt(T x);
template <> __device__ __forceinline__ float t_sqrt<float>(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double t_sqrt<double>(double x) { return sqrt(x); }

template <typename T> __device__ __forceinline__ T t_max(T a, T b) { return a > b ? a : b; }

// EVP stress relaxation with replacement pressure at one corner
// (the arithmetic of dynamics/constitutive.py::evp_stress_update).
template <typename T>
__device__ __forceinline__ void evp_relax(T x11, T x22, T x12, T press,
                                          T o11, T o22, T o12,
                                          const EvpParams<T>& P,
                                          T& n11, T& n22, T& n12)
{
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
  n12 = (o12 + (pc / P.ecc2) * shearing * T(0.5)) / P.denom;
  n11 = T(0.5) * (stress1 + stress2);
  n22 = T(0.5) * (stress1 - stress2);
}

// Ocean drag and the 2x2 momentum solve of one vertex whose velocity is
// solved (the arithmetic of dynamics/momentum.py::momentum_update): du, dv
// the stress-divergence sums, uu, vv the vertex's velocity; returns the new
// velocity in u_new, v_new.
template <typename T>
__device__ __forceinline__ void evp_momentum(T du, T dv, T denom, T uu, T vv,
                                             T uo, T vo, T mass_v, T mass_f,
                                             T rhs_u0, T rhs_v0, T ocn_u, T ocn_v,
                                             T area, const EvpParams<T>& P,
                                             T& u_new, T& v_new)
{
  const T div_u = -du / denom;
  const T div_v = -dv / denom;
  const T dux = uo - uu, dvy = vo - vv;
  const T oc = P.drag * area * t_sqrt<T>(dux * dux + dvy * dvy);
  const T sgn = mass_f < T(0) ? T(-1) : T(1);          // sign(0) -> +1
  const T a11 = mass_v / P.dte + oc * P.cosw;
  const T a12 = -mass_f - oc * P.sinw * sgn;
  const T a21 = mass_f + oc * P.sinw * sgn;
  const T rhs1 = div_u + rhs_u0 + oc * ocn_u + mass_v * uu / P.dte;
  const T rhs2 = div_v + rhs_v0 + oc * ocn_v + mass_v * vv / P.dte;
  T det = a11 * a11 - a12 * a21;
  if (det == T(0)) det = T(1);
  u_new = (a11 * rhs1 - a12 * rhs2) / det;
  v_new = (a11 * rhs2 - a21 * rhs1) / det;
}

// Dev builds only (nvcc -DEVP_PHASE_TIMER, dev/k1_k4_time.py): the SM
// cycles of each phase of a whole-loop kernel, summed per block into
// evp_phase_cycles[block][phase] by the block's thread 0 behind a block
// barrier; evp_phase_cycles_read copies them to the host (and zeroes them).
// Without the macro, mark() is nothing.
#ifdef EVP_PHASE_TIMER
__device__ long long evp_phase_cycles[2048 * 4];
struct DevPhaseTimer {
  long long last = 0;
  __device__ __forceinline__ void mark(int p) {
    __syncthreads();
    if (threadIdx.x != 0) return;
    const long long now = clock64();
    if (p >= 0) evp_phase_cycles[blockIdx.x * 4 + p] += now - last;
    last = now;
  }
};
#else
struct DevPhaseTimer {
  __device__ __forceinline__ void mark(int) {}
};
#endif

// Corner slot k of the cell at padded position (p; a, b) is the vertex at
// (a + da, b + db) of plane t (mesh/panels.py CORNER_OFFSETS moved to the
// padded lattice), flat offset da*(N+1) + db from the cell's column:
//   s0: (0,+1) t=0   s1: (-1,+1) t=0   s2: (0,0) t=0
//   s3: (-1,+1) t=1  s4: (0,0) t=1     s5: (-1,0) t=1
__device__ __forceinline__ void corner_offset(int k, int& da, int& db, int& t)
{
  da = (k == 1 || k == 3 || k == 5) ? -1 : 0;
  db = (k == 0 || k == 1 || k == 3) ? 1 : 0;
  t = k < 3 ? 0 : 1;
}

// Flat position in the [2, npp] planes of corner k of the cell at column q =
// (p; a, b), or -1 for "zero".  A real cell (a in 1..N, b in 0..N-1) has all
// six corners inside its own panel's padded block.  Two of its positions can
// be seam ghosts: the a = N row, else the b = 0 column; with the two ghost
// maps given they are read from the real position the maps name (-1: zero),
// so the planes' own ghost entries are never read and need no refresh;
// without maps (nullptr) the planes are read as they are, ghosts filled by
// the caller.  A pad column (a = 0 or b = N) carries a zero basis, so what
// it reads does not matter; it gets zero where its corner falls outside
// the panel's block.
__device__ __forceinline__ int corner_position(int k, int q, int p, int a, int b,
                                               int N, int npp,
                                               const int* __restrict__ row_pos,   // [2, 10, N+1]
                                               const int* __restrict__ col_pos)   // [2, 10, N]
{
  int da, db, t;
  corner_offset(k, da, db, t);
  const int R = N + 1;
  const int ak = a + da, bk = b + db;
  if (ak < 0 || bk > N) return -1;
  if (row_pos != nullptr) {
    if (ak == N) return row_pos[(t * 10 + p) * R + bk];
    if (bk == 0) return col_pos[(t * 10 + p) * N + ak];
  }
  return t * npp + q + da * R + db;
}

// ---- the arithmetic of the cell side of one subcycle ----
// panel_cell_math: Wachspress strain (+ tan(lat)/r metric) from a column's
// six corner values, EVP stress relaxation where ss (the stresses updated
// in place in the caller's registers), divergence partials pu, pv (mu, mv
// with metric) per dual slot.  The whole-loop route (evp_panel_fused.cu)
// keeps a column's stresses in registers or shared memory across subcycles
// and its basis in shared memory where it fits, so the basis comes as three
// base pointers and one stride: basis value k of the column is
// bg[k * stride] (k = (b*2 + d)*6 + g), bi[k * stride] (k = (s*2 + d)*6 + j)
// and bm[k * stride] (k = s*6 + j); kStream loads it with `basis_load`'s
// evict-first hint.  The per-subcycle route (evp_panel_cell.cu) spreads a
// column over six threads and sums in the same order.

// A basis value: a plain load, or (kStream: a value read from device
// memory every subcycle) one the L2 evicts first, so that it does not push
// out what the loop reads again soon.
template <bool kStream, typename T>
__device__ __forceinline__ T basis_load(const T* p)
{
  if constexpr (kStream) return __ldcs(p);
  else return *p;
}

template <typename T, bool kStream = false>
__device__ __forceinline__ void panel_cell_math(
    const T uc[6], const T vc[6], const T tl[6], int metric,
    const T* bg, const T* bi, const T* bm, int stride,
    T press, bool ss,
    T s11[6], T s22[6], T s12[6],          // in: old stresses; out: new
    T pu[6], T pv[6], T mu[6], T mv[6],    // out: partials per dual slot
    const EvpParams<T>& P)
{
  // strain at corner g: e[g] = sum_b vel[b] * grad[b, d, g]
  T e11[6], e22[6], eA[6], eB[6];
#pragma unroll
  for (int g = 0; g < 6; ++g) { e11[g] = T(0); e22[g] = T(0); eA[g] = T(0); eB[g] = T(0); }
#pragma unroll
  for (int b = 0; b < 6; ++b) {
#pragma unroll
    for (int g = 0; g < 6; ++g) {
      const T gx = basis_load<kStream>(bg + ((b * 2 + 0) * 6 + g) * stride);
      const T gy = basis_load<kStream>(bg + ((b * 2 + 1) * 6 + g) * stride);
      e11[g] += uc[b] * gx;
      e22[g] += vc[b] * gy;
      eA[g] += uc[b] * gy;
      eB[g] += vc[b] * gx;
    }
  }

#pragma unroll
  for (int g = 0; g < 6; ++g) {
    T x11 = e11[g], x22 = e22[g], x12 = T(0.5) * (eA[g] + eB[g]);
    if (metric) {
      x11 = x11 - vc[g] * tl[g];
      x12 = x12 + T(0.5) * uc[g] * tl[g];
    }
    T n11, n22, n12;
    evp_relax<T>(x11, x22, x12, press, s11[g], s22[g], s12[g], P, n11, n22, n12);
    if (ss) { s11[g] = n11; s22[g] = n22; s12[g] = n12; }
  }

  // divergence partials per dual slot j
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    T a = T(0), b2 = T(0), c2 = T(0), d2 = T(0), m1 = T(0), m2 = T(0);
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      const T bu = basis_load<kStream>(bi + ((s * 2 + 0) * 6 + j) * stride);
      const T bv = basis_load<kStream>(bi + ((s * 2 + 1) * 6 + j) * stride);
      a += s11[s] * bu;
      b2 += s12[s] * bv;
      c2 += s22[s] * bv;
      d2 += s12[s] * bu;
      if (metric) {
        const T w = basis_load<kStream>(bm + (s * 6 + j) * stride);
        m1 += s12[s] * w;
        m2 += s11[s] * w;
      }
    }
    pu[j] = a + b2;
    pv[j] = c2 + d2;
    mu[j] = m1;
    mv[j] = m2;
  }
}

}  // namespace

#ifdef EVP_PHASE_TIMER
extern "C" int evp_phase_cycles_read(long long* host, int n, int zero)
{
  cudaError_t e = cudaMemcpyFromSymbol(host, evp_phase_cycles, n * sizeof(long long));
  if (e != cudaSuccess || !zero) return (int)e;
  static long long z[2048 * 4] = {0};
  return (int)cudaMemcpyToSymbol(evp_phase_cycles, z, sizeof z);
}
#endif
