// EVP elastic-subcycle loop on the panel-reordered icosahedral sphere, for
// Hopper: ONE persistent, cooperative launch per solve.
//
// Replaces the TPU kernel of seaice_tpu/dynamics/pallas_panel_fused.py
// (build_fused_panel_solver): all n_sub subcycles of
//   corner reads at static offsets -> Wachspress strain (+ tan(lat)/r metric)
//   -> EVP stress relaxation -> stress-divergence partials
//   -> dual sum at static offsets, seam ghosts included
//   -> 12 exception cells (2 poles, 10 pentagons) on a ring-indexed side path
//   -> ocean drag -> 2x2 momentum solve.
// The TPU kernel is one sequential program that holds the basis and the
// whole state in its fast memory for the loop.  Here that becomes a grid of
// co-resident blocks (one per SM on an H100: the occupancy query at the
// shared-memory budget, times the SM count), each owning for the whole loop
//   * a fixed run of real cell columns: their 18 stresses, pressure, stress
//     mask, six corner positions and six tan(lat)/r corner values in
//     registers, their basis (180 values a column in f32 with metric) in
//     dynamic shared memory as far as the opt-in budget goes (232,448 B:
//     all 311 columns a block owns at N = 64 in f32; the rest, and the f64
//     case, read it from global memory);
//   * fixed vertex positions: the twelve vertex invariants, u, v and the
//     three dual-sum positions in registers (two per thread at N = 64);
//   * in the last block, 72 threads (exception cell e, ring slot j) for the
//     12 exception cells.
// Inside, per subcycle: cell phase -> grid barrier -> vertex phase -> grid
// barrier (cooperative_groups::this_grid().sync()).  Only u, v (the vertex
// planes), the partials [4, 6, npc], the exception cells' stresses (double
// buffered) and their 72 divergence contributions go through global memory
// (L2) between phases.  A prologue gathers the caller's real-order inputs
// through cell_pad_idx, ring_of_slot and k_real_pos, an epilogue scatters
// the results back through slot_of_ring_a: the wrapper does no layout work.
//
// No ghost is ever stored.  A reader whose static offset lands on a seam
// position (corner reads: the a = N row or b = 0 column of a panel; dual
// reads: the a = 0 row or b = N column) looks the real position up in a
// small edge table (10 panels x (N+1) entries per plane or slot), once, in
// the prologue.  An exception thread computes all six corner stresses of its
// cell (six threads, the same values), keeps the one of its slot, and
// writes its divergence contribution; the vertex owner sums its fixed list
// of contributions in list order.  No phase writes what another thread of
// the same phase reads, nothing is accumulated with atomics, and a run
// repeats bitwise.  Data written during the launch is read with plain
// loads after a grid barrier (never through the read-only path).
//
// What bounds it: the inputs read once take ~0.01 ms and the ~1,100 flops
// per cell and subcycle ~0.08 ms at the f32 peak; what the design cannot
// remove is 2 * n_sub + 1 grid barriers and, per subcycle, the partials
// (24 values a column) and u, v through L2.  Measured on an H100 80GB
// HBM3 at 700 W (chip_smoke.py): a co-resident grid of 132 blocks x 320
// threads; 168 registers a thread, the most that 10 warps on the SM's 4
// sub-partitions allow (a few hundred bytes of spills in f32, 1.3 KB in
// f64); 223,920 B of dynamic shared memory a block in f32 (the basis of
// all its 311 columns), 231,840 B in f64 (161 columns).  A subcycle takes
// ~17.5 us: ~60% the blocks' cell work (latency-bound at 10 warps per SM),
// ~1.5 us each bare grid barrier, the rest waiting for the slowest block.

#include <algorithm>

#include <cooperative_groups.h>

#include "evp_panel_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kExc = 12;                 // exception cells
constexpr int kMe = 6;                   // ring size (max edges)
constexpr int kExcItems = kExc * kMe;    // (ring slot j, cell e) -> j*12 + e
constexpr int kThreads = 320;            // >= the 311 columns a block owns at N = 64
constexpr int kVertRegs = 2;             // vertex positions a thread holds in registers

// SM cycles per phase for one block, added by its thread 0 to
// timer[blockIdx.x][p] (zeroed by the caller): mark(p, timer) ends phase p
// (-1: starts the first).  Every mark is behind a block barrier, so a
// phase ends when the block's slowest warp does.  Off (no barrier, no
// clock read) when the pointer is null; then only `last` is kept.
struct PhaseTimer {
  long long last = 0;
  __device__ __forceinline__ void mark(int p, long long* timer) {
    if (timer == nullptr) return;
    __syncthreads();
    if (threadIdx.x != 0) return;
    const long long now = clock64();
    if (p >= 0) timer[blockIdx.x * 4 + p] += now - last;
    last = now;
  }
};

template <typename T>
struct LoopArgs {
  int N, npp, npc, nc, nv, metric, n_sub, n_tgt, tgt_k;
  int ncol;        // real panel cells (columns) = 10 N^2; the poles are exceptions
  int cpb;         // columns per block
  int n_smem;      // columns per block whose basis is in shared memory
  // inputs, real order
  const T* __restrict__ u_in;
  const T* __restrict__ v_in;
  const T* __restrict__ s_in[3];          // [6, nc] ring-indexed each
  const T* __restrict__ pressure;         // [nc]
  const T* __restrict__ solve_stress;     // [nc]
  const T* __restrict__ inv[12];          // [nv] each: uo, vo, mass, mass*f,
                                          // rhs_u0, rhs_v0, ocean_u, ocean_v,
                                          // solve_velocity, area, denominator,
                                          // tan(lat)/r
  // panel tables
  const T* __restrict__ bgrad;            // [6(b), 2, 6(g), npc]
  const T* __restrict__ bint;             // [6(s), 2, 6(j), npc]
  const T* __restrict__ bmet;             // [6(s), 6(j), npc]
  const T* __restrict__ slot_used;        // [6, npc]
  const long long* __restrict__ cell_pad;       // [nc] real cell -> column
  const long long* __restrict__ ring_of_slot;   // [6, nc]
  const long long* __restrict__ slot_of_ring;   // [6, nc]
  const long long* __restrict__ real_pos;       // [nv] -> flat into [2, npp]
  const long long* __restrict__ exc_real;       // [12] real cell ids
  const int* __restrict__ row_pos;        // [2, 10, N+1] corner seam reads
  const int* __restrict__ col_pos;        // [2, 10, N]
  const int* __restrict__ row_src;        // [6, 10, N+1] dual seam reads
  const int* __restrict__ col_src;        // [6, 10, N+1]
  const int* __restrict__ exc_vpos;       // [6, 12] ring vertices, into [2, npp]
  const int* __restrict__ tgt_pos;        // [n_tgt] into [2, npp]
  const int* __restrict__ tgt_items;      // [n_tgt, tgt_k] j*12 + e, or -1
  const T* __restrict__ exc_mask;         // [6, 12]
  const T* __restrict__ ebg;              // [6(b), 2, 6(g), 12]
  const T* __restrict__ ebi;              // [6(s), 2, 6(j), 12]
  const T* __restrict__ ebm;              // [6(s), 6(j), 12]
  // scratch, written and read during the launch: plain pointers, plain loads
  T* planes;       // [3 (u, v, tan(lat)/r), 2, npp]; only real positions used
  T* part;         // [4, 6, npc]; zero at every column no thread writes
  T* exc_s;        // [2 (parity), 3, 6(g), 12] exception cells' stresses
  T* exc_c;        // [2 (u, v), 72] their divergence contributions
  // outputs, real order
  T* uv_out;       // [2, nv]
  T* s_out;        // [3, 6, nc]; also the stress store of overflow columns
  long long* timer;  // [grid, 4] phase cycles (PhaseTimer), or null
  EvpParams<T> P;
};

// A column a thread owns for the whole loop.
template <typename T>
struct Column {
  T s11[6], s22[6], s12[6];
  T tl[6];            // tan(lat)/r at the corners (metric)
  T press;
  int at[6];          // corner positions in [2, npp], -1 = zero
  int q;              // padded column, -1 = none or an exception cell
  int c;              // real cell
  bool ss;
};

// A vertex a thread owns for the whole loop.
template <typename T>
struct Vertex {
  T inv[12];
  T u, v;
  int pos;            // position in [2, npp], -1 = none
  int at[3];          // dual-sum positions into [6, npc] (slot included)
  int tgt;            // row of the exception target list, or -1
  int id;             // real vertex
};

template <typename T>
__device__ __forceinline__ T pick6(const T x[6], long long k)
{
  T r = x[0];
#pragma unroll
  for (int s = 1; s < 6; ++s) if (k == s) r = x[s];
  return r;
}

// Column c's fixed data and its stresses, ring -> slot.  Exception cells
// (the 10 pentagons among the panel cells) get q = -1: the exception
// threads carry them.  `from` is the caller's stresses or, for an overflow
// column, s_out.
template <typename T>
__device__ __forceinline__ void load_column(Column<T>& col, int c, const LoopArgs<T>& A,
                            const T* const from[3])
{
  col.c = c;
  col.q = -1;
  if (c < 0) return;
  for (int e = 0; e < kExc; ++e) if (A.exc_real[e] == c) return;
  const int q = (int)A.cell_pad[c];
  col.q = q;
  const int R = A.N + 1;
  const int b = q % R, pa = q / R, a = pa % R, p = pa / R;
#pragma unroll
  for (int k = 0; k < 6; ++k)
    col.at[k] = corner_position(k, q, p, a, b, A.N, A.npp, A.row_pos, A.col_pos);
  col.press = A.pressure[c];
  col.ss = A.solve_stress[c] > T(0);
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const long long r = A.ring_of_slot[(size_t)s * A.nc + c];
    const T used = A.slot_used[(size_t)s * A.npc + q];
    col.s11[s] = from[0][r * A.nc + c] * used;
    col.s22[s] = from[1][r * A.nc + c] * used;
    col.s12[s] = from[2][r * A.nc + c] * used;
  }
}

template <typename T>
__device__ __forceinline__ void load_corner_tl(Column<T>& col, const LoopArgs<T>& A)
{
  const T* pl_t = A.planes + (size_t)4 * A.npp;
#pragma unroll
  for (int k = 0; k < 6; ++k)
    col.tl[k] = (A.metric && col.at[k] >= 0) ? pl_t[col.at[k]] : T(0);
}

// Stresses slot -> ring into s_out (the epilogue, and an overflow column's
// store after each subcycle).
template <typename T>
__device__ __forceinline__ void store_column(const Column<T>& col, const LoopArgs<T>& A)
{
  if (col.q < 0) return;
  const size_t nc = A.nc;
  for (int r = 0; r < 6; ++r) {
    const long long s = A.slot_of_ring[r * nc + col.c];
    A.s_out[(0 * 6 + r) * nc + col.c] = pick6(col.s11, s);
    A.s_out[(1 * 6 + r) * nc + col.c] = pick6(col.s22, s);
    A.s_out[(2 * 6 + r) * nc + col.c] = pick6(col.s12, s);
  }
}

// Cell phase of one column; basis value k at bg[k * stride] etc.
template <typename T>
__device__ __forceinline__ void column_step(Column<T>& col, const LoopArgs<T>& A,
                                            const T* bg, const T* bi, const T* bm,
                                            int stride)
{
  const T* pl_u = A.planes;
  const T* pl_v = A.planes + (size_t)2 * A.npp;
  T uc[6], vc[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    uc[k] = col.at[k] >= 0 ? pl_u[col.at[k]] : T(0);
    vc[k] = col.at[k] >= 0 ? pl_v[col.at[k]] : T(0);
  }
  T pu[6], pv[6], mu[6], mv[6];
  panel_cell_math<T>(uc, vc, col.tl, A.metric, bg, bi, bm, stride, col.press, col.ss,
                     col.s11, col.s22, col.s12, pu, pv, mu, mv, A.P);
  const size_t n = A.npc;
  const int q = col.q;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    A.part[(0 * 6 + j) * n + q] = pu[j];
    A.part[(1 * 6 + j) * n + q] = pv[j];
    if (A.metric) {
      A.part[(2 * 6 + j) * n + q] = mu[j];
      A.part[(3 * 6 + j) * n + q] = mv[j];
    }
  }
}

// Vertex `id`'s fixed data; u, v from the caller (prologue) or from the
// planes (an overflow vertex, every subcycle).
template <typename T>
__device__ __forceinline__ void load_vertex(Vertex<T>& vx, int id, const LoopArgs<T>& A, bool from_planes)
{
  vx.id = id;
  vx.pos = -1;
  if (id < 0) return;
  const int pos = (int)A.real_pos[id];
  vx.pos = pos;
#pragma unroll
  for (int k = 0; k < 12; ++k) vx.inv[k] = A.inv[k][id];
  if (from_planes) {
    vx.u = A.planes[pos];
    vx.v = A.planes[(size_t)2 * A.npp + pos];
  } else {
    vx.u = A.u_in[id];
    vx.v = A.v_in[id];
  }
  // Vertex (t; a, b) sums pu[slot] at (a + da, b + db) (variational_panel.py
  // DUAL_OFFSETS moved to the padded lattice):
  //   t=0: s0:(0,-1)  s1:(+1,-1)  s2:(0,0)    t=1: s3:(+1,-1)  s4:(0,0)  s5:(+1,0)
  // A seam-ghost position (the a = 0 row, else the b = N column) is read from
  // the source the edge tables name (an index into [6, npc]; entries that
  // name the position itself point at a pad column, which stays zero).
  const int N = A.N, R = N + 1;
  const int t = pos >= A.npp ? 1 : 0;
  const int q = pos - t * A.npp;
  const int b = q % R, pa = q / R, a = pa % R, p = pa / R;
  const int da[3] = {t ? 1 : 0, t ? 0 : 1, t ? 1 : 0};
  const int db[3] = {-1, t ? 0 : -1, 0};
  const int sl[3] = {t ? 3 : 0, t ? 4 : 1, t ? 5 : 2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int ak = a + da[k], bk = b + db[k];
    int at = sl[k] * A.npc + q + da[k] * R + db[k];
    if (ak == 0) at = A.row_src[(sl[k] * 10 + p) * R + bk];
    else if (bk == N) at = A.col_src[(sl[k] * 10 + p) * R + ak];
    vx.at[k] = at;
  }
  vx.tgt = -1;
  for (int k = 0; k < A.n_tgt; ++k) if (A.tgt_pos[k] == pos) vx.tgt = k;
}

template <typename T>
__device__ __forceinline__ void write_planes(const Vertex<T>& vx, const LoopArgs<T>& A)
{
  A.planes[vx.pos] = vx.u;
  A.planes[(size_t)2 * A.npp + vx.pos] = vx.v;
}

// Vertex phase: dual sum, metric, exception share, drag, 2x2 solve.
template <typename T>
__device__ __forceinline__ void vertex_step(Vertex<T>& vx, const LoopArgs<T>& A)
{
  const T* x = vx.inv;
  // uo vo mass_v mass_f rhs_u0 rhs_v0 ocn_u ocn_v solve_velocity area denom tanlat
  if (!(x[8] > T(0))) return;            // u, v keep their values
  T g[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    if (f >= 2 && !A.metric) break;
    const T* pf = A.part + (size_t)f * 6 * A.npc;
    T tot = pf[vx.at[0]];
    tot = tot + pf[vx.at[1]];
    tot = tot + pf[vx.at[2]];
    g[f] = tot;
  }
  T du, dv;
  if (A.metric) {
    du = -(g[0] + g[2] * x[11]);
    dv = -g[1] + g[3] * x[11];
  } else {
    du = -g[0];
    dv = -g[1];
  }
  if (vx.tgt >= 0) {                     // exception cells' share, in list order
    T su = T(0), sv = T(0);
    for (int m = 0; m < A.tgt_k; ++m) {
      const int it = A.tgt_items[vx.tgt * A.tgt_k + m];
      if (it >= 0) { su += A.exc_c[it]; sv += A.exc_c[kExcItems + it]; }
    }
    du = du - su;
    dv = dv - sv;
  }
  const EvpParams<T>& P = A.P;
  const T div_u = du / x[10];
  const T div_v = dv / x[10];
  const T uu = vx.u, vv = vx.v;
  const T dux = x[0] - uu, dvy = x[1] - vv;
  const T oc = P.drag * x[9] * t_sqrt<T>(dux * dux + dvy * dvy);
  const T mf = x[3];
  const T sgn = mf < T(0) ? T(-1) : T(1);            // sign(0) -> +1
  const T mv = x[2];
  const T a11 = mv / P.dte + oc * P.cosw;
  const T a12 = -mf - oc * P.sinw * sgn;
  const T a21 = mf + oc * P.sinw * sgn;
  const T rhs1 = div_u + x[4] + oc * x[6] + mv * uu / P.dte;
  const T rhs2 = div_v + x[5] + oc * x[7] + mv * vv / P.dte;
  T det = a11 * a11 - a12 * a21;
  if (det == T(0)) det = T(1);
  vx.u = (a11 * rhs1 - a12 * rhs2) / det;
  vx.v = (a11 * rhs2 - a21 * rhs1) / det;
  write_planes(vx, A);
}

// One exception item (ring slot j, cell e) for subcycle k: all six corner
// stresses of cell e from the parity-k buffer, the one of slot j into the
// other buffer, and cell e's divergence contribution to its ring vertex j.
template <typename T>
__device__ __forceinline__ void exception_step(int x, int k, const LoopArgs<T>& A)
{
  const int e = x % kExc, j = x / kExc;
  constexpr int S = kMe * kExc;
  const T* s_old = A.exc_s + (size_t)(k & 1) * 3 * S;
  T* s_new = A.exc_s + (size_t)((k + 1) & 1) * 3 * S;
  const T* pl_u = A.planes;
  const T* pl_v = A.planes + (size_t)2 * A.npp;
  const T* pl_t = A.planes + (size_t)4 * A.npp;
  const int metric = A.metric;
  T ue[kMe], ve[kMe], tle[kMe], mk[kMe];
#pragma unroll
  for (int b = 0; b < kMe; ++b) {
    const int at = A.exc_vpos[b * kExc + e];
    mk[b] = A.exc_mask[b * kExc + e];
    ue[b] = pl_u[at] * mk[b];
    ve[b] = pl_v[at] * mk[b];
    tle[b] = metric ? pl_t[at] * mk[b] : T(0);
  }
  const long long c = A.exc_real[e];
  const T press = A.pressure[c];
  const bool ss = A.solve_stress[c] > T(0);
  T r11[kMe], r22[kMe], r12[kMe];
#pragma unroll
  for (int g = 0; g < kMe; ++g) {
    T x11 = T(0), x22 = T(0), xa = T(0), xb = T(0);
#pragma unroll
    for (int b = 0; b < kMe; ++b) {
      const T gx = A.ebg[((b * 2 + 0) * kMe + g) * kExc + e];
      const T gy = A.ebg[((b * 2 + 1) * kMe + g) * kExc + e];
      x11 += ue[b] * gx;
      x22 += ve[b] * gy;
      xa += ue[b] * gy;
      xb += ve[b] * gx;
    }
    T x12 = T(0.5) * (xa + xb);
    if (metric) {
      x11 = x11 - ve[g] * tle[g];
      x12 = x12 + T(0.5) * ue[g] * tle[g];
    }
    const T o11 = s_old[g * kExc + e], o22 = s_old[S + g * kExc + e];
    const T o12 = s_old[2 * S + g * kExc + e];
    T n11, n22, n12;
    evp_relax<T>(x11, x22, x12, press, o11, o22, o12, A.P, n11, n22, n12);
    r11[g] = ss ? n11 : o11;
    r22[g] = ss ? n22 : o22;
    r12[g] = ss ? n12 : o12;
  }
  s_new[x] = pick6(r11, j);
  s_new[S + x] = pick6(r22, j);
  s_new[2 * S + x] = pick6(r12, j);
  T a = T(0), b2 = T(0), c2 = T(0), d2 = T(0), mu = T(0), mv = T(0);
#pragma unroll
  for (int s = 0; s < kMe; ++s) {
    const T bu = A.ebi[((s * 2 + 0) * kMe + j) * kExc + e];
    const T bv = A.ebi[((s * 2 + 1) * kMe + j) * kExc + e];
    a += r11[s] * bu;
    b2 += r12[s] * bv;
    c2 += r22[s] * bv;
    d2 += r12[s] * bu;
    if (metric) {
      const T bm = A.ebm[(s * kMe + j) * kExc + e];
      mu += r12[s] * bm;
      mv += r11[s] * bm;
    }
  }
  T cu = a + b2, cv = c2 + d2;
  const T tle_j = pick6(tle, j);
  if (metric) {
    cu = cu + mu * tle_j;
    cv = cv - mv * tle_j;
  }
  const T mk_j = pick6(mk, j);
  A.exc_c[x] = cu * mk_j;
  A.exc_c[kExcItems + x] = cv * mk_j;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) panel_loop_kernel(LoopArgs<T> A)
{
  extern __shared__ __align__(16) unsigned char k3_smem[];
  T* bs = reinterpret_cast<T*>(k3_smem);   // [nk][n_smem] basis of the block's columns
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  const int gtid = blockIdx.x * kThreads + tid;
  const int c0 = blockIdx.x * A.cpb;                        // first column of the block
  const int ncb = max(0, min(A.cpb, A.ncol - c0));          // columns of the block
  const int ns = A.n_smem;
  const int nk = A.metric ? 180 : 144;
  const int exc_x = (blockIdx.x == gridDim.x - 1) ? tid - (kThreads - kExcItems) : -1;
  const int half = A.nv / 2;    // visit the even vertex ids (plane t = 0), then the odd

  // ---- prologue ----
  for (int jl = tid; jl < min(ns, ncb); jl += kThreads) {
    const long long q = A.cell_pad[c0 + jl];
    for (int k = 0; k < nk; ++k) {
      const T* src = k < 72 ? A.bgrad + (size_t)k * A.npc
                   : k < 144 ? A.bint + (size_t)(k - 72) * A.npc
                   : A.bmet + (size_t)(k - 144) * A.npc;
      bs[k * ns + jl] = src[q];
    }
  }
  const T* const s_in[3] = {A.s_in[0], A.s_in[1], A.s_in[2]};
  const T* const s_out[3] = {A.s_out, A.s_out + (size_t)6 * A.nc,
                             A.s_out + (size_t)12 * A.nc};
  Column<T> col;
  load_column(col, tid < ncb ? c0 + tid : -1, A, s_in);
  for (int jl = tid + kThreads; jl < ncb; jl += kThreads) {   // overflow columns
    Column<T> o;
    load_column(o, c0 + jl, A, s_in);
    store_column(o, A);
  }
  Vertex<T> vx[kVertRegs];
#pragma unroll
  for (int m = 0; m < kVertRegs; ++m) {
    const int i = gtid + m * nthreads;
    load_vertex(vx[m], i < A.nv ? 2 * (i % half) + i / half : -1, A, false);
  }
  for (int i = gtid; i < A.nv; i += nthreads) {   // every owned vertex: the planes
    const int id = 2 * (i % half) + i / half;
    const int pos = (int)A.real_pos[id];
    A.planes[pos] = A.u_in[id];
    A.planes[(size_t)2 * A.npp + pos] = A.v_in[id];
    A.planes[(size_t)4 * A.npp + pos] = A.inv[11][id];
  }
  if (exc_x >= 0) {
    const int e = exc_x % kExc, j = exc_x / kExc;
    const long long c = A.exc_real[e];
#pragma unroll
    for (int f = 0; f < 3; ++f)
      A.exc_s[f * kExcItems + exc_x] = s_in[f][(size_t)j * A.nc + c];
  }
  grid.sync();
  if (col.q >= 0) load_corner_tl(col, A);

  const T* bg_s = bs + tid;
  const T* bi_s = bs + 72 * ns + tid;
  const T* bm_s = bs + 144 * ns + tid;
  // optional phase timer (A.timer non-null): thread 0 of each block sums
  // the SM cycles of its block's cell work, its wait at the first barrier,
  // its vertex work and its wait at the second, each behind a block barrier
  PhaseTimer timer;
  for (int k = 0; k < A.n_sub; ++k) {
    timer.mark(-1, A.timer);
    // ---- cell phase ----
    if (exc_x >= 0) exception_step(exc_x, k, A);
    if (col.q >= 0) {
      if (tid < ns) column_step(col, A, bg_s, bi_s, bm_s, ns);
      else column_step(col, A, A.bgrad + col.q, A.bint + col.q, A.bmet + col.q, A.npc);
    }
    for (int jl = tid + kThreads; jl < ncb; jl += kThreads) {
      Column<T> o;
      load_column(o, c0 + jl, A, s_out);
      if (o.q < 0) continue;
      load_corner_tl(o, A);
      if (jl < ns)
        column_step(o, A, bs + jl, bs + 72 * ns + jl, bs + 144 * ns + jl, ns);
      else
        column_step(o, A, A.bgrad + o.q, A.bint + o.q, A.bmet + o.q, A.npc);
      store_column(o, A);
    }
    timer.mark(0, A.timer);
    grid.sync();
    timer.mark(1, A.timer);
    // ---- vertex phase ----
#pragma unroll
    for (int m = 0; m < kVertRegs; ++m)
      if (vx[m].pos >= 0) vertex_step(vx[m], A);
    for (int i = gtid + kVertRegs * nthreads; i < A.nv; i += nthreads) {
      Vertex<T> o;
      load_vertex(o, 2 * (i % half) + i / half, A, true);
      vertex_step(o, A);
    }
    timer.mark(2, A.timer);
    grid.sync();
    timer.mark(3, A.timer);
  }

  // ---- epilogue ----
  store_column(col, A);
#pragma unroll
  for (int m = 0; m < kVertRegs; ++m)
    if (vx[m].pos >= 0) {
      A.uv_out[vx[m].id] = vx[m].u;
      A.uv_out[(size_t)A.nv + vx[m].id] = vx[m].v;
    }
  for (int i = gtid + kVertRegs * nthreads; i < A.nv; i += nthreads) {
    const int id = 2 * (i % half) + i / half;
    const int pos = (int)A.real_pos[id];
    A.uv_out[id] = A.planes[pos];
    A.uv_out[(size_t)A.nv + id] = A.planes[(size_t)2 * A.npp + pos];
  }
  if (exc_x >= 0) {
    const int e = exc_x % kExc, j = exc_x / kExc;
    const long long c = A.exc_real[e];
    const T* s_fin = A.exc_s + (size_t)(A.n_sub & 1) * 3 * kExcItems;
#pragma unroll
    for (int f = 0; f < 3; ++f)
      A.s_out[((size_t)f * 6 + j) * A.nc + c] = s_fin[f * kExcItems + exc_x];
  }
}

// Sizes the grid and the shared-memory basis, then launches.  info[0..5]:
// launches, grid, threads per block, dynamic shared memory bytes per block,
// columns per block, columns per block with the basis in shared memory.
template <typename T>
int run_loop(const int* ints, const void* const* ptrs, const double* reals,
             void* stream_v, int* info)
{
  LoopArgs<T> A;
  A.N = ints[0];
  A.n_sub = ints[1];
  A.metric = ints[2];
  A.n_tgt = ints[3];
  A.tgt_k = ints[4];
  const int R = A.N + 1;
  A.npp = 10 * R * R;
  A.npc = A.npp + 2;
  A.ncol = 10 * A.N * A.N;
  A.nc = A.ncol + 2;
  A.nv = 20 * A.N * A.N;
  info[0] = 0;
  if (A.N < 1 || A.n_sub < 0 || (A.n_tgt > 0 && A.tgt_k <= 0))
    return (int)cudaErrorInvalidValue;
  int i = 0;
  A.u_in = (const T*)ptrs[i++];
  A.v_in = (const T*)ptrs[i++];
  for (int f = 0; f < 3; ++f) A.s_in[f] = (const T*)ptrs[i++];
  A.pressure = (const T*)ptrs[i++];
  A.solve_stress = (const T*)ptrs[i++];
  for (int k = 0; k < 12; ++k) A.inv[k] = (const T*)ptrs[i++];
  A.bgrad = (const T*)ptrs[i++];
  A.bint = (const T*)ptrs[i++];
  A.bmet = (const T*)ptrs[i++];
  A.slot_used = (const T*)ptrs[i++];
  A.cell_pad = (const long long*)ptrs[i++];
  A.ring_of_slot = (const long long*)ptrs[i++];
  A.slot_of_ring = (const long long*)ptrs[i++];
  A.real_pos = (const long long*)ptrs[i++];
  A.exc_real = (const long long*)ptrs[i++];
  A.row_pos = (const int*)ptrs[i++];
  A.col_pos = (const int*)ptrs[i++];
  A.row_src = (const int*)ptrs[i++];
  A.col_src = (const int*)ptrs[i++];
  A.exc_vpos = (const int*)ptrs[i++];
  A.tgt_pos = (const int*)ptrs[i++];
  A.tgt_items = (const int*)ptrs[i++];
  A.exc_mask = (const T*)ptrs[i++];
  A.ebg = (const T*)ptrs[i++];
  A.ebi = (const T*)ptrs[i++];
  A.ebm = (const T*)ptrs[i++];
  A.planes = (T*)ptrs[i++];
  A.part = (T*)ptrs[i++];
  A.exc_s = (T*)ptrs[i++];
  A.exc_c = (T*)ptrs[i++];
  A.uv_out = (T*)ptrs[i++];
  A.s_out = (T*)ptrs[i++];
  A.timer = (long long*)ptrs[i++];
  A.P = make_params<T>(reals[0], reals[1], reals[2], reals[3], reals[4], reals[5],
                       reals[6]);

  cudaError_t err;
  int dev = 0, sms = 0, budget = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  auto kernel = panel_loop_kernel<T>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  budget)) != cudaSuccess)
    return (int)err;
  // blocks per SM at the whole budget (one on an H100): the grid is what is
  // co-resident, cut to a warp's worth of columns per block on small meshes
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           (size_t)budget)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = std::min(per_sm * sms, std::max(1, (A.ncol + 31) / 32));
  A.cpb = (A.ncol + grid - 1) / grid;
  const int per_col = (A.metric ? 180 : 144) * (int)sizeof(T);
  A.n_smem = std::min(A.cpb, budget / per_col);
  const size_t smem = (size_t)A.n_smem * per_col;
  info[1] = grid;
  info[2] = kThreads;
  info[3] = (int)smem;
  info[4] = A.cpb;
  info[5] = A.n_smem;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream_v;
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

// ints: N, n_sub, metric, n_tgt, tgt_k.  ptrs: the 46 pointers in the order
// of run_loop (cuda_panel_fused.py::_bind builds the list; the last, the
// phase timer, may be null).  reals: dte,
// damping, ecc2, puny, cos w, sin w, drag.  The inputs are not written; the
// scratch needs zeros at the columns no thread writes (the caller zeroes it
// once); uv_out [2, nv] and s_out [3, 6, nc] receive the result.  Returns
// the first CUDA error (0 = none); info as run_loop says.
extern "C" int evp_panel_loop_f32(const int* ints, const void* const* ptrs,
                                  const double* reals, void* stream, int* info)
{
  return run_loop<float>(ints, ptrs, reals, stream, info);
}
extern "C" int evp_panel_loop_f64(const int* ints, const void* const* ptrs,
                                  const double* reals, void* stream, int* info)
{
  return run_loop<double>(ints, ptrs, reals, stream, info);
}
