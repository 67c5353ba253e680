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
// co-resident blocks (one per SM on an H100), each owning a fixed run of
// real cell columns and fixed vertices for the whole loop.  Inside, per
// subcycle: cell phase -> grid barrier -> vertex phase -> grid barrier
// (cooperative_groups::this_grid().sync()).  Only u, v (the vertex planes),
// the partials [4, 6, npc], the exception cells' stresses (double buffered)
// and their 72 divergence contributions go through global memory (L2)
// between phases.
//
// Where the loop state lives follows from the shapes, the SM count and the
// opt-in shared-memory budget (`plan_loop`), in one of two placements:
//   * registers (a block's columns and vertices fit one column and two
//     vertices a thread: N = 64): blocks of 320 threads (168 registers);
//     a thread keeps its column's 18 stresses (slot order), pressure,
//     stress mask, six corner positions and six tan(lat)/r values and its
//     two vertices' invariants and u, v in registers for the whole loop;
//   * tables (N = 128: 1,242 columns and 2,482 vertices a block): blocks of
//     kTableThreads threads (640 in f32, at 96 registers), whose registers
//     hold a column or a vertex only while it is worked on, so that more
//     warps keep loads in flight; every column's fixed data lives in
//     block-local int32 / T tables that the prologue writes once, in the
//     order the threads read them (six corner positions, 2 q + stress
//     mask; pressure, tan(lat)/r at the corners), its stresses in slot
//     order in shared memory as far as it goes and in s_out at its own
//     cell past that; every vertex reads its three dual-sum positions,
//     plane position and exception-target row from a table and its 12
//     invariants from the inputs, whose id order is the threads'.
// Ring <-> slot is done in the prologue and the epilogue only; the loop
// neither recomputes a corner position nor scans a table.  The basis (180
// values a column in f32 with metric) takes the shared memory the
// stresses leave, for the block's first columns: all 311 columns a block
// owns at N = 64 in f32 (223,920 B); the rest is read in place, each value
// by 32 neighbouring columns at once.  (Streamed through shared memory by
// each warp with cp.async instead, it measured slower: the warp issuing
// the copies stalls on them and computes nothing meanwhile.)
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
// What bounds it.  At N = 64 in f32 the ~1,100 flops per cell and subcycle
// (~0.08 ms a call at the f32 peak), 2 * n_sub + 1 grid barriers and, per
// subcycle, the partials (24 values a column) and u, v through L2:
// measured ~15.5 us a subcycle on an H100 80GB HBM3 at 700 W (1.85 to
// 1.86 ms a call of 120).  At N = 128 in f32 the basis streamed from device
// memory every subcycle: 143,644 of the 163,840 columns, 103.4 MB, 31 us
// at 3.35 TB/s against the operations' 2.75 us; measured ~72 us a
// subcycle (8.6 ms a call), the cell phase (~60 us) reading that basis at
// about 1.7 TB/s.  The table placement keeps shared memory to what leaves
// the L1 kL1Keep more than its least, since the loads in flight land there
// (measured: 8% slower with the whole budget); its in-place basis loads
// carry the evict-first hint (`basis_load`, 1.3% faster).

#include <algorithm>

#include <cooperative_groups.h>

#include "evp_panel_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kExc = 12;                 // exception cells
constexpr int kMe = 6;                   // ring size (max edges)
constexpr int kExcItems = kExc * kMe;    // (ring slot j, cell e) -> j*12 + e
constexpr int kRegThreads = 320;         // >= the 311 columns a block owns at N = 64
// the table placement's blocks: as many threads as hold a column's
// arithmetic in registers with few spills (f32: 96 registers; f64, whose
// values take two registers each: 204), measured on an H100 (704 f32
// threads spill and are 21% slower, 384 f64 threads 3%)
template <typename T>
constexpr int kTableThreads = sizeof(T) == 4 ? 640 : 320;
constexpr int kVertRegs = 2;             // vertices a thread holds in registers
constexpr int kL1Keep = 32 * 1024;       // table placement: L1 left beyond its least
constexpr int kStress = 18;              // stresses a column

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
  int n_res;       // columns per block whose basis stays in shared memory
  int n_ss;        // table columns per block whose stresses are in shared memory
  int tables;      // 1: the table placement (else registers)
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
  int* ctab_i;     // tables: [7, grid * cpb] six corner positions,
                   // 2 q + stress mask (-1: none, or an exception cell)
  T* ctab_t;       // tables: [1 + 6 metric, grid * cpb] pressure, tan(lat)/r
  int* vtab;       // tables: [5, nv] three dual-sum positions, plane
                   // position, exception-target row
  // outputs, real order
  T* uv_out;       // [2, nv]
  T* s_out;        // [3, 6, nc]; tables: the stresses past n_ss, slot order
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

// Column c's fixed data and its stresses from the caller's, ring -> slot
// (the prologue).  Exception cells (the 10 pentagons among the panel cells)
// get q = -1: the exception threads carry them.
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

// Stresses slot -> ring into s_out (the epilogue).
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
template <typename T, bool kStream = false>
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
  panel_cell_math<T, kStream>(uc, vc, col.tl, A.metric, bg, bi, bm, stride, col.press, col.ss,
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

// Table column g (= blockIdx.x * cpb + jl, real cell c): its fixed data
// from the tables, its stresses in slot order from shared memory
// (jl < n_ss) or s_out.
template <typename T>
__device__ __forceinline__ T* table_stresses(const LoopArgs<T>& A, T* ss_smem, int jl, int c,
                                             size_t& stride)
{
  if (jl < A.n_ss) {
    stride = A.n_ss;
    return ss_smem + jl;
  }
  stride = A.nc;
  return A.s_out + c;
}

template <typename T>
__device__ __forceinline__ void load_table_column(Column<T>& col, const LoopArgs<T>& A,
                                                  T* ss_smem, int jl, int c)
{
  const size_t n = (size_t)gridDim.x * A.cpb;
  const size_t g = (size_t)blockIdx.x * A.cpb + jl;
  const int qs = A.ctab_i[6 * n + g];
  col.c = c;
  col.q = qs < 0 ? -1 : qs >> 1;
  if (qs < 0) return;
  col.ss = (qs & 1) != 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) col.at[k] = A.ctab_i[k * n + g];
  col.press = A.ctab_t[g];
#pragma unroll
  for (int k = 0; k < 6; ++k) col.tl[k] = A.metric ? A.ctab_t[(1 + k) * n + g] : T(0);
  size_t st;
  const T* p = table_stresses(A, ss_smem, jl, c, st);
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    col.s11[s] = p[(0 * 6 + s) * st];
    col.s22[s] = p[(1 * 6 + s) * st];
    col.s12[s] = p[(2 * 6 + s) * st];
  }
}

template <typename T>
__device__ __forceinline__ void store_table_stresses(const Column<T>& col, const LoopArgs<T>& A,
                                                     T* ss_smem, int jl)
{
  if (col.q < 0) return;
  size_t st;
  T* p = table_stresses(A, ss_smem, jl, col.c, st);
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    p[(0 * 6 + s) * st] = col.s11[s];
    p[(1 * 6 + s) * st] = col.s22[s];
    p[(2 * 6 + s) * st] = col.s12[s];
  }
}

// Vertex `id`'s fixed data and its u, v from the caller (the prologue).
template <typename T>
__device__ __forceinline__ void load_vertex(Vertex<T>& vx, int id, const LoopArgs<T>& A)
{
  vx.id = id;
  vx.pos = -1;
  if (id < 0) return;
  const int pos = (int)A.real_pos[id];
  vx.pos = pos;
#pragma unroll
  for (int k = 0; k < 12; ++k) vx.inv[k] = A.inv[k][id];
  vx.u = A.u_in[id];
  vx.v = A.v_in[id];
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

// Table vertex i: its fixed data from the table the prologue wrote, its
// invariants from the inputs, u, v from the planes.
template <typename T>
__device__ __forceinline__ void load_table_vertex(Vertex<T>& vx, int i, const LoopArgs<T>& A)
{
  const size_t n = A.nv;
  vx.id = i;
#pragma unroll
  for (int k = 0; k < 3; ++k) vx.at[k] = A.vtab[k * n + i];
  vx.pos = A.vtab[3 * n + i];
  vx.tgt = A.vtab[4 * n + i];
#pragma unroll
  for (int k = 0; k < 12; ++k) vx.inv[k] = A.inv[k][i];
  vx.u = A.planes[vx.pos];
  vx.v = A.planes[(size_t)2 * A.npp + vx.pos];
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

template <typename T, int kThreads, bool kTables>
__global__ void __launch_bounds__(kThreads, 1) panel_loop_kernel(LoopArgs<T> A)
{
  extern __shared__ __align__(16) unsigned char k3_smem[];
  const int nk = A.metric ? 180 : 144;
  T* const res = reinterpret_cast<T*>(k3_smem);   // [nk][n_res] the first columns' basis
  T* const ss_smem = res + (size_t)nk * A.n_res;  // [18][n_ss] table columns' stresses
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  const int gtid = blockIdx.x * kThreads + tid;
  const int c0 = blockIdx.x * A.cpb;                        // first column of the block
  const int ncb = max(0, min(A.cpb, A.ncol - c0));          // columns of the block
  const int exc_x = (blockIdx.x == gridDim.x - 1) ? tid - (kThreads - kExcItems) : -1;
  const size_t n_tab = (size_t)gridDim.x * A.cpb;           // table columns, all blocks
  const int half = A.nv / 2;    // register vertices: the even ids (plane t = 0), then odd

  // ---- prologue ----
  for (int jl = tid; jl < min(A.n_res, ncb); jl += kThreads) {
    const long long q = A.cell_pad[c0 + jl];
    for (int k = 0; k < nk; ++k) {
      const T* src = k < 72 ? A.bgrad + (size_t)k * A.npc
                   : k < 144 ? A.bint + (size_t)(k - 72) * A.npc
                   : A.bmet + (size_t)(k - 144) * A.npc;
      res[k * A.n_res + jl] = src[q];
    }
  }
  const T* const s_in[3] = {A.s_in[0], A.s_in[1], A.s_in[2]};
  Column<T> col;
  Vertex<T> vx[kVertRegs];
  if constexpr (!kTables) {
    load_column(col, tid < ncb ? c0 + tid : -1, A, s_in);
#pragma unroll
    for (int r = 0; r < kVertRegs; ++r) {
      const int i = gtid + r * nthreads;
      load_vertex(vx[r], i < A.nv ? 2 * (i % half) + i / half : -1, A);
    }
  } else {
    for (int jl = tid; jl < ncb; jl += kThreads) {
      Column<T> o;
      load_column(o, c0 + jl, A, s_in);
      const size_t g = (size_t)blockIdx.x * A.cpb + jl;
#pragma unroll
      for (int k = 0; k < 6; ++k) A.ctab_i[k * n_tab + g] = o.q >= 0 ? o.at[k] : -1;
      A.ctab_i[6 * n_tab + g] = o.q >= 0 ? 2 * o.q + (o.ss ? 1 : 0) : -1;
      A.ctab_t[g] = o.q >= 0 ? o.press : T(0);
      store_table_stresses(o, A, ss_smem, jl);
    }
    for (int i = gtid; i < A.nv; i += nthreads) {
      Vertex<T> o;
      load_vertex(o, i, A);
#pragma unroll
      for (int k = 0; k < 3; ++k) A.vtab[(size_t)k * A.nv + i] = o.at[k];
      A.vtab[(size_t)3 * A.nv + i] = o.pos;
      A.vtab[(size_t)4 * A.nv + i] = o.tgt;
    }
  }
  for (int i = gtid; i < A.nv; i += nthreads) {   // every vertex: the planes
    const int pos = (int)A.real_pos[i];
    A.planes[pos] = A.u_in[i];
    A.planes[(size_t)2 * A.npp + pos] = A.v_in[i];
    A.planes[(size_t)4 * A.npp + pos] = A.inv[11][i];
  }
  if (exc_x >= 0) {
    const int e = exc_x % kExc, j = exc_x / kExc;
    const long long c = A.exc_real[e];
#pragma unroll
    for (int f = 0; f < 3; ++f)
      A.exc_s[f * kExcItems + exc_x] = s_in[f][(size_t)j * A.nc + c];
  }
  grid.sync();
  if constexpr (!kTables) {
    if (col.q >= 0) load_corner_tl(col, A);
  } else if (A.metric) {                 // the table columns' tan(lat)/r at the corners
    const T* pl_t = A.planes + (size_t)4 * A.npp;
    for (int jl = tid; jl < ncb; jl += kThreads) {
      const size_t g = (size_t)blockIdx.x * A.cpb + jl;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const int at = A.ctab_i[k * n_tab + g];
        A.ctab_t[(1 + k) * n_tab + g] = at >= 0 ? pl_t[at] : T(0);
      }
    }
  }

  // optional phase timer (A.timer non-null): thread 0 of each block sums
  // the SM cycles of its block's cell work, its wait at the first barrier,
  // its vertex work and its wait at the second, each behind a block barrier
  PhaseTimer timer;
  for (int k = 0; k < A.n_sub; ++k) {
    timer.mark(-1, A.timer);
    // ---- cell phase ----
    if (exc_x >= 0) exception_step(exc_x, k, A);
    if constexpr (!kTables) {
      if (col.q >= 0) {
        if (tid < A.n_res)
          column_step(col, A, res + tid, res + 72 * A.n_res + tid, res + 144 * A.n_res + tid,
                      A.n_res);
        else
          column_step(col, A, A.bgrad + col.q, A.bint + col.q, A.bmet + col.q, A.npc);
      }
    } else {
      for (int jl = tid; jl < ncb; jl += kThreads) {
        Column<T> o;
        load_table_column(o, A, ss_smem, jl, c0 + jl);
        if (o.q < 0) continue;
        if (jl < A.n_res)
          column_step(o, A, res + jl, res + 72 * A.n_res + jl, res + 144 * A.n_res + jl,
                      A.n_res);
        else
          column_step<T, true>(o, A, A.bgrad + o.q, A.bint + o.q, A.bmet + o.q, A.npc);
        store_table_stresses(o, A, ss_smem, jl);
      }
    }
    timer.mark(0, A.timer);
    grid.sync();
    timer.mark(1, A.timer);
    // ---- vertex phase ----
    if constexpr (!kTables) {
#pragma unroll
      for (int r = 0; r < kVertRegs; ++r)
        if (vx[r].pos >= 0) vertex_step(vx[r], A);
    } else {
      for (int i = gtid; i < A.nv; i += nthreads) {
        Vertex<T> o;
        load_table_vertex(o, i, A);
        vertex_step(o, A);
      }
    }
    timer.mark(2, A.timer);
    grid.sync();
    timer.mark(3, A.timer);
  }

  // ---- epilogue ----
  if constexpr (!kTables) {
    store_column(col, A);
#pragma unroll
    for (int r = 0; r < kVertRegs; ++r)
      if (vx[r].pos >= 0) {
        A.uv_out[vx[r].id] = vx[r].u;
        A.uv_out[(size_t)A.nv + vx[r].id] = vx[r].v;
      }
  } else {
    for (int jl = tid; jl < ncb; jl += kThreads) {   // slot -> ring into s_out
      Column<T> o;
      load_table_column(o, A, ss_smem, jl, c0 + jl);
      store_column(o, A);
    }
    for (int i = gtid; i < A.nv; i += nthreads) {
      const int pos = A.vtab[(size_t)3 * A.nv + i];
      A.uv_out[i] = A.planes[pos];
      A.uv_out[(size_t)A.nv + i] = A.planes[(size_t)2 * A.npp + pos];
    }
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

// The co-resident grid of one placement: blocks per SM at the whole
// shared-memory budget (one on an H100) times the SM count, cut to a
// warp's worth of columns per block on small meshes.
template <typename K>
int coresident_grid(K kernel, int threads, int budget, int sms, int ncol, int* grid)
{
  cudaError_t err;
  int per_sm = 0;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  budget)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                           (size_t)budget)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid = std::min(per_sm * sms, std::max(1, (ncol + 31) / 32));
  return 0;
}

// Where the loop state lives (see the header), from the shapes, the SM
// count and the opt-in shared-memory budget.  Registers where a block's
// columns and vertices fit one column and kVertRegs vertices a thread;
// then the basis of the block's first columns takes the shared memory.
// Else tables; then the columns' stresses take the shared memory first
// (72 B read and 72 B written a subcycle for 72 B of shared memory, twice
// what their basis saves a byte: 720 B read for 720 B), the basis of the
// first columns what is left.  info[1..7]: grid, threads per block,
// dynamic shared memory bytes per block, columns per block, resident-basis
// columns per block, table columns per block whose stresses are in shared
// memory, 1 for the table placement.
template <typename T>
int plan_loop(LoopArgs<T>& A, int* info)
{
  cudaError_t err;
  int dev = 0, sms = 0, budget = 0, grid = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  int e = coresident_grid(panel_loop_kernel<T, kRegThreads, false>, kRegThreads, budget, sms,
                          A.ncol, &grid);
  if (e != 0) return e;
  A.cpb = (A.ncol + grid - 1) / grid;
  A.tables = A.cpb > kRegThreads || A.nv > kVertRegs * kRegThreads * grid;
  if (A.tables) {
    e = coresident_grid(panel_loop_kernel<T, kTableThreads<T>, true>, kTableThreads<T>, budget, sms,
                        A.ncol, &grid);
    if (e != 0) return e;
    A.cpb = (A.ncol + grid - 1) / grid;
  }
  const size_t per_col = (size_t)(A.metric ? 180 : 144) * sizeof(T);
  const size_t per_ss = (size_t)kStress * sizeof(T);
  const size_t B = (size_t)budget;
  size_t room = B;
  A.n_ss = 0;
  if (A.tables) {
    // the stresses first; the resident basis only as far as the L1 keeps
    // kL1Keep more than its least (the streamed loads land there)
    int per_sm = 0, reserved = 0;
    if ((err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                      dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                                      dev)) != cudaSuccess)
      return (int)err;
    A.n_ss = (int)std::min<size_t>(A.cpb, B / per_ss);
    const size_t cap = (size_t)std::max(0, per_sm - reserved - kL1Keep);
    room = std::min(B, std::max(cap, A.n_ss * per_ss));
  }
  A.n_res = (int)std::min<size_t>(A.cpb, (room - A.n_ss * per_ss) / per_col);
  info[1] = grid;
  info[2] = A.tables ? kTableThreads<T> : kRegThreads;
  info[3] = (int)(A.n_res * per_col + A.n_ss * per_ss);
  info[4] = A.cpb;
  info[5] = A.n_res;
  info[6] = A.n_ss;
  info[7] = A.tables;
  return 0;
}

// Plans (plan_loop), then launches; with ptrs null it only plans.  info[0]:
// launches made.
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
  const int planned = plan_loop(A, info);
  if (planned != 0 || ptrs == nullptr) return planned;
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
  A.ctab_t = (T*)ptrs[i++];
  A.ctab_i = (int*)ptrs[i++];
  A.vtab = (int*)ptrs[i++];
  A.uv_out = (T*)ptrs[i++];
  A.s_out = (T*)ptrs[i++];
  A.timer = (long long*)ptrs[i++];
  A.P = make_params<T>(reals[0], reals[1], reals[2], reals[3], reals[4], reals[5],
                       reals[6]);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(info[1]);
  cfg.blockDim = dim3(info[2]);
  cfg.dynamicSmemBytes = (size_t)info[3];
  cfg.stream = (cudaStream_t)stream_v;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = A.tables
      ? cudaLaunchKernelEx(&cfg, panel_loop_kernel<T, kTableThreads<T>, true>, A)
      : cudaLaunchKernelEx(&cfg, panel_loop_kernel<T, kRegThreads, false>, A);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  info[0] = 1;
  return 0;
}

}  // namespace

// ints: N, n_sub, metric, n_tgt, tgt_k.  ptrs: the 49 pointers in the order
// of run_loop (cuda_panel_fused.py::_bind builds the list; the last, the
// phase timer, may be null), or null to plan only (info[1..7], no launch).
// reals: dte, damping, ecc2, puny, cos w, sin w, drag.  The inputs are not
// written; the scratch needs zeros at the columns no thread writes (the
// caller zeroes it once; the kernel fills the tables itself); uv_out
// [2, nv] and s_out [3, 6, nc] receive the result.  Returns the first CUDA
// error (0 = none); info as plan_loop and run_loop say.
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
