// Cell side of ONE elastic subcycle on the panel-reordered icosahedral
// sphere, for Hopper.
//
// Replaces the TPU kernel of seaice_tpu/dynamics/pallas_panel.py
// (build_panel_cell_kernel): corner reads -> Wachspress strain (+ tan(lat)/r
// metric) -> EVP stress relaxation -> stress-divergence partials pu, pv
// (mu, mv with metric), one launch per subcycle.  The seam-ghost refresh, the
// dual sum, the 12 exception cells and the momentum solve stay in PyTorch
// between two launches (dynamics/evp.py); the mask the kernel is given has
// the exception columns zeroed, so it leaves their stress alone.
//
// The TPU kernel is handed six pre-shifted copies of the vertex planes,
// because its compiler takes no load at an unaligned offset.  A GPU thread
// reads the two vertex planes at the six static offsets itself: the kernel
// is `panel_cell_kernel` of evp_panel_common.cuh, whose arithmetic
// (`panel_cell_math`) the whole-loop route (evp_panel_fused.cu) runs too.  Here the planes come with
// their seam ghosts filled by the caller, so no ghost map is passed.
//
// What bounds it: bytes.  One launch reads the three basis tensors (30.4 MB
// in f32 at N = 64) and reads and writes about 4 MB of stresses and
// partials: ~0.010 ms at 3.35 TB/s, against ~0.0007 ms for its ~46 MFLOP at
// the f32 peak.

#include "evp_panel_common.cuh"

namespace {

template <typename T>
int run_cell(int N, int metric, const void* planes, const void* bgrad,
             const void* bint, const void* bmet, const void* pressure,
             const void* ss_mask, void* s11, void* s22, void* s12, void* part,
             double dte, double damping, double ecc2, double puny, void* stream_v)
{
  cudaStream_t stream = (cudaStream_t)stream_v;
  const EvpParams<T> P = make_params<T>(dte, damping, ecc2, puny, 0.0, 0.0, 0.0);
  const int R = N + 1;
  const int npp = 10 * R * R;
  const int npc = npp + 2;
  const T* pl_u = (const T*)planes;
  const T* pl_v = pl_u + (size_t)2 * npp;
  const T* pl_t = pl_v + (size_t)2 * npp;     // read only with metric
  const int threads = 128;
  const int blocks = (npp + threads - 1) / threads;
  panel_cell_kernel<T><<<blocks, threads, 0, stream>>>(
      N, npp, npc, metric, pl_u, pl_v, pl_t, nullptr, nullptr, (const T*)bgrad, (const T*)bint,
      (const T*)bmet, (const T*)pressure, (const T*)ss_mask, (T*)s11, (T*)s22,
      (T*)s12, (T*)part, P);
  return (int)cudaGetLastError();
}

}  // namespace

#define CELL_ARGS                                                                  \
  int N, int metric, const void* planes, const void* bgrad, const void* bint,      \
  const void* bmet, const void* pressure, const void* ss_mask, void* s11,          \
  void* s22, void* s12, void* part, double dte, double damping, double ecc2,       \
  double puny, void* stream
#define CELL_PASS                                                                  \
  N, metric, planes, bgrad, bint, bmet, pressure, ss_mask, s11, s22, s12, part,    \
  dte, damping, ecc2, puny, stream

// planes [2 or 3 (u, v, tan(lat)/r), 2(t), npp]; s11, s22, s12 [6, npc] are
// updated in place; part [2 or 4, 6, npc] receives the partials at the
// columns q < npp (the caller zeroes the two pole columns).
// Returns the CUDA error of the launch (0 = none).
extern "C" int panel_cell_f32(CELL_ARGS) { return run_cell<float>(CELL_PASS); }
extern "C" int panel_cell_f64(CELL_ARGS) { return run_cell<double>(CELL_PASS); }
