// Host stand-in for <cooperative_groups.h>: the grid-wide barrier of a
// launch that `cudaLaunchKernelEx` of cuda_runtime.h (beside this file) runs
// with every block's threads at once.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {

struct grid_group {
  void sync() const { shim_grid_barrier->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }

}  // namespace cooperative_groups
