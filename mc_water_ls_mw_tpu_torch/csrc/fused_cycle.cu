// The two-lattice kernels of the fused cycle with the plain settings:
// fused_cycle (table), fused_cycle_dense and fused_cycle_multi (the
// instantiations NL = 2, EXT = false of fused_warp_kernel; the design,
// what bounds the kernels and what they replace: fused_warp.cuh).
#include "fused_warp.cuh"

extern "C" {

FUSED_ENTRIES(fused_cycle, TABLE, 2, false)
FUSED_ENTRIES(fused_cycle_dense, DENSE, 2, false)
FUSED_ENTRIES(fused_cycle_multi, MULTI, 2, false)

}  // extern "C"
