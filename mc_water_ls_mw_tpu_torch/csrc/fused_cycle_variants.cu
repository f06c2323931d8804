// The fused cycle's other instantiations (fused_warp.cuh): one lattice
// (NL = 1: fused_cycle_1l, fused_cycle_dense_1l) and the extended
// settings at two lattices (EXT: MINU, NVT, leshift, the Swetnam and 1/t
// schedules: fused_cycle_ext, fused_cycle_dense_ext,
// fused_cycle_multi_ext).  A library of its own, so that nvcc builds it
// beside fused_cycle.cu.
#include "fused_warp.cuh"

extern "C" {

FUSED_ENTRIES(fused_cycle_1l, TABLE, 1, false)
FUSED_ENTRIES(fused_cycle_dense_1l, DENSE, 1, false)
FUSED_ENTRIES(fused_cycle_ext, TABLE, 2, true)
FUSED_ENTRIES(fused_cycle_dense_ext, DENSE, 2, true)
FUSED_ENTRIES(fused_cycle_multi_ext, MULTI, 2, true)

}  // extern "C"
