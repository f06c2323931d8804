// Whole-cell SW energy and per-molecule moments of one lattice,
// walker-batched: (r3 [3,N,W], H [3,3,W]) -> (E [W], mom [10,N,W]).
//
// Replaces the TPU kernel FullEnergyPallas._kernel
// (mc_water_ls_mw_tpu/ops/pallas_energy.py), which streams chunks of 8
// centre rows through VMEM.  Plain version: ops/dense.full_energy_batch
// with mic=True.
//
// What bounds it on the H100: operations.  Every (centre i, partner j,
// walker w) triple pays a minimum-image fold and a distance test (~48
// operations) and the in-range ones two exponentials and the moment sums,
// while the only bytes are r3 and H in and mom out (~46 MB at N=216,
// W=4096 in f32).  Built without FMA contraction, each product and sum
// is an instruction of its own, so the per-pair arithmetic cannot run
// faster than about twice the operations bound (which counts an FMA as
// two operations).
//
// Its first design (one thread per (i, w), a grid of N x W/128 blocks,
// every partner row read from global memory, and a second kernel that
// summed the centres' terms) took 0.71 ms per lattice at N=216, W=4096
// in f32 on an H100 80GB HBM3 at 700 W: a block's 128 walkers x N rows
// did not stay in L1, so ~2.3 GB of L1/L2 traffic fed 46 MB of data.
//
// Design: a block takes a tile of ``tw`` walkers (32 in f32, 16 in f64:
// one 128-byte line of a row) and a group of ``cpg`` centres
// (ops/full_energy.full_energy_plan mirrors the split).  It copies the
// tile's rows of all N molecules into shared memory once (cp.async,
// 3 N tw elements: 83 KB at N=216 in both types) and turns them into
// fractional coordinates s = H^-1 r, each thread its own walker's
// column; then each thread takes one walker (tid % tw) and the centres
// tid / tw + slots q of its group, reading every partner row from
// shared memory: a warp's lanes read consecutive words (or broadcast
// one), so there are no bank conflicts.  The cell matrix and its
// inverse are per thread, in registers; the image vectors of the
// folded shifts are staged beside the rows (once per walker, not per
// pair).  A
// pair folds the difference of fractional coordinates, s_j - s_i minus
// its nearest integer, and maps it back with H: 15 operations a pair
// fewer than folding H^-1 (r_j - r_i), and 0.40 against 0.53 ms at
// N=216, W=4096 in f32 on that card; it rounds differently from the
// plain version, within the float64 (1e-12 relative) and float32 gates.
// 16 warps a block, at most 64 registers a thread in f32, so that two
// blocks share an SM.  Each centre's energy term 0.5*pair +
// lam*eps*e3 goes to a scratch row [N, W]; the last block of a tile to
// finish (an atomic ticket after __threadfence, reset by that block for
// the next launch) sums the N terms of its walkers in centre order, as
// the first design's second kernel did, so E does not depend on which
// block finishes last and there is one launch per call.
#include "cp_async.cuh"
#include "sw_common.cuh"

// Mirror of the ctypes structure FullEnergyArgs in ops/full_energy.py.
struct FullEnergyArgs {
  const void* r;      // [3,N,W]
  const void* h;      // [3,3,W]
  const int* shifts;  // [S,3] folded image shifts
  void* mom;          // [10,N,W] out
  void* E;            // [W] out
  void* contrib;      // [N,W] scratch: each centre's energy term
  int* ticket;        // [tiles] blocks of a tile done; 0 between launches
  int S, N, W;
  int tw;      // walkers per tile (threads of one centre slot)
  int warps;   // warps per block
  int groups;  // blocks per tile
  int cpg;     // centres per group (a multiple of the block's slots)
  SWConsts sw;
};

namespace {

constexpr int FE_THREADS_MAX = 512;

// Sum of x[0], x[stride], ..., x[(n - 1) stride] from 0, in index order,
// read through L2 (values other blocks wrote in this launch): the loads
// go out B at a time, so a long sum waits for n / B round trips, not n.
template <int B, typename T>
__device__ __forceinline__ T ordered_sum_l2(const T* x, size_t stride,
                                            int n) {
  T sum = (T)0;
  for (int i0 = 0; i0 < n; i0 += B) {
    T v[B];
#pragma unroll
    for (int b = 0; b < B; ++b)
      v[b] = i0 + b < n ? __ldcg(x + (size_t)(i0 + b) * stride) : (T)0;
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (i0 + b < n) sum += v[b];
  }
  return sum;
}

// The pair sums of centre i of this thread's walker against every
// partner j of the staged rows sr [3][N][tw] (this walker's column at
// lane offset wl), over the folded shifts: sv [S][3][tw] their image
// vectors H @ shift, null the index of the null shift (S1: it is the
// only one).  The staged rows hold fractional coordinates H^-1 r.
template <typename T, bool S1>
__device__ __forceinline__ void centre_sums(const T* sr, const T* sv, int N,
                                            int tw, int wl, int i, int S,
                                            int null, const T H[3][3],
                                            const SW<T>& p,
                                            Mom<T>& acc, T& pair) {
  const T xi = sr[(0 * N + i) * tw + wl];
  const T yi = sr[(1 * N + i) * tw + wl];
  const T zi = sr[(2 * N + i) * tw + wl];
  for (int j = 0; j < N; ++j) {
    // the minimum image: the fractional difference minus its nearest
    // integer (ops/dense._mic_fold's rule), back to Cartesian
    T s[3] = {sr[(0 * N + j) * tw + wl] - xi, sr[(1 * N + j) * tw + wl] - yi,
              sr[(2 * N + j) * tw + wl] - zi};
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = s[k] - floor(s[k] + (T)0.5);
    T f[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      f[k] = H[k][0] * s[0] + H[k][1] * s[1] + H[k][2] * s[2];
    for (int m = 0; m < (S1 ? 1 : S); ++m) {
      const bool null_shift = S1 || m == null;
      T dx = f[0], dy = f[1], dz = f[2];
      if (!null_shift) {
        dx += sv[(3 * m + 0) * tw + wl];
        dy += sv[(3 * m + 1) * tw + wl];
        dz += sv[(3 * m + 2) * tw + wl];
      }
      const T r2 = dx * dx + dy * dy + dz * dz;
      // out-of-range and self terms contribute exactly zero in the
      // plain version (masked to 0), so they are skipped
      if (!(r2 < p.rc2) || (null_shift && j == i)) continue;
      const T inv = sw_rsqrt(r2);
      const T rij = r2 * inv;
      const T den = sw_denom(rij, p);
      pair += sw_pair(r2, den, p);
      acc.add(sw_leg(den, p), dx * inv, dy * inv, dz * inv);
    }
  }
}

}  // namespace

// One block per (walker tile blockIdx.x, centre group blockIdx.y).
// At most 64 registers a thread in f32, so that two blocks of 16 warps
// share an SM.
template <typename T>
__global__ void __launch_bounds__(FE_THREADS_MAX, sizeof(T) == 4 ? 2 : 1)
full_energy_kernel(const FullEnergyArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  T* sr = reinterpret_cast<T*>(smem);  // [3][N][tw]
  T* sv = sr + (size_t)3 * a.N * a.tw;  // [S][3][tw]
  const int N = a.N, W = a.W, tw = a.tw;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int slots = nthreads / tw;
  const int wl = tid % tw, slot = tid / tw;
  const int tile = blockIdx.x;
  const int w_raw = tile * tw + wl;
  // ragged edge: walkers beyond W repeat the last one and store nothing
  const int w = w_raw < W ? w_raw : W - 1;

  // the tile's rows of all N molecules; nthreads is a multiple of tw,
  // so this thread copies only its own walker's column
  const T* r = static_cast<const T*>(a.r) + w;
  for (int e = slot; e < 3 * N; e += slots)
    cp_async_elem(sr + (size_t)e * tw + wl, r + (size_t)e * W);
  cp_async_commit();

  const SW<T> p(a.sw);
  T H[3][3], A[3][3];
  const T* Hm = static_cast<const T*>(a.h);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) H[i][j] = Hm[(i * 3 + j) * W + w];
  inv3_rows(H, A);
  // the image vectors of the folded shifts, once per walker rather than
  // per pair, and the null shift's index
  const int S = a.S;
  int null = -1;
  for (int s = 0; s < S; ++s) {
    const int s0 = a.shifts[3 * s], s1 = a.shifts[3 * s + 1],
              s2 = a.shifts[3 * s + 2];
    if ((s0 == 0) & (s1 == 0) & (s2 == 0) & (null < 0)) null = s;
    if (slot != 0) continue;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      sv[(3 * s + k) * tw + wl] =
          (T)s0 * H[k][0] + (T)s1 * H[k][1] + (T)s2 * H[k][2];
  }
  const bool only_null = S == 1 && null == 0;
  cp_async_wait_all();
  __syncthreads();
  // fractional coordinates of this walker's staged column
  for (int j = slot; j < N; j += slots) {
    T* at = sr + (size_t)j * tw + wl;
    const T x = at[0], y = at[(size_t)N * tw], z = at[(size_t)2 * N * tw];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      at[(size_t)k * N * tw] = A[k][0] * x + A[k][1] * y + A[k][2] * z;
  }
  __syncthreads();

  T* mom = static_cast<T*>(a.mom);
  T* contrib = static_cast<T*>(a.contrib);
  const int i0 = blockIdx.y * a.cpg;
  const int i1 = min(N, i0 + a.cpg);
  for (int i = i0 + slot; i < i1; i += slots) {
    Mom<T> acc;
    acc.zero();
    T pair = (T)0;
    if (only_null)
      centre_sums<T, true>(sr, sv, N, tw, wl, i, 1, 0, H, p, acc, pair);
    else
      centre_sums<T, false>(sr, sv, N, tw, wl, i, S, null, H, p, acc, pair);
    if (w_raw < W) {
#pragma unroll
      for (int fld = 0; fld < 10; ++fld)
        mom[((size_t)fld * N + i) * W + w] = acc.m[fld];
      const T e3 = e3_closed_form(acc.m, acc.w2, p);
      contrib[(size_t)i * W + w] = (T)0.5 * pair + p.lam_eps * e3;
    }
  }

  // the last block of this tile sums the centres' terms in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(a.ticket + tile, 1);
    s_last = done == a.groups - 1;
    if (s_last) a.ticket[tile] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (slot != 0 || w_raw >= W) return;
  static_cast<T*>(a.E)[w] = ordered_sum_l2<24>(contrib + w, (size_t)W, N);
}

namespace {

template <typename T>
size_t smem_bytes(const FullEnergyArgs* a) {
  return sizeof(T) * 3 * ((size_t)a->N + a->S) * a->tw;
}

// (grid, block, dynamic shared bytes) of a launch, or false for a plan
// the kernel does not take.
template <typename T>
bool geometry(const FullEnergyArgs* a, dim3& grid, dim3& block,
              size_t& smem) {
  const int threads = 32 * a->warps;
  if (a->tw < 1 || a->tw > 32 || threads > FE_THREADS_MAX
      || threads % a->tw != 0 || a->groups < 1 || a->cpg < 1
      || (long long)a->groups * a->cpg < a->N || a->groups > 65535)
    return false;
  grid = dim3((a->W + a->tw - 1) / a->tw, a->groups);
  block = dim3(threads);
  smem = smem_bytes<T>(a);
  return true;
}

template <typename T>
int launch(const FullEnergyArgs* a, cudaStream_t stream) {
  dim3 grid, block;
  size_t smem;
  if (!geometry<T>(a, grid, block, smem)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      full_energy_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  full_energy_kernel<T><<<grid, block, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// out = {registers per thread, local (spill) bytes per thread, blocks
// resident on one SM, dynamic shared bytes per block, blocks}.
template <typename T>
int occupancy(const FullEnergyArgs* a, int* out) {
  dim3 grid, block;
  size_t smem;
  if (!geometry<T>(a, grid, block, smem)) return (int)cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(full_energy_kernel<T>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      (int)block.x, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = per_sm;
  out[3] = (int)smem;
  out[4] = (int)(grid.x * grid.y);
  return (int)err;
}

}  // namespace

extern "C" {

int full_energy_f32(const FullEnergyArgs* a, void* stream) {
  return launch<float>(a, (cudaStream_t)stream);
}

int full_energy_f64(const FullEnergyArgs* a, void* stream) {
  return launch<double>(a, (cudaStream_t)stream);
}

int full_energy_occupancy(int f64, const FullEnergyArgs* a, int* out) {
  return f64 ? occupancy<double>(a, out) : occupancy<float>(a, out);
}

}  // extern "C"
