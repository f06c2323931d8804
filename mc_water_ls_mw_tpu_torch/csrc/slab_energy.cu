// Whole-cell SW energy and fresh per-slot moments of the cell engine's
// slab layout, both lattices in one launch:
// (r [L,3,nslot,W], valid [nslot,W], H [L,3,3,W], the grid's coverage
// tables) -> (E [L,W], mom [10,L,nslot,W]).
//
// Replaces no TPU kernel.  The JAX package computes this with plain jnp
// (mc_water_ls_mw_tpu/ops/cell_energy.py slab_full_energy, a lax.map over
// centre chunks that XLA fuses), so the bring-up left the port's
// counterpart as unfused PyTorch: ~130 element-wise and reduction
// launches a chunk over [chunk, cap, CF cap, W] intermediates and 18
// blocking table copies a call, ~160 ms for both lattices at N=8064,
// W=32 on the H100, which made the volume moves ~90% of the large-N
// run's time.  Plain version: ops/cell_energy.slab_full_energy (one
// lattice a call), the same per-pair arithmetic in the same association
// order; the sums over candidates, slots and cells run in another order.
//
// What bounds it on the H100: bytes, by the roofline's count.  The work
// that the physics needs is ~2 M in-range pair and leg terms at N=8064,
// W=32 (~1 µs of operations at 67 TFLOP/s), against the positions read
// (~13 MB) and the moments written (~42 MB): ~17 µs at 3.35 TB/s.  What
// the algorithm spends is the distance tests: every occupied centre slot
// against every occupied candidate slot of its CF coverage cells (27 at
// N=8064, 75 on narrower grids), ~219 M (centre, candidate, walker)
// triples at N=8064, W=32, ~10 operations each, most of them out of
// range.  Those tests set its time: 0.86 ms for both lattices at N=8064,
// W=32 on an H100 80GB HBM3 at 700 W, ~2% of the bound.
//
// Design: a block takes one lattice, one fine centre cell and a tile of
// 32 walkers, a lane a walker, so every [slot, W] row it reads or writes
// is one coalesced line.  It first reads its cell's coverage row (ids and
// wrap offsets) and, per candidate slot, a 32-bit vote of the tile's
// occupied walkers; slots empty for the whole tile are never staged nor
// tested, so the work follows the occupied slots (~16 of the 32 at
// N=8064), not the capacity.  The centre cell's occupied slots are
// listed and dealt to the warps, SPW each (4 in f32, 2 in f64), each
// thread holding its SPW centres' 13 sums in registers; warps left
// without centres still stage.  The coverage cells' coordinate rows
// stream through a ring of ``depth`` cp.async stages in shared memory (3
// cap 32 rows a stage, each thread copying its own walker's column of
// the occupied slots), every thread reading only its own column, so the
// reads have no bank conflicts.  Out-of-range candidates cost the test
// and nothing else (the warp's lanes, walkers near one lattice, agree on
// which pairs are in range, so the in-range branch rarely diverges).
// Each centre's energy term 0.5 pair + lam eps e3 (in T, as the plain
// version) goes to shared memory, warp 0 adds the cell's slots in slot
// order into a scratch row [L, nfine, W], and the last block of a
// (lattice, tile) (an atomic ticket after __threadfence, reset by that
// block) adds the cells in cell order, each warp a fixed run of cells and
// then the warps in order: no float atomics, and the result does not
// depend on which block is last.  These sums over slots and cells are
// taken in double, so that the float32 energy (~150 Hartree at N=8064,
// an ulp ~1.5e-5) is rounded once, where float32 sums over runs of 64
// cells would drift by a few of its ulps.  The
// ops/slab_energy.slab_energy_plan mirrors the split.
#include "cp_async.cuh"
#include "sw_common.cuh"

// Mirror of the ctypes structure SlabEnergyArgs in ops/slab_energy.py.
struct SlabEnergyArgs {
  const void* r;               // [L,3,nslot,W]
  const unsigned char* valid;  // [nslot,W] bool
  const void* h;               // [L,3,3,W]
  const int* cells;            // [nfine,CF] coverage cell ids
  const int* off;              // [nfine,CF,3] their wrap offsets
  void* mom;                   // [10,L,nslot,W] out
  void* E;                     // [L,W] out
  double* part;                // [L,nfine,W] scratch: each cell's terms
  int* ticket;                 // [L,tiles] cells done; 0 between launches
  int L, nfine, cap, CF, W;
  int warps;  // warps per block
  int spw;    // centre slots per warp and pass: SPW<T>
  int depth;  // stages of the coordinate ring (2-4)
  SWConsts sw;
};

namespace {

constexpr int SE_THREADS_MAX = 512;
constexpr unsigned FULL = 0xffffffffu;
// centre slots a warp holds in registers (13 sums each): 4 in f32, 2 in
// f64, so that a thread stays within 128 registers without spills
template <typename T>
constexpr int SPW = sizeof(T) == 4 ? 4 : 2;

// Sum of x[0], x[stride], ..., x[(n - 1) stride] from 0, in index order,
// read through L2 (values other blocks wrote in this launch): the loads
// go out B at a time.
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

__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  // cp.async.wait_group takes an immediate: the ring's depth - 2
  switch (pending) {
    case 0: cp_async_wait_group<0>(); break;
    case 1: cp_async_wait_group<1>(); break;
    default: cp_async_wait_group<2>(); break;
  }
}

// The dynamic shared memory of a block, in this order: the warps' sums
// [warps][32] of double; the ring [depth][3][cap][32] and the centres'
// terms [cap][32] of T; the candidate votes [CF][cap] and the centre
// cell's [cap] of 32 bits; the coverage ids [CF], offsets [CF][3] and the
// list of occupied centre slots [cap] of int.
struct Smem {
  size_t wsum, ring, contrib, masks, cmask, cells, offs, clist, bytes;
};

__host__ __device__ inline Smem smem_layout(const SlabEnergyArgs& a,
                                            size_t itemsize) {
  Smem s;
  s.wsum = 0;
  s.ring = s.wsum + sizeof(double) * a.warps * 32;
  s.contrib = s.ring + itemsize * a.depth * 3 * a.cap * 32;
  s.masks = s.contrib + itemsize * a.cap * 32;
  s.cmask = s.masks + 4 * (size_t)a.CF * a.cap;
  s.cells = s.cmask + 4 * (size_t)a.cap;
  s.offs = s.cells + 4 * (size_t)a.CF;
  s.clist = s.offs + 12 * (size_t)a.CF;
  s.bytes = s.clist + 4 * (size_t)a.cap;
  return s;
}

}  // namespace

// One block per (walker tile blockIdx.x, fine centre cell blockIdx.y,
// lattice blockIdx.z); a lane per walker.
template <typename T>
__global__ void __launch_bounds__(SE_THREADS_MAX)
slab_energy_kernel(const SlabEnergyArgs a) {
  constexpr int S = SPW<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_nocc, s_last;
  const Smem lay = smem_layout(a, sizeof(T));
  T* ring = reinterpret_cast<T*>(smem + lay.ring);
  T* contrib = reinterpret_cast<T*>(smem + lay.contrib);
  double* wsum = reinterpret_cast<double*>(smem + lay.wsum);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + lay.masks);
  unsigned* cmask = reinterpret_cast<unsigned*>(smem + lay.cmask);
  int* cells = reinterpret_cast<int*>(smem + lay.cells);
  int* offs = reinterpret_cast<int*>(smem + lay.offs);
  int* clist = reinterpret_cast<int*>(smem + lay.clist);

  const int cap = a.cap, CF = a.CF, D = a.depth, W = a.W;
  const int nslot = a.nfine * cap;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int tile = blockIdx.x, c = blockIdx.y, l = blockIdx.z;
  const int w = tile * 32 + lane;
  const bool live = w < W;
  // lanes beyond W read a real walker and store nothing
  const int wr = live ? w : W - 1;

  // the cell's coverage row; the centres' terms start at zero
  for (int i = threadIdx.x; i < CF; i += blockDim.x)
    cells[i] = a.cells[(size_t)c * CF + i];
  for (int i = threadIdx.x; i < 3 * CF; i += blockDim.x)
    offs[i] = a.off[(size_t)c * 3 * CF + i];
  for (int i = threadIdx.x; i < cap * 32; i += blockDim.x) contrib[i] = (T)0;
  __syncthreads();

  // the votes: bit t of a slot's word is set where walker 32 tile + t
  // holds a molecule there (column CF: the centre cell itself); a warp per
  // slot, four slots' loads in flight
  const unsigned char* vcol = a.valid + wr;
  const int nvote = (CF + 1) * cap;
  for (int e0 = 4 * warp; e0 < nvote; e0 += 4 * nw) {
    bool v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q;
      v[q] = false;
      if (e < nvote && live) {
        const int k = e / cap, b = e - k * cap;
        const int cell = k < CF ? cells[k] : c;
        v[q] = vcol[(size_t)(cell * cap + b) * W] != 0;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q;
      const unsigned m = __ballot_sync(FULL, v[q]);
      if (lane == 0 && e < nvote) {
        if (e < CF * cap)
          masks[e] = m;
        else
          cmask[e - CF * cap] = m;
      }
    }
  }
  __syncthreads();

  // the centre cell's slots occupied by some walker of the tile, in slot
  // order
  if (warp == 0) {
    int n = 0;
    for (int b0 = 0; b0 < cap; b0 += 32) {
      const int b = b0 + lane;
      const bool occ = b < cap && cmask[b] != 0u;
      const unsigned bal = __ballot_sync(FULL, occ);
      if (occ) clist[n + __popc(bal & ((1u << lane) - 1u))] = b;
      n += __popc(bal);
    }
    if (lane == 0) s_nocc = n;
  }
  __syncthreads();
  const int nocc = s_nocc;

  const T* r = static_cast<const T*>(a.r);
  T* mom = static_cast<T*>(a.mom);
  const size_t fstride = (size_t)a.L * nslot * W;  // one moment field
  // slots empty for every walker of the tile: zero moments
  if (live) {
    for (int b = warp; b < cap; b += nw) {
      if (cmask[b] != 0u) continue;
      T* m = mom + ((size_t)l * nslot + (size_t)c * cap + b) * W + w;
#pragma unroll
      for (int f = 0; f < 10; ++f) m[f * fstride] = (T)0;
    }
  }

  const SW<T> p(a.sw);
  T H[3][3];
  const T* Hm = static_cast<const T*>(a.h) + (size_t)l * 9 * W + wr;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) H[i][j] = Hm[(size_t)(i * 3 + j) * W];

  const int stage = 3 * cap * 32;
  const T* rl = r + (size_t)l * 3 * nslot * W + wr;
  // stage coverage cell k into ring slot k % D: this thread copies its
  // own walker's column of the slots warp, warp + nw, ... that the walker
  // occupies
  auto stage_cell = [&](int k) {
    T* dst = ring + (size_t)(k % D) * stage + lane;
    const int cell = cells[k];
    for (int b = warp; b < cap; b += nw) {
      if (!((masks[k * cap + b] >> lane) & 1u)) continue;
      const size_t row = (size_t)cell * cap + b;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax)
        cp_async_elem(dst + (ax * cap + b) * 32,
                      rl + ((size_t)ax * nslot + row) * W);
    }
  };

  const int per_pass = nw * S;
  for (int base0 = 0; base0 < nocc; base0 += per_pass) {
    const int base = base0 + warp * S;
    const int mine = max(0, min(S, nocc - base));  // warp-uniform
    T px[S], py[S], pz[S], pair[S];
    Mom<T> acc[S];
    bool vi[S];
    int slot[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acc[s].zero();
      pair[s] = (T)0;
      slot[s] = s < mine ? clist[base + s] : -1;
      vi[s] = s < mine && ((cmask[slot[s]] >> lane) & 1u);
      px[s] = py[s] = pz[s] = (T)0;
      if (vi[s]) {
        const size_t row = (size_t)c * cap + slot[s];
        px[s] = rl[row * W];
        py[s] = rl[((size_t)nslot + row) * W];
        pz[s] = rl[((size_t)2 * nslot + row) * W];
      }
    }

    for (int k = 0; k < D - 1; ++k) {
      if (k < CF) stage_cell(k);
      cp_async_commit();
    }
    for (int k = 0; k < CF; ++k) {
      cp_async_wait_upto(D - 2);
      __syncthreads();  // stage k landed; stage k - 1's slot is free
      if (k + D - 1 < CF) stage_cell(k + D - 1);
      cp_async_commit();
      if (mine == 0) continue;
      const T* buf = ring + (size_t)(k % D) * stage + lane;
      const int cell = cells[k];
      const bool self_cell = cell == c;
      // the image shift H @ off, as ops/cell_energy._shift_vectors
      const T o0 = (T)offs[3 * k], o1 = (T)offs[3 * k + 1],
              o2 = (T)offs[3 * k + 2];
      T sh[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax)
        sh[ax] = o0 * H[ax][0] + o1 * H[ax][1] + o2 * H[ax][2];
      const unsigned* mk = masks + k * cap;
      for (int b = 0; b < cap; ++b) {
        const unsigned mb = mk[b];
        if (mb == 0u) continue;  // empty for the whole tile
        const bool vj = (mb >> lane) & 1u;
        const T cx = buf[(0 * cap + b) * 32] + sh[0];
        const T cy = buf[(1 * cap + b) * 32] + sh[1];
        const T cz = buf[(2 * cap + b) * 32] + sh[2];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (s >= mine || (self_cell && b == slot[s])) continue;
          const T d[3] = {cx - px[s], cy - py[s], cz - pz[s]};
          const T r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
          // masked and out-of-range terms are exactly zero in the plain
          // version, so they are skipped
          if (vj && vi[s] && r2 < p.rc2) {
            const Leg<T> g = leg_in_range(d, r2, p);
            pair[s] += g.pair;
            acc[s].add(g.w, g.ux, g.uy, g.uz);
          }
        }
      }
    }
    __syncthreads();  // the ring is free for the next pass

    if (live) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s >= mine) continue;
        T* m = mom + ((size_t)l * nslot + (size_t)c * cap + slot[s]) * W + w;
#pragma unroll
        for (int f = 0; f < 10; ++f) m[f * fstride] = acc[s].m[f];
        const T e3 = e3_closed_form(acc[s].m, acc[s].w2, p);
        contrib[slot[s] * 32 + lane] = (T)0.5 * pair[s] + p.lam_eps * e3;
      }
    }
  }
  __syncthreads();

  // the cell's terms in slot order, in double
  double* part = static_cast<double*>(a.part);
  if (warp == 0 && live) {
    double sum = 0.0;
    for (int b = 0; b < cap; ++b) sum += (double)contrib[b * 32 + lane];
    part[((size_t)l * a.nfine + c) * W + w] = sum;
  }

  // the last block of this (lattice, tile) adds the cells in order
  __threadfence();
  __syncthreads();
  int* ticket = a.ticket + (size_t)l * gridDim.x + tile;
  if (threadIdx.x == 0) {
    const int done = atomicAdd(ticket, 1);
    s_last = done == a.nfine - 1;
    if (s_last) *ticket = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int run = (a.nfine + nw - 1) / nw;
  const int c0 = min(a.nfine, warp * run), c1 = min(a.nfine, c0 + run);
  wsum[warp * 32 + lane] =
      live ? ordered_sum_l2<16>(part + ((size_t)l * a.nfine + c0) * W + w,
                                (size_t)W, c1 - c0)
           : 0.0;
  __syncthreads();
  if (warp != 0 || !live) return;
  double e = 0.0;
  for (int q = 0; q < nw; ++q) e += wsum[q * 32 + lane];
  static_cast<T*>(a.E)[(size_t)l * W + w] = (T)e;
}

namespace {

// (grid, block, dynamic shared bytes) of a launch, or false for a plan
// the kernel does not take.
template <typename T>
bool geometry(const SlabEnergyArgs* a, dim3& grid, dim3& block,
              size_t& smem) {
  const int threads = 32 * a->warps;
  if (a->warps < 1 || threads > SE_THREADS_MAX || a->spw != SPW<T>
      || a->depth < 2 || a->depth > 4 || a->L < 1 || a->L > 65535
      || a->nfine < 1 || a->nfine > 65535 || a->cap < 1 || a->CF < 1
      || a->W < 1)
    return false;
  grid = dim3((a->W + 31) / 32, a->nfine, a->L);
  block = dim3(threads);
  smem = smem_layout(*a, sizeof(T)).bytes;
  return true;
}

template <typename T>
int launch(const SlabEnergyArgs* a, cudaStream_t stream) {
  dim3 grid, block;
  size_t smem;
  const void* fn = reinterpret_cast<const void*>(slab_energy_kernel<T>);
  if (!geometry<T>(a, grid, block, smem)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {const_cast<SlabEnergyArgs*>(a)};
  err = cudaLaunchKernel(fn, grid, block, params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// out = {registers per thread, local (spill) bytes per thread, blocks
// resident on one SM, dynamic shared bytes per block, blocks}.
template <typename T>
int occupancy(const SlabEnergyArgs* a, int* out) {
  dim3 grid, block;
  size_t smem;
  const void* fn = reinterpret_cast<const void*>(slab_energy_kernel<T>);
  if (!geometry<T>(a, grid, block, smem)) return (int)cudaErrorInvalidValue;
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
  out[4] = (int)(grid.x * grid.y * grid.z);
  return (int)err;
}

}  // namespace

extern "C" {

int slab_energy_f32(const SlabEnergyArgs* a, void* stream) {
  return launch<float>(a, (cudaStream_t)stream);
}

int slab_energy_f64(const SlabEnergyArgs* a, void* stream) {
  return launch<double>(a, (cudaStream_t)stream);
}

int slab_energy_occupancy(int f64, const SlabEnergyArgs* a, int* out) {
  return f64 ? occupancy<double>(a, out) : occupancy<float>(a, out);
}

}  // extern "C"
