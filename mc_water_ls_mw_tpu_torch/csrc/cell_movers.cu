// The three stencil kernels of the large-N cell engine's sub-step, for K
// movers (one per same-colour coarse cell), both lattices and every
// walker in one launch each:
//
//   mover_energies  local energy of each mover at its old and its
//                   proposed position (pair + three-body: the mover's
//                   own centre-angle sum and the wing sums against its
//                   neighbours' moments, corrected for the new position
//                   by the mover's own leg change) and the mover's new
//                   own moments; its second entry point
//                   (mover_energies_deltas) also writes every candidate
//                   slot's ten moment deltas new - old, which the
//                   engine's scatter path adds to the slab;
//   mover_points    the same at P = T + 1 points per mover (the
//                   multi-trial sub-step: point 0 the stored position,
//                   points 1..T the anchored-window candidates) in one
//                   pass over the stencil, and the own moments at every
//                   point;
//   mover_apply     in place on the packed slab, for accepted movers:
//                   add the per-candidate moment deltas new - old to
//                   the neighbours' moment rows, set the mover's own
//                   slot to its new moments and its coordinate rows to
//                   the new position.
//
// They replace the TPU kernels MoverEnergiesPallas._kernel (both
// with_deltas=False and with_deltas=True), MoverPointsPallas._kernel and
// MoverApplyPallas._kernel (mc_water_ls_mw_tpu/ops/cell_pallas.py).
// Plain versions: MoverEnergiesKernel.plain / MoverPointsKernel.plain /
// MoverApplyKernel.plain in ops/cell_kernels.py
// (cell_energy.mover_energies, cell_energy.mover_point_energies and the
// scatter path).
//
// Data: each lattice's state is one packed slab pk [nfine, 14, cap, W]
// (rows 0:10 the moments, 10:13 x y z, 13 the occupied flag), walker
// last.  A mover's candidates are the cap slots of the CF fine cells of
// its coverage stencil (cand [K,CF], wrap offsets off [K,CF,3]; CF = 27
// where the fine cells are at least the coverage radius wide, 75 on
// narrower ones); a candidate's image shift is H @ off.  Masking as in the
// TPU kernel: a slot counts if its flag is > 0.5 and it is not the
// mover's own slot (the candidate cell is the mover's cell and the slot
// equals rank).
//
// What bounds them on the H100: bytes.  Every candidate slot's flag must
// be read (K*CF*cap*W elements: 14 MB per lattice at K=8, CF=27, cap=32,
// W=512 in f32) and the three coordinate rows of the occupied slots
// (about half of them), but only the few slots within the cutoff of one
// of the two positions need their ten moment rows; the arithmetic is
// ~10^9 operations.  Lane = walker throughout, so every row access of
// a warp is one coalesced 128-byte line (f32); the flag and coordinate
// rows are loaded unconditionally (independent loads the hardware
// overlaps), the moment rows only where a leg is in range.
// mover_energies_deltas (kernel 3b): a block is one (mover, lattice,
// tile of 32 walkers), the candidate slots of a triple split over the
// NW warps of its block (warp y takes slots y, y+NW, ... of every
// cell), the 26 partial sums of the NW warps reduced through shared
// memory in a fixed order (no float atomics: accept decisions must not
// depend on scheduling).  It adds the output [L, K, CF, 10, cap, W] (per
// lattice the rows of the packed slab's moment block, so the engine's
// scatter reads it as it is) and writes EVERY slot of it, zeros where
// the slot is masked or out of range of both positions: a single pass
// with no memset, whose coalesced stores (lane = walker) are the bulk of
// its bytes (10*K*CF*cap*W per lattice, 393 MB at K=32, CF=75, cap=32,
// W=128 in f32), so it is bound by them.
// mover_energies (kernel 3) ran on that body too: 0.1007 ms per launch
// at N=8064, K=8, W=512 in f32 on an H100 80GB HBM3 at 700 W, against a
// bound of 0.022 ms: 256 blocks on 132 SMs, each warp walking 27 cells
// x 4 slots one after another, each slot's loads issued only after the
// previous slot's branch resolved; nearly every 32-byte sector of the
// flag and coordinate rows is read (~113 MB, 34 us at 3.35 TB/s).
// Design: each warp streams its slots through a ring of shared memory
// with asynchronous copies (cp.async), in passes of EN_SPW slots of one
// candidate cell: a pass's occupied flags are copied EN_FLAG_LEAD
// passes ahead of its use and, once they have landed, the coordinates
// of the occupied slots only, EN_COORD_LEAD passes ahead (about half of
// the candidate slots are empty, most of them in every walker of a
// warp, so ~40% of the sectors are never fetched), while warp 0 puts the
// tile's context (both points, rank, the image shifts) in shared memory;
// the slots in range of either point then read their ten moment rows.
// A block is one (walker tile, mover, lattice), as before
// (ops/cell_kernels.energies_geometry), its warps' 26 x 32 partial sums
// reduced in a fixed order.  A split of each stencil over several
// blocks, the groups' sums added by the last block to finish, ran
// slower at the main path's shape (256 blocks on 132 SMs: groups of 9
// cells 0.070 ms, of 3 cells 0.090 ms, against 0.051 for none; H100
// 80GB HBM3, 700 W) and is not kept.
// mover_apply needs no reduction and no atomics: same-colour stencils
// are disjoint, so no two movers touch one cell (nor one mover a cell
// twice), a mover's own slot is never read as a neighbour (it is
// self-masked), and a slot's deltas depend only on its own coordinates
// and the mover's two points.  So every (lattice, mover, candidate cell,
// slot, walker) is written by exactly one thread whatever the split of
// the stencil over blocks.  Its first design (a block per (mover,
// lattice, 32 walkers), each warp walking 27 cells x 4 slots one after
// another) took 0.134-0.138 ms per launch at N=8064, K=8, W=512 in f32
// on an H100 80GB HBM3 at 700 W: 256 blocks on 132 SMs (64 at W=128),
// each slot's loads issued only after the previous slot's branch
// resolved, and an in-range slot's ten moment rows read and written one
// after another (the compiler cannot tell the rows apart, so each
// read waited for the previous write).  What bounds it is bytes: every
// candidate slot's flag and coordinates for the accepted walkers (a
// 32-byte sector holds 8 walkers, so nearly every sector is read: 113
// MB at W=512, 34 us at 3.35 TB/s).  Design:
// the grid also runs over the candidate cells, (W/32, K*CF, L), a block
// per (walker tile, mover, candidate cell, lattice): 6912 blocks at K=8,
// CF=27, W=512.  Each of its warps takes APPLY_SPW slots of the cell and
// issues their flag and coordinate loads together, first thing (they
// depend only on the cell); meanwhile warp 0 loads what the tile's
// walkers need of their mover (accept flag, both points, the cell's
// image shift) into shared memory once for the block.  A lane whose
// mover was rejected then returns (a warp when none of its walkers
// accepted); the few slots in range of either point (~2% of the
// occupied ones) read all ten moment rows before writing any.  Held to
// 64 registers, four blocks (32 warps) share an SM.  The TPU kernel's
// copy of every visited block through an aliased output and its scalar
// prefetch of the tables have no counterpart here.
//
// Built without FMA contraction (cuda_build.py): every product and sum
// rounds as the plain versions' elementwise ops do.
#include <cstdint>

#include "cp_async.cuh"
#include "sw_common.cuh"

namespace {

constexpr int PK_R0 = 10, PK_VALID = 13, PK_ROWS = 14;
constexpr int NW = 8;     // warps per block (candidate-slot split)
constexpr int NACC = 26;  // pair o/n, w2 o/n, wing o/n, own o[10]/n[10]
// (cell, slot) items of a group a warp of mover_energies takes at a
// time, their copies in flight together
// (ops/cell_kernels.ENERGIES_SLOTS_PER_WARP)
constexpr int EN_SPW = 4;
// a pass's flags are copied EN_FLAG_LEAD passes ahead of its use, its
// coordinates EN_COORD_LEAD; the ring holds EN_FLAG_LEAD + 1 passes
constexpr int EN_FLAG_LEAD = 3, EN_COORD_LEAD = 2;
constexpr int EN_STAGES = EN_FLAG_LEAD + 1;
// slots of one candidate cell a warp of mover_apply takes at a time,
// their loads in flight together (ops/cell_kernels.APPLY_SLOTS_PER_WARP)
constexpr int APPLY_SPW = 4;

}  // namespace

// Mirror of the ctypes structure MoverArgs in ops/cell_kernels.py.
struct MoverArgs {
  void* pk[2];    // per lattice [nfine, 14, cap, W]
  void* h;        // [L,3,3,W]
  void* cand;     // [K,CF] int32 candidate fine cells
  void* off;      // [K,CF,3] int32 wrap offsets
  void* fc;       // [K] int32 movers' fine cells
  void* rank;     // [K,W] int32 movers' slot ranks
  void* p_old;    // [L,3,K,W]
  void* p_new;    // [L,3,K,W]
  void* e;        // [L,K,2,W]   (energies: out; point 0 old, 1 new)
  void* own;      // [L,K,10,W]  (energies: out; apply: in)
  void* accf;     // rows of W accept flags (> 0.5), row k at k*acc_stride
  void* dlt;      // [L,K,CF,10,cap,W] (energies with deltas: out)
  long long acc_stride;
  int L, K, CF, cap, W;
  SWConsts sw;
  int apply_warps;  // mover_apply: warps per block (apply_geometry)
  int en_warps;     // mover_energies: warps per block (energies_geometry)
};

// What a thread needs of its (mover, lattice, walker).
template <typename T>
struct MoverCtx {
  const T* pk;
  int w, W, cap, rank, fcell;
  T H[3][3];
  T po[3], pn[3];
};

template <typename T>
__device__ __forceinline__ void load_ctx(MoverCtx<T>& c, const MoverArgs& a,
                                         int l, int k, int w) {
  const int W = a.W, K = a.K;
  c.pk = static_cast<const T*>(a.pk[l]);
  c.w = w;
  c.W = W;
  c.cap = a.cap;
  c.rank = static_cast<const int*>(a.rank)[(size_t)k * W + w];
  c.fcell = static_cast<const int*>(a.fc)[k];
  const T* h = static_cast<const T*>(a.h);
  const T* po = static_cast<const T*>(a.p_old);
  const T* pn = static_cast<const T*>(a.p_new);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c.H[i][j] = h[((size_t)(l * 3 + i) * 3 + j) * W + w];
    c.po[i] = po[((size_t)(l * 3 + i) * K + k) * W + w];
    c.pn[i] = pn[((size_t)(l * 3 + i) * K + k) * W + w];
  }
}

// Image shift H @ off of one candidate cell.
template <typename T>
__device__ __forceinline__ void cell_shift(const MoverCtx<T>& c,
                                           const int* off, T sh[3]) {
  const T o0 = (T)off[0], o1 = (T)off[1], o2 = (T)off[2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    sh[i] = o0 * c.H[i][0] + o1 * c.H[i][1] + o2 * c.H[i][2];
}

// Leg of the candidate at position cj seen from p (no minimum image:
// the coverage tables hold every partner once, image-shifted).
template <typename T>
__device__ __forceinline__ Leg<T> leg_at(const T cj[3], const T p[3],
                                         const SW<T>& sw) {
  const T d[3] = {cj[0] - p[0], cj[1] - p[1], cj[2] - p[2]};
  const T r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  if (!(r2 < sw.rc2)) return leg_none<T>();
  return leg_in_range(d, r2, sw);
}

// Slot j of candidate cell cid: true, with both legs, if the slot is a
// neighbour (occupied, not the mover itself) within the cutoff of the
// old or the new position.
template <typename T>
__device__ __forceinline__ bool slot_legs(const MoverCtx<T>& c, int cid,
                                          int j, bool self_cell,
                                          const T sh[3], const SW<T>& sw,
                                          Leg<T>& go, Leg<T>& gn) {
  const size_t base = ((size_t)cid * PK_ROWS * c.cap + j) * c.W + c.w;
  const size_t row = (size_t)c.cap * c.W;
  const T valid = c.pk[base + PK_VALID * row];
  const T cj[3] = {c.pk[base + (PK_R0 + 0) * row] + sh[0],
                   c.pk[base + (PK_R0 + 1) * row] + sh[1],
                   c.pk[base + (PK_R0 + 2) * row] + sh[2]};
  if (!(valid > (T)0.5) || (self_cell && j == c.rank)) return false;
  go = leg_at(cj, c.po, sw);
  gn = leg_at(cj, c.pn, sw);
  return go.in || gn.in;
}

// The partner's-view moment contribution of a leg: (w, -w u, w u u^T).
template <typename T>
__device__ __forceinline__ void leg_delta(const Leg<T>& g, T d[10]) {
  const T wux = g.w * g.ux, wuy = g.w * g.uy, wuz = g.w * g.uz;
  d[0] = g.w;
  d[1] = -wux;
  d[2] = -wuy;
  d[3] = -wuz;
  d[4] = wux * g.ux;
  d[5] = wuy * g.uy;
  d[6] = wuz * g.uz;
  d[7] = wux * g.uy;
  d[8] = wux * g.uz;
  d[9] = wuy * g.uz;
}

template <typename T>
__global__ void __launch_bounds__(32 * NW)
mover_energies_deltas_kernel(const MoverArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* red = reinterpret_cast<T*>(smem);  // [NW][NACC][32]
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int k = blockIdx.y, l = blockIdx.z;
  const int W = a.W, K = a.K, CF = a.CF, cap = a.cap;
  const int w_raw = blockIdx.x * 32 + lane;
  // ragged edge: lanes beyond W repeat the last walker and store nothing
  const int w = w_raw < W ? w_raw : W - 1;
  const SW<T> sw(a.sw);
  MoverCtx<T> c;
  load_ctx(c, a, l, k, w);
  const int* cand = static_cast<const int*>(a.cand) + (size_t)k * CF;
  const int* off = static_cast<const int*>(a.off) + (size_t)k * CF * 3;

  Mom<T> oo, on;
  oo.zero();
  on.zero();
  T pair_o = 0, pair_n = 0, e3j_o = 0, e3j_n = 0;
  for (int ci = 0; ci < CF; ++ci) {
    const int cid = cand[ci];
    const bool self_cell = cid == c.fcell;
    T sh[3];
    cell_shift(c, off + ci * 3, sh);
    for (int j = wy; j < cap; j += NW) {
      Leg<T> go, gn;
      const bool in = slot_legs(c, cid, j, self_cell, sh, sw, go, gn);
      if (w_raw < W) {
        // this slot's deltas new - old (zero where no leg is in range)
        T* d = static_cast<T*>(a.dlt)
             + ((((size_t)l * K + k) * CF + ci) * 10 * cap + j) * W + w;
        T dlo[10], dln[10];
        if (in) {
          leg_delta(go, dlo);
          leg_delta(gn, dln);
        }
#pragma unroll
        for (int f = 0; f < 10; ++f)
          d[(size_t)f * cap * W] = in ? dln[f] - dlo[f] : (T)0;
      }
      if (!in) continue;
      const size_t base = ((size_t)cid * PK_ROWS * cap + j) * W + w;
      T mj[10];
#pragma unroll
      for (int f = 0; f < 10; ++f) mj[f] = c.pk[base + (size_t)f * cap * W];
      if (go.in) {
        pair_o += go.pair;
        oo.add(go.w, go.ux, go.uy, go.uz);
        e3j_o += wing(go, mj, sw);
      }
      if (gn.in) {
        pair_n += gn.pair;
        on.add(gn.w, gn.ux, gn.uy, gn.uz);
        moved_moments(mj, go, gn);
        e3j_n += wing(gn, mj, sw);
      }
    }
  }

  // partial sums of this warp -> shared memory
  T* mine = red + (size_t)wy * NACC * 32;
  mine[0 * 32 + lane] = pair_o;
  mine[1 * 32 + lane] = pair_n;
  mine[2 * 32 + lane] = oo.w2;
  mine[3 * 32 + lane] = on.w2;
  mine[4 * 32 + lane] = e3j_o;
  mine[5 * 32 + lane] = e3j_n;
#pragma unroll
  for (int f = 0; f < 10; ++f) {
    mine[(6 + f) * 32 + lane] = oo.m[f];
    mine[(16 + f) * 32 + lane] = on.m[f];
  }
  __syncthreads();
  // each (sum, walker) pair is reduced by one thread, warps in order
  for (int i = wy * 32 + lane; i < NACC * 32; i += NW * 32) {
    T sum = red[i];
    for (int y = 1; y < NW; ++y) sum += red[(size_t)y * NACC * 32 + i];
    red[i] = sum;
  }
  __syncthreads();
  if (wy != 0 || w_raw >= W) return;

  T mo[10], mn[10];
#pragma unroll
  for (int f = 0; f < 10; ++f) {
    mo[f] = red[(6 + f) * 32 + lane];
    mn[f] = red[(16 + f) * 32 + lane];
  }
  const T e_old = red[0 * 32 + lane]
      + sw.lam_eps * (e3_closed_form(mo, red[2 * 32 + lane], sw)
                      + red[4 * 32 + lane]);
  const T e_new = red[1 * 32 + lane]
      + sw.lam_eps * (e3_closed_form(mn, red[3 * 32 + lane], sw)
                      + red[5 * 32 + lane]);
  // the layout of the chain kernel's point table (P = 2)
  T* e = static_cast<T*>(a.e) + ((size_t)l * K + k) * 2 * W + w;
  e[0] = e_old;
  e[W] = e_new;
  T* own = static_cast<T*>(a.own) + ((size_t)l * K + k) * 10 * W + w;
#pragma unroll
  for (int f = 0; f < 10; ++f) own[(size_t)f * W] = mn[f];
}

// A warp's pass over slots j0 + q nw (q < EN_SPW, below cap) of cell
// cid, copied into its ring stage [EN_SPW][4][32] (flag, x, y, z of this
// lane's walker) in two groups of copies: the occupied flags
// (energies_flags), then, once they have landed, the coordinates of the
// occupied slots only (energies_coords).  Each closes its group (empty
// where ``live`` is false).
template <typename T>
__device__ __forceinline__ void energies_flags(T* stage, const T* pk, int cid,
                                               int j0, int nw, bool live,
                                               int cap, int W, size_t row,
                                               int lane) {
  if (live) {
    const T* cell = pk + (size_t)cid * PK_ROWS * row + PK_VALID * row;
#pragma unroll
    for (int q = 0; q < EN_SPW; ++q) {
      const int j = j0 + q * nw;
      if (j < cap)
        cp_async_elem(stage + (q * 4) * 32 + lane, cell + (size_t)j * W);
    }
  }
  cp_async_commit();
}

template <typename T>
__device__ __forceinline__ void energies_coords(T* stage, const T* pk,
                                                int cid, int j0, int nw,
                                                bool live, int cap, int W,
                                                size_t row, int lane) {
  if (live) {
    const T* cell = pk + (size_t)cid * PK_ROWS * row + PK_R0 * row;
#pragma unroll
    for (int q = 0; q < EN_SPW; ++q) {
      const int j = j0 + q * nw;
      if (j < cap && stage[(q * 4) * 32 + lane] > (T)0.5) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          cp_async_elem(stage + (q * 4 + 1 + i) * 32 + lane,
                        cell + i * row + (size_t)j * W);
      }
    }
  }
  cp_async_commit();
}

// Dynamic shared memory of a mover_energies block of nw warps over CF
// candidate cells: the warps' rings [nw][EN_STAGES][EN_SPW][4][32],
// whose space then holds their partial sums [nw][NACC][32], the tile's
// context [6 + 3 CF][32] (old point, new point, the cells' image
// shifts) and the ranks [32].
template <typename T>
static size_t energies_smem_bytes(int nw, int CF) {
  const size_t ring = (size_t)nw * EN_STAGES * EN_SPW * 4 * 32;
  const size_t red = (size_t)nw * NACC * 32;
  return sizeof(T) * ((ring > red ? ring : red) + 32 * (6 + 3 * (size_t)CF))
         + sizeof(int) * 32;
}

// One block per (32-walker tile, mover k, lattice l); warp y of nw
// takes slots y + nw q (q < EN_SPW) of each candidate cell in turn, in
// ceil(cap / (nw EN_SPW)) passes a cell (ops/cell_kernels.
// energies_geometry mirrors the grid), streamed through its ring of
// EN_STAGES passes.
template <typename T>
__global__ void __launch_bounds__(32 * NW, 2)
mover_energies_kernel(const MoverArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, wy = threadIdx.y, nw = blockDim.y;
  const int tid = wy * 32 + lane, nthreads = nw * 32;
  const int W = a.W, K = a.K, CF = a.CF, cap = a.cap;
  const int k = blockIdx.y, l = blockIdx.z;
  const int span = nw * EN_SPW, ppc = (cap + span - 1) / span;
  const int n_st = CF * ppc;  // passes of this warp
  const size_t ring_sz = (size_t)nw * EN_STAGES * EN_SPW * 4 * 32;
  const size_t red_sz = (size_t)nw * NACC * 32;
  const int stage_sz = EN_SPW * 4 * 32;
  T* ring = reinterpret_cast<T*>(smem) + (size_t)wy * EN_STAGES * stage_sz;
  T* red = reinterpret_cast<T*>(smem);  // [nw][NACC][32], after the rings
  T* s_ctx = reinterpret_cast<T*>(smem) + (ring_sz > red_sz ? ring_sz
                                                            : red_sz);
  int* s_rank = reinterpret_cast<int*>(s_ctx + (size_t)(6 + 3 * CF) * 32);
  const int w_raw = blockIdx.x * 32 + lane;
  // ragged edge: lanes beyond W repeat the last walker and store nothing
  const int w = w_raw < W ? w_raw : W - 1;
  const size_t row = (size_t)cap * W;
  const T* pk = static_cast<const T*>(a.pk[l]) + w;
  const int* cand = static_cast<const int*>(a.cand) + (size_t)k * CF;
  const int fcell = __ldg(static_cast<const int*>(a.fc) + k);

  // the tile's context, loaded by warp 0 while the other warps start
  // their passes
  if (wy == 0) {
    MoverCtx<T> c;
    load_ctx(c, a, l, k, w);
    const int* off = static_cast<const int*>(a.off) + (size_t)k * CF * 3;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s_ctx[i * 32 + lane] = c.po[i];
      s_ctx[(3 + i) * 32 + lane] = c.pn[i];
    }
    for (int ci = 0; ci < CF; ++ci) {
      T sh[3];
      cell_shift(c, off + ci * 3, sh);
#pragma unroll
      for (int i = 0; i < 3; ++i) s_ctx[(6 + 3 * ci + i) * 32 + lane] = sh[i];
    }
    s_rank[lane] = c.rank;
  }

  // pass st of this warp: cell st / ppc, its slots from
  // (st % ppc) * span + wy.  Each pass commits the flags of pass st +
  // EN_FLAG_LEAD, waits for those of st + EN_COORD_LEAD, commits the
  // coordinates of that pass's occupied slots, and waits for those of
  // pass st; passes below 0 only start the pipeline
  auto flags = [&](int st) {
    const bool live = st < n_st;
    const int ci = ppc == 1 ? st : st / ppc;
    energies_flags(ring + (st % EN_STAGES) * stage_sz, pk,
                   live ? __ldg(cand + ci) : 0, (st - ci * ppc) * span + wy,
                   nw, live, cap, W, row, lane);
  };
  auto coords = [&](int st) {
    const bool live = st >= 0 && st < n_st;
    const int sc = live ? st : 0, ci = ppc == 1 ? sc : sc / ppc;
    energies_coords(ring + (sc % EN_STAGES) * stage_sz, pk,
                    live ? __ldg(cand + ci) : 0, (sc - ci * ppc) * span + wy,
                    nw, live, cap, W, row, lane);
  };
  for (int st = -EN_FLAG_LEAD; st < 0; ++st) {
    flags(st + EN_FLAG_LEAD);
    cp_async_wait_group<2 * (EN_FLAG_LEAD - EN_COORD_LEAD)>();
    coords(st + EN_COORD_LEAD);
  }
  __syncthreads();
  const SW<T> sw(a.sw);
  T po[3], pn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    po[i] = s_ctx[i * 32 + lane];
    pn[i] = s_ctx[(3 + i) * 32 + lane];
  }
  const int rank = s_rank[lane];

  Mom<T> oo, on;
  oo.zero();
  on.zero();
  T pair_o = 0, pair_n = 0, e3j_o = 0, e3j_n = 0;
  for (int st = 0; st < n_st; ++st) {
    flags(st + EN_FLAG_LEAD);
    cp_async_wait_group<2 * (EN_FLAG_LEAD - EN_COORD_LEAD)>();
    coords(st + EN_COORD_LEAD);
    const int ci = ppc == 1 ? st : st / ppc;
    const int j0 = (st - ci * ppc) * span + wy;
    const int cid = __ldg(cand + ci);
    const T* sh = s_ctx + (6 + 3 * ci) * 32 + lane;
    const T sx = sh[0], sy = sh[32], sz = sh[64];
    cp_async_wait_group<2 * EN_COORD_LEAD>();  // pass st has landed
    const T* b = ring + (st % EN_STAGES) * stage_sz + lane;
#pragma unroll
    for (int q = 0; q < EN_SPW; ++q) {
      const int j = j0 + q * nw;
      if (j >= cap) break;
      if (!(b[(q * 4) * 32] > (T)0.5)) continue;  // empty
      if (cid == fcell && j == rank) continue;     // the mover itself
      const T p[3] = {b[(q * 4 + 1) * 32] + sx, b[(q * 4 + 2) * 32] + sy,
                      b[(q * 4 + 3) * 32] + sz};
      const Leg<T> go = leg_at(p, po, sw);
      const Leg<T> gn = leg_at(p, pn, sw);
      if (!go.in && !gn.in) continue;
      const T* at = pk + ((size_t)cid * PK_ROWS * cap + j) * W;
      T mj[10];
#pragma unroll
      for (int f = 0; f < 10; ++f) mj[f] = __ldg(at + (size_t)f * row);
      if (go.in) {
        pair_o += go.pair;
        oo.add(go.w, go.ux, go.uy, go.uz);
        e3j_o += wing(go, mj, sw);
      }
      if (gn.in) {
        pair_n += gn.pair;
        on.add(gn.w, gn.ux, gn.uy, gn.uz);
        moved_moments(mj, go, gn);
        e3j_n += wing(gn, mj, sw);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every ring is drained: its space takes the sums

  // partial sums of this warp -> shared memory
  T* mine = red + (size_t)wy * NACC * 32;
  mine[0 * 32 + lane] = pair_o;
  mine[1 * 32 + lane] = pair_n;
  mine[2 * 32 + lane] = oo.w2;
  mine[3 * 32 + lane] = on.w2;
  mine[4 * 32 + lane] = e3j_o;
  mine[5 * 32 + lane] = e3j_n;
#pragma unroll
  for (int f = 0; f < 10; ++f) {
    mine[(6 + f) * 32 + lane] = oo.m[f];
    mine[(16 + f) * 32 + lane] = on.m[f];
  }
  __syncthreads();
  // each (sum, walker) pair is reduced by one thread, warps in order
  for (int i = tid; i < NACC * 32; i += nthreads) {
    T sum = red[i];
    for (int y = 1; y < nw; ++y) sum += red[(size_t)y * NACC * 32 + i];
    red[i] = sum;
  }
  __syncthreads();
  if (wy != 0 || w_raw >= W) return;

  T mo[10], mn[10];
#pragma unroll
  for (int f = 0; f < 10; ++f) {
    mo[f] = red[(6 + f) * 32 + lane];
    mn[f] = red[(16 + f) * 32 + lane];
  }
  const T e_old = red[0 * 32 + lane]
      + sw.lam_eps * (e3_closed_form(mo, red[2 * 32 + lane], sw)
                      + red[4 * 32 + lane]);
  const T e_new = red[1 * 32 + lane]
      + sw.lam_eps * (e3_closed_form(mn, red[3 * 32 + lane], sw)
                      + red[5 * 32 + lane]);
  // the layout of the chain kernel's point table (P = 2)
  T* e = static_cast<T*>(a.e) + ((size_t)l * K + k) * 2 * W + w;
  e[0] = e_old;
  e[W] = e_new;
  T* own = static_cast<T*>(a.own) + ((size_t)l * K + k) * 10 * W + w;
#pragma unroll
  for (int f = 0; f < 10; ++f) own[(size_t)f * W] = mn[f];
}

// The occupied flags and coordinates of slots j0 + q nw (q < APPLY_SPW)
// of a cell (slot j at cell[j * W], rows ``row`` apart), loaded together;
// a slot beyond cap reads as empty.
template <typename T>
__device__ __forceinline__ void apply_slots(const T* cell, int j0, int nw,
                                            int cap, int W, size_t row,
                                            T valid[APPLY_SPW],
                                            T cj[APPLY_SPW][3]) {
#pragma unroll
  for (int q = 0; q < APPLY_SPW; ++q) {
    const int j = j0 + q * nw;
    const T* at = cell + (size_t)(j < cap ? j : 0) * W;
    valid[q] = j < cap ? at[PK_VALID * row] : (T)0;
#pragma unroll
    for (int i = 0; i < 3; ++i) cj[q][i] = at[(PK_R0 + i) * row];
  }
}

// One block per (32-walker tile, mover k and candidate cell ci, lattice
// l); warp y of nw takes the cell's slots y + nw (q + APPLY_SPW i)
// (ops/cell_kernels.apply_geometry mirrors the split).  At most 64
// registers a thread, so that four blocks share an SM.
template <typename T>
__global__ void __launch_bounds__(32 * NW, 4)
mover_apply_kernel(const MoverArgs a) {
  // what the tile's walkers need of their mover, loaded once by warp 0:
  // the accept flag, the old and the new point, the cell's image shift
  __shared__ T s_ctx[10][32];
  __shared__ int s_rank[32];
  const int lane = threadIdx.x, wy = threadIdx.y, nw = blockDim.y;
  const int W = a.W, K = a.K, CF = a.CF, cap = a.cap;
  const int k = blockIdx.y / CF, ci = blockIdx.y - k * CF, l = blockIdx.z;
  const int w_raw = blockIdx.x * 32 + lane;
  // ragged edge: lanes beyond W repeat the last walker and store nothing
  const int w = w_raw < W ? w_raw : W - 1;
  const int cid = __ldg(static_cast<const int*>(a.cand) + (size_t)k * CF + ci);
  const bool self_cell = cid == __ldg(static_cast<const int*>(a.fc) + k);
  const size_t row = (size_t)cap * W;
  T* cell = static_cast<T*>(a.pk[l]) + (size_t)cid * PK_ROWS * row + w;

  // the flags and coordinates of this warp's first slots, in flight
  // while warp 0 loads the tile's context
  T valid[APPLY_SPW], cj[APPLY_SPW][3];
  apply_slots(cell, wy, nw, cap, W, row, valid, cj);
  if (wy == 0) {
    MoverCtx<T> c;
    load_ctx(c, a, l, k, w);
    T sh[3];
    cell_shift(c, static_cast<const int*>(a.off) + ((size_t)k * CF + ci) * 3,
               sh);
    s_ctx[0][lane] = static_cast<const T*>(a.accf)[(size_t)k * a.acc_stride
                                                   + w];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s_ctx[1 + i][lane] = c.po[i];
      s_ctx[4 + i][lane] = c.pn[i];
      s_ctx[7 + i][lane] = sh[i];
    }
    s_rank[lane] = c.rank;
  }
  __syncthreads();
  if (w_raw >= W || !(s_ctx[0][lane] > (T)0.5))
    return;  // rejected: the slab stays as it is
  const SW<T> sw(a.sw);
  T po[3], pn[3], sh[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    po[i] = s_ctx[1 + i][lane];
    pn[i] = s_ctx[4 + i][lane];
    sh[i] = s_ctx[7 + i][lane];
  }
  const int rank = s_rank[lane];

  for (int j0 = wy;;) {
#pragma unroll
    for (int q = 0; q < APPLY_SPW; ++q) {
      const int j = j0 + q * nw;
      T* at = cell + (size_t)j * W;
      // (every row is read before any is written: the compiler cannot
      // tell the rows apart, and would otherwise wait for each read in
      // turn)
      T m[10];
      if (self_cell && j == rank) {
        // the mover's own slot: new own moments, new position
        const T* own = static_cast<const T*>(a.own)
                     + ((size_t)l * K + k) * 10 * W + w;
#pragma unroll
        for (int f = 0; f < 10; ++f) m[f] = own[(size_t)f * W];
#pragma unroll
        for (int f = 0; f < 10; ++f) at[f * row] = m[f];
#pragma unroll
        for (int i = 0; i < 3; ++i) at[(PK_R0 + i) * row] = pn[i];
        continue;
      }
      if (!(valid[q] > (T)0.5)) continue;  // empty (or beyond cap)
      const T p[3] = {cj[q][0] + sh[0], cj[q][1] + sh[1], cj[q][2] + sh[2]};
      const Leg<T> go = leg_at(p, po, sw);
      const Leg<T> gn = leg_at(p, pn, sw);
      if (!go.in && !gn.in) continue;
#pragma unroll
      for (int f = 0; f < 10; ++f) m[f] = at[f * row];
      T dlo[10], dln[10];
      leg_delta(go, dlo);
      leg_delta(gn, dln);
#pragma unroll
      for (int f = 0; f < 10; ++f) at[f * row] = m[f] + (dln[f] - dlo[f]);
    }
    j0 += nw * APPLY_SPW;
    if (j0 >= cap) break;
    apply_slots(cell, j0, nw, cap, W, row, valid, cj);
  }
}

// ---------------------------------------------------------------------
// mover_points: the multi-trial sub-step's energies at P points.
//
// What bounds it on the H100: bytes, then latency.  The stencil is read
// as by mover_energies (every candidate slot's flag, the coordinates of
// the occupied ones, the moment rows of the slots in range of some
// point) and ONCE for all P points; only the ~13 slots in range of a
// point cost a leg and a wing term there.
//
// Its first design (a block per (32-walker tile, mover, lattice), 7
// warps at P = 9 each walking 27 cells x 5 slots one after another and
// keeping its P x 13 running sums per lane in shared memory) took 0.154
// ms per launch at K=8, CF=27, cap=32, T=8, W=128 in f32 on an H100 80GB
// HBM3 at 700 W, against a bound of 0.0056 ms: 64 blocks on 132 SMs,
// and each slot's loads issued only after the previous slot's branch
// resolved.
//
// Design: the grid also runs over groups of ``cpg`` candidate cells, a
// block per (walker tile, mover x cell group, lattice)
// (ops/cell_kernels.points_geometry mirrors it): 576 blocks at that
// shape.  The block stages its group's slots in shared memory: every
// thread issues the flag copies of its slots together (cp.async), then,
// once they have landed, the coordinates of its occupied slots only,
// and lists the slots within rc + (the farthest point's distance from
// point 0) of point 0 (by the triangle inequality, every slot in range
// of some point is among them).  Each warp then owns points t = wy, wy
// + nw, ... and keeps that point's 13 sums (pair, w^2, wing, own
// moments) in registers while it walks its lane's near slots (every
// staging thread's list in turn): the warp takes its lanes' n-th near
// slots together, whatever slots they are.  Lane = walker, and each
// walker packs its cells in its own slot order, so walking the slots
// themselves diverged: for nearly every occupied slot some lane was in
// range, and the warp paid the leg arithmetic for it (0.071 ms without
// the lists, 0.054 with them).  A near slot in range of the point
// reads its ten moment rows.  The group's sums go to a scratch buffer
// [L, K, groups, P, 13, W]; the last block of a (tile, mover, lattice)
// to finish (an atomic ticket after __threadfence, reset by that block)
// adds the groups in index order, their loads in flight together, and
// writes e and own, so the result does not depend on which block
// finishes last, in one launch.  At least 8 warps stage (T = 2 and 4
// have fewer points than that), at most 9; at most 72 registers in f32,
// so that three blocks share an SM.  The arithmetic per leg is the
// first design's; only the order of the sums over slots changed.
// ---------------------------------------------------------------------

constexpr int NPA = 13;  // per point: pair, w^2, wing, own moments [10]
constexpr int PT_WARPS_MAX = 9;

// Mirror of the ctypes structure PointsArgs in ops/cell_kernels.py.
struct PointsArgs {
  void* pk[2];  // per lattice [nfine, 14, cap, W]
  void* h;      // [L,3,3,W]
  void* cand;   // [K,CF] int32 candidate fine cells
  void* off;    // [K,CF,3] int32 wrap offsets
  void* fc;     // [K] int32 movers' fine cells
  void* rank;   // [K,W] int32 movers' slot ranks
  void* pts;    // [P,L,3,K,W] evaluation points (point 0 = stored)
  void* e;      // [L,K,P,W] out: the chain kernel's point table
  void* own;    // [L,K,P,10,W] out: own moments at every point
  int L, K, CF, cap, W, P, nw;
  SWConsts sw;
  void* part;   // [L,K,ng,P,NPA,W] scratch: the groups' sums
  int* ticket;  // [L,K,tiles] blocks done; 0 between launches
  int cpg, ng;  // candidate cells per group, groups per mover
};

// At most 72 registers a thread in f32, so that three blocks of 9 warps
// share an SM.
template <typename T>
__global__ void __launch_bounds__(32 * PT_WARPS_MAX, sizeof(T) == 4 ? 3 : 2)
mover_points_kernel(const PointsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int P = a.P, nw = a.nw, cpg = a.cpg, ng = a.ng;
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int W = a.W, K = a.K, L = a.L, CF = a.CF, cap = a.cap;
  const int k = blockIdx.y / ng, g = blockIdx.y - k * ng, l = blockIdx.z;
  const int c0 = g * cpg, nc = min(cpg, CF - c0), nslot = nc * cap;
  const int qmax = (cpg * cap + nw - 1) / nw;  // slots a thread stages
  T* s_flag = reinterpret_cast<T*>(smem);             // [cpg cap][32]
  T* s_xyz = s_flag + (size_t)cpg * cap * 32;         // [cpg cap][3][32]
  T* s_sh = s_xyz + (size_t)cpg * cap * 3 * 32;       // [cpg][3][32]
  T* s_d2 = s_sh + (size_t)cpg * 3 * 32;              // [nw][32]
  int* s_cnt = reinterpret_cast<int*>(s_d2 + (size_t)nw * 32);  // [nw][32]
  unsigned short* s_near =
      reinterpret_cast<unsigned short*>(s_cnt + nw * 32);  // [nw][qmax][32]
  const int w_raw = blockIdx.x * 32 + lane;
  // ragged edge: lanes beyond W repeat the last walker and store nothing
  const int w = w_raw < W ? w_raw : W - 1;
  const size_t row = (size_t)cap * W;
  const T* pk = static_cast<const T*>(a.pk[l]) + w;
  const int* cand = static_cast<const int*>(a.cand) + (size_t)k * CF + c0;

  // the flags of this thread's slots s = wy + nw q (cell s / cap, slot
  // s % cap), all in flight together, then the coordinates of the
  // occupied ones
  for (int s = wy; s < nslot; s += nw) {
    const int ci = s / cap, j = s - ci * cap;
    cp_async_elem(s_flag + (size_t)s * 32 + lane,
                  pk + ((size_t)__ldg(cand + ci) * PK_ROWS + PK_VALID) * row
                      + (size_t)j * W);
  }
  cp_async_commit();
  const SW<T> sw(a.sw);
  const int rank = __ldg(static_cast<const int*>(a.rank) + (size_t)k * W + w);
  const int fcell = __ldg(static_cast<const int*>(a.fc) + k);
  const int* off = static_cast<const int*>(a.off) + ((size_t)k * CF + c0) * 3;
  const T* pts = static_cast<const T*>(a.pts);
  auto point = [&](int t, T p[3]) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      p[i] = pts[(((size_t)t * L + l) * 3 + i) * K * W + (size_t)k * W + w];
  };
  T p0[3];
  point(0, p0);
  T reach2;  // a slot in range of any point is within this of point 0
  {
    MoverCtx<T> c;  // for cell_shift: the cell matrix
    const T* h = static_cast<const T*>(a.h);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        c.H[i][j] = h[((size_t)(l * 3 + i) * 3 + j) * W + w];
    if (wy == 0) {
      for (int ci = 0; ci < nc; ++ci) {
        T sh[3];
        cell_shift(c, off + ci * 3, sh);
#pragma unroll
        for (int i = 0; i < 3; ++i) s_sh[(ci * 3 + i) * 32 + lane] = sh[i];
      }
    }
    // the farthest point from point 0, squared: each warp its own
    // points, then the block's maximum (the flags are in flight)
    T d2 = (T)0;
    for (int t = wy; t < P; t += nw) {
      T pt[3];
      point(t, pt);
      const T d[3] = {pt[0] - p0[0], pt[1] - p0[1], pt[2] - p0[2]};
      d2 = fmax(d2, d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    }
    s_d2[wy * 32 + lane] = d2;
    __syncthreads();
    for (int y = 0; y < nw; ++y) d2 = fmax(d2, s_d2[y * 32 + lane]);
    // (triangle inequality, widened far beyond round-off)
    const T reach = sw.rc + sqrt(d2);
    reach2 = reach * reach * (T)1.001;
    cp_async_wait_all();
    for (int s = wy; s < nslot; s += nw) {
      if (!(s_flag[(size_t)s * 32 + lane] > (T)0.5)) continue;
      const int ci = s / cap, j = s - ci * cap;
      const T* at = pk + ((size_t)__ldg(cand + ci) * PK_ROWS + PK_R0) * row
                    + (size_t)j * W;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        cp_async_elem(s_xyz + ((size_t)s * 3 + i) * 32 + lane, at + i * row);
    }
    cp_async_commit();
    cp_async_wait_all();
    // this thread's occupied slots near point 0 (not the mover itself),
    // in order: the points' warps take only these
    int n = 0;
    int ci_sh = -1;
    T sh[3];
    for (int s = wy; s < nslot; s += nw) {
      if (!(s_flag[(size_t)s * 32 + lane] > (T)0.5)) continue;
      const int ci = s / cap, j = s - ci * cap;
      if (__ldg(cand + ci) == fcell && j == rank) continue;  // the mover
      if (ci != ci_sh) {
        cell_shift(c, off + ci * 3, sh);
        ci_sh = ci;
      }
      const T* xyz = s_xyz + (size_t)s * 3 * 32 + lane;
      const T d[3] = {xyz[0] + sh[0] - p0[0], xyz[32] + sh[1] - p0[1],
                      xyz[64] + sh[2] - p0[2]};
      if (d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < reach2)
        s_near[((size_t)wy * qmax + n++) * 32 + lane] = (unsigned short)s;
    }
    s_cnt[wy * 32 + lane] = n;
  }
  __syncthreads();

  T* part = static_cast<T*>(a.part)
          + ((size_t)(l * K + k) * ng + g) * P * NPA * W + w;
  for (int t = wy; t < P; t += nw) {
    T pt[3];
    point(t, pt);
    T acc[NPA];
#pragma unroll
    for (int f = 0; f < NPA; ++f) acc[f] = (T)0;
    // the near slots of this lane, every staging thread's list in turn:
    // the warp takes its lanes' n-th slots together, whatever they are
    int total = 0;
    for (int y = 0; y < nw; ++y) total += s_cnt[y * 32 + lane];
    const int n_max = __reduce_max_sync(0xffffffffu, total);
    for (int n = 0, y = 0, q = 0; n < n_max; ++n) {
      if (n >= total) continue;
      while (q >= s_cnt[y * 32 + lane]) {
        ++y;
        q = 0;
      }
      const int s = s_near[((size_t)y * qmax + q++) * 32 + lane];
      const int ci = s / cap, j = s - ci * cap;
      const T* xyz = s_xyz + (size_t)s * 3 * 32 + lane;
      const T* sh = s_sh + ci * 3 * 32 + lane;
      const T cj[3] = {xyz[0] + sh[0], xyz[32] + sh[32], xyz[64] + sh[64]};
      // leg_at(cj, pt), its moment rows requested before its arithmetic
      const T d[3] = {cj[0] - pt[0], cj[1] - pt[1], cj[2] - pt[2]};
      const T r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      if (!(r2 < sw.rc2)) continue;
      T mj[10];
      const T* at = pk + (size_t)__ldg(cand + ci) * PK_ROWS * row
                  + (size_t)j * W;
#pragma unroll
      for (int f = 0; f < 10; ++f) mj[f] = __ldg(at + (size_t)f * row);
      const Leg<T> gl = leg_in_range(d, r2, sw);
      acc[0] += gl.pair;
      acc[1] += gl.w * gl.w;
      if (t == 0) {
        acc[2] += wing(gl, mj, sw);
      } else {
        // world(t): the neighbour's moments with the mover's leg moved
        // from point 0 to point t
        moved_moments(mj, leg_at(cj, p0, sw), gl);
        acc[2] += wing(gl, mj, sw);
      }
      const T wux = gl.w * gl.ux, wuy = gl.w * gl.uy, wuz = gl.w * gl.uz;
      acc[3] += gl.w;
      acc[4] += wux;
      acc[5] += wuy;
      acc[6] += wuz;
      acc[7] += wux * gl.ux;
      acc[8] += wuy * gl.uy;
      acc[9] += wuz * gl.uz;
      acc[10] += wux * gl.uy;
      acc[11] += wux * gl.uz;
      acc[12] += wuy * gl.uz;
    }
    if (w_raw < W) {
#pragma unroll
      for (int f = 0; f < NPA; ++f)
        part[((size_t)t * NPA + f) * W] = acc[f];
    }
  }

  // the last block of this (tile, mover, lattice) adds the groups in
  // index order
  __threadfence();
  __syncthreads();
  int* ticket = a.ticket + ((size_t)l * K + k) * gridDim.x + blockIdx.x;
  if (wy == 0 && lane == 0) {
    const int done = atomicAdd(ticket, 1);
    s_last = done == ng - 1;
    if (s_last) *ticket = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!s_last || w_raw >= W) return;
  __threadfence();
  const T* first = static_cast<const T*>(a.part)
                 + (size_t)(l * K + k) * ng * P * NPA * W + w;
  for (int t = wy; t < P; t += nw) {
    // the 13 sums of point t over the groups, in group order, three
    // groups' loads in flight at a time
    T r[NPA];
#pragma unroll
    for (int f = 0; f < NPA; ++f) r[f] = (T)0;
    for (int g0 = 0; g0 < ng; g0 += 3) {
      T v[3][NPA];
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int f = 0; f < NPA; ++f)
          v[b][f] = g0 + b < ng
              ? __ldcg(first + (((size_t)(g0 + b) * P + t) * NPA + f) * W)
              : (T)0;
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int f = 0; f < NPA; ++f)
          if (g0 + b < ng) r[f] += v[b][f];
    }
    T m[10];
#pragma unroll
    for (int f = 0; f < 10; ++f) m[f] = r[3 + f];
    const T e_t = r[0] + sw.lam_eps * (e3_closed_form(m, r[1], sw) + r[2]);
    static_cast<T*>(a.e)[(((size_t)l * K + k) * P + t) * W + w] = e_t;
    T* own = static_cast<T*>(a.own) + (((size_t)l * K + k) * P + t) * 10 * W + w;
#pragma unroll
    for (int f = 0; f < 10; ++f) own[(size_t)f * W] = m[f];
  }
}

// (grid, block, dynamic shared bytes) of a mover_points launch, or
// false for a plan it does not take.
template <typename T>
static bool points_geometry(const PointsArgs* a, dim3& grid, dim3& block,
                            size_t& smem) {
  if (a->nw < 1 || a->nw > PT_WARPS_MAX || a->cpg < 1 || a->ng < 1
      || (long long)a->cpg * a->ng < a->CF
      || (long long)a->cpg * (a->ng - 1) >= a->CF
      || (long long)a->K * a->ng > 65535 || (long long)a->cpg * a->cap > 65535)
    return false;
  grid = dim3((a->W + 31) / 32, a->K * a->ng, a->L);
  block = dim3(32, a->nw);
  const size_t qmax = ((size_t)a->cpg * a->cap + a->nw - 1) / a->nw;
  smem = sizeof(T) * 32 * (4 * (size_t)a->cpg * a->cap + 3 * (size_t)a->cpg
                           + a->nw)
       + sizeof(int) * 32 * a->nw + sizeof(unsigned short) * 32 * a->nw * qmax;
  return true;
}

template <typename T>
static int launch_points(const PointsArgs* a, cudaStream_t stream) {
  dim3 grid, block;
  size_t smem;
  if (!points_geometry<T>(a, grid, block, smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mover_points_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mover_points_kernel<T><<<grid, block, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// out = {registers per thread, local (spill) bytes per thread, blocks
// resident on one SM, dynamic shared bytes per block, blocks} of a
// mover_points launch (only its shape and plan are read).
template <typename T>
static int points_occupancy(const PointsArgs* a, int* out) {
  dim3 grid, block;
  size_t smem;
  if (!points_geometry<T>(a, grid, block, smem))
    return (int)cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(mover_points_kernel<T>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, (int)(block.x * block.y), smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = per_sm;
  out[3] = (int)smem;
  out[4] = (int)(grid.x * grid.y * grid.z);
  return (int)err;
}

template <typename T>
static int launch_energies_deltas(const MoverArgs* a, cudaStream_t stream) {
  if (a->dlt == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * NW * NACC * 32;
  cudaError_t err = cudaFuncSetAttribute(
      mover_energies_deltas_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a->W + 31) / 32, a->K, a->L), block(32, NW);
  mover_energies_deltas_kernel<T><<<grid, block, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// (grid, block, dynamic shared bytes) of a mover_energies launch, or
// false for a block it does not take.
template <typename T>
static bool energies_geometry(const MoverArgs* a, dim3& grid, dim3& block,
                              size_t& smem) {
  if (a->en_warps < 1 || a->en_warps > NW) return false;
  grid = dim3((a->W + 31) / 32, a->K, a->L);
  block = dim3(32, a->en_warps);
  smem = energies_smem_bytes<T>(a->en_warps, a->CF);
  return true;
}

template <typename T>
static int launch_energies(const MoverArgs* a, cudaStream_t stream) {
  dim3 grid, block;
  size_t smem;
  if (!energies_geometry<T>(a, grid, block, smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mover_energies_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mover_energies_kernel<T><<<grid, block, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// out = {registers per thread, local (spill) bytes per thread, blocks
// resident on one SM, dynamic shared bytes per block, blocks} of a
// mover_energies launch (only its shape and warps are read).
template <typename T>
static int energies_occupancy(const MoverArgs* a, int* out) {
  dim3 grid, block;
  size_t smem;
  if (!energies_geometry<T>(a, grid, block, smem))
    return (int)cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(mover_energies_kernel<T>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, (int)(block.x * block.y), smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = per_sm;
  out[3] = (int)smem;
  out[4] = (int)(grid.x * grid.y * grid.z);
  return (int)err;
}

template <typename T>
static int launch_apply(const MoverArgs* a, cudaStream_t stream) {
  if (a->apply_warps < 1 || a->apply_warps > NW
      || (long long)a->K * a->CF > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a->W + 31) / 32, a->K * a->CF, a->L),
      block(32, a->apply_warps);
  mover_apply_kernel<T><<<grid, block, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" {

int mover_energies_f32(const MoverArgs* a, void* stream) {
  return launch_energies<float>(a, (cudaStream_t)stream);
}

int mover_energies_f64(const MoverArgs* a, void* stream) {
  return launch_energies<double>(a, (cudaStream_t)stream);
}

int mover_energies_occupancy(int f64, const MoverArgs* a, int* out) {
  return f64 ? energies_occupancy<double>(a, out)
             : energies_occupancy<float>(a, out);
}

int mover_energies_deltas_f32(const MoverArgs* a, void* stream) {
  return launch_energies_deltas<float>(a, (cudaStream_t)stream);
}

int mover_energies_deltas_f64(const MoverArgs* a, void* stream) {
  return launch_energies_deltas<double>(a, (cudaStream_t)stream);
}

int mover_apply_f32(const MoverArgs* a, void* stream) {
  return launch_apply<float>(a, (cudaStream_t)stream);
}

int mover_apply_f64(const MoverArgs* a, void* stream) {
  return launch_apply<double>(a, (cudaStream_t)stream);
}

int mover_points_f32(const PointsArgs* a, void* stream) {
  return launch_points<float>(a, (cudaStream_t)stream);
}

int mover_points_f64(const PointsArgs* a, void* stream) {
  return launch_points<double>(a, (cudaStream_t)stream);
}

int mover_points_occupancy(int f64, const PointsArgs* a, int* out) {
  return f64 ? points_occupancy<double>(a, out)
             : points_occupancy<float>(a, out);
}

}  // extern "C"
