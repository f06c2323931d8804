// One cycle of the lattice-switch sampler for every walker: all
// translations, switch attempts and per-move Wang-Landau or
// unbiased-histogram updates of the cycle.  Three branches, one per
// branch of the TPU kernel, all one warp per walker
// (fused_warp_kernel<T, BR, SL, NL, EXT>):
//
// * fused_cycle (BR = TABLE): static neighbour tables, one trial per
//   move (the shared molecule schedule, the displacement wall);
// * fused_cycle_dense (BR = DENSE): dense candidates (no tables): each
//   walker moves its own molecule and every molecule under every folded
//   image shift is a candidate, no wall;
// * fused_cycle_multi (BR = MULTI): static tables, T > 1 anchored-window
//   trials per shared mover on one fetch of its table rows.
//
// Replaces the TPU kernel FusedCycle._kernel with its branches
// _do_translation_tbl, _do_translation and _do_translation_tbl_multi
// (mc_water_ls_mw_tpu/mcmc/fused.py), which keep a 128-walker block's
// state in VMEM and express every gather as a one-hot contraction.
// Plain versions: FusedCycle.plain in mcmc/fused.py, loops over the
// steps that call the engine's own steps (Engine._translation_tbl,
// _translation, _translation_tbl_multi) and switch.
//
// What bounds them on the H100: latency.  Each walker's chain is a
// sequence of N dependent steps.  A table step reads the scheduled
// molecule's ~28 table partners in both lattices (3 coordinates, then
// 10 moments of the partners in range) and does a few 10^3 operations;
// a dense step tests all N molecules under S shifts at both points
// (N/M times the operations).  Neither the bytes (~229 MB per cycle at
// N=216, W=4096 in f32) nor the operations (~6*10^9) come near the
// card's limits (0.09 ms): the time is the length of one walker's chain
// of dependent loads and arithmetic, divided by how many chains the
// card runs at once.
//
// The first design (one thread per walker, the state in device memory
// in the walker-last layout, 128-thread blocks) took 22.9 ms per cycle
// (table) and 211 ms (dense, S=1) at N=216, W=4096 in f32 on an H100
// 80GB HBM3 at 700 W (scripts/bench_torch_fused.py): 32 blocks on 132
// SMs, ~112 dependent device-memory round trips per table step, and in
// the dense kernel a warp of 32 walkers paid the leg and wing work of a
// candidate wherever one of them had it in range.
//
// This design (table and dense branches): one warp per walker, the
// walker's state in shared memory for the whole cycle.  On the same card
// it takes 4.7-4.8 ms per table cycle (4.8x) and 11.3-11.5 ms per dense
// cycle at S=1 (18.6x), 2.7-2.8 ms at N=48, S=3 (5.8x).  What bounds it
// now is still latency: a table step of one walker takes ~5.5 us (its
// chain of dependent arithmetic, shuffles and shared and L2 loads), and
// an SM holds only 8 such chains (219 registers a thread in f32; the
// states of 10 walkers fill its shared memory), so W=4096 runs in 4
// waves of ~1.2 ms (a wave of 6-walker blocks takes ~1.1 ms).
//
// * Lanes: the table slots of the scheduled molecule map one to a lane
//   (slot m on lane m mod 32), the same slot of both lattices on one
//   lane, computed without branches (a leg out of range adds exact
//   zeros), so the two lattices' work interleaves; the dense candidates
//   j are strided over the lanes, first as cheap in-range tests only: a
//   ballot compacts the rows with a leg in range of either point into a
//   per-walker list in shared memory, and the lanes then share that
//   short list for the leg, wing and moment work (the centre's own
//   images as before).  Each lane sums its partners' pair terms, moments
//   and wing terms for the old and new points; the warp reduces the 26
//   sums of a lattice with xor shuffles in recursive halving (each level
//   keeps half of the values, 31 shuffles for 32 values, then one
//   broadcast shuffle per value, in place of a butterfly's 5 per value):
//   every lane ends with the same bits and takes the same accept
//   decision, WL lookup and switch.  Lane 0 alone writes the WL arrays
//   and trans_per_mol, with fire-and-forget atomics (one writer per
//   entry, so they round as a plain +=).  eta(mu) of the current point
//   is carried from step to step while the weight view cannot change (a
//   sample run, or no WL update).  An accepted move's rewrite of the
//   partners' rows is spread over the lanes as well.
// * Shared memory: r [2,3,N] and the moments [10,2,N] of the block's
//   walkers are staged once from the walker-last device layout
//   (coalesced over the block's walkers) into a walker-contiguous layout
//   and written back once at the end; all N steps run out of shared
//   memory (26*N values a walker: 22.5 KB at N=216 in f32).  The
//   walkers per block (warps) come from that budget and the kernels'
//   register bound (mcmc/fused.launch_plan: 8 in f32, 5 in f64 at
//   N=216).  Where even one walker's state does not fit, the same body
//   runs on the device layout (accessors over a base pointer and a
//   stride).  The tables, frac0, the WL arrays and the uniforms stay in
//   device memory: the table row and frac0 of a step are the same for
//   every walker (L1 hits), the WL arrays and uniforms are touched once
//   per step, the next step's uniforms loaded ahead.
//
// The multi-trial branch runs on the same warps and the same staged
// state.  The first design (one thread per walker, 128-thread blocks,
// the tables in shared memory) re-read the mover's rows for every trial
// and took 13.1 ms per cycle at N=216, T=8, W=4096 in f32 on the same
// card: 32 blocks on 132 SMs.  Here a mover's rows are read once: every
// trial point's energy depends only on the original rows (the JAX
// branch's eff_t = st - d0 + dt against the rows it gathered once), so
// each lane keeps its slots' coordinates and moments less the point-0
// leg (st - d0) in registers for all T + 1 points, and the accept / WL
// chain over the trials runs on broadcast scalars.  The two lattices'
// 13 sums of a point are reduced together; each half of the warp then
// gathers one lattice's sums and computes its energy, so lane 16 l + f
// holds the centre's moment f in lattice l (kept for the accepted
// point).  The store recomputes the rows of the last accepted point
// from the same registers, or is skipped when no trial was accepted.
// The points are evaluated in the chain's order, each just before its
// decision: a switch accepted between two trials changes the active
// lattice, and with it the later trials' points (Engine._map_disp).  On
// the same card this takes 4.3 ms per cycle at T=8 (3.2x), 4.2 ms at
// T=4 (3.8x) and 4.6 ms at T=2 (4.3x), 214 registers in f32 and 8
// walkers a block as above: a trial (its point, then the decision, the
// WL update and the bookkeeping, a chain of dependent arithmetic,
// shuffles and L2 loads) takes ~4.4 us of one walker's warp.
//
// All are built without FMA contraction (cuda_build.py), so each step
// rounds as the plain version's elementwise ops do; the warp sums add in
// another order than the plain versions, so float32 accept decisions
// within round-off of their threshold can come out otherwise.  A row
// with no leg in range of either point keeps st - 0 + 0 = st exactly and
// is not written.
//
// Instantiations.  The two-lattice plain settings (NPT, no MINU, no
// leshift, the plain WL factor) are fused_cycle.cu's fused_cycle,
// fused_cycle_dense and fused_cycle_multi (NL = 2, EXT = false).
// fused_cycle_variants.cu holds the rest, each a path of its own:
// * NL = 1 (fused_cycle_1l, fused_cycle_dense_1l): one lattice, the
//   single-box NPT run: the state of one lattice (13 N values a
//   walker), a move's own Boltzmann factor, no mu, no WL update, no
//   switch; the proposal is the active lattice's displacement alone;
// * EXT = true at two lattices (fused_cycle_ext, fused_cycle_dense_ext,
//   fused_cycle_multi_ext): MINU (a switch to the lattice of the lower
//   trial enthalpy folded into each translation), NVT (no PV or
//   volume-entropy terms in the switch), leshift (the reference
//   enthalpies in mu and in the switch) and the Swetnam and 1/t f
//   schedules, runtime fields of FusedArgs.  Swetnam's f reads the
//   walker's whole histogram at each update: its B bins are strided
//   over the lanes and summed by an xor butterfly (warp_f_schedule).
// The extended settings stay out of the plain instantiations (if
// constexpr), so those keep their registers and code.
//
// In-place: r, mom, e, wgt, hist, uh, tpm, wf and wi are updated where
// they lie.
#pragma once

#include <cstdint>

#include "sw_common.cuh"
#include "wl_common.cuh"

namespace {

constexpr int TRANS = 0, SWITCH = 2;
constexpr int WF_MU = 0, WF_F = 1, WF_SUMHIST = 2, WF_MIN_DMU = 3,
              WF_MAX_DMU = 4, WF_MAX_TRANS = 5, WF_MU_MIN = 6, WF_MU_MAX = 7;
constexpr int WI_LS = 0, WI_ATT = 1, WI_ACC = 4, WI_START = 7, WI_END = 8,
              WI_INWIN = 9, WI_INVT = 10;

}  // namespace

// Mirror of the ctypes structure FusedArgs in mcmc/fused.py.
struct FusedArgs {
  void* r;      // [L,3,N,W]
  void* mom;    // [10,L,N,W]
  void* e;      // [L,W]
  void* wgt;    // [B,W]
  void* hist;   // [B,W]
  void* uh;     // [B,W] (sample run only, else null)
  void* tpm;    // [N,W] int32
  void* wf;     // [8,W]
  void* wi;     // [11,W] int32
  void* h;      // [L,3,3,W]
  void* recip;  // [L,3,3,W]
  void* vol;    // [L,W]
  void* cu;     // [N/T,n_u,W] pre-drawn uniforms (n_u = 7, or 4+5T)
  void* binw;   // [B]
  void* mub;    // [B]
  void* basew;  // [B,W] master weight view per walker
  void* sched;   // int32: the move codes [N], then the molecule
                 // schedule [N/T] (table modes only)
  void* tbl;     // [L*N*M] int32, (l*N + imol)*M + m, sentinel N
                 // (table modes, else null)
  void* frac0;   // [L*3*N], (l*3 + a)*N + imol (table modes, else null)
  void* shifts;  // [S*3] int32 folded image shifts, the null shift first
  int N, W, B, M, S, T;
  int wl_active, switch_ok, samplerun, eta_interp, dd_seeding, do_switch,
      always_switch;
  double beta, betaP, pressure, nwater, log_norm, wall2, av_bw;
  double cpos, cneg, a_pos, a_neg, lnr_pos, lnr_neg;  // mu_to_bin
  SWConsts sw;
  // launch plan (mcmc/fused.launch_plan): walkers (warps) per block,
  // and whether their state is staged in shared memory (1) or read in
  // place (0)
  int wpb, state_smem;
  // the settings of the extended kernels (EXT): MINU, NPT (0: NVT),
  // leshift with the reference enthalpies rh0, rh1, the f schedule
  // (SCHED_* of wl_common.cuh) with Swetnam's alpha and cap and its flat target per bin
  // and master histogram view, and the 1/t cap B / (cycle N)
  int minu, npt, leshift, f_sched;
  double rh0, rh1, alpha, wl_factor, invt_f;
  void* binfrac;  // [B]
  void* baseh;    // [B,W] master histogram view per walker (Swetnam)
};

template <typename T>
struct Consts {
  T beta, betaP, pressure, nwater, wall2;
  T rh0, rh1;  // the extended kernels' reference enthalpies (EXT)
  BinConsts<T> bin;
  __device__ explicit Consts(const FusedArgs& a)
      : beta((T)a.beta), betaP((T)a.betaP), pressure((T)a.pressure),
        nwater((T)a.nwater), wall2((T)a.wall2), rh0((T)a.rh0),
        rh1((T)a.rh1) {
    bin.cpos = (T)a.cpos;
    bin.cneg = (T)a.cneg;
    bin.a_pos = (T)a.a_pos;
    bin.a_neg = (T)a.a_neg;
    bin.lnr_pos = (T)a.lnr_pos;
    bin.lnr_neg = (T)a.lnr_neg;
    bin.av_bw = (T)a.av_bw;
    bin.log_norm = (T)a.log_norm;
  }
};

// Per-walker view of the state and its constants (every lane of the
// walker's warp holds a copy; WarpWalker adds the state's accessors).
template <typename T>
struct Walker {
  int w, W, N, M;
  T* r;
  T* mom;
  int* tpm;
  WLView<T> wl;  // the WL arrays, the bin grid and the walker's window
  const T* frac0;   // [L*3*N] (table modes; shared or device memory)
  const int* tbl;   // [L*N*M] (table modes; shared or device memory)
  const int* s_shifts;  // [S*3]
  int S;
  T H[2][3][3];  // cell matrices
  T A[2][3][3];  // rows of their inverses (MIC fold)
  const T* recip;  // [L,3,3,W] reciprocal matrices
  T vol[2];
  T e[2];
  T mu, f, min_dmu, max_dmu, max_trans;
  T sumhist;   // Swetnam's count of updates (EXT)
  bool invt;   // the walker runs 1/t (EXT)
  FSched<T> fs;  // the run's f schedule (EXT)
  int ls, att[3], acc[3];
};

// The walker as a warp kernel sees it: its coordinates and moments at a
// base pointer with a stride between molecules, its block in shared
// memory (stride 1) or its column of the walker-last device layout
// (stride W); NL lattices.
template <typename T, int NL>
struct WarpWalker : Walker<T> {
  int rs;

  __device__ __forceinline__ T& rr(int l, int a, int j) {
    return this->r[(size_t)((l * 3 + a) * this->N + j) * rs];
  }
  __device__ __forceinline__ T& mm(int fld, int l, int j) {
    return this->mom[(size_t)((fld * NL + l) * this->N + j) * rs];
  }
};

// Old/new terms of one candidate partner at c from centre position p
// (minimum image; the null image of the centre itself is excluded).
template <typename T>
__device__ __forceinline__ Leg<T> leg_of(const T c[3], const T p[3],
                                         const T H[3][3], const T A[3][3],
                                         const SW<T>& sw) {
  T d[3] = {c[0] - p[0], c[1] - p[1], c[2] - p[2]};
  mic_fold(d, H, A);
  const T r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  if (!((r2 < sw.rc2) & (r2 > (T)1e-8))) return leg_none<T>();
  return leg_in_range(d, r2, sw);
}

// Active-lattice displacement v -> per-lattice trial vectors tv: the
// same fractional displacement in the partner lattice
// (Engine._map_disp; mc_moves.F90:1042-1067); one lattice moves by v.
template <int NL, typename T>
__device__ __forceinline__ void map_disp(const Walker<T>& s, const T v[3],
                                         T tv[2][3]) {
  if constexpr (NL == 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) tv[0][k] = v[k];
    return;
  }
  // reciprocal matrix of the active lattice
  const T* R = s.recip + (size_t)(s.ls == 0 ? 0 : 9) * s.W + s.w;
  const T inv2pi = (T)(0.5 / 3.14159265358979323846);
  T sfrac[3];
#pragma unroll
  for (int b = 0; b < 3; ++b)
    sfrac[b] = (v[0] * R[(0 * 3 + b) * s.W] + v[1] * R[(1 * 3 + b) * s.W]
                + v[2] * R[(2 * 3 + b) * s.W]) * inv2pi;
#pragma unroll
  for (int l = 0; l < 2; ++l)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      tv[l][k] = (s.ls == l)
          ? v[k]
          : s.H[l][k][0] * sfrac[0] + s.H[l][k][1] * sfrac[1]
                + s.H[l][k][2] * sfrac[2];
}

// Random displacement of a one-trial move (Engine._trial_vectors;
// mc_moves.F90:1021-1039) -> per-lattice trial vectors.
template <int NL, typename T>
__device__ __forceinline__ void trial_vectors(const Walker<T>& s,
                                              const T* u, T tv[2][3]) {
  const T d0 = (T)2 * u[1] - (T)1;
  const T d1 = (T)2 * u[2] - (T)1;
  const T d2 = (T)2 * u[3] - (T)1;
  const T inv_norm = sw_rsqrt(fmax(d0 * d0 + d1 * d1 + d2 * d2, (T)1e-30));
  const T rmag = ((T)2 * u[4] - (T)1) * s.max_trans * inv_norm;
  const T v[3] = {d0 * rmag, d1 * rmag, d2 * rmag};
  map_disp<NL>(s, v, tv);
}

// Displacement-wall test of the point p in lattice l: reference site =
// H . frac0 (reference positions hold their fractional coordinates
// through volume moves, mc_volume:1284-1350).
template <typename T>
__device__ __forceinline__ bool in_wall(const Walker<T>& s, int l, int imol,
                                        const T p[3], const Consts<T>& c) {
  const int N = s.N;
  T dw2 = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T ref = s.H[l][k][0] * s.frac0[(l * 3 + 0) * N + imol]
                + s.H[l][k][1] * s.frac0[(l * 3 + 1) * N + imol]
                + s.H[l][k][2] * s.frac0[(l * 3 + 2) * N + imol];
    const T dk = p[k] - ref;
    dw2 += dk * dk;
  }
  return dw2 <= c.wall2;
}

// ---- one warp per walker: the shared pieces and the table branch --------

constexpr unsigned FULL = 0xffffffffu;

// One level of the warp's recursive halving over v[0..2H): lanes with
// bit H clear keep v[0..H), the others v[H..2H), each adding its xor
// partner's copy of the half it keeps.
template <int H, typename T>
__device__ __forceinline__ void halve(T (&v)[32], int lane) {
  const bool hi = (lane & H) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const T send = hi ? v[k] : v[k + H];
    const T keep = hi ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(FULL, send, H);
  }
}

// One lattice's sums of a translation over the partners a lane holds:
// the pair terms, the centre's moments (and sum of w^2) and the wing
// terms at the old and the new point.
template <typename T>
struct Local {
  Mom<T> oo, on;
  T pair_o, pair_n, e3j_o, e3j_n;

  __device__ __forceinline__ void zero() {
    oo.zero();
    on.zero();
    pair_o = pair_n = e3j_o = e3j_n = (T)0;
  }

  __device__ __forceinline__ void pack(T (&v)[32]) const {
    v[0] = pair_o;
    v[1] = pair_n;
    v[2] = e3j_o;
    v[3] = e3j_n;
#pragma unroll
    for (int f = 0; f < 10; ++f) {
      v[4 + f] = oo.m[f];
      v[15 + f] = on.m[f];
    }
    v[14] = oo.w2;
    v[25] = on.w2;
#pragma unroll
    for (int q = 26; q < 32; ++q) v[q] = (T)0;
  }

  // the sums from lane q's value q (after the halving), in every lane
  __device__ __forceinline__ void unpack(T mine) {
    pair_o = __shfl_sync(FULL, mine, 0);
    pair_n = __shfl_sync(FULL, mine, 1);
    e3j_o = __shfl_sync(FULL, mine, 2);
    e3j_n = __shfl_sync(FULL, mine, 3);
#pragma unroll
    for (int f = 0; f < 10; ++f) {
      oo.m[f] = __shfl_sync(FULL, mine, 4 + f);
      on.m[f] = __shfl_sync(FULL, mine, 15 + f);
    }
    oo.w2 = __shfl_sync(FULL, mine, 14);
    on.w2 = __shfl_sync(FULL, mine, 25);
  }

  // Replace each of the 26 sums by its sum over the warp, in every lane.
  // Recursive halving with xor shuffles: at each level a lane keeps half
  // of its values and adds its partner's copy of that half, so after 5
  // levels lane q holds the sum of value q (a fixed pairwise tree); one
  // broadcast shuffle per value then gives every lane the same bits.
  __device__ __forceinline__ void warp_sum(int lane) {
    T v[32];
    pack(v);
    halve<16>(v, lane);
    halve<8>(v, lane);
    halve<4>(v, lane);
    halve<2>(v, lane);
    halve<1>(v, lane);
    unpack(v[0]);
  }

  __device__ __forceinline__ T e_old(const SW<T>& sw) const {
    return pair_o + sw.lam_eps * (e3_closed_form(oo.m, oo.w2, sw) + e3j_o);
  }
  __device__ __forceinline__ T e_new(const SW<T>& sw) const {
    return pair_n + sw.lam_eps * (e3_closed_form(on.m, on.w2, sw) + e3j_n);
  }
};

// Both lattices' sums reduced together (Local::warp_sum, the two
// halvings interleaved).
template <typename T>
__device__ __forceinline__ void warp_sum2(Local<T>& a, Local<T>& b,
                                          int lane) {
  T u[32], v[32];
  a.pack(u);
  b.pack(v);
  halve<16>(u, lane);
  halve<16>(v, lane);
  halve<8>(u, lane);
  halve<8>(v, lane);
  halve<4>(u, lane);
  halve<4>(v, lane);
  halve<2>(u, lane);
  halve<2>(v, lane);
  halve<1>(u, lane);
  halve<1>(v, lane);
  a.unpack(u[0]);
  b.unpack(v[0]);
}

// m[lane] for lanes 0..9 (a select per field, no local memory), else 0.
template <typename T>
__device__ __forceinline__ T lane_field(const T m[10], int lane) {
  T v = (T)0;
#pragma unroll
  for (int f = 0; f < 10; ++f)
    if (lane == f) v = m[f];
  return v;
}

// The centre's own row after an accepted move: coordinates from lanes
// 0..2, moments from lanes 0..9 (own = lane_field of its new moments).
template <typename T, int NL>
__device__ __forceinline__ void store_centre(WarpWalker<T, NL>& s, int l,
                                             int imol, const T p[3], T own,
                                             int lane) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (lane == k) s.rr(l, k, imol) = p[k];
  if (lane < 10) s.mm(lane, l, imol) = own;
}

// eta(mu) of the walker's current mu, carried from step to step while
// the arrays it reads do not change: in a sample run, or with the WL
// update off (the weight view is fixed for the cycle), until a switch
// moves mu.
template <typename T>
struct EtaCarry {
  T val;
  bool ok;
};

template <typename T>
__device__ __forceinline__ T eta_current(const Walker<T>& s,
                                         const EtaCarry<T>& ec,
                                         const Consts<T>& c) {
  return ec.ok ? ec.val : eta_of(s.wl, s.mu, c.bin);
}

// After a performed translation: eta of the walker's mu is the old or the
// new point's.
template <typename T>
__device__ __forceinline__ void eta_carry(EtaCarry<T>& ec, bool accept,
                                          T eta_old, T eta_new,
                                          const FusedArgs& a) {
  ec.val = accept ? eta_new : eta_old;
  ec.ok = a.samplerun || !a.wl_active;
}

// Acceptance of a translation with energy changes dE
// (Engine._trans_decision; mc_moves.F90:1113-1146) with the
// finite-state guard and the table modes' wall (extra_ok), eta(mu) of
// the walker's current mu given: every lane computes it at the start of
// the step, so its loads overlap the step's leg work.  Returns also
// eta(mu_new) and the lattice the move leaves the walker on (ls_next:
// under MINU, Engine._minu, the lattice of the lower trial enthalpy).
// One lattice: the move's Boltzmann factor alone, mu unchanged (no eta).
template <int NL, bool EXT, typename T>
__device__ __forceinline__ bool warp_decision(const Walker<T>& s,
                                              const T dE[2], T u_acc,
                                              bool extra_ok,
                                              const Consts<T>& c,
                                              const FusedArgs& a, T eta_old,
                                              T& mu_new, T& dmu, T& eta_new,
                                              int& ls_next) {
  ls_next = s.ls;
  if constexpr (NL == 1) {
    dmu = (T)0;
    mu_new = s.mu;
    eta_new = eta_old;
    const T diffkT = c.beta * dE[0];
    return (isfinite(diffkT) & extra_ok) && (u_acc < exp(-diffkT));
  }
  dmu = (dE[0] - dE[1]) * c.beta;
  mu_new = s.mu + dmu;
  eta_new = eta_of(s.wl, mu_new, c.bin);
  const T dE_ls = s.ls == 0 ? dE[0] : dE[1];
  T diffkT = c.beta * dE_ls + eta_new - eta_old;
  if constexpr (EXT) {
    if (a.minu) {
      // #ifdef MINU (mc_moves.F90:1119-1140): the first minimum of the
      // trial enthalpies on a tie
      const T et0 = s.e[0] + dE[0], et1 = s.e[1] + dE[1];
      T en0 = et0, en1 = et1;
      if (a.npt) {
        en0 = en0 + c.pressure * s.vol[0];
        en1 = en1 + c.pressure * s.vol[1];
      }
      if (a.leshift) {
        en0 = en0 - c.rh0;
        en1 = en1 - c.rh1;
      }
      const int lsn = en1 < en0 ? 1 : 0;
      const T E_ls = s.ls == 0 ? s.e[0] : s.e[1];
      T alt = c.beta * ((lsn == 0 ? et0 : et1) - E_ls) + eta_new - eta_old;
      if (a.npt) {
        const T V_lsn = lsn == 0 ? s.vol[0] : s.vol[1];
        const T V_ls = s.ls == 0 ? s.vol[0] : s.vol[1];
        alt = alt + c.betaP * (V_lsn - V_ls) - c.nwater * log(V_lsn / V_ls);
      }
      if (a.leshift)
        alt = alt - c.beta * ((lsn == 0 ? c.rh0 : c.rh1)
                              - (s.ls == 0 ? c.rh0 : c.rh1));
      if (lsn != s.ls) diffkT = alt;
      ls_next = lsn;
    }
  }
  const bool ok = isfinite(diffkT) & isfinite(mu_new) & extra_ok;
  return ok && (u_acc < exp(-diffkT));
}

// wl_update_at of the walker's lane 0 with eta(mu) known (the sample run's
// weight of the performed move: eta_new if accepted, else eta_old, read
// from the same arrays), its additions fire-and-forget atomics (a
// walker's entries have one writer, so they round as a plain +=).
template <typename T>
__device__ __forceinline__ void warp_wl_update(const WLView<T>& s, T mu, T f,
                                               bool healthy, T eta_val,
                                               const BinConsts<T>& c) {
  const int B = s.B, W = s.W, w = s.w;
  const long long k = mu_to_bin(mu, B, c);
  const bool upd = (k >= 0) & (k < B) & healthy;
  if (!upd) return;
  const int kc = (int)k;
  const T incr = c.av_bw / s.binw[kc];
  atomicAdd(s.hist + kc * W + w, incr);
  if (s.samplerun) {
    // mask before the exp and gate walled entries out entirely
    if (eta_val < (T)1e29) {
      const T arg = eta_val - c.log_norm;
      atomicAdd(s.uh + kc * W + w, incr * exp(fmin(arg, (T)60)));
    }
  } else {
    atomicAdd(s.wgt + kc * W + w, incr * f);
  }
}

// The sum of v over the warp, the same bits in every lane (an xor
// butterfly: a fixed order of additions).
template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The f schedule of a performed move's WL update (f_schedule_at of
// wl_common.cuh by the walker's warp): Swetnam's sum over the B bins
// strided over the lanes and added by warp_allsum, so that every lane
// ends with the same f and sumhist.
template <typename T>
__device__ __forceinline__ void warp_f_schedule(Walker<T>& s, bool healthy,
                                                const Consts<T>& c,
                                                int lane) {
  const FSched<T>& fs = s.fs;
  if (fs.kind == SCHED_INVT) {
    if (s.invt) s.f = fmin(s.f, fs.invt_f);
    return;
  }
  const int B = s.wl.B;
  const long long k = mu_to_bin(s.mu, B, c.bin);
  const bool upd = (k >= 0) & (k < B) & healthy;
  const int kc = clampi(k, B);
  const T incr = c.bin.av_bw / s.wl.binw[kc];
  s.sumhist = s.sumhist + (upd ? (T)1 : (T)0);
  const T sum = warp_allsum(
      swetnam_part(s.wl, fs, kc, upd, incr, s.sumhist, lane, 32));
  const T f_new = swetnam_f(sum, B, fs);
  if (upd) s.f = f_new;
}

// Energies, mu, the lattice (MINU), counters and the per-move WL update
// after a performed translation (Engine._trans_bookkeeping): every lane
// updates its copy of the walker's scalars (and the f schedule's), lane
// 0 writes trans_per_mol and the WL arrays.  One lattice keeps no WL
// arrays.
template <int NL, bool EXT, typename T>
__device__ __forceinline__ void warp_bookkeeping(WarpWalker<T, NL>& s,
                                                 int imol, bool accept,
                                                 T mu_new, T dmu, int ls_next,
                                                 const T dE[2], T eta_old,
                                                 T eta_new,
                                                 const Consts<T>& c,
                                                 const FusedArgs& a,
                                                 int lane) {
  __syncwarp();  // every lane has read the WL arrays for this step
  if (accept) {
#pragma unroll
    for (int l = 0; l < NL; ++l) s.e[l] = s.e[l] + dE[l];
    s.mu = mu_new;
    if constexpr (EXT) s.ls = a.minu ? ls_next : s.ls;
    const T admu = fabs(dmu);
    if (admu < s.min_dmu) s.min_dmu = admu;
    if (admu > s.max_dmu) s.max_dmu = admu;
  }
  s.att[TRANS] += 1;
  s.acc[TRANS] += accept ? 1 : 0;
  if constexpr (EXT && NL == 2) {
    if (a.wl_active && s.fs.kind != SCHED_PLAIN && !a.samplerun)
      warp_f_schedule(s, isfinite(s.e[0]) & isfinite(s.e[1]), c, lane);
  }
  if (lane == 0) {
    atomicAdd(s.tpm + (size_t)imol * s.W + s.w, 1);
    // health gate: finite energies in both lattices
    if (NL == 2 && a.wl_active)
      warp_wl_update(s.wl, s.mu, s.f,
                     isfinite(s.e[0]) & isfinite(s.e[NL - 1]),
                     accept ? eta_new : eta_old, c.bin);
  }
  __syncwarp();  // the step's writes are seen by every lane
}

// Leg g where in, else the null leg (its terms add exact zeros).
template <typename T>
__device__ __forceinline__ Leg<T> leg_if(bool in, const Leg<T>& g) {
  Leg<T> r;
  r.in = in;
  r.pair = in ? g.pair : (T)0;
  r.w = in ? g.w : (T)0;
  r.ux = in ? g.ux : (T)0;
  r.uy = in ? g.uy : (T)0;
  r.uz = in ? g.uz : (T)0;
  return r;
}

// Old and new legs of the partner at c from p_old and p_new (leg_of),
// computed without branches: the terms of a leg out of range (or of a
// padded slot, valid false) are zeros.
template <typename T>
__device__ __forceinline__ void slot_legs(const T c[3], const T p_old[3],
                                          const T p_new[3], const T H[3][3],
                                          const T A[3][3], const SW<T>& sw,
                                          bool valid, Leg<T>& go,
                                          Leg<T>& gn) {
  T d0[3] = {c[0] - p_old[0], c[1] - p_old[1], c[2] - p_old[2]};
  T d1[3] = {c[0] - p_new[0], c[1] - p_new[1], c[2] - p_new[2]};
  mic_fold(d0, H, A);
  mic_fold(d1, H, A);
  const T r0 = d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2];
  const T r1 = d1[0] * d1[0] + d1[1] * d1[1] + d1[2] * d1[2];
  go = leg_if(valid & (r0 < sw.rc2) & (r0 > (T)1e-8),
              leg_in_range(d0, r0, sw));
  gn = leg_if(valid & (r1 < sw.rc2) & (r1 > (T)1e-8),
              leg_in_range(d1, r1, sw));
}

// One table slot's terms in lattice l (the body of the first design's
// loop, branch-free): its pair terms, the centre's moments and the wing
// terms, the new one on the partner's moved moments.
template <typename T, int NL>
__device__ __forceinline__ void table_slot(WarpWalker<T, NL>& s, int l,
                                           int j_raw, const T p_old[3],
                                           const T p_new[3],
                                           const SW<T>& sw, Local<T>& q) {
  const bool valid = j_raw < s.N;  // sentinel N: padded table slot
  const int j = valid ? j_raw : 0;
  const T cj[3] = {s.rr(l, 0, j), s.rr(l, 1, j), s.rr(l, 2, j)};
  Leg<T> go, gn;
  slot_legs(cj, p_old, p_new, s.H[l], s.A[l], sw, valid, go, gn);
  T mj[10];
#pragma unroll
  for (int fld = 0; fld < 10; ++fld) mj[fld] = s.mm(fld, l, j);
  q.pair_o += go.pair;
  q.oo.add(go.w, go.ux, go.uy, go.uz);
  const T wo = wing(go, mj, sw);
  q.e3j_o += go.in ? wo : (T)0;
  q.pair_n += gn.pair;
  q.on.add(gn.w, gn.ux, gn.uy, gn.uz);
  moved_moments(mj, go, gn);
  const T wn = wing(gn, mj, sw);
  q.e3j_n += gn.in ? wn : (T)0;
}

// One table-mode translation of the shared molecule imol
// (Engine._translation_tbl; mc_moves.F90:966-1213) by the walker's warp:
// each lane takes the same table slot in both lattices, the two
// lattices' sums are reduced together (one lattice: its own alone).
template <int NL, bool EXT, typename T>
__device__ void translation_warp(WarpWalker<T, NL>& s, const T* u, int imol,
                                 const Consts<T>& c, const SW<T>& sw,
                                 const FusedArgs& a, int lane,
                                 EtaCarry<T>& ec) {
  const int N = s.N, M = s.M;
  const T eta_old = NL == 2 ? eta_current(s, ec, c) : (T)0;
  T tv[2][3];
  trial_vectors<NL>(s, u, tv);

  T p_old[2][3], p_new[2][3];
  bool wall_ok = true;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p_old[l][k] = s.rr(l, k, imol);
      p_new[l][k] = p_old[l][k] + tv[l][k];
    }
    wall_ok = wall_ok & in_wall(s, l, imol, p_new[l], c);
  }
  Local<T> q0, q1;
  q0.zero();
  q1.zero();
  const int* row0 = s.tbl + imol * M;
  const int* row1 = s.tbl + (N + imol) * M;
  for (int m = lane; m < M; m += 32) {
    if constexpr (NL == 2) {
      const int j0 = __ldg(row0 + m), j1 = __ldg(row1 + m);
      table_slot(s, 0, j0, p_old[0], p_new[0], sw, q0);
      table_slot(s, 1, j1, p_old[1], p_new[1], sw, q1);
    } else {
      table_slot(s, 0, __ldg(row0 + m), p_old[0], p_new[0], sw, q0);
    }
  }
  T dE[2], own[2];
  if constexpr (NL == 2) {
    warp_sum2(q0, q1, lane);
    dE[1] = q1.e_new(sw) - q1.e_old(sw);
    own[1] = lane_field(q1.on.m, lane);
  } else {
    q0.warp_sum(lane);
  }
  dE[0] = q0.e_new(sw) - q0.e_old(sw);
  own[0] = lane_field(q0.on.m, lane);

  T mu_new, dmu, eta_new;
  int ls_next;
  const bool accept = warp_decision<NL, EXT>(s, dE, u[5], wall_ok, c, a,
                                             eta_old, mu_new, dmu, eta_new,
                                             ls_next);
  if (accept) {  // the same in every lane
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      // candidate moments: recomputed exactly as in the first pass, each
      // lane its own slots
      const int* row = s.tbl + (l * N + imol) * M;
      for (int m = lane; m < M; m += 32) {
        const int j = __ldg(row + m);
        if (j >= N) continue;
        const T cj[3] = {s.rr(l, 0, j), s.rr(l, 1, j), s.rr(l, 2, j)};
        const Leg<T> go = leg_of(cj, p_old[l], s.H[l], s.A[l], sw);
        const Leg<T> gn = leg_of(cj, p_new[l], s.H[l], s.A[l], sw);
        if (!go.in && !gn.in) continue;
        T mj[10];
#pragma unroll
        for (int fld = 0; fld < 10; ++fld) mj[fld] = s.mm(fld, l, j);
        moved_moments(mj, go, gn);
#pragma unroll
        for (int fld = 0; fld < 10; ++fld) s.mm(fld, l, j) = mj[fld];
      }
      store_centre(s, l, imol, p_new[l], own[l], lane);
    }
  }
  warp_bookkeeping<NL, EXT>(s, imol, accept, mu_new, dmu, ls_next, dE,
                            eta_old, eta_new, c, a, lane);
  eta_carry(ec, accept, eta_old, eta_new, a);
}

// ---- dense candidates -------------------------------------------------

// Image vector of folded shift sh in lattice l (ops/dense
// _img_components); the null shift is shifts[0].
template <typename T>
__device__ __forceinline__ void image_of(const Walker<T>& s, int l, int sh,
                                         T img[3]) {
  const T s0 = (T)s.s_shifts[3 * sh], s1 = (T)s.s_shifts[3 * sh + 1],
          s2 = (T)s.s_shifts[3 * sh + 2];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    img[k] = s0 * s.H[l][k][0] + s1 * s.H[l][k][1] + s2 * s.H[l][k][2];
}

// d = the folded displacement f under shift sh (the null shift adds
// nothing); returns |d|^2.
template <typename T>
__device__ __forceinline__ T dense_r2(const Walker<T>& s, int l, int sh,
                                      const T f[3], T d[3]) {
  d[0] = f[0];
  d[1] = f[1];
  d[2] = f[2];
  if (sh > 0) {
    T img[3];
    image_of(s, l, sh, img);
    d[0] = f[0] + img[0];
    d[1] = f[1] + img[1];
    d[2] = f[2] + img[2];
  }
  return d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
}

// Leg of the folded displacement f under shift sh: in range when
// r2 < rc^2; the null image of the centre itself (self) is excluded
// (molint.F90:196-198, 532).
template <typename T>
__device__ __forceinline__ Leg<T> dense_leg(const Walker<T>& s, int l, int sh,
                                            const T f[3], bool self,
                                            const SW<T>& sw) {
  if (sh == 0 && self) return leg_none<T>();
  T d[3];
  const T r2 = dense_r2(s, l, sh, f, d);
  if (!(r2 < sw.rc2)) return leg_none<T>();
  return leg_in_range(d, r2, sw);
}

// Folded displacements of candidate j from the old and the new centre;
// the centre's own row holds the centre itself (ops/dense._candidates).
template <typename T, int NL>
__device__ __forceinline__ void dense_folds(WarpWalker<T, NL>& s, int l,
                                            int j,
                                            bool self, const T p_old[3],
                                            const T p_new[3], T fo[3],
                                            T fn[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T cj = s.rr(l, k, j);
    fo[k] = (self ? p_old[k] : cj) - p_old[k];
    fn[k] = (self ? p_new[k] : cj) - p_new[k];
  }
  mic_fold(fo, s.H[l], s.A[l]);
  mic_fold(fn, s.H[l], s.A[l]);
}

// The rows j (the centre's own row too when with_self) with a leg in
// range of either point in lattice l, in increasing j, into the walker's
// list; returns their count.  The candidates are strided over the lanes
// and only tested here (the same r2 as dense_leg), so the leg and wing
// work that follows runs on the short list.
template <typename T, int NL>
__device__ int dense_rows(WarpWalker<T, NL>& s, int l, int imol,
                          bool with_self,
                          const T p_old[3], const T p_new[3],
                          const SW<T>& sw, int lane,
                          unsigned short* list) {
  const int N = s.N, S = s.S;
  int n = 0;
  for (int j0 = 0; j0 < N; j0 += 32) {
    const int j = j0 + lane;
    bool any = false;
    if (j < N && (with_self || j != imol)) {
      const bool self = j == imol;
      T fo[3], fn[3];
      dense_folds(s, l, j, self, p_old, p_new, fo, fn);
      for (int sh = self ? 1 : 0; sh < S; ++sh) {
        T d[3];
        any = any | (dense_r2(s, l, sh, fo, d) < sw.rc2)
                  | (dense_r2(s, l, sh, fn, d) < sw.rc2);
      }
    }
    const unsigned b = __ballot_sync(FULL, any);
    if (any) list[n + __popc(b & ((1u << lane) - 1u))] = (unsigned short)j;
    n += __popc(b);
  }
  __syncwarp();  // the list is seen by every lane
  return n;
}

// Row j's moments after the move, st - delta_o + delta_n, from the sums
// Ro, Rn of its old and new legs over the shifts (delta = (w, -w u,
// w u u^T) from the row's view; mcmc/fused._local of the JAX package).
template <typename T>
__device__ __forceinline__ void moved_rows(T m[10], const Mom<T>& Ro,
                                           const Mom<T>& Rn) {
  m[0] = m[0] - Ro.m[0] + Rn.m[0];
#pragma unroll
  for (int f = 1; f < 4; ++f) m[f] = m[f] - (-Ro.m[f]) + (-Rn.m[f]);
#pragma unroll
  for (int f = 4; f < 10; ++f) m[f] = m[f] - Ro.m[f] + Rn.m[f];
}

template <typename T>
__device__ __forceinline__ void add_sums(Mom<T>& acc, const Mom<T>& R) {
#pragma unroll
  for (int f = 0; f < 10; ++f) acc.m[f] += R.m[f];
  acc.w2 += R.w2;
}

// One dense-candidate translation of the walker's own molecule
// (Engine._translation; mc_moves.F90:966-1213; the JAX package's
// fused._do_translation) by the walker's warp.
template <int NL, bool EXT, typename T>
__device__ void translation_dense_warp(WarpWalker<T, NL>& s, const T* u,
                                       const Consts<T>& c, const SW<T>& sw,
                                       const FusedArgs& a, int lane,
                                       unsigned short* list,
                                       EtaCarry<T>& ec) {
  const int N = s.N, S = s.S;
  // the molecule: int32(u0 * N) with the product in the working type
  int imol = (int)(u[0] * (T)N);
  if (imol > N - 1) imol = N - 1;
  const T eta_old = NL == 2 ? eta_current(s, ec, c) : (T)0;
  T tv[2][3];
  trial_vectors<NL>(s, u, tv);

  T dE[2], p_old[2][3], p_new[2][3], own[2];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p_old[l][k] = s.rr(l, k, imol);
      p_new[l][k] = p_old[l][k] + tv[l][k];
    }
    const int n = dense_rows(s, l, imol, true, p_old[l], p_new[l], sw, lane,
                             list);
    Local<T> q;
    q.zero();
    bool self_new = false;  // a non-null image of the centre in range
    for (int i = lane; i < n; i += 32) {
      const int j = list[i];
      const bool self = j == imol;
      T fo[3], fn[3];
      dense_folds(s, l, j, self, p_old[l], p_new[l], fo, fn);
      Mom<T> Ro, Rn;
      Ro.zero();
      Rn.zero();
      bool any = false, any_n = false;
      T mj[10];
      for (int sh = 0; sh < S; ++sh) {
        const Leg<T> go = dense_leg(s, l, sh, fo, self, sw);
        if (go.in) {
          if (!any) {
#pragma unroll
            for (int fld = 0; fld < 10; ++fld) mj[fld] = s.mm(fld, l, j);
            any = true;
          }
          q.pair_o += go.pair;
          Ro.add(go.w, go.ux, go.uy, go.uz);
          q.e3j_o += wing(go, mj, sw);
        }
        const Leg<T> gn = dense_leg(s, l, sh, fn, self, sw);
        if (gn.in) {
          q.pair_n += gn.pair;
          Rn.add(gn.w, gn.ux, gn.uy, gn.uz);
          any_n = true;
        }
      }
      if (any_n) {
        if (self) {
          // wing terms of the centre's own images need its new
          // moments: added after the warp's sum
          self_new = true;
        } else {
          if (!any) {
#pragma unroll
            for (int fld = 0; fld < 10; ++fld) mj[fld] = s.mm(fld, l, j);
          }
          moved_rows(mj, Ro, Rn);
          for (int sh = 0; sh < S; ++sh) {
            const Leg<T> gn = dense_leg(s, l, sh, fn, self, sw);
            if (gn.in) q.e3j_n += wing(gn, mj, sw);
          }
        }
      }
      add_sums(q.oo, Ro);
      add_sums(q.on, Rn);
    }
    self_new = __any_sync(FULL, self_new);
    q.warp_sum(lane);
    if (self_new) {
      T fz[3] = {0, 0, 0};  // the folded zero displacement
      for (int sh = 1; sh < S; ++sh) {
        const Leg<T> gn = dense_leg(s, l, sh, fz, true, sw);
        if (gn.in) q.e3j_n += wing(gn, q.on.m, sw);
      }
    }
    dE[l] = q.e_new(sw) - q.e_old(sw);
    own[l] = lane_field(q.on.m, lane);
    __syncwarp();  // the list is rebuilt for the next lattice
  }

  T mu_new, dmu, eta_new;
  int ls_next;
  const bool accept = warp_decision<NL, EXT>(s, dE, u[5], true, c, a,
                                             eta_old, mu_new, dmu, eta_new,
                                             ls_next);
  if (accept) {  // the same in every lane
    // second pass: write the rows the move changed, recomputed exactly
    // as in the first
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int n = dense_rows(s, l, imol, false, p_old[l], p_new[l], sw,
                               lane, list);
      for (int i = lane; i < n; i += 32) {
        const int j = list[i];
        T fo[3], fn[3];
        dense_folds(s, l, j, false, p_old[l], p_new[l], fo, fn);
        Mom<T> Ro, Rn;
        Ro.zero();
        Rn.zero();
        for (int sh = 0; sh < S; ++sh) {
          const Leg<T> go = dense_leg(s, l, sh, fo, false, sw);
          if (go.in) Ro.add(go.w, go.ux, go.uy, go.uz);
          const Leg<T> gn = dense_leg(s, l, sh, fn, false, sw);
          if (gn.in) Rn.add(gn.w, gn.ux, gn.uy, gn.uz);
        }
        T mj[10];
#pragma unroll
        for (int fld = 0; fld < 10; ++fld) mj[fld] = s.mm(fld, l, j);
        moved_rows(mj, Ro, Rn);
#pragma unroll
        for (int fld = 0; fld < 10; ++fld) s.mm(fld, l, j) = mj[fld];
      }
      store_centre(s, l, imol, p_new[l], own[l], lane);
      __syncwarp();  // the list is rebuilt for the next lattice
    }
  }
  warp_bookkeeping<NL, EXT>(s, imol, accept, mu_new, dmu, ls_next, dE,
                            eta_old, eta_new, c, a, lane);
  eta_carry(ec, accept, eta_old, eta_new, a);
}

// Lattice switch attempt (Engine._switch; mc_moves.F90:1536-1594); the
// extended kernels (EXT) drop the PV and volume-entropy terms under NVT
// and shift by the reference enthalpies under leshift.
template <bool EXT, typename T>
__device__ void lattice_switch(Walker<T>& s, T zeta, const Consts<T>& c,
                               const FusedArgs& a) {
  const int ls = s.ls;
  const T E_ls = ls == 0 ? s.e[0] : s.e[1];
  const T E_lsn = ls == 0 ? s.e[1] : s.e[0];
  const T V_ls = ls == 0 ? s.vol[0] : s.vol[1];
  const T V_lsn = ls == 0 ? s.vol[1] : s.vol[0];
  T diffkT;
  if constexpr (EXT) {
    diffkT = c.beta * (E_lsn - E_ls);
    if (a.npt)
      diffkT = diffkT + c.betaP * (V_lsn - V_ls)
               - c.nwater * log(V_lsn / V_ls);
    if (a.leshift)
      diffkT = diffkT - c.beta * ((ls == 0 ? c.rh1 : c.rh0)
                                  - (ls == 0 ? c.rh0 : c.rh1));
  } else {
    diffkT = c.beta * (E_lsn - E_ls) + c.betaP * (V_lsn - V_ls)
             - c.nwater * log(V_lsn / V_ls);
  }
  const bool accept = isfinite(diffkT) && (zeta < exp(-diffkT));
  if (accept) {
    s.ls = 1 - ls;
    T mu = s.e[0] + c.pressure * s.vol[0] - s.e[1] - c.pressure * s.vol[1];
    if constexpr (EXT) {
      if (a.leshift) mu = mu - c.rh0 + c.rh1;
    }
    s.mu = mu * c.beta - c.nwater * log(s.vol[0] / s.vol[1]);
  }
  s.att[SWITCH] += 1;
  s.acc[SWITCH] += accept ? 1 : 0;
}

__device__ __forceinline__ bool switch_on(int code, const FusedArgs& a) {
  return a.do_switch && a.switch_ok
         && (code == SWITCH || (a.always_switch && code == TRANS));
}

// ---- multi-trial table mode -------------------------------------------

// Leg of the partner at c from point p (leg_of), computed without
// branches: the terms of a leg out of range (or of a padded slot, valid
// false) are zeros.
template <typename T>
__device__ __forceinline__ Leg<T> slot_leg(const T c[3], const T p[3],
                                           const T H[3][3], const T A[3][3],
                                           const SW<T>& sw, bool valid) {
  T d[3] = {c[0] - p[0], c[1] - p[1], c[2] - p[2]};
  mic_fold(d, H, A);
  const T r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  return leg_if(valid & (r2 < sw.rc2) & (r2 > (T)1e-8),
                leg_in_range(d, r2, sw));
}

// m - delta(o) and a + delta(n): the two halves of moved_moments, in its
// association ((m - delta_o) + delta_n), so that a partner's moments
// less its point-0 leg are computed once per mover.
template <typename T>
__device__ __forceinline__ void less_leg(T m[10], const Leg<T>& o) {
  const T owx = o.w * o.ux, owy = o.w * o.uy, owz = o.w * o.uz;
  m[0] = m[0] - o.w;
  m[1] = m[1] - (-owx);
  m[2] = m[2] - (-owy);
  m[3] = m[3] - (-owz);
  m[4] = m[4] - owx * o.ux;
  m[5] = m[5] - owy * o.uy;
  m[6] = m[6] - owz * o.uz;
  m[7] = m[7] - owx * o.uy;
  m[8] = m[8] - owx * o.uz;
  m[9] = m[9] - owy * o.uz;
}

template <typename T>
__device__ __forceinline__ void plus_leg(const T a[10], const Leg<T>& n,
                                         T m[10]) {
  const T nwx = n.w * n.ux, nwy = n.w * n.uy, nwz = n.w * n.uz;
  m[0] = a[0] + n.w;
  m[1] = a[1] + (-nwx);
  m[2] = a[2] + (-nwy);
  m[3] = a[3] + (-nwz);
  m[4] = a[4] + nwx * n.ux;
  m[5] = a[5] + nwy * n.uy;
  m[6] = a[6] + nwz * n.uz;
  m[7] = a[7] + nwx * n.uy;
  m[8] = a[8] + nwx * n.uz;
  m[9] = a[9] + nwy * n.uz;
}

// A lane's table slots of the mover in both lattices (slot m = lane +
// 32 k, k < SL, the same slot of both lattices on one lane), read once
// per mover: the partner (N for a padded slot), its coordinates, its
// moments less the mover's point-0 leg (st - d0) and whether that leg
// is in range.
template <typename T, int SL>
struct MoverRows {
  int j[SL][2];
  bool in0[SL][2];
  T c[SL][2][3];
  T a[SL][2][10];
};

// One lattice's sums of one point over the partners a lane holds: the
// pair terms, the wing terms and the centre's moments (and sum of w^2).
template <typename T>
struct PointSums {
  T pair, e3j;
  Mom<T> on;

  __device__ __forceinline__ void zero() {
    pair = e3j = (T)0;
    on.zero();
  }
  __device__ __forceinline__ void add_leg(const Leg<T>& g, T wg) {
    pair += g.pair;
    on.add(g.w, g.ux, g.uy, g.uz);
    e3j += g.in ? wg : (T)0;
  }
};

// Point 0 (the stored position p0) of the mover imol: each lane reads
// its slots' rows into R and sums their terms at p0 against the
// original moments.
template <typename T, int SL>
__device__ __forceinline__ void rows_point0(WarpWalker<T, 2>& s, int imol,
                                            const T p0[2][3],
                                            const SW<T>& sw, int lane,
                                            MoverRows<T, SL>& R,
                                            PointSums<T> q[2]) {
  const int N = s.N, M = s.M;
  q[0].zero();
  q[1].zero();
#pragma unroll
  for (int k = 0; k < SL; ++k) {
    const int m = lane + 32 * k;
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int jr = m < M ? __ldg(s.tbl + (l * N + imol) * M + m) : N;
      const bool valid = jr < N;  // sentinel N: padded table slot
      const int j = valid ? jr : 0;
      R.j[k][l] = jr;
      T mj[10];
#pragma unroll
      for (int a = 0; a < 3; ++a) R.c[k][l][a] = s.rr(l, a, j);
#pragma unroll
      for (int fld = 0; fld < 10; ++fld) mj[fld] = s.mm(fld, l, j);
      const Leg<T> g = slot_leg(R.c[k][l], p0[l], s.H[l], s.A[l], sw, valid);
      R.in0[k][l] = g.in;
      q[l].add_leg(g, wing(g, mj, sw));
      less_leg(mj, g);
#pragma unroll
      for (int fld = 0; fld < 10; ++fld) R.a[k][l][fld] = mj[fld];
    }
  }
}

// A trial point p of the mover from the rows in R: the legs at p and the
// wing terms on the partners' moments moved from p0 to p,
// (st - d0) + dt (_do_translation_tbl_multi's eff_t).
template <typename T, int SL>
__device__ __forceinline__ void rows_point(const WarpWalker<T, 2>& s,
                                           const MoverRows<T, SL>& R,
                                           const T p[2][3], const SW<T>& sw,
                                           PointSums<T> q[2]) {
  q[0].zero();
  q[1].zero();
#pragma unroll
  for (int k = 0; k < SL; ++k) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const Leg<T> g = slot_leg(R.c[k][l], p[l], s.H[l], s.A[l], sw,
                                R.j[k][l] < s.N);
      T eff[10];
      plus_leg(R.a[k][l], g, eff);
      q[l].add_leg(g, wing(g, eff, sw));
    }
  }
}

// The two lattices' 13 sums of a point reduced over the warp (recursive
// halving, as Local::warp_sum: lane q ends with the sum of value q);
// each half of the warp then gathers one lattice's sums and computes its
// local energy.  Returns e[2] in every lane, and in lane 16 l + f (f <
// 10) the centre's moment f in lattice l.
template <typename T>
__device__ __forceinline__ T point_energies(const PointSums<T> q[2],
                                            const SW<T>& sw, int lane,
                                            T e[2]) {
  T v[32];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    v[13 * l] = q[l].pair;
    v[13 * l + 1] = q[l].e3j;
    v[13 * l + 2] = q[l].on.w2;
#pragma unroll
    for (int f = 0; f < 10; ++f) v[13 * l + 3 + f] = q[l].on.m[f];
  }
#pragma unroll
  for (int i = 26; i < 32; ++i) v[i] = (T)0;
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  const int base = lane < 16 ? 0 : 13;
  T x[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) x[i] = __shfl_sync(FULL, v[0], base + i);
  const T eh = x[0] + sw.lam_eps * (e3_closed_form(x + 3, x[2], sw) + x[1]);
  e[0] = __shfl_sync(FULL, eh, 0);
  e[1] = __shfl_sync(FULL, eh, 16);
  return lane_field(x + 3, lane & 15);
}

// The pre-drawn uniforms of one mover (n_u = 4 + 5T rows): rows lane and
// lane + 32 held by each lane (loaded a mover ahead), broadcast by a
// shuffle where a row is needed; rows from 64 on (T > 12) read where
// needed.
template <typename T>
struct MoverUniforms {
  T lo, hi;
  const T* base;  // the mover's row 0 of the walker, rows W apart
  int W;

  __device__ __forceinline__ void load(const T* b, int n_u, int w_stride,
                                       int lane) {
    base = b;
    W = w_stride;
    lo = lane < n_u ? b[(size_t)lane * W] : (T)0;
    hi = lane + 32 < n_u ? b[(size_t)(lane + 32) * W] : (T)0;
  }
  // row ``row`` (the same in every lane)
  __device__ __forceinline__ T operator()(int row) const {
    if (row < 64) return __shfl_sync(FULL, row < 32 ? lo : hi, row & 31);
    return base[(size_t)row * W];
  }
};

// T anchored-window trials of the shared mover imol on one read of its
// rows (Engine._translation_tbl_multi; the JAX package's
// fused._do_translation_tbl_multi) by the walker's warp.  Every trial
// point is evaluated against the original rows and the energy of point
// 0, the accept / WL chain runs on broadcast values (every lane takes
// the same decisions), and the rows of the last accepted point are
// stored once at the end.  codes: the move codes of the mover's T
// trials.
template <typename T, int SL, bool EXT>
__device__ void translation_multi_warp(WarpWalker<T, 2>& s,
                                       const MoverUniforms<T>& u,
                                       const int* codes, int imol,
                                       const Consts<T>& c, const SW<T>& sw,
                                       const FusedArgs& a, int lane,
                                       EtaCarry<T>& ec) {
  const int N = s.N, TT = a.T;
  T p0[2][3];
#pragma unroll
  for (int l = 0; l < 2; ++l)
#pragma unroll
    for (int k = 0; k < 3; ++k) p0[l][k] = s.rr(l, k, imol);
  MoverRows<T, SL> R;
  PointSums<T> q[2];
  rows_point0(s, imol, p0, sw, lane, R, q);
  T e_cur[2];
  point_energies(q, sw, lane, e_cur);
  T anc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) anc[k] = (T)2 * u(1 + k) - (T)1;

  bool moved = false;  // a trial was accepted
  T p_cur[2][3], own_cur = (T)0;
  for (int t = 0; t < TT; ++t) {
    const int code = codes[t];
    if (code == TRANS) {
      const T eta_old = eta_current(s, ec, c);
      // anchored-window candidate: v_t = (a + b_t) * max_trans
      T v[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        v[k] = (anc[k] + ((T)2 * u(4 + 3 * t + k) - (T)1)) * s.max_trans;
      T tv[2][3], p_t[2][3];
      map_disp<2>(s, v, tv);
      bool wall_ok = true;
#pragma unroll
      for (int l = 0; l < 2; ++l) {
#pragma unroll
        for (int k = 0; k < 3; ++k) p_t[l][k] = p0[l][k] + tv[l][k];
        // displacement wall on the candidate point
        wall_ok = wall_ok & in_wall(s, l, imol, p_t[l], c);
      }
      rows_point(s, R, p_t, sw, q);
      T e_t[2];
      const T own_t = point_energies(q, sw, lane, e_t);
      const T dE[2] = {e_t[0] - e_cur[0], e_t[1] - e_cur[1]};
      T mu_new, dmu, eta_new;
      int ls_next;
      const bool accept = warp_decision<2, EXT>(s, dE, u(4 + 3 * TT + t),
                                                wall_ok, c, a, eta_old,
                                                mu_new, dmu, eta_new,
                                                ls_next);
      if (accept) {  // the same in every lane
        moved = true;
        own_cur = own_t;
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          e_cur[l] = e_t[l];
#pragma unroll
          for (int k = 0; k < 3; ++k) p_cur[l][k] = p_t[l][k];
        }
      }
      warp_bookkeeping<2, EXT>(s, imol, accept, mu_new, dmu, ls_next, dE,
                               eta_old, eta_new, c, a, lane);
      eta_carry(ec, accept, eta_old, eta_new, a);
    }
    if (switch_on(code, a)) {
      const int ls = s.ls;
      lattice_switch<EXT>(s, u(4 + 4 * TT + t), c, a);
      ec.ok = ec.ok & (s.ls == ls);  // an accepted switch moves mu
    }
  }
  if (!moved) return;  // every row keeps its value

  // one store per T trials: the rows of the last accepted point,
  // recomputed from R exactly as in its trial; a row with no leg in
  // range of either point keeps st and is not written
#pragma unroll
  for (int k = 0; k < SL; ++k) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int j = R.j[k][l];
      if (j >= N) continue;
      const Leg<T> g = slot_leg(R.c[k][l], p_cur[l], s.H[l], s.A[l], sw,
                                true);
      if (!(R.in0[k][l] || g.in)) continue;
      T eff[10];
      plus_leg(R.a[k][l], g, eff);
#pragma unroll
      for (int fld = 0; fld < 10; ++fld) s.mm(fld, l, j) = eff[fld];
    }
  }
  // the centre: lane 16 l + f writes its coordinate f (f < 3) and moment
  // f (f < 10) in lattice l
  const int lc = lane >> 4, f = lane & 15;
  T pc = (T)0;
#pragma unroll
  for (int l = 0; l < 2; ++l)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (l == lc && k == f) pc = p_cur[l][k];
  if (f < 3) s.rr(lc, f, imol) = pc;
  if (f < 10) s.mm(f, lc, imol) = own_cur;
  __syncwarp();  // the stored rows are seen by every lane
}

// ---- the kernels --------------------------------------------------------

enum Branch { TABLE = 0, DENSE = 1, MULTI = 2 };

// The walker's scalars, cells and WL view from the per-walker rows (every
// thread of the walker holds a copy).
template <int NL, typename T>
__device__ __forceinline__ void load_walker(Walker<T>& s, const FusedArgs& a,
                                            int w, const T* s_binw,
                                            const T* s_mub,
                                            const int* s_shifts) {
  const int W = a.W;
  const T* h = static_cast<const T*>(a.h);
  const T* volp = static_cast<const T*>(a.vol);
  const T* ep = static_cast<const T*>(a.e);
  const T* wf = static_cast<const T*>(a.wf);
  const int* wi = static_cast<const int*>(a.wi);
  s.w = w;
  s.W = W;
  s.N = a.N;
  s.M = a.M;
  s.S = a.S;
  s.wl.w = w;
  s.wl.W = W;
  s.wl.B = a.B;
  s.wl.wgt = static_cast<T*>(a.wgt);
  s.wl.hist = static_cast<T*>(a.hist);
  s.wl.uh = static_cast<T*>(a.uh);
  s.wl.basew = static_cast<const T*>(a.basew);
  s.wl.binw = s_binw;
  s.wl.mub = s_mub;
  s.wl.eta_interp = a.eta_interp;
  s.wl.dd_seeding = a.dd_seeding;
  s.wl.samplerun = a.samplerun;
  s.tpm = static_cast<int*>(a.tpm);
  s.recip = static_cast<const T*>(a.recip);
  s.s_shifts = s_shifts;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        s.H[l][i][j] = h[((l * 3 + i) * 3 + j) * W + w];
      }
    inv3_rows(s.H[l], s.A[l]);
    s.vol[l] = volp[l * W + w];
    s.e[l] = ep[l * W + w];
  }
  s.mu = wf[WF_MU * W + w];
  s.f = wf[WF_F * W + w];
  s.min_dmu = wf[WF_MIN_DMU * W + w];
  s.max_dmu = wf[WF_MAX_DMU * W + w];
  s.max_trans = wf[WF_MAX_TRANS * W + w];
  s.wl.mu_min = wf[WF_MU_MIN * W + w];
  s.wl.mu_max = wf[WF_MU_MAX * W + w];
  s.ls = wi[WI_LS * W + w];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.att[k] = wi[(WI_ATT + k) * W + w];
    s.acc[k] = wi[(WI_ACC + k) * W + w];
  }
  s.wl.start_bin = wi[WI_START * W + w];
  s.wl.end_bin = wi[WI_END * W + w];
  s.wl.in_window = wi[WI_INWIN * W + w];
  s.sumhist = wf[WF_SUMHIST * W + w];
  s.invt = wi[WI_INVT * W + w] != 0;
  s.fs.kind = a.f_sched;
  s.fs.alpha = (T)a.alpha;
  s.fs.wl_factor = (T)a.wl_factor;
  s.fs.invt_f = (T)a.invt_f;
  s.fs.binfrac = static_cast<const T*>(a.binfrac);
  s.fs.baseh = a.baseh ? static_cast<const T*>(a.baseh) + w : nullptr;
  s.fs.bh_stride = W;
}

template <int NL, bool EXT, typename T>
__device__ __forceinline__ void store_walker(const Walker<T>& s,
                                             const FusedArgs& a) {
  const int W = a.W, w = s.w;
  T* ep = static_cast<T*>(a.e);
  T* wf = static_cast<T*>(a.wf);
  int* wi = static_cast<int*>(a.wi);
  if constexpr (EXT) {
    // the f schedules' state
    wf[WF_F * W + w] = s.f;
    wf[WF_SUMHIST * W + w] = s.sumhist;
  }
#pragma unroll
  for (int l = 0; l < NL; ++l) ep[l * W + w] = s.e[l];
  wf[WF_MU * W + w] = s.mu;
  wf[WF_MIN_DMU * W + w] = s.min_dmu;
  wf[WF_MAX_DMU * W + w] = s.max_dmu;
  wi[WI_LS * W + w] = s.ls;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    wi[(WI_ATT + k) * W + w] = s.att[k];
    wi[(WI_ACC + k) * W + w] = s.acc[k];
  }
}

// -- the kernels: one warp per walker ---------------------------------------

// Walkers (warps) per block at most: the kernels' register bound
// (__launch_bounds__(32 * WarpCap)), mirrored by mcmc/fused.WARP_CAP.
template <typename T> struct WarpCap;
template <> struct WarpCap<float> { static constexpr int value = 8; };
template <> struct WarpCap<double> { static constexpr int value = 5; };

// Rows of N values in one walker's state: r [NL,3] and the moments
// [10,NL] (mcmc/fused.STATE_ROWS per lattice).
constexpr int STATE_ROWS_PER_LATTICE = 13;

// Table slots a lane of the multi-trial branch holds at most (SL <= 2:
// M <= 64), mirrored by mcmc/fused.MULTI_SLOTS_MAX.
constexpr int MULTI_SL_MAX = 2;

// Ints of the schedule in shared memory: the move codes [N], then the
// molecule schedule ([N] in table mode, [N/T] movers in multi-trial
// mode, none in dense mode).
__host__ __device__ __forceinline__ int sched_ints(int branch, int N, int T) {
  return branch == TABLE ? 2 * N : branch == MULTI ? N + N / T : N;
}

// Dynamic shared memory of a block (mcmc/fused.smem_bytes): bin widths
// and centres, the walkers' states of NL lattices (state_smem), the
// schedule, the folded shifts, and in dense mode each walker's list of
// rows.
template <typename T>
static size_t warp_smem_bytes(int branch, int N, int B, int S, int T_,
                              int wpb, int state_smem, int NL) {
  return sizeof(T) * (2 * (size_t)B
                      + (state_smem ? (size_t)wpb * STATE_ROWS_PER_LATTICE
                                          * NL * N
                                    : 0))
         + sizeof(int) * ((size_t)sched_ints(branch, N, T_) + 3 * (size_t)S)
         + (branch == DENSE ? sizeof(unsigned short) * (size_t)wpb * N : 0);
}

// The kernel of branch BR (SL: the multi-trial branch's table slots a
// lane holds) at NL lattices; EXT: the extended settings (MINU, NVT,
// leshift, the Swetnam and 1/t schedules) read from the args, compiled
// out of the plain instantiations.
template <typename T, int BR, int SL, int NL, bool EXT>
__global__ void __launch_bounds__(32 * WarpCap<T>::value)
    fused_warp_kernel(const FusedArgs a) {
  static_assert(NL == 2 || (BR != MULTI && !EXT),
                "one lattice: table and dense branches, plain settings");
  const int N = a.N, W = a.W, B = a.B, S = a.S, wpb = a.wpb;
  const int n_sched = sched_ints(BR, N, a.T);
  const bool st = a.state_smem != 0;
  const int rows = STATE_ROWS_PER_LATTICE * NL * N;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_binw = reinterpret_cast<T*>(smem);
  T* s_mub = s_binw + B;
  T* s_state = s_mub + B;  // [wpb][26N] when st
  int* s_sched = reinterpret_cast<int*>(s_state + (st ? wpb * rows : 0));
  int* s_shifts = s_sched + n_sched;
  unsigned short* s_list =
      reinterpret_cast<unsigned short*>(s_shifts + 3 * S);  // [wpb][N]

  const int w0 = blockIdx.x * wpb;
  const int nw = min(wpb, W - w0);  // ragged edge: the last block's walkers
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    s_binw[i] = static_cast<const T*>(a.binw)[i];
    s_mub[i] = static_cast<const T*>(a.mub)[i];
  }
  for (int i = threadIdx.x; i < n_sched; i += blockDim.x)
    s_sched[i] = static_cast<const int*>(a.sched)[i];
  for (int i = threadIdx.x; i < 3 * S; i += blockDim.x)
    s_shifts[i] = static_cast<const int*>(a.shifts)[i];
  const T* gr = static_cast<const T*>(a.r);
  const T* gm = static_cast<const T*>(a.mom);
  if (st) {
    // rows of the walker-last layout: the block's nw walkers are nw
    // consecutive values of each row; four loads in flight per thread
    const int n = rows * nw, nt = blockDim.x;
    for (int i0 = threadIdx.x; i0 < n; i0 += 4 * nt) {
      T v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + q * nt;
        if (i < n) {
          const int row = i / nw, k = i - row * nw;
          v[q] = row < 3 * NL * N
                     ? gr[(size_t)row * W + w0 + k]
                     : gm[(size_t)(row - 3 * NL * N) * W + w0 + k];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + q * nt;
        if (i < n) {
          const int row = i / nw, k = i - row * nw;
          s_state[(size_t)k * rows + row] = v[q];
        }
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < nw) {
    const int w = w0 + warp;
    const Consts<T> c(a);
    const SW<T> sw(a.sw);
    WarpWalker<T, NL> s;
    load_walker<NL>(s, a, w, s_binw, s_mub, s_shifts);
    if (st) {
      s.r = s_state + (size_t)warp * rows;
      s.mom = s.r + 3 * NL * N;
      s.rs = 1;
    } else {
      s.r = static_cast<T*>(a.r) + w;
      s.mom = static_cast<T*>(a.mom) + w;
      s.rs = W;
    }
    s.frac0 = static_cast<const T*>(a.frac0);
    s.tbl = static_cast<const int*>(a.tbl);
    EtaCarry<T> ec;
    ec.val = (T)0;
    ec.ok = false;
    const T* cu = static_cast<const T*>(a.cu) + w;

    if constexpr (BR == MULTI) {
      // N/T movers; the uniforms of mover t + 1 loaded ahead
      const int n_steps = N / a.T, n_u = 4 + 5 * a.T;
      MoverUniforms<T> u, un;
      u.load(cu, n_u, W, lane);
      for (int t = 0; t < n_steps; ++t) {
        if (t + 1 < n_steps)
          un.load(cu + (size_t)(t + 1) * n_u * W, n_u, W, lane);
        translation_multi_warp<T, SL, EXT>(s, u, s_sched + t * a.T,
                                           s_sched[N + t], c, sw, a, lane,
                                           ec);
        if (t + 1 < n_steps) u = un;
      }
    } else {
      unsigned short* list = s_list + (size_t)warp * N;
      // the uniforms of step t, those of step t + 1 loaded ahead
      T u[7], un[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) u[k] = cu[(size_t)k * W];
      for (int t = 0; t < N; ++t) {
        if (t + 1 < N) {
#pragma unroll
          for (int k = 0; k < 7; ++k)
            un[k] = cu[((size_t)(t + 1) * 7 + k) * W];
        }
        const int code = s_sched[t];
        if (code == TRANS) {
          if constexpr (BR == DENSE)
            translation_dense_warp<NL, EXT>(s, u, c, sw, a, lane, list, ec);
          else
            translation_warp<NL, EXT>(s, u, s_sched[N + t], c, sw, a, lane,
                                      ec);
        }
        if constexpr (NL == 2) {
          if (switch_on(code, a)) {
            const int ls = s.ls;
            lattice_switch<EXT>(s, u[6], c, a);
            ec.ok = ec.ok & (s.ls == ls);  // an accepted switch moves mu
          }
        }
#pragma unroll
        for (int k = 0; k < 7; ++k) u[k] = un[k];
      }
    }
    if (lane == 0) store_walker<NL, EXT>(s, a);
  }
  __syncthreads();
  if (st) {
    T* r = static_cast<T*>(a.r);
    T* mom = static_cast<T*>(a.mom);
    for (int i = threadIdx.x; i < rows * nw; i += blockDim.x) {
      const int row = i / nw, k = i - row * nw;
      const T v = s_state[(size_t)k * rows + row];
      if (row < 3 * NL * N)
        r[(size_t)row * W + w0 + k] = v;
      else
        mom[(size_t)(row - 3 * NL * N) * W + w0 + k] = v;
    }
  }
}

// -- launches and occupancy ------------------------------------------------

// (threads per block, dynamic shared bytes, blocks) of a launch of
// branch BR at NL lattices, or false for a plan or a shape the kernels do
// not take.
template <typename T, int BR, int NL>
static bool geometry(const FusedArgs* a, int& threads, size_t& smem,
                     int& blocks) {
  if (a->wpb < 1 || a->wpb > WarpCap<T>::value || a->N > 65535) return false;
  if (BR == MULTI && (a->T < 2 || a->N % a->T != 0 || a->M < 1
                      || a->M > 32 * MULTI_SL_MAX))
    return false;
  threads = 32 * a->wpb;
  smem = warp_smem_bytes<T>(BR, a->N, a->B, a->S, a->T, a->wpb,
                            a->state_smem, NL);
  blocks = (a->W + a->wpb - 1) / a->wpb;
  return true;
}

// The kernel of a launch: the multi-trial branch's by the table slots a
// lane holds (SL = ceil(M / 32)).
template <typename T, int BR, int NL, bool EXT>
static const void* kernel_of(const FusedArgs* a) {
  if constexpr (BR == MULTI) {
    if (a->M > 32)
      return reinterpret_cast<const void*>(
          fused_warp_kernel<T, BR, 2, NL, EXT>);
  }
  return reinterpret_cast<const void*>(fused_warp_kernel<T, BR, 1, NL, EXT>);
}

template <typename T, int BR, int NL, bool EXT>
static int launch(const FusedArgs* a, cudaStream_t stream) {
  int threads, blocks;
  size_t smem;
  if (!geometry<T, BR, NL>(a, threads, smem, blocks))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of<T, BR, NL, EXT>(a);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bool two = false;  // two table slots a lane
  if constexpr (BR == MULTI) {
    two = a->M > 32;
    if (two)
      fused_warp_kernel<T, BR, 2, NL, EXT>
          <<<blocks, threads, smem, stream>>>(*a);
  }
  if (!two)
    fused_warp_kernel<T, BR, 1, NL, EXT><<<blocks, threads, smem, stream>>>(
        *a);
  return (int)cudaGetLastError();
}

// out = {registers per thread, local (spill) bytes per thread, walkers
// resident on one SM, dynamic shared bytes per block, walkers per
// block, blocks} of the launch of a (only its shape and plan are read).
template <typename T, int BR, int NL, bool EXT>
static int occupancy(const FusedArgs* a, int* out) {
  int threads, blocks;
  size_t smem;
  if (!geometry<T, BR, NL>(a, threads, smem, blocks))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of<T, BR, NL, EXT>(a);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = per_sm * a->wpb;
  out[3] = (int)smem;
  out[4] = a->wpb;
  out[5] = blocks;
  return (int)err;
}

// The C entry points of one instantiation, bound by name in mcmc/fused.py
// (KERNELS): NAME_f32/_f64 launch on a stream, NAME_occupancy_f32/_f64
// fill occupancy's out.
#define FUSED_ENTRIES(NAME, BR, NL, EXT)                                    \
  int NAME##_f32(const FusedArgs* a, void* stream) {                       \
    return launch<float, BR, NL, EXT>(a, (cudaStream_t)stream);            \
  }                                                                        \
  int NAME##_f64(const FusedArgs* a, void* stream) {                       \
    return launch<double, BR, NL, EXT>(a, (cudaStream_t)stream);           \
  }                                                                        \
  int NAME##_occupancy_f32(const FusedArgs* a, int* out) {                 \
    return occupancy<float, BR, NL, EXT>(a, out);                          \
  }                                                                        \
  int NAME##_occupancy_f64(const FusedArgs* a, int* out) {                 \
    return occupancy<double, BR, NL, EXT>(a, out);                         \
  }
