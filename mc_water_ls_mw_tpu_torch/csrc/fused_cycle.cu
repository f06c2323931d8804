// One cycle of the lattice-switch sampler for every walker: all
// translations (two lattices), switch attempts and per-move
// Wang-Landau or unbiased-histogram updates of the cycle.  Three
// kernels, one per branch of the TPU kernel:
//
// * fused_cycle_kernel: static neighbour tables, one trial per move
//   (the shared molecule schedule, the displacement wall);
// * fused_cycle_dense_kernel: dense candidates (no tables): each walker
//   moves its own molecule and every molecule under every folded image
//   shift is a candidate, no wall;
// * fused_cycle_multi_kernel: static tables, T > 1 anchored-window
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
// sequence of dependent steps.  A table step reads the scheduled
// molecule's ~28 table partners in both lattices (3 coordinates, then
// 10 moments once the partner is in range: two dependent loads per
// partner) and does a few 10^3 operations, so neither the card's bytes
// (~229 MB per cycle at N=216, W=4096 in f32) nor its operations
// (~6*10^9) come near their limits in the time one thread needs to walk
// its steps (on an H100 at 700 W: 23 ms per cycle against a 0.09 ms
// bound).  A dense step tests all N molecules under S shifts at both
// points instead (N*S*2 folded distance tests per lattice), which makes
// its operation count N/M times larger.  Design: one thread per walker
// runs all steps with its per-walker scalars, cell matrices and their
// inverses in registers; the state stays in device memory in the
// walker-last layout, so a warp's loads of one row of r or of the
// moments are coalesced 128-byte lines: the dense kernel's threads walk
// the candidates j = 0..N-1 in lock step although their molecules
// differ.  What is uniform across the block is staged in shared memory
// once per block: the tables (2*216*32 int32 = 55 KB), frac0, the bin
// grid, the folded shifts and the schedule, so every index fetch is a
// broadcast.  The one-hot eta and bin-width lookups of the TPU kernel
// become direct indexing weight[k*W + w]; the sentinel table index N is
// skipped explicitly instead of reading a zeroed pad row.  W = 4096
// gives 32 blocks of 128 threads on 132 SMs: the card is under-occupied
// by design in this first version (warp-cooperative candidate loops are
// the way to more parallelism per walker).  It is built without FMA
// contraction (cuda_build.py), so each step rounds as the plain
// version's elementwise ops do and float32 accept decisions near their
// threshold rarely come out otherwise.
//
// The dense kernel writes only the rows a move changed: a row with no
// leg in range of either point keeps st - 0 + 0 = st exactly.  The
// multi-trial kernel holds no copy of the mover's table rows: every
// trial re-reads the original rows (the state is not written until the
// mover's store), and the store recomputes the rows of the last
// accepted point, or skips them when no trial was accepted (the JAX
// kernel then stores the original rows unchanged).
//
// In-place: r, mom, e, wgt, hist, uh, tpm, wf and wi are updated where
// they lie.
#include <cstdint>

#include "sw_common.cuh"
#include "wl_common.cuh"

namespace {

constexpr int TRANS = 0, SWITCH = 2;
constexpr int WF_MU = 0, WF_F = 1, WF_MIN_DMU = 3, WF_MAX_DMU = 4,
              WF_MAX_TRANS = 5, WF_MU_MIN = 6, WF_MU_MAX = 7;
constexpr int WI_LS = 0, WI_ATT = 1, WI_ACC = 4, WI_START = 7, WI_END = 8,
              WI_INWIN = 9;

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
};

template <typename T>
struct Consts {
  T beta, betaP, pressure, nwater, wall2;
  BinConsts<T> bin;
  __device__ explicit Consts(const FusedArgs& a)
      : beta((T)a.beta), betaP((T)a.betaP), pressure((T)a.pressure),
        nwater((T)a.nwater), wall2((T)a.wall2) {
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

// Per-walker view of the state and its constants.
template <typename T>
struct Walker {
  int w, W, N, M;
  T* r;
  T* mom;
  int* tpm;
  WLView<T> wl;  // the WL arrays, the bin grid and the walker's window
  const T* s_frac0;
  const int* s_tbl;
  const int* s_shifts;  // [S*3]
  int S;
  T H[2][3][3];  // cell matrices
  T A[2][3][3];  // rows of their inverses (MIC fold)
  const T* recip;  // [L,3,3,W] reciprocal matrices
  T vol[2];
  T e[2];
  T mu, f, min_dmu, max_dmu, max_trans;
  int ls, att[3], acc[3];

  __device__ __forceinline__ T& rr(int l, int a, int j) {
    return r[((size_t)(l * 3 + a) * N + j) * W + w];
  }
  __device__ __forceinline__ T& mm(int fld, int l, int j) {
    return mom[((size_t)(fld * 2 + l) * N + j) * W + w];
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
// (Engine._map_disp; mc_moves.F90:1042-1067).
template <typename T>
__device__ __forceinline__ void map_disp(const Walker<T>& s, const T v[3],
                                         T tv[2][3]) {
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
template <typename T>
__device__ __forceinline__ void trial_vectors(const Walker<T>& s,
                                              const T* u, T tv[2][3]) {
  const T d0 = (T)2 * u[1] - (T)1;
  const T d1 = (T)2 * u[2] - (T)1;
  const T d2 = (T)2 * u[3] - (T)1;
  const T inv_norm = sw_rsqrt(fmax(d0 * d0 + d1 * d1 + d2 * d2, (T)1e-30));
  const T rmag = ((T)2 * u[4] - (T)1) * s.max_trans * inv_norm;
  const T v[3] = {d0 * rmag, d1 * rmag, d2 * rmag};
  map_disp(s, v, tv);
}

// Acceptance of a translation with energy changes dE
// (Engine._trans_decision; mc_moves.F90:1113-1146) with the
// finite-state guard and the table modes' wall.
template <typename T>
__device__ __forceinline__ bool trans_decision(const Walker<T>& s,
                                               const T dE[2], T u_acc,
                                               bool extra_ok,
                                               const Consts<T>& c,
                                               T& mu_new, T& dmu) {
  dmu = (dE[0] - dE[1]) * c.beta;
  mu_new = s.mu + dmu;
  const T eta_old = eta_of(s.wl, s.mu, c.bin);
  const T eta_new = eta_of(s.wl, mu_new, c.bin);
  const T dE_ls = s.ls == 0 ? dE[0] : dE[1];
  const T diffkT = c.beta * dE_ls + eta_new - eta_old;
  const bool ok = isfinite(diffkT) & isfinite(mu_new) & extra_ok;
  return ok && (u_acc < exp(-diffkT));
}

// Energies, mu, counters and the per-move WL update after a performed
// translation (Engine._trans_bookkeeping).
template <typename T>
__device__ __forceinline__ void trans_bookkeeping(Walker<T>& s, bool accept,
                                                  T mu_new, T dmu,
                                                  const T dE[2],
                                                  const Consts<T>& c,
                                                  const FusedArgs& a) {
  if (accept) {
    s.e[0] = s.e[0] + dE[0];
    s.e[1] = s.e[1] + dE[1];
    s.mu = mu_new;
    const T admu = fabs(dmu);
    if (admu < s.min_dmu) s.min_dmu = admu;
    if (admu > s.max_dmu) s.max_dmu = admu;
  }
  s.att[TRANS] += 1;
  s.acc[TRANS] += accept ? 1 : 0;
  // health gate: finite energies in both lattices
  if (a.wl_active)
    wl_update(s.wl, s.mu, s.f, isfinite(s.e[0]) & isfinite(s.e[1]),
              c.bin);
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
    const T ref = s.H[l][k][0] * s.s_frac0[(l * 3 + 0) * N + imol]
                + s.H[l][k][1] * s.s_frac0[(l * 3 + 1) * N + imol]
                + s.H[l][k][2] * s.s_frac0[(l * 3 + 2) * N + imol];
    const T dk = p[k] - ref;
    dw2 += dk * dk;
  }
  return dw2 <= c.wall2;
}

// One table-mode translation of the shared molecule imol
// (Engine._translation_tbl; mc_moves.F90:966-1213).
template <typename T>
__device__ void translation(Walker<T>& s, const T* u, int imol,
                            const Consts<T>& c, const SW<T>& sw,
                            const FusedArgs& a) {
  const int N = s.N, M = s.M;
  T tv[2][3];
  trial_vectors(s, u, tv);

  T dE[2], p_new[2][3], own_n[2][10];
  bool wall_ok = true;
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    T p_old[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p_old[k] = s.rr(l, k, imol);
      p_new[l][k] = p_old[k] + tv[l][k];
    }
    Mom<T> oo, on;
    oo.zero();
    on.zero();
    T pair_o = 0, pair_n = 0, e3j_o = 0, e3j_n = 0;
    const int* row = s.s_tbl + (l * N + imol) * M;
    for (int m = 0; m < M; ++m) {
      const int j = row[m];
      if (j >= N) continue;  // sentinel: padded table slot
      const T cj[3] = {s.rr(l, 0, j), s.rr(l, 1, j), s.rr(l, 2, j)};
      const Leg<T> go = leg_of(cj, p_old, s.H[l], s.A[l], sw);
      const Leg<T> gn = leg_of(cj, p_new[l], s.H[l], s.A[l], sw);
      // a partner out of range in both positions contributes exactly 0
      if (!go.in && !gn.in) continue;
      T mj[10];
#pragma unroll
      for (int fld = 0; fld < 10; ++fld) mj[fld] = s.mm(fld, l, j);
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
    const T e_old = pair_o + sw.lam_eps * (e3_closed_form(oo.m, oo.w2, sw)
                                           + e3j_o);
    const T e_new = pair_n + sw.lam_eps * (e3_closed_form(on.m, on.w2, sw)
                                           + e3j_n);
    dE[l] = e_new - e_old;
#pragma unroll
    for (int fld = 0; fld < 10; ++fld) own_n[l][fld] = on.m[fld];
    wall_ok = wall_ok & in_wall(s, l, imol, p_new[l], c);
  }

  T mu_new, dmu;
  const bool accept = trans_decision(s, dE, u[5], wall_ok, c, mu_new, dmu);
  if (accept) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      T p_old[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) p_old[k] = s.rr(l, k, imol);
      // candidate moments: recomputed exactly as in the first pass
      const int* row = s.s_tbl + (l * N + imol) * M;
      for (int m = 0; m < M; ++m) {
        const int j = row[m];
        if (j >= N) continue;
        const T cj[3] = {s.rr(l, 0, j), s.rr(l, 1, j), s.rr(l, 2, j)};
        const Leg<T> go = leg_of(cj, p_old, s.H[l], s.A[l], sw);
        const Leg<T> gn = leg_of(cj, p_new[l], s.H[l], s.A[l], sw);
        if (!go.in && !gn.in) continue;
        T mj[10];
#pragma unroll
        for (int fld = 0; fld < 10; ++fld) mj[fld] = s.mm(fld, l, j);
        moved_moments(mj, go, gn);
#pragma unroll
        for (int fld = 0; fld < 10; ++fld) s.mm(fld, l, j) = mj[fld];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) s.rr(l, k, imol) = p_new[l][k];
#pragma unroll
      for (int fld = 0; fld < 10; ++fld) s.mm(fld, l, imol) = own_n[l][fld];
    }
  }
  s.tpm[(size_t)imol * s.W + s.w] += 1;
  trans_bookkeeping(s, accept, mu_new, dmu, dE, c, a);
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

// Leg of the folded displacement f under shift sh: in range when
// r2 < rc^2; the null image of the centre itself (self) is excluded
// (molint.F90:196-198, 532).  The null shift adds nothing.
template <typename T>
__device__ __forceinline__ Leg<T> dense_leg(const Walker<T>& s, int l, int sh,
                                            const T f[3], bool self,
                                            const SW<T>& sw) {
  T d[3] = {f[0], f[1], f[2]};
  if (sh > 0) {
    T img[3];
    image_of(s, l, sh, img);
    d[0] = f[0] + img[0];
    d[1] = f[1] + img[1];
    d[2] = f[2] + img[2];
  } else if (self) {
    return leg_none<T>();
  }
  const T r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  if (!(r2 < sw.rc2)) return leg_none<T>();
  return leg_in_range(d, r2, sw);
}

// Folded displacements of candidate j from the old and the new centre;
// the centre's own row holds the centre itself (ops/dense._candidates).
template <typename T>
__device__ __forceinline__ void dense_folds(Walker<T>& s, int l, int j,
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
// fused._do_translation).
template <typename T>
__device__ void translation_dense(Walker<T>& s, const T* u,
                                  const Consts<T>& c, const SW<T>& sw,
                                  const FusedArgs& a) {
  const int N = s.N, S = s.S;
  // the molecule: int32(u0 * N) with the product in the working type
  int imol = (int)(u[0] * (T)N);
  if (imol > N - 1) imol = N - 1;
  T tv[2][3];
  trial_vectors(s, u, tv);

  T dE[2], p_new[2][3], own_n[2][10];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    T p_old[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p_old[k] = s.rr(l, k, imol);
      p_new[l][k] = p_old[k] + tv[l][k];
    }
    Mom<T> oo, on;
    oo.zero();
    on.zero();
    T pair_o = 0, pair_n = 0, e3j_o = 0, e3j_n = 0;
    bool self_new = false;  // a non-null image of the centre in range
    for (int j = 0; j < N; ++j) {
      const bool self = j == imol;
      T fo[3], fn[3];
      dense_folds(s, l, j, self, p_old, p_new[l], fo, fn);
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
          pair_o += go.pair;
          Ro.add(go.w, go.ux, go.uy, go.uz);
          e3j_o += wing(go, mj, sw);
        }
        const Leg<T> gn = dense_leg(s, l, sh, fn, self, sw);
        if (gn.in) {
          pair_n += gn.pair;
          Rn.add(gn.w, gn.ux, gn.uy, gn.uz);
          any_n = true;
        }
      }
      if (!any && !any_n) continue;  // the row contributes exactly 0
      if (any_n) {
        if (self) {
          // wing terms of the centre's own images need its new
          // moments: added after the loop
          self_new = true;
        } else {
          if (!any) {
#pragma unroll
            for (int fld = 0; fld < 10; ++fld) mj[fld] = s.mm(fld, l, j);
          }
          moved_rows(mj, Ro, Rn);
          for (int sh = 0; sh < S; ++sh) {
            const Leg<T> gn = dense_leg(s, l, sh, fn, self, sw);
            if (gn.in) e3j_n += wing(gn, mj, sw);
          }
        }
      }
      add_sums(oo, Ro);
      add_sums(on, Rn);
    }
    if (self_new) {
      T fn[3] = {0, 0, 0};  // the folded zero displacement
      for (int sh = 1; sh < S; ++sh) {
        const Leg<T> gn = dense_leg(s, l, sh, fn, true, sw);
        if (gn.in) e3j_n += wing(gn, on.m, sw);
      }
    }
    const T e_old = pair_o + sw.lam_eps * (e3_closed_form(oo.m, oo.w2, sw)
                                           + e3j_o);
    const T e_new = pair_n + sw.lam_eps * (e3_closed_form(on.m, on.w2, sw)
                                           + e3j_n);
    dE[l] = e_new - e_old;
#pragma unroll
    for (int fld = 0; fld < 10; ++fld) own_n[l][fld] = on.m[fld];
  }

  T mu_new, dmu;
  const bool accept = trans_decision(s, dE, u[5], true, c, mu_new, dmu);
  if (accept) {
    // second pass: write the rows the move changed, recomputed exactly
    // as in the first
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      T p_old[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) p_old[k] = s.rr(l, k, imol);
      for (int j = 0; j < N; ++j) {
        if (j == imol) continue;
        T fo[3], fn[3];
        dense_folds(s, l, j, false, p_old, p_new[l], fo, fn);
        Mom<T> Ro, Rn;
        Ro.zero();
        Rn.zero();
        bool any = false;
        for (int sh = 0; sh < S; ++sh) {
          const Leg<T> go = dense_leg(s, l, sh, fo, false, sw);
          if (go.in) {
            Ro.add(go.w, go.ux, go.uy, go.uz);
            any = true;
          }
          const Leg<T> gn = dense_leg(s, l, sh, fn, false, sw);
          if (gn.in) {
            Rn.add(gn.w, gn.ux, gn.uy, gn.uz);
            any = true;
          }
        }
        if (!any) continue;
        T mj[10];
#pragma unroll
        for (int fld = 0; fld < 10; ++fld) mj[fld] = s.mm(fld, l, j);
        moved_rows(mj, Ro, Rn);
#pragma unroll
        for (int fld = 0; fld < 10; ++fld) s.mm(fld, l, j) = mj[fld];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) s.rr(l, k, imol) = p_new[l][k];
#pragma unroll
      for (int fld = 0; fld < 10; ++fld) s.mm(fld, l, imol) = own_n[l][fld];
    }
  }
  s.tpm[(size_t)imol * s.W + s.w] += 1;
  trans_bookkeeping(s, accept, mu_new, dmu, dE, c, a);
}

// Lattice switch attempt (Engine._switch; mc_moves.F90:1536-1594).
template <typename T>
__device__ void lattice_switch(Walker<T>& s, T zeta, const Consts<T>& c) {
  const int ls = s.ls;
  const T E_ls = ls == 0 ? s.e[0] : s.e[1];
  const T E_lsn = ls == 0 ? s.e[1] : s.e[0];
  const T V_ls = ls == 0 ? s.vol[0] : s.vol[1];
  const T V_lsn = ls == 0 ? s.vol[1] : s.vol[0];
  const T diffkT = c.beta * (E_lsn - E_ls) + c.betaP * (V_lsn - V_ls)
                 - c.nwater * log(V_lsn / V_ls);
  const bool accept = isfinite(diffkT) && (zeta < exp(-diffkT));
  if (accept) {
    s.ls = 1 - ls;
    const T mu = s.e[0] + c.pressure * s.vol[0] - s.e[1]
               - c.pressure * s.vol[1];
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

// One pass over the mover's table partners in lattice l against the
// original rows: the local energy at point p, with (when p0 is given)
// each partner's moments moved from p0 to p (st - delta(p0) +
// delta(p)), and the centre's own moments at p.
template <typename T>
__device__ T table_point_energy(Walker<T>& s, int l, int imol,
                                const T* p0, const T p[3], const SW<T>& sw,
                                T own[10]) {
  const int N = s.N, M = s.M;
  Mom<T> on;
  on.zero();
  T pair = 0, e3j = 0;
  const int* row = s.s_tbl + (l * N + imol) * M;
  for (int m = 0; m < M; ++m) {
    const int j = row[m];
    if (j >= N) continue;
    const T cj[3] = {s.rr(l, 0, j), s.rr(l, 1, j), s.rr(l, 2, j)};
    const Leg<T> gt = leg_of(cj, p, s.H[l], s.A[l], sw);
    if (!gt.in) continue;  // its wing term is exactly 0
    T mj[10];
#pragma unroll
    for (int fld = 0; fld < 10; ++fld) mj[fld] = s.mm(fld, l, j);
    if (p0 != nullptr) {
      const Leg<T> g0 = leg_of(cj, p0, s.H[l], s.A[l], sw);
      moved_moments(mj, g0, gt);
    }
    pair += gt.pair;
    on.add(gt.w, gt.ux, gt.uy, gt.uz);
    e3j += wing(gt, mj, sw);
  }
#pragma unroll
  for (int fld = 0; fld < 10; ++fld) own[fld] = on.m[fld];
  return pair + sw.lam_eps * (e3_closed_form(on.m, on.w2, sw) + e3j);
}

// T anchored-window trials of the shared mover imol on one fetch of its
// rows (Engine._translation_tbl_multi; the JAX package's
// fused._do_translation_tbl_multi).  u points at the mover's uniforms
// (slot k at u[k * W]); codes at the codes of its T trials.
template <typename T>
__device__ void mover_multi(Walker<T>& s, const T* u, const int* codes,
                            int imol, const Consts<T>& c, const SW<T>& sw,
                            const FusedArgs& a) {
  const int N = s.N, M = s.M, TT = a.T, W = s.W;
  T p0[2][3], e_cur[2], own[10];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
#pragma unroll
    for (int k = 0; k < 3; ++k) p0[l][k] = s.rr(l, k, imol);
    // point 0: the mover's current local energy
    e_cur[l] = table_point_energy<T>(s, l, imol, nullptr, p0[l], sw, own);
  }
  T anc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) anc[k] = (T)2 * u[(1 + k) * W] - (T)1;
  int acc_t = -1;  // the last accepted trial
  T p_cur[2][3], own_cur[2][10];
  int n_en = 0;
  for (int t = 0; t < TT; ++t) {
    const int code = codes[t];
    if (code == TRANS) {
      ++n_en;
      // anchored-window candidate: v_t = (a + b_t) * max_trans
      T v[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        v[k] = (anc[k] + ((T)2 * u[(4 + 3 * t + k) * W] - (T)1))
               * s.max_trans;
      T tv[2][3];
      map_disp(s, v, tv);
      T p_t[2][3], e_t[2], dE[2], own_t[2][10];
      bool wall_ok = true;
#pragma unroll
      for (int l = 0; l < 2; ++l) {
#pragma unroll
        for (int k = 0; k < 3; ++k) p_t[l][k] = p0[l][k] + tv[l][k];
        e_t[l] = table_point_energy<T>(s, l, imol, p0[l], p_t[l], sw,
                                       own_t[l]);
        dE[l] = e_t[l] - e_cur[l];
        // displacement wall on the candidate point
        wall_ok = wall_ok & in_wall(s, l, imol, p_t[l], c);
      }
      T mu_new, dmu;
      const bool accept = trans_decision(s, dE, u[(4 + 3 * TT + t) * W],
                                         wall_ok, c, mu_new, dmu);
      trans_bookkeeping(s, accept, mu_new, dmu, dE, c, a);
      if (accept) {
        acc_t = t;
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          e_cur[l] = e_t[l];
#pragma unroll
          for (int k = 0; k < 3; ++k) p_cur[l][k] = p_t[l][k];
#pragma unroll
          for (int fld = 0; fld < 10; ++fld) own_cur[l][fld] = own_t[l][fld];
        }
      }
    }
    if (switch_on(code, a)) lattice_switch(s, u[(4 + 4 * TT + t) * W], c);
  }

  // one store per T trials: the rows of the last accepted point; with
  // none accepted, every row keeps its value
  if (acc_t >= 0) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int* row = s.s_tbl + (l * N + imol) * M;
      for (int m = 0; m < M; ++m) {
        const int j = row[m];
        if (j >= N) continue;
        const T cj[3] = {s.rr(l, 0, j), s.rr(l, 1, j), s.rr(l, 2, j)};
        const Leg<T> g0 = leg_of(cj, p0[l], s.H[l], s.A[l], sw);
        const Leg<T> gn = leg_of(cj, p_cur[l], s.H[l], s.A[l], sw);
        if (!g0.in && !gn.in) continue;
        T mj[10];
#pragma unroll
        for (int fld = 0; fld < 10; ++fld) mj[fld] = s.mm(fld, l, j);
        moved_moments(mj, g0, gn);
#pragma unroll
        for (int fld = 0; fld < 10; ++fld) s.mm(fld, l, j) = mj[fld];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) s.rr(l, k, imol) = p_cur[l][k];
#pragma unroll
      for (int fld = 0; fld < 10; ++fld)
        s.mm(fld, l, imol) = own_cur[l][fld];
    }
  }
  s.tpm[(size_t)imol * W + s.w] += n_en;
}

// ---- the kernels --------------------------------------------------------

enum Branch { TABLE = 0, DENSE = 1, MULTI = 2 };

constexpr int TB = 128;  // threads (walkers) per block

// Dynamic shared memory of a block: frac0 (table modes), bin widths and
// centres, then the tables (table modes), the schedule (codes and, in
// the table modes, the molecule schedule) and the folded shifts.
template <typename T>
static size_t smem_bytes(int branch, int N, int B, int M,
                                      int S, int n_steps) {
  const bool tbl = branch != DENSE;
  return sizeof(T) * ((tbl ? 2 * 3 * N : 0) + 2 * B)
         + sizeof(int) * ((tbl ? 2 * N * M + n_steps : 0) + N + 3 * S);
}

template <typename T, int BR>
__global__ void __launch_bounds__(TB) fused_kernel(const FusedArgs a) {
  const int N = a.N, W = a.W, B = a.B, M = a.M, S = a.S;
  const bool tbl = BR != DENSE;
  const int n_steps = BR == MULTI ? N / a.T : N;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_frac0 = reinterpret_cast<T*>(smem);
  T* s_binw = s_frac0 + (tbl ? 2 * 3 * N : 0);
  T* s_mub = s_binw + B;
  int* s_tbl = reinterpret_cast<int*>(s_mub + B);
  int* s_sched = s_tbl + (tbl ? 2 * N * M : 0);
  int* s_shifts = s_sched + N + (tbl ? n_steps : 0);
  if (tbl) {
    for (int i = threadIdx.x; i < 2 * 3 * N; i += blockDim.x)
      s_frac0[i] = static_cast<const T*>(a.frac0)[i];
    for (int i = threadIdx.x; i < 2 * N * M; i += blockDim.x)
      s_tbl[i] = static_cast<const int*>(a.tbl)[i];
  }
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    s_binw[i] = static_cast<const T*>(a.binw)[i];
    s_mub[i] = static_cast<const T*>(a.mub)[i];
  }
  for (int i = threadIdx.x; i < N + (tbl ? n_steps : 0); i += blockDim.x)
    s_sched[i] = static_cast<const int*>(a.sched)[i];
  for (int i = threadIdx.x; i < 3 * S; i += blockDim.x)
    s_shifts[i] = static_cast<const int*>(a.shifts)[i];
  __syncthreads();

  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;  // ragged edge: W need not be a multiple of 128

  const Consts<T> c(a);
  const SW<T> sw(a.sw);
  const T* h = static_cast<const T*>(a.h);
  const T* volp = static_cast<const T*>(a.vol);
  T* ep = static_cast<T*>(a.e);
  T* wf = static_cast<T*>(a.wf);
  int* wi = static_cast<int*>(a.wi);

  Walker<T> s;
  s.w = w;
  s.W = W;
  s.N = N;
  s.M = M;
  s.S = S;
  s.r = static_cast<T*>(a.r);
  s.mom = static_cast<T*>(a.mom);
  s.wl.w = w;
  s.wl.W = W;
  s.wl.B = B;
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
  s.s_frac0 = s_frac0;
  s.s_tbl = s_tbl;
  s.s_shifts = s_shifts;
#pragma unroll
  for (int l = 0; l < 2; ++l) {
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

  const T* cu = static_cast<const T*>(a.cu);
  if (BR == MULTI) {
    const int n_u = 4 + 5 * a.T;
    for (int t = 0; t < n_steps; ++t)
      mover_multi(s, cu + (size_t)t * n_u * W + w, s_sched + t * a.T,
                  s_sched[N + t], c, sw, a);
  } else {
    for (int t = 0; t < N; ++t) {
      const int code = s_sched[t];
      T u[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) u[k] = cu[((size_t)t * 7 + k) * W + w];
      if (code == TRANS) {
        if (BR == DENSE)
          translation_dense(s, u, c, sw, a);
        else
          translation(s, u, s_sched[N + t], c, sw, a);
      }
      if (switch_on(code, a)) lattice_switch(s, u[6], c);
    }
  }

#pragma unroll
  for (int l = 0; l < 2; ++l) ep[l * W + w] = s.e[l];
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

template <typename T, int BR>
static int launch(const FusedArgs* a, cudaStream_t stream) {
  const int n_steps = BR == MULTI ? a->N / a->T : a->N;
  const size_t smem = smem_bytes<T>(BR, a->N, a->B, a->M, a->S, n_steps);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<T, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_kernel<T, BR><<<(a->W + TB - 1) / TB, TB, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// out = {registers per thread, local (spill) bytes per thread, blocks
// of TB threads that can be resident on one SM}.
template <typename T, int BR>
static int occupancy(int N, int B, int M, int S, int n_steps, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fused_kernel<T, BR>);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<T>(BR, N, B, M, S, n_steps);
  err = cudaFuncSetAttribute(fused_kernel<T, BR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], fused_kernel<T, BR>, TB, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return (int)err;
}

template <typename T>
static int occupancy_of(int branch, int N, int B, int M, int S,
                        int n_steps, int* out) {
  switch (branch) {
    case TABLE: return occupancy<T, TABLE>(N, B, M, S, n_steps, out);
    case DENSE: return occupancy<T, DENSE>(N, B, M, S, n_steps, out);
    default: return occupancy<T, MULTI>(N, B, M, S, n_steps, out);
  }
}

extern "C" {

int fused_cycle_f32(const FusedArgs* a, void* stream) {
  return launch<float, TABLE>(a, (cudaStream_t)stream);
}

int fused_cycle_f64(const FusedArgs* a, void* stream) {
  return launch<double, TABLE>(a, (cudaStream_t)stream);
}

int fused_cycle_dense_f32(const FusedArgs* a, void* stream) {
  return launch<float, DENSE>(a, (cudaStream_t)stream);
}

int fused_cycle_dense_f64(const FusedArgs* a, void* stream) {
  return launch<double, DENSE>(a, (cudaStream_t)stream);
}

int fused_cycle_multi_f32(const FusedArgs* a, void* stream) {
  return launch<float, MULTI>(a, (cudaStream_t)stream);
}

int fused_cycle_multi_f64(const FusedArgs* a, void* stream) {
  return launch<double, MULTI>(a, (cudaStream_t)stream);
}

int fused_cycle_occupancy(int branch, int f64, int N, int B, int M, int S,
                          int n_steps, int* out) {
  return f64 ? occupancy_of<double>(branch, N, B, M, S, n_steps, out)
             : occupancy_of<float>(branch, N, B, M, S, n_steps, out);
}

}  // extern "C"
