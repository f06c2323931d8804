// One cycle of the lattice-switch sampler for every walker: all N
// steps of translations (static neighbour-table mode, one trial per
// move, two lattices), switch attempts and per-move Wang-Landau or
// unbiased-histogram updates.
//
// Replaces the TPU kernel FusedCycle._kernel with its table branch
// _do_translation_tbl (mc_water_ls_mw_tpu/mcmc/fused.py), which keeps a
// 128-walker block's state in VMEM and expresses every gather as a
// one-hot contraction.  Plain version: FusedCycle.plain in
// mcmc/fused.py, a loop over the steps that calls the engine's
// table-mode step (Engine._translation_tbl) and switch.
//
// What bounds it on the H100: latency.  Each walker's chain is a
// sequence of N dependent steps; a step reads the scheduled molecule's
// ~28 table partners in both lattices (3 coordinates, then 10 moments
// once the partner is in range: two dependent loads per partner) and
// does a few 10^3 operations, so neither the card's bytes (~229 MB per
// cycle at N=216, W=4096 in f32) nor its operations (~6*10^9) come near
// their limits in the time one thread needs to walk its steps (on an
// H100 at 700 W: 23 ms per cycle against a 0.09 ms bound).  Design: one
// thread per walker runs all N steps with its per-walker scalars, cell
// matrices and their inverses in registers; the state stays in device
// memory in the walker-last layout, so a warp's loads of one row of r or
// of the moments are coalesced 128-byte lines.  The shared schedule, the
// table row of the scheduled molecule and frac0 are uniform across the
// block: the tables (2*216*32 int32 = 55 KB), frac0, the bin grid and
// the schedule are staged in shared memory once per block, so every
// index fetch is a broadcast.  The one-hot eta and bin-width lookups of
// the TPU kernel become direct indexing weight[k*W + w]; the sentinel
// table index N is skipped explicitly instead of reading a zeroed pad
// row.  W = 4096 gives 32 blocks of 128 threads on 132 SMs: the card is
// under-occupied by design in this first version (warp-cooperative
// candidate loops are the way to more parallelism per walker).  It is
// built without FMA contraction (cuda_build.py), so each step rounds
// as the plain version's elementwise ops do and float32 accept
// decisions near their threshold rarely come out otherwise.
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
  void* cu;     // [N,7,W] pre-drawn uniforms
  void* binw;   // [B]
  void* mub;    // [B]
  void* basew;  // [B,W] master weight view per walker
  void* sched;  // [2,N] int32: move codes, then the molecule schedule
  void* tbl;    // [L*N*M] int32, (l*N + imol)*M + m, sentinel N
  void* frac0;  // [L*3*N], (l*3 + a)*N + imol
  int N, W, B, M;
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

// One table-mode translation of the shared molecule imol
// (Engine._translation_tbl; mc_moves.F90:966-1213).
template <typename T>
__device__ void translation(Walker<T>& s, const T* u, int imol,
                            const Consts<T>& c, const SW<T>& sw,
                            const FusedArgs& a) {
  const int N = s.N, M = s.M;
  // trial displacement in the active lattice, same fractional
  // displacement in the partner (mc_moves.F90:1021-1067)
  const T d0 = (T)2 * u[1] - (T)1;
  const T d1 = (T)2 * u[2] - (T)1;
  const T d2 = (T)2 * u[3] - (T)1;
  const T inv_norm = sw_rsqrt(fmax(d0 * d0 + d1 * d1 + d2 * d2, (T)1e-30));
  const T rmag = ((T)2 * u[4] - (T)1) * s.max_trans * inv_norm;
  const T v[3] = {d0 * rmag, d1 * rmag, d2 * rmag};
  // reciprocal matrix of the active lattice (read once per step)
  const T* R = s.recip + (size_t)(s.ls == 0 ? 0 : 9) * s.W + s.w;
  const T inv2pi = (T)(0.5 / 3.14159265358979323846);
  T sfrac[3];
#pragma unroll
  for (int b = 0; b < 3; ++b)
    sfrac[b] = (v[0] * R[(0 * 3 + b) * s.W] + v[1] * R[(1 * 3 + b) * s.W]
                + v[2] * R[(2 * 3 + b) * s.W]) * inv2pi;

  T dE[2], p_new[2][3], own_n[2][10];
  bool in_wall = true;
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    T p_old[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T tv = (s.ls == l)
          ? v[k]
          : s.H[l][k][0] * sfrac[0] + s.H[l][k][1] * sfrac[1]
                + s.H[l][k][2] * sfrac[2];
      p_old[k] = s.rr(l, k, imol);
      p_new[l][k] = p_old[k] + tv;
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
    // displacement wall: reference site = H . frac0
    T dw2 = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T ref = s.H[l][k][0] * s.s_frac0[(l * 3 + 0) * N + imol]
                  + s.H[l][k][1] * s.s_frac0[(l * 3 + 1) * N + imol]
                  + s.H[l][k][2] * s.s_frac0[(l * 3 + 2) * N + imol];
      const T dk = p_new[l][k] - ref;
      dw2 += dk * dk;
    }
    in_wall = in_wall & (dw2 <= c.wall2);
  }

  // acceptance (mc_moves.F90:1113-1146) with the finite-state guard
  const T dmu = (dE[0] - dE[1]) * c.beta;
  const T mu_new = s.mu + dmu;
  const T eta_old = eta_of(s.wl, s.mu, c.bin);
  const T eta_new = eta_of(s.wl, mu_new, c.bin);
  const T dE_ls = s.ls == 0 ? dE[0] : dE[1];
  const T diffkT = c.beta * dE_ls + eta_new - eta_old;
  const bool ok = isfinite(diffkT) & isfinite(mu_new) & in_wall;
  const bool accept = ok && (u[5] < exp(-diffkT));

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
      s.e[l] = s.e[l] + dE[l];
    }
    s.mu = mu_new;
    const T admu = fabs(dmu);
    if (admu < s.min_dmu) s.min_dmu = admu;
    if (admu > s.max_dmu) s.max_dmu = admu;
  }
  s.att[TRANS] += 1;
  s.acc[TRANS] += accept ? 1 : 0;
  s.tpm[(size_t)imol * s.W + s.w] += 1;
  // health gate: finite energies in both lattices
  if (a.wl_active)
    wl_update(s.wl, s.mu, s.f, isfinite(s.e[0]) & isfinite(s.e[1]),
              c.bin);
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

template <typename T>
__global__ void __launch_bounds__(128)
fused_cycle_kernel(const FusedArgs a) {
  const int N = a.N, W = a.W, B = a.B, M = a.M;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_frac0 = reinterpret_cast<T*>(smem);
  T* s_binw = s_frac0 + 2 * 3 * N;
  T* s_mub = s_binw + B;
  int* s_tbl = reinterpret_cast<int*>(s_mub + B);
  int* s_sched = s_tbl + 2 * N * M;
  for (int i = threadIdx.x; i < 2 * 3 * N; i += blockDim.x)
    s_frac0[i] = static_cast<const T*>(a.frac0)[i];
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    s_binw[i] = static_cast<const T*>(a.binw)[i];
    s_mub[i] = static_cast<const T*>(a.mub)[i];
  }
  for (int i = threadIdx.x; i < 2 * N * M; i += blockDim.x)
    s_tbl[i] = static_cast<const int*>(a.tbl)[i];
  for (int i = threadIdx.x; i < 2 * N; i += blockDim.x)
    s_sched[i] = static_cast<const int*>(a.sched)[i];
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
  for (int t = 0; t < N; ++t) {
    const int code = s_sched[t];
    const int imol = s_sched[N + t];
    T u[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) u[k] = cu[((size_t)t * 7 + k) * W + w];
    if (code == TRANS) translation(s, u, imol, c, sw, a);
    if (a.do_switch && a.switch_ok
        && (code == SWITCH || (a.always_switch && code == TRANS)))
      lattice_switch(s, u[6], c);
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

constexpr int TB = 128;  // threads (walkers) per block

// Dynamic shared memory of a block: frac0, bin widths and centres, the
// tables and the schedule.
template <typename T>
static size_t smem_bytes(int N, int B, int M) {
  return sizeof(T) * (2 * 3 * N + 2 * B) + sizeof(int) * (2 * N * M + 2 * N);
}

template <typename T>
static int launch(const FusedArgs* a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a->N, a->B, a->M);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cycle_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_cycle_kernel<T><<<(a->W + TB - 1) / TB, TB, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// out = {registers per thread, local (spill) bytes per thread, blocks
// of TB threads that can be resident on one SM}.
template <typename T>
static int occupancy(int N, int B, int M, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fused_cycle_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<T>(N, B, M);
  err = cudaFuncSetAttribute(fused_cycle_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], fused_cycle_kernel<T>, TB, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return (int)err;
}

extern "C" {

int fused_cycle_f32(const FusedArgs* a, void* stream) {
  return launch<float>(a, (cudaStream_t)stream);
}

int fused_cycle_f64(const FusedArgs* a, void* stream) {
  return launch<double>(a, (cudaStream_t)stream);
}

int fused_cycle_occupancy(int f64, int N, int B, int M, int* out) {
  return f64 ? occupancy<double>(N, B, M, out)
             : occupancy<float>(N, B, M, out);
}

}  // extern "C"
