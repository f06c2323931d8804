// The acceptance chain of one cell-engine sub-step: per walker the
// sequential K x T Metropolis trials over a table of precomputed point
// energies (P = T + 1 points per mover, point 0 the current position),
// the compensated energy accumulation, the per-move Wang-Landau or
// unbiased-histogram update of weight / hist / uhist [B, W], the switch
// attempt after each trial, and the counters.
//
// Replaces the TPU kernel ChainWLPallas._kernel
// (mc_water_ls_mw_tpu/mcmc/chain_pallas.py), whose reason for being is
// to keep the [B, W] WL slabs resident in VMEM for the whole chain and
// which looks every bin up by a one-hot contraction over B.  Plain
// version: ChainWLKernel.plain in mcmc/chain_kernel.py.
//
// What bounds it on the H100: latency.  A walker's chain is K*T
// dependent steps, each a handful of loads at data-dependent bins of its
// own column of the slabs and ~10^2 operations; the bytes touched
// (K*T*(2P + 4) table values and ~10 slab entries per walker: ~0.3 MB
// at K=8, T=1, W=512 in f32) would take the card ~0.1 us.  Design: one
// thread per walker with the chain state (mu, both energies and their
// compensation residuals, ls, counters) in registers; the slabs stay in
// device memory and are indexed directly at [bin, walker] (a warp's 32
// walkers read one row each: neighbouring addresses where they sit in
// the same bin); the bin grid and the move codes are staged in shared
// memory.  Blocks are single warps, so that W = 512 walkers spread over
// 16 SMs rather than 4.  The loop is written for any T; MINU, the
// Swetnam and the 1/t schedules are not ported (the engine refuses them).
//
// eta_of and wl_update are those of the N=216 whole-cycle kernel
// (wl_common.cuh).  Built without FMA contraction and without fast
// math: the two-sum below must not be reassociated.
//
// In place: cf, ci, wgt, hist and uh are updated where they lie.
#include <cstdint>

#include "wl_common.cuh"

namespace {

constexpr int TRANS = 0, SWITCH = 2;
// row layouts of mcmc/chain_kernel.py
constexpr int CF_MU = 0, CF_E0 = 1, CF_E1 = 2, CF_F = 3, CF_MIN_DMU = 5,
              CF_MAX_DMU = 6, CF_MU_MIN = 7, CF_MU_MAX = 8, CF_CMU = 9,
              CF_SWC = 10, CF_E0E = 12, CF_E1E = 13;
constexpr int CI_LS = 0, CI_START = 1, CI_END = 2, CI_INWIN = 3,
              CI_OCCOK = 5, CI_SWOK = 6;
constexpr int CN_EN = 0, CN_ACC = 1, CN_SWEN = 2, CN_SWACC = 3, CN_FIXED = 4;
constexpr int TB = 32;  // threads (walkers) per block

}  // namespace

// Mirror of the ctypes structure ChainArgs in mcmc/chain_kernel.py.
struct ChainArgs {
  void* codes;  // [K*T] int32 move codes, trial (k, t) at k*T + t
  void* cf;     // [14, W] float rows (in/out)
  void* ci;     // [7, W] int32 rows (in/out)
  void* wgt;    // [B, W] (in/out)
  void* hist;   // [B, W] (in/out)
  void* uh;     // [B, W] (in/out; sample run only, else null)
  void* basew;  // [B, W] master weight view per walker
  void* binw;   // [B]
  void* mub;    // [B]
  void* e;      // [2*K*P, W] point energies: lattice, mover, point
  void* inc;    // [K*P, W] in-cell flags (> 0.5)
  void* hasm;   // [K, W] mover-exists flags (> 0.5)
  void* ua;     // [K*T, W] accept uniforms
  void* uz;     // [K*T, W] switch uniforms
  void* joh;    // [K*P, W] out: one-hot of each mover's accepted point
  void* cnt;    // [4+K, W] int32 out
  int K, Tn, W, B;  // Tn: trials per mover
  int wl_active, samplerun, eta_interp, dd_seeding, do_switch,
      always_switch;
  double beta, av_bw, log_norm;
  double cpos, cneg, a_pos, a_neg, lnr_pos, lnr_neg;  // mu_to_bin
};

// Knuth two-sum: s + err == a + b exactly.
template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& err) {
  s = a + b;
  const T bb = s - a;
  err = (a - (s - bb)) + (b - bb);
}

template <typename T>
__global__ void __launch_bounds__(TB) chain_wl_kernel(const ChainArgs a) {
  const int K = a.K, Tn = a.Tn, P = a.Tn + 1, W = a.W, B = a.B;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_binw = reinterpret_cast<T*>(smem);
  T* s_mub = s_binw + B;
  int* s_codes = reinterpret_cast<int*>(s_mub + B);
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    s_binw[i] = static_cast<const T*>(a.binw)[i];
    s_mub[i] = static_cast<const T*>(a.mub)[i];
  }
  for (int i = threadIdx.x; i < K * Tn; i += blockDim.x)
    s_codes[i] = static_cast<const int*>(a.codes)[i];
  __syncthreads();

  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;

  BinConsts<T> bc;
  bc.cpos = (T)a.cpos;
  bc.cneg = (T)a.cneg;
  bc.a_pos = (T)a.a_pos;
  bc.a_neg = (T)a.a_neg;
  bc.lnr_pos = (T)a.lnr_pos;
  bc.lnr_neg = (T)a.lnr_neg;
  bc.av_bw = (T)a.av_bw;
  bc.log_norm = (T)a.log_norm;
  const T beta = (T)a.beta;

  T* cf = static_cast<T*>(a.cf);
  int* ci = static_cast<int*>(a.ci);
  const T* e = static_cast<const T*>(a.e);
  const T* inc = static_cast<const T*>(a.inc);
  const T* hasm = static_cast<const T*>(a.hasm);
  const T* ua = static_cast<const T*>(a.ua);
  const T* uz = static_cast<const T*>(a.uz);
  T* joh = static_cast<T*>(a.joh);
  int* cnt = static_cast<int*>(a.cnt);

  WLView<T> v;
  v.w = w;
  v.W = W;
  v.B = B;
  v.wgt = static_cast<T*>(a.wgt);
  v.hist = static_cast<T*>(a.hist);
  v.uh = static_cast<T*>(a.uh);
  v.basew = static_cast<const T*>(a.basew);
  v.binw = s_binw;
  v.mub = s_mub;
  v.mu_min = cf[CF_MU_MIN * W + w];
  v.mu_max = cf[CF_MU_MAX * W + w];
  v.start_bin = ci[CI_START * W + w];
  v.end_bin = ci[CI_END * W + w];
  v.in_window = ci[CI_INWIN * W + w];
  v.eta_interp = a.eta_interp;
  v.dd_seeding = a.dd_seeding;
  v.samplerun = a.samplerun;

  // the chain state, in registers
  T mu = cf[CF_MU * W + w];
  T e0 = cf[CF_E0 * W + w], e1 = cf[CF_E1 * W + w];
  T er0 = cf[CF_E0E * W + w], er1 = cf[CF_E1E * W + w];
  const T f = cf[CF_F * W + w];
  T min_dmu = cf[CF_MIN_DMU * W + w], max_dmu = cf[CF_MAX_DMU * W + w];
  const T cmu = cf[CF_CMU * W + w], sw_c = cf[CF_SWC * W + w];
  int ls = ci[CI_LS * W + w];
  const bool occ_ok = ci[CI_OCCOK * W + w] != 0;
  const bool sw_ok = ci[CI_SWOK * W + w] != 0;
  int n_en = 0, n_acc = 0, n_swen = 0, n_swacc = 0;

  for (int k = 0; k < K; ++k) {
    const bool has_k = hasm[(size_t)k * W + w] > (T)0.5;
    int j = 0;      // the mover's current point
    int kt_en = 0;  // its translation attempts
    for (int t = 1; t < P; ++t) {
      const int i = k * Tn + (t - 1);
      const int code = s_codes[i];
      const bool tt = code == TRANS;
      const bool sw_try = a.always_switch ? (tt || code == SWITCH)
                                          : code == SWITCH;
      // a trial exists where the scheduled cell holds a molecule; the
      // cell wall only vetoes acceptance
      const bool enabled = tt && has_k;
      if (enabled) {
        // dE(current point -> t) from the point table.  The current
        // point's values are read as the TPU kernel reads them, as
        // sum_p onehot[p] * v[p]: a non-finite energy at any point of
        // the mover poisons (and so rejects) its later trials
        const size_t r0 = (size_t)(k * P) * W + w;
        const size_t r1 = (size_t)((K + k) * P) * W + w;
        T ec0 = (T)0, ec1 = (T)0, ic = (T)0;
        for (int p = 0; p < P; ++p) {
          const T oh = p == j ? (T)1 : (T)0;
          ec0 = ec0 + oh * e[r0 + (size_t)p * W];
          ec1 = ec1 + oh * e[r1 + (size_t)p * W];
          ic = ic + oh * inc[r0 + (size_t)p * W];
        }
        const T dE0 = e[r0 + (size_t)t * W] - ec0;
        const T dE1 = e[r1 + (size_t)t * W] - ec1;
        const bool gate = (ic > (T)0.5) && (inc[r0 + (size_t)t * W] > (T)0.5);
        const T dmu = (dE0 - dE1) * beta;
        const T mu_new = mu + dmu;
        const T eta_old = eta_of(v, mu, bc);
        const T eta_new = eta_of(v, mu_new, bc);
        const T dE_ls = ls == 0 ? dE0 : dE1;
        const T diffkT = beta * dE_ls + eta_new - eta_old;
        // finite-state guard: never accept non-finite deltas
        const bool ok = isfinite(diffkT) && isfinite(mu_new);
        const bool accept = gate && ok
            && (ua[(size_t)i * W + w] < exp(-diffkT));
        if (accept) {
          // compensated accumulation: at N ~ 10^4 a move's dE is of the
          // size of an ulp of the float32 total
          T s_, r_, h_, l_;
          two_sum(e0, dE0, s_, r_);
          two_sum(s_, er0 + r_, h_, l_);
          e0 = h_;
          er0 = l_;
          two_sum(e1, dE1, s_, r_);
          two_sum(s_, er1 + r_, h_, l_);
          e1 = h_;
          er1 = l_;
          mu = mu_new;
          j = t;
          const T admu = fabs(dmu);
          min_dmu = fmin(min_dmu, admu);
          max_dmu = fmax(max_dmu, admu);
          n_acc += 1;
        }
        n_en += 1;
        kt_en += 1;
        // per-move WL update at mu after the trial; a walker with
        // non-finite energies or an overflowed slab never writes into
        // the shared arrays
        if (a.wl_active)
          wl_update(v, mu, f, isfinite(e0) && isfinite(e1) && occ_ok, bc);
      }
      // switch attempt after the trial (mc_lattice_switch,
      // mc_moves.F90:1536-1594)
      if (a.do_switch && sw_ok && sw_try) {
        const T de10 = beta * ((e1 - e0) + (er1 - er0));
        const T dsw = ls == 0 ? de10 + sw_c : -(de10 + sw_c);
        const bool sw_acc = isfinite(dsw)
            && (uz[(size_t)i * W + w] < exp(-dsw));
        if (sw_acc) {
          ls = 1 - ls;
          mu = cmu - de10;  // mu from scratch
          n_swacc += 1;
        }
        n_swen += 1;
      }
    }
    for (int p = 0; p < P; ++p)
      joh[(size_t)(k * P + p) * W + w] = p == j ? (T)1 : (T)0;
    cnt[(size_t)(CN_FIXED + k) * W + w] = kt_en;
  }

  cf[CF_MU * W + w] = mu;
  cf[CF_E0 * W + w] = e0;
  cf[CF_E1 * W + w] = e1;
  cf[CF_E0E * W + w] = er0;
  cf[CF_E1E * W + w] = er1;
  cf[CF_MIN_DMU * W + w] = min_dmu;
  cf[CF_MAX_DMU * W + w] = max_dmu;
  ci[CI_LS * W + w] = ls;
  cnt[CN_EN * W + w] = n_en;
  cnt[CN_ACC * W + w] = n_acc;
  cnt[CN_SWEN * W + w] = n_swen;
  cnt[CN_SWACC * W + w] = n_swacc;
}

template <typename T>
static int launch(const ChainArgs* a, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 2 * a->B + sizeof(int) * a->K * a->Tn;
  chain_wl_kernel<T><<<(a->W + TB - 1) / TB, TB, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" {

int chain_wl_f32(const ChainArgs* a, void* stream) {
  return launch<float>(a, (cudaStream_t)stream);
}

int chain_wl_f64(const ChainArgs* a, void* stream) {
  return launch<double>(a, (cudaStream_t)stream);
}

}  // extern "C"
