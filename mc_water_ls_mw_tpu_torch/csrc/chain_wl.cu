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
// dependent steps, each a handful of lookups at data-dependent bins of
// its own column of the slabs and ~10^2 operations; the bytes touched
// (K*T*(2P + 4) table values and ~10 slab entries per walker: ~0.3 MB
// at K=8, T=1, W=512 in f32) would take the card ~0.1 us.  The first
// design (one thread per walker, the slabs indexed in device memory)
// took 0.0276 ms at K=8, W=512, 0.142 ms at K=32, W=128 and 0.174 ms
// at K=8, T=8, W=128 in f32 on an H100 80GB HBM3 at 700 W: 2.7-4.4 us
// a trial.  Staging the slabs in shared memory alone took that to
// 0.0228, 0.074 and 0.141 ms: a trial was still ~2.2 us, the dependent
// instructions of one thread (three mu_to_bin a trial, each a log and
// two IEEE divisions, two eta lookups with two divisions each, two exp),
// issued in order by a warp whose 8 walkers diverged at every branch.
// Design: the walker's columns stay on the chip for the whole pass, as
// the TPU kernel keeps its slabs in VMEM.  A block of ``wpb`` warps
// serves wpb walkers (mcmc/chain_kernel.chain_plan: 4, one for each of
// an SM's warp schedulers; no two walkers share a warp, so none waits on
// another's branches); all its threads copy the walkers' columns of
// wgt, basew, hist (and uhist in a sample run) and of every table the
// chain reads (point energies, in-cell flags, mover flags, both uniform
// rows) into shared memory ([row][walker]) with asynchronous copies
// issued all at once; lane 0 of warp i then runs walker i's chain on
// shared memory alone, and the block writes back the slab columns the
// chain may have changed.  A trial is written without branches (each
// outcome formed, then selected), and each new mu is binned once (the
// bin travels with mu).  Where one walker's columns do not fit a
// block's shared memory the plan reads them in place (8 walkers a
// block, read-only tables through the non-coherent cache).  The bin
// grid and the move codes are staged in both.  What a trial still costs on
// an H100 (~1900 cycles in f32, clock probes): its dependent
// instructions issued in order by one lane, the IEEE divisions (two in
// mu_to_bin, two in each eta lookup) each a check-and-call region of
// its own that nothing overlaps.  The loop is written for any T.
// Instantiations with EXT = true take MINU, which folds a switch to the
// lattice of the lower trial enthalpy into each translation (its hoisted
// terms in CF_MINUC and CF_SWC), and the Swetnam and 1/t f schedules
// (f_schedule_at of wl_common.cuh), which change f, and Swetnam's
// sumhist, from trial to trial: Swetnam's f sums the walker's whole
// histogram, its growth from the staged columns and the master view read
// in place, at each update (B bins in order, by lane 0).  The plain
// settings run the EXT = false instantiations, which keep their
// registers (the rules' terms raise the staged f32 kernel's from 80 to
// ~127 a thread).
//
// mu_to_bin and eta (eta_at) are those of the N=216 whole-cycle kernel
// and the WL update is wl_update_at (all in wl_common.cuh), given a view
// whose column stride is wpb (staged) or W (in place): the same
// operations in the same order either way.  Built without FMA contraction and without
// fast math: the two-sum below must not be reassociated.
//
// In place: cf, ci, wgt, hist and uh are updated where they lie.
#include <cstdint>

#include "cp_async.cuh"
#include "wl_common.cuh"

namespace {

constexpr int TRANS = 0, SWITCH = 2;
// row layouts of mcmc/chain_kernel.py
constexpr int CF_MU = 0, CF_E0 = 1, CF_E1 = 2, CF_F = 3, CF_SUMHIST = 4,
              CF_MIN_DMU = 5, CF_MAX_DMU = 6, CF_MU_MIN = 7, CF_MU_MAX = 8,
              CF_CMU = 9, CF_SWC = 10, CF_MINUC = 11, CF_E0E = 12,
              CF_E1E = 13;
constexpr int CI_LS = 0, CI_START = 1, CI_END = 2, CI_INWIN = 3,
              CI_INVT = 4, CI_OCCOK = 5, CI_SWOK = 6;
constexpr int CN_EN = 0, CN_ACC = 1, CN_SWEN = 2, CN_SWACC = 3, CN_FIXED = 4;
// walkers (warps) of a block at most (mcmc/chain_kernel.CHAIN_WPB_MAX)
// and of an in-place block (INPLACE_WPB)
constexpr int CHAIN_WPB_MAX = 8;
constexpr int INPLACE_WPB = 8;
// one block's shared memory at most (mcmc/chain_kernel.SMEM_BLOCK_MAX)
constexpr size_t SMEM_BLOCK_MAX = 232448;

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
  int wpb, staged;  // launch plan (mcmc/chain_kernel.chain_plan)
  // MINU, and the f schedule (SCHED_* of wl_common.cuh) with Swetnam's
  // alpha and cap, the 1/t cap B / (cycle N), Swetnam's flat target per
  // bin and the master histogram view
  int minu, f_sched;
  double alpha, wl_factor, invt_f;
  void* binfrac;  // [B]
  void* baseh;    // [B, W] (Swetnam only, else null)
};

// Rows of one walker's staged columns: the WL slabs (wgt, basew, hist,
// and uhist in a sample run), then the point energies, in-cell flags,
// mover flags and both uniform rows (mcmc/chain_kernel.staged_rows).
__host__ __device__ inline int staged_rows(int B, int K, int Tn,
                                           int samplerun) {
  const int P = Tn + 1;
  return (3 + (samplerun ? 1 : 0)) * B + 3 * K * P + K + 2 * K * Tn;
}

// Dynamic shared memory of a block (mcmc/chain_kernel.chain_smem_bytes):
// bin widths and centres, the walkers' staged columns, the move codes.
template <typename T>
static size_t chain_smem_bytes(const ChainArgs* a) {
  return sizeof(T) * (2 * (size_t)a->B
                      + (a->staged ? (size_t)a->wpb
                                         * staged_rows(a->B, a->K, a->Tn,
                                                       a->samplerun)
                                   : 0))
         + sizeof(int) * (size_t)a->K * a->Tn;
}

// Knuth two-sum: s + err == a + b exactly.
template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& err) {
  s = a + b;
  const T bb = s - a;
  err = (a - (s - bb)) + (b - bb);
}

// Column c < nw of ``rows`` rows [rows, W] at walker w0 + c ->
// dst[row * wpb + c], every copy in flight at once.  A block has 32 wpb
// threads: thread (r0, c) = divmod(threadIdx.x, wpb) takes column c of
// rows r0, r0 + 32, ...
template <typename T>
__device__ __forceinline__ void stage_in(T* dst, const void* src, int rows,
                                         int W, int w0, int wpb, int nw,
                                         int r0, int c) {
  if (c >= nw) return;
  const T* g = static_cast<const T*>(src) + w0 + c;
  for (int r = r0; r < rows; r += 32)
    cp_async_elem(dst + r * wpb + c, g + (size_t)r * W);
}

template <typename T>
__device__ __forceinline__ void stage_out(void* dst, const T* src, int rows,
                                          int W, int w0, int wpb, int nw,
                                          int r0, int c) {
  if (c >= nw) return;
  T* g = static_cast<T*>(dst) + w0 + c;
  for (int r = r0; r < rows; r += 32) g[(size_t)r * W] = src[r * wpb + c];
}

// One walker's column of a [rows, stride] table: shared memory (staged)
// or a read-only device array read through the non-coherent cache.
template <typename T, bool STAGED>
struct Col {
  const T* p;  // the walker's entry of row 0
  int stride;
  __device__ __forceinline__ T operator[](int r) const {
    if constexpr (STAGED)
      return p[(size_t)r * stride];
    else
      return __ldg(p + (size_t)r * stride);
  }
};

// The K x T chain of one walker: its column of the tables (e, inc,
// hasm, ua, uz) and of the WL view v; its rows of cf / ci / joh / cnt
// at device column w.
template <typename T, bool STAGED, bool EXT>
__device__ __forceinline__ void walker_chain(
    const ChainArgs& a, const WLView<T>& v, const BinConsts<T>& bc,
    const FSched<T>& fs, const int* s_codes, Col<T, STAGED> e,
    Col<T, STAGED> inc, Col<T, STAGED> hasm, Col<T, STAGED> ua,
    Col<T, STAGED> uz, int w) {
  const int K = a.K, Tn = a.Tn, P = a.Tn + 1, W = a.W;
  const T beta = (T)a.beta;
  T* __restrict__ cf = static_cast<T*>(a.cf);
  int* __restrict__ ci = static_cast<int*>(a.ci);
  T* __restrict__ joh = static_cast<T*>(a.joh);
  int* __restrict__ cnt = static_cast<int*>(a.cnt);

  // the chain state, in registers; kb is mu's bin (mu_to_bin), so that
  // each new mu is binned once
  T mu = cf[CF_MU * W + w];
  T e0 = cf[CF_E0 * W + w], e1 = cf[CF_E1 * W + w];
  T er0 = cf[CF_E0E * W + w], er1 = cf[CF_E1E * W + w];
  T f = cf[CF_F * W + w], sumhist = cf[CF_SUMHIST * W + w];
  T min_dmu = cf[CF_MIN_DMU * W + w], max_dmu = cf[CF_MAX_DMU * W + w];
  const T cmu = cf[CF_CMU * W + w], sw_c = cf[CF_SWC * W + w];
  const T minu_c = cf[CF_MINUC * W + w];
  const bool invt = ci[CI_INVT * W + w] != 0;
  int ls = ci[CI_LS * W + w];
  const bool occ_ok = ci[CI_OCCOK * W + w] != 0;
  const bool sw_ok = ci[CI_SWOK * W + w] != 0;
  int n_en = 0, n_acc = 0, n_swen = 0, n_swacc = 0;
  long long kb = mu_to_bin(mu, v.B, bc);

  for (int k = 0; k < K; ++k) {
    const bool has_k = hasm[k] > (T)0.5;
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
        const int r0 = k * P, r1 = (K + k) * P;
        T ec0 = (T)0, ec1 = (T)0, ic = (T)0;
        for (int p = 0; p < P; ++p) {
          const T oh = p == j ? (T)1 : (T)0;
          ec0 = ec0 + oh * e[r0 + p];
          ec1 = ec1 + oh * e[r1 + p];
          ic = ic + oh * inc[r0 + p];
        }
        const T dE0 = e[r0 + t] - ec0;
        const T dE1 = e[r1 + t] - ec1;
        const bool gate = (ic > (T)0.5) & (inc[r0 + t] > (T)0.5);
        const T dmu = (dE0 - dE1) * beta;
        const T mu_new = mu + dmu;
        const long long kn = mu_to_bin(mu_new, v.B, bc);
        const T eta_old = eta_at(v, mu, kb);
        const T eta_new = eta_at(v, mu_new, kn);
        const T dE_ls = ls == 0 ? dE0 : dE1;
        T diffkT = beta * dE_ls + eta_new - eta_old;
        int lsn = ls;
        if (EXT && a.minu) {
          // #ifdef MINU fold-in (mc_moves.F90:1119-1140): the move carries
          // the walker to the lattice of the lower trial enthalpy
          const T en0 = e0 + er0 + dE0, en1 = e1 + er1 + dE1;
          lsn = beta * (en1 - en0) + minu_c < (T)0 ? 1 : 0;
          const T E_cur = ls == 0 ? e0 + er0 : e1 + er1;
          const T alt = beta * ((lsn == 0 ? en0 : en1) - E_cur) + eta_new
                        - eta_old + (ls == 0 ? sw_c : -sw_c);
          diffkT = lsn != ls ? alt : diffkT;
        }
        // finite-state guard: never accept non-finite deltas
        const bool ok = isfinite(diffkT) & isfinite(mu_new);
        const bool accept = gate & ok & (ua[i] < exp(-diffkT));
        // compensated accumulation: at N ~ 10^4 a move's dE is of the
        // size of an ulp of the float32 total (formed on every trial,
        // kept on an accepted one)
        T s_, r_, h0, l0, h1, l1;
        two_sum(e0, dE0, s_, r_);
        two_sum(s_, er0 + r_, h0, l0);
        two_sum(e1, dE1, s_, r_);
        two_sum(s_, er1 + r_, h1, l1);
        const T admu = fabs(dmu);
        e0 = accept ? h0 : e0;
        er0 = accept ? l0 : er0;
        e1 = accept ? h1 : e1;
        er1 = accept ? l1 : er1;
        mu = accept ? mu_new : mu;
        kb = accept ? kn : kb;
        ls = accept ? lsn : ls;
        j = accept ? t : j;
        min_dmu = accept ? fmin(min_dmu, admu) : min_dmu;
        max_dmu = accept ? fmax(max_dmu, admu) : max_dmu;
        n_acc += accept ? 1 : 0;
        n_en += 1;
        kt_en += 1;
        // per-move WL update at mu after the trial; a walker with
        // non-finite energies or an overflowed slab never writes into
        // the shared arrays (a sample run's weight: eta(mu), the
        // weight view unchanged)
        if (a.wl_active) {
          const bool healthy = isfinite(e0) & isfinite(e1) & occ_ok;
          if constexpr (EXT)
            f_schedule_at(v, kb, healthy, invt, fs, bc, f, sumhist);
          wl_update_at(v, kb, f, healthy, accept ? eta_new : eta_old, bc);
        }
      }
      // switch attempt after the trial (mc_lattice_switch,
      // mc_moves.F90:1536-1594)
      // (formed on every trial, kept where an attempt is made)
      const bool sw_on = a.do_switch & sw_ok & sw_try;
      const T de10 = beta * ((e1 - e0) + (er1 - er0));
      const T dsw = ls == 0 ? de10 + sw_c : -(de10 + sw_c);
      const bool sw_acc = sw_on & isfinite(dsw) & (uz[i] < exp(-dsw));
      ls = sw_acc ? 1 - ls : ls;
      n_swacc += sw_acc ? 1 : 0;
      n_swen += sw_on ? 1 : 0;
      if (sw_acc) {
        mu = cmu - de10;  // mu from scratch
        kb = mu_to_bin(mu, v.B, bc);
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
  if constexpr (EXT) {
    cf[CF_F * W + w] = f;
    cf[CF_SUMHIST * W + w] = sumhist;
  }
  ci[CI_LS * W + w] = ls;
  cnt[CN_EN * W + w] = n_en;
  cnt[CN_ACC * W + w] = n_acc;
  cnt[CN_SWEN * W + w] = n_swen;
  cnt[CN_SWACC * W + w] = n_swacc;
}

// One block of wpb warps per wpb walkers: warp i runs walker i's chain
// (no two walkers share a warp, so none waits on another's branches);
// all threads copy the columns in and out.
template <typename T, bool STAGED, bool EXT>
__global__ void __launch_bounds__(32 * CHAIN_WPB_MAX)
    chain_wl_kernel(const ChainArgs a) {
  const int K = a.K, Tn = a.Tn, P = a.Tn + 1, W = a.W, B = a.B;
  const int wpb = a.wpb;
  const int w0 = blockIdx.x * wpb;
  const int nw = min(wpb, W - w0);  // walkers of this block
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_binw = reinterpret_cast<T*>(smem);
  T* s_mub = s_binw + B;
  // staged: [row][wpb] columns in staged_rows order
  T* s_wgt = s_mub + B;
  T* s_basew = s_wgt + (STAGED ? (size_t)B * wpb : 0);
  T* s_hist = s_basew + (STAGED ? (size_t)B * wpb : 0);
  T* s_uh = s_hist + (STAGED ? (size_t)B * wpb : 0);
  T* s_e = s_uh + (STAGED && a.samplerun ? (size_t)B * wpb : 0);
  T* s_inc = s_e + (STAGED ? (size_t)2 * K * P * wpb : 0);
  T* s_hasm = s_inc + (STAGED ? (size_t)K * P * wpb : 0);
  T* s_ua = s_hasm + (STAGED ? (size_t)K * wpb : 0);
  T* s_uz = s_ua + (STAGED ? (size_t)K * Tn * wpb : 0);
  int* s_codes = reinterpret_cast<int*>(
      s_uz + (STAGED ? (size_t)K * Tn * wpb : 0));

  const int r0 = threadIdx.x / wpb, c = threadIdx.x - r0 * wpb;
  if constexpr (STAGED) {
    // the slab columns the chain reads (hist and uhist only where the
    // WL update is live), then the tables, all copies in flight at once
    stage_in(s_wgt, a.wgt, B, W, w0, wpb, nw, r0, c);
    stage_in(s_basew, a.basew, B, W, w0, wpb, nw, r0, c);
    if (a.wl_active) {
      stage_in(s_hist, a.hist, B, W, w0, wpb, nw, r0, c);
      if (a.samplerun) stage_in(s_uh, a.uh, B, W, w0, wpb, nw, r0, c);
    }
    stage_in(s_e, a.e, 2 * K * P, W, w0, wpb, nw, r0, c);
    stage_in(s_inc, a.inc, K * P, W, w0, wpb, nw, r0, c);
    stage_in(s_hasm, a.hasm, K, W, w0, wpb, nw, r0, c);
    stage_in(s_ua, a.ua, K * Tn, W, w0, wpb, nw, r0, c);
    stage_in(s_uz, a.uz, K * Tn, W, w0, wpb, nw, r0, c);
  }
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    s_binw[i] = __ldg(static_cast<const T*>(a.binw) + i);
    s_mub[i] = __ldg(static_cast<const T*>(a.mub) + i);
  }
  for (int i = threadIdx.x; i < K * Tn; i += blockDim.x)
    s_codes[i] = __ldg(static_cast<const int*>(a.codes) + i);
  if constexpr (STAGED) cp_async_wait_all();
  __syncthreads();

  const int lw = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0 && lw < nw) {  // lane 0 of walker lw's warp
    const int w = w0 + lw;
    BinConsts<T> bc;
    bc.cpos = (T)a.cpos;
    bc.cneg = (T)a.cneg;
    bc.a_pos = (T)a.a_pos;
    bc.a_neg = (T)a.a_neg;
    bc.lnr_pos = (T)a.lnr_pos;
    bc.lnr_neg = (T)a.lnr_neg;
    bc.av_bw = (T)a.av_bw;
    bc.log_norm = (T)a.log_norm;
    FSched<T> fs;
    fs.kind = a.f_sched;
    fs.alpha = (T)a.alpha;
    fs.wl_factor = (T)a.wl_factor;
    fs.invt_f = (T)a.invt_f;
    fs.binfrac = static_cast<const T*>(a.binfrac);
    fs.baseh = a.baseh ? static_cast<const T*>(a.baseh) + w : nullptr;
    fs.bh_stride = W;
    const T* cf = static_cast<const T*>(a.cf);
    const int* ci = static_cast<const int*>(a.ci);
    WLView<T> v;
    v.B = B;
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
    if constexpr (STAGED) {
      v.w = lw;
      v.W = wpb;
      v.wgt = s_wgt;
      v.hist = s_hist;
      v.uh = s_uh;
      v.basew = s_basew;
      walker_chain<T, true, EXT>(a, v, bc, fs, s_codes, {s_e + lw, wpb},
                            {s_inc + lw, wpb}, {s_hasm + lw, wpb},
                            {s_ua + lw, wpb}, {s_uz + lw, wpb}, w);
    } else {
      v.w = w;
      v.W = W;
      v.wgt = static_cast<T*>(a.wgt);
      v.hist = static_cast<T*>(a.hist);
      v.uh = static_cast<T*>(a.uh);
      v.basew = static_cast<const T*>(a.basew);
      walker_chain<T, false, EXT>(
          a, v, bc, fs, s_codes, {static_cast<const T*>(a.e) + w, W},
          {static_cast<const T*>(a.inc) + w, W},
          {static_cast<const T*>(a.hasm) + w, W},
          {static_cast<const T*>(a.ua) + w, W},
          {static_cast<const T*>(a.uz) + w, W}, w);
    }
  }

  if constexpr (STAGED) {
    // the slab columns the chain may have changed, back in place
    if (!a.wl_active) return;
    __syncthreads();
    stage_out(a.hist, s_hist, B, W, w0, wpb, nw, r0, c);
    if (a.samplerun)
      stage_out(a.uh, s_uh, B, W, w0, wpb, nw, r0, c);
    else
      stage_out(a.wgt, s_wgt, B, W, w0, wpb, nw, r0, c);
  }
}

// The kernel of a launch: the staged or in-place branch, with the rules
// (EXT) where MINU or an f schedule is on.
template <typename T, bool EXT>
static const void* kernel_fn(bool staged) {
  return staged ? reinterpret_cast<const void*>(chain_wl_kernel<T, true, EXT>)
                : reinterpret_cast<const void*>(chain_wl_kernel<T, false, EXT>);
}

__host__ __forceinline__ bool ext_rules(const ChainArgs* a) {
  return a->minu || a->f_sched != SCHED_PLAIN;
}

// (kernel, threads, dynamic shared bytes, blocks) of a launch, or false
// for a plan the kernel does not take.
template <typename T>
static bool geometry(const ChainArgs* a, const void*& fn, int& threads,
                     size_t& smem, int& blocks) {
  if (a->staged ? (a->wpb < 1 || a->wpb > CHAIN_WPB_MAX)
                : a->wpb != INPLACE_WPB)
    return false;
  smem = chain_smem_bytes<T>(a);
  if (smem > SMEM_BLOCK_MAX) return false;
  threads = 32 * a->wpb;
  blocks = (a->W + a->wpb - 1) / a->wpb;
  fn = ext_rules(a) ? kernel_fn<T, true>(a->staged)
                    : kernel_fn<T, false>(a->staged);
  return true;
}

template <typename T>
static int launch(const ChainArgs* a, cudaStream_t stream) {
  const void* fn;
  int threads, blocks;
  size_t smem;
  if (!geometry<T>(a, fn, threads, smem, blocks))
    return (int)cudaErrorInvalidValue;
  // every launch sets its own limit: the attribute is the function's,
  // and the occupancy query below sets it to another plan's bytes
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool ext = ext_rules(a);
  if (a->staged && ext)
    chain_wl_kernel<T, true, true><<<blocks, threads, smem, stream>>>(*a);
  else if (a->staged)
    chain_wl_kernel<T, true, false><<<blocks, threads, smem, stream>>>(*a);
  else if (ext)
    chain_wl_kernel<T, false, true><<<blocks, threads, smem, stream>>>(*a);
  else
    chain_wl_kernel<T, false, false><<<blocks, threads, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// out = {registers per thread, local (spill) bytes per thread, blocks
// resident on one SM, dynamic shared bytes per block, walkers per block,
// blocks} of the launch of a (only its shape and plan are read).
template <typename T>
static int occupancy(const ChainArgs* a, int* out) {
  const void* fn;
  int threads, blocks;
  size_t smem;
  if (!geometry<T>(a, fn, threads, smem, blocks))
    return (int)cudaErrorInvalidValue;
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
  out[2] = per_sm;
  out[3] = (int)smem;
  out[4] = a->wpb;
  out[5] = blocks;
  return (int)err;
}

extern "C" {

int chain_wl_f32(const ChainArgs* a, void* stream) {
  return launch<float>(a, (cudaStream_t)stream);
}

int chain_wl_f64(const ChainArgs* a, void* stream) {
  return launch<double>(a, (cudaStream_t)stream);
}

int chain_wl_occupancy(int f64, const ChainArgs* a, int* out) {
  return f64 ? occupancy<double>(a, out) : occupancy<float>(a, out);
}

}  // extern "C"
