// Multicanonical pieces shared by the kernels that run an acceptance
// chain (fused_warp.cuh, chain_wl.cu): the bin of an order parameter,
// the weight lookup eta(mu) (at a bin already known: eta_at), the
// per-move Wang-Landau or unbiased-histogram update and the f schedules
// of a WL generation run (Swetnam's, 1/t).  One definition for both
// chains, so that they cannot drift apart.  Each mirrors the plain
// PyTorch function (mcmc/bins.mu_to_bin, Engine._eta,
// bins.wl_move_update).
// They are written without branches (each case's value computed as the
// plain function computes it, then selected), so that a chain's
// independent lookups interleave.
#pragma once

#include <cuda_runtime.h>

// Bin-grid and update constants in the working type.
template <typename T>
struct BinConsts {
  T cpos, cneg, a_pos, a_neg, lnr_pos, lnr_neg;  // mu_to_bin
  T av_bw;                                       // mean bin width
  T log_norm;                                    // unbiased-histogram norm
};

// Round toward zero, saturating, NaN -> 0 (the hardware conversion).
template <typename T>
__device__ __forceinline__ long long trunc_ll(T x) {
  return (long long)(int)x;
}

// 0-based bin of mu, possibly outside [0, B) (mcmc/bins.mu_to_bin): the
// centre bin for |mu| <= 1/2, else the geometric bins of mu's side.
template <typename T>
__device__ __forceinline__ long long mu_to_bin(T mu, int B,
                                               const BinConsts<T>& c) {
  const long long centre = B / 2;
  const T m = fabs(mu);  // (mu itself where mu > 0)
  const bool pos = mu > (T)0;
  const T arg = (T)1 - (m - (T)0.5) * (pos ? c.cpos : c.cneg)
                / (pos ? c.a_pos : c.a_neg);
  const long long r = trunc_ll(log(fmax(arg, (T)1e-300))
                               / (pos ? c.lnr_pos : c.lnr_neg));
  const long long k = pos ? centre + 1 + r : centre - 1 - r;
  return m <= (T)0.5 ? centre : k;
}

__device__ __forceinline__ int clampi(long long k, int B) {
  return (int)(k < 0 ? 0 : (k > B - 1 ? B - 1 : k));
}

// One walker's view of the WL arrays ([B, W] slabs indexed at column w;
// the bin widths and centres [B] may lie in shared or device memory)
// and of its window.
template <typename T>
struct WLView {
  int w, W, B;
  T* wgt;          // [B,W] weight growth since the last sync
  T* hist;         // [B,W]
  T* uh;           // [B,W] (sample run only)
  const T* basew;  // [B,W] master weight view
  const T* binw;   // [B]
  const T* mub;    // [B]
  T mu_min, mu_max;
  int start_bin, end_bin, in_window;
  int eta_interp, dd_seeding, samplerun;
};

// eta(mu) against the current weight view (Engine._eta) with the bin
// kraw = mu_to_bin(mu) given: weight total = per-walker growth + master
// base, by direct indexing.
template <typename T>
__device__ __forceinline__ T eta_at(const WLView<T>& s, T mu,
                                    long long kraw) {
  const int B = s.B, W = s.W, w = s.w;
  const int k = clampi(kraw, B);
  const int km = k - 1 < 0 ? 0 : k - 1;
  const int kp = k + 1 > B - 1 ? B - 1 : k + 1;
  const T w_k = s.wgt[k * W + w] + s.basew[k * W + w];
  const T w_km = s.wgt[km * W + w] + s.basew[km * W + w];
  const T w_kp = s.wgt[kp * W + w] + s.basew[kp * W + w];
  const T bw_k = s.binw[k], bw_km = s.binw[km], bw_kp = s.binw[kp];
  const T mub_k = s.mub[k], mub_km = s.mub[km];
  const T grad_up = (T)2 * (w_kp - w_k) / (bw_k + bw_kp);
  const T grad_dn = (T)2 * (w_k - w_km) / (bw_k + bw_km);
  // interpolated: up from bin k at the window's start bin or above the
  // centre, down to it at the end bin, else down from bin k - 1
  const T up = w_k + (mu - mub_k) * grad_up;
  const T dn = w_k + (mu - mub_k) * grad_dn;
  const T lo = w_km + (mu - mub_km) * grad_dn;
  const T interp = k == s.start_bin ? up
                 : k == s.end_bin   ? dn
                 : mu > mub_k       ? up
                                    : lo;
  const T eta = s.eta_interp ? interp : w_k;
  const bool wall = (mu < s.mu_min) | (mu > s.mu_max);
  const T walled = wall ? (T)1e30 : eta;
  const T pre = s.dd_seeding ? eta : (T)0;
  return s.in_window ? walled : pre;
}

// eta(mu) against the current weight view (Engine._eta).
template <typename T>
__device__ T eta_of(const WLView<T>& s, T mu, const BinConsts<T>& c) {
  return eta_at(s, mu, mu_to_bin(mu, s.B, c));
}

// Per-move WL / unbiased-histogram update of a performed move at order
// parameter mu with modification factor f (Engine._wl_update;
// mc_update_wl_bins, mc_moves.F90:1597-1689), given mu's bin k =
// mu_to_bin(mu) and, for a sample run, eta_val = eta(mu) (the weight view
// a sample run reads does not change).  ``healthy``: the walker's health
// gate (finite energies, no slab overflow); an unhealthy walker never
// writes into the shared WL arrays.  The sums are formed at the clamped
// bin and stored only where the update happens.
template <typename T>
__device__ __forceinline__ void wl_update_at(const WLView<T>& s, long long k,
                                             T f, bool healthy, T eta_val,
                                             const BinConsts<T>& c) {
  const int B = s.B, W = s.W, w = s.w;
  const bool upd = (k >= 0) & (k < B) & healthy;
  const int kc = clampi(k, B);
  const T incr = c.av_bw / s.binw[kc];
  const T h = s.hist[kc * W + w] + incr;
  if (upd) s.hist[kc * W + w] = h;
  if (s.samplerun) {
    // mask before the exp and gate walled entries out entirely
    const T arg = eta_val - c.log_norm;
    const T u = s.uh[kc * W + w] + incr * exp(fmin(arg, (T)60));
    if (upd && eta_val < (T)1e29) s.uh[kc * W + w] = u;
  } else {
    const T g = s.wgt[kc * W + w] + incr * f;
    if (upd) s.wgt[kc * W + w] = g;
  }
}

// The f schedules of a WL generation run (bins.FSchedule,
// mc_moves.F90:1636-1658): the plain factor, Swetnam's f from the RMS
// deviation of the walker's total histogram from flat, or the 1/t cap.
constexpr int SCHED_PLAIN = 0, SCHED_SWETNAM = 1, SCHED_INVT = 2;

template <typename T>
struct FSched {
  int kind;           // SCHED_*
  T alpha, wl_factor;  // Swetnam's f = min(ln(rms) alpha B, wl_factor)
  T invt_f;           // the 1/t cap B / (cycle N)
  const T* binfrac;   // [B] Swetnam's flat target per bin
  const T* baseh;     // the walker's entry of row 0 of the master
                      // histogram view (device memory)
  size_t bh_stride;   // between its rows
};

// Part of Swetnam's sum over the bins b0, b0 + step, ... < B: the squared
// deviation of (growth + master) * binwidth / max(sumhist, 1) from the
// flat target, the growth read before this update and its increment
// incr added at the bin kc where the update lands (upd), as the plain
// version adds it.
template <typename T>
__device__ __forceinline__ T swetnam_part(const WLView<T>& s,
                                          const FSched<T>& fs, int kc,
                                          bool upd, T incr, T sumhist,
                                          int b0, int step) {
  const int B = s.B, W = s.W, w = s.w;
  const T den = fmax(sumhist, (T)1);
  T acc = (T)0;
  for (int b = b0; b < B; b += step) {
    T h = s.hist[(size_t)b * W + w];
    if (upd && b == kc) h = h + incr;
    const T dev = (h + fs.baseh[(size_t)b * fs.bh_stride]) * s.binw[b] / den
                  - fs.binfrac[b];
    acc += dev * dev;
  }
  return acc;
}

// Swetnam's f from the whole sum over the B bins (the mean as the sum
// times 1/B, as PyTorch's mean forms it).
template <typename T>
__device__ __forceinline__ T swetnam_f(T sum, int B, const FSched<T>& fs) {
  const T rms = sqrt(sum * ((T)1 / (T)B));
  return fmin(log(fmax(rms, (T)1e-300)) * fs.alpha * (T)B, fs.wl_factor);
}

// The f schedule at a performed move of a WL generation run, one thread
// (the chain kernel): f and sumhist updated in place, before the weight
// increment that uses the new f (wl_update_at).  k = mu_to_bin(mu);
// healthy: the walker's health gate; invt: the walker runs 1/t.
template <typename T>
__device__ __forceinline__ void f_schedule_at(const WLView<T>& s, long long k,
                                              bool healthy, bool invt,
                                              const FSched<T>& fs,
                                              const BinConsts<T>& c, T& f,
                                              T& sumhist) {
  if (fs.kind == SCHED_INVT) {
    if (invt) f = fmin(f, fs.invt_f);
    return;
  }
  if (fs.kind != SCHED_SWETNAM) return;
  const int B = s.B;
  const bool upd = (k >= 0) & (k < B) & healthy;
  const int kc = clampi(k, B);
  const T incr = c.av_bw / s.binw[kc];
  sumhist = sumhist + (upd ? (T)1 : (T)0);
  const T f_new = swetnam_f(swetnam_part(s, fs, kc, upd, incr, sumhist, 0, 1),
                            B, fs);
  if (upd) f = f_new;
}
