// Multicanonical pieces shared by the kernels that run an acceptance
// chain (fused_cycle.cu, chain_wl.cu): the bin of an order parameter,
// the weight lookup eta(mu) (at a bin already known: eta_at) and the
// per-move Wang-Landau or unbiased-histogram update.  One definition for
// both chains, so that they cannot drift apart.  Each mirrors the plain
// PyTorch function (mcmc/bins.mu_to_bin, Engine._eta, Engine._wl_update).
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
