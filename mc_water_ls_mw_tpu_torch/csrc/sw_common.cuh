// Stillinger-Weber pieces shared by the hand-written kernels: the pair
// term, the three-body leg weight, the minimum-image fold, the
// closed-form centre-angle sum of the moment formulation, and the
// per-partner leg, wing and moved-moment terms of a trial move.  Each
// mirrors the plain PyTorch function of the same name in ops/dense.py
// (or the engine's table step) and keeps its association order, so that
// float64 results agree to round-off.
#pragma once

#include <cuda_runtime.h>

// Model constants folded in double on the host, as the JAX package
// folds its Python-float expressions before they meet a tensor
// (models/sw.py; ops/dense.py _pair/_leg/_e3_closed_form).
struct SWConsts {
  double rc;       // cutoff a*sigma
  double rc2;      // rc*rc
  double sigma;
  double gs;       // gamma*sigma
  double AE;       // bigA*epsilon
  double Bs4;      // bigB*sigma^4
  double lam_eps;  // lambda*epsilon
  double c0;       // cos(theta_0)
  double two_c0;   // 2*c0
  double c0sq;     // c0*c0
  double omc2;     // (1-c0)^2
};

template <typename T>
struct SW {
  T rc, rc2, sigma, gs, AE, Bs4, lam_eps, c0, two_c0, c0sq, omc2;
  __host__ __device__ explicit SW(const SWConsts& c)
      : rc((T)c.rc), rc2((T)c.rc2), sigma((T)c.sigma), gs((T)c.gs),
        AE((T)c.AE), Bs4((T)c.Bs4), lam_eps((T)c.lam_eps), c0((T)c.c0),
        two_c0((T)c.two_c0), c0sq((T)c.c0sq), omc2((T)c.omc2) {}
};

__device__ __forceinline__ float sw_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double sw_rsqrt(double x) { return rsqrt(x); }

// Screening denominator of an in-range pair, clamped strictly negative
// (ops/dense._DENOM_CLAMP).
template <typename T>
__device__ __forceinline__ T sw_denom(T rij, const SW<T>& p) {
  return fmin(rij - p.rc, (T)-1e-5);
}

template <typename T>
__device__ __forceinline__ T sw_pair(T r2, T denom, const SW<T>& p) {
  return p.AE * (p.Bs4 / (r2 * r2) - (T)1) * exp(p.sigma / denom);
}

template <typename T>
__device__ __forceinline__ T sw_leg(T denom, const SW<T>& p) {
  return exp(p.gs / denom);
}

// Rows of H^{-1} (ops/dense._inv3_rows).
template <typename T>
__device__ __forceinline__ void inv3_rows(const T H[3][3], T a[3][3]) {
  T det = H[0][0] * (H[1][1] * H[2][2] - H[1][2] * H[2][1])
        - H[0][1] * (H[1][0] * H[2][2] - H[1][2] * H[2][0])
        + H[0][2] * (H[1][0] * H[2][1] - H[1][1] * H[2][0]);
  T inv_det = (T)1 / det;
  a[0][0] = (H[1][1] * H[2][2] - H[1][2] * H[2][1]) * inv_det;
  a[0][1] = (H[0][2] * H[2][1] - H[0][1] * H[2][2]) * inv_det;
  a[0][2] = (H[0][1] * H[1][2] - H[0][2] * H[1][1]) * inv_det;
  a[1][0] = (H[1][2] * H[2][0] - H[1][0] * H[2][2]) * inv_det;
  a[1][1] = (H[0][0] * H[2][2] - H[0][2] * H[2][0]) * inv_det;
  a[1][2] = (H[0][2] * H[1][0] - H[0][0] * H[1][2]) * inv_det;
  a[2][0] = (H[1][0] * H[2][1] - H[1][1] * H[2][0]) * inv_det;
  a[2][1] = (H[0][1] * H[2][0] - H[0][0] * H[2][1]) * inv_det;
  a[2][2] = (H[0][0] * H[1][1] - H[0][1] * H[1][0]) * inv_det;
}

// Minimum-image fold of d in place (ops/dense._mic_fold).
template <typename T>
__device__ __forceinline__ void mic_fold(T d[3], const T H[3][3],
                                         const T a[3][3]) {
  T s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s[k] = a[k][0] * d[0] + a[k][1] * d[1] + a[k][2] * d[2];
    s[k] = s[k] - floor(s[k] + (T)0.5);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    d[k] = H[k][0] * s[0] + H[k][1] * s[1] + H[k][2] * s[2];
}

// The ten moments plus the sum of squared leg weights, in Moments
// field order (s1, mx, my, mz, mxx, myy, mzz, mxy, mxz, myz).
template <typename T>
struct Mom {
  T m[10];
  T w2;
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int f = 0; f < 10; ++f) m[f] = (T)0;
    w2 = (T)0;
  }
  // add one leg of weight w along unit vector u
  __device__ __forceinline__ void add(T w, T ux, T uy, T uz) {
    T wux = w * ux, wuy = w * uy, wuz = w * uz;
    m[0] += w;
    m[1] += wux;
    m[2] += wuy;
    m[3] += wuz;
    m[4] += wux * ux;
    m[5] += wuy * uy;
    m[6] += wuz * uz;
    m[7] += wux * uy;
    m[8] += wux * uz;
    m[9] += wuy * uz;
    w2 += w * w;
  }
};

// 1/2 [||M||^2 - 2 c0 |m|^2 + c0^2 s^2 - (1-c0)^2 sum w^2]
// (ops/dense._e3_closed_form).
template <typename T>
__device__ __forceinline__ T e3_closed_form(const T m[10], T sumw2,
                                            const SW<T>& p) {
  T frob = m[4] * m[4] + m[5] * m[5] + m[6] * m[6]
         + (T)2 * (m[7] * m[7] + m[8] * m[8] + m[9] * m[9]);
  T msq = m[1] * m[1] + m[2] * m[2] + m[3] * m[3];
  return (T)0.5 * (frob - p.two_c0 * msq + p.c0sq * m[0] * m[0]
                   - p.omc2 * sumw2);
}

// Terms of one candidate partner seen from a centre: pair energy, leg
// weight and the unit vector centre -> partner; all zero out of range.
template <typename T>
struct Leg {
  bool in;
  T pair, w, ux, uy, uz;
};

template <typename T>
__device__ __forceinline__ Leg<T> leg_none() {
  Leg<T> g;
  g.in = false;
  g.pair = g.w = g.ux = g.uy = g.uz = (T)0;
  return g;
}

// Leg of an in-range displacement d with r2 = |d|^2 < rc^2.
template <typename T>
__device__ __forceinline__ Leg<T> leg_in_range(const T d[3], T r2,
                                               const SW<T>& sw) {
  Leg<T> g;
  g.in = true;
  const T inv = sw_rsqrt(r2);
  const T rij = r2 * inv;
  const T den = sw_denom(rij, sw);
  g.pair = sw_pair(r2, den, sw);
  g.w = sw_leg(den, sw);
  g.ux = d[0] * inv;
  g.uy = d[1] * inv;
  g.uz = d[2] * inv;
  return g;
}

// Candidate moments after the move: m - delta(old leg) + delta(new leg),
// with delta = (w, -w u, w u u^T) from the partner's view.
template <typename T>
__device__ __forceinline__ void moved_moments(T m[10], const Leg<T>& o,
                                              const Leg<T>& n) {
  const T owx = o.w * o.ux, owy = o.w * o.uy, owz = o.w * o.uz;
  const T nwx = n.w * n.ux, nwy = n.w * n.uy, nwz = n.w * n.uz;
  m[0] = m[0] - o.w + n.w;
  m[1] = m[1] - (-owx) + (-nwx);
  m[2] = m[2] - (-owy) + (-nwy);
  m[3] = m[3] - (-owz) + (-nwz);
  m[4] = m[4] - owx * o.ux + nwx * n.ux;
  m[5] = m[5] - owy * o.uy + nwy * n.uy;
  m[6] = m[6] - owz * o.uz + nwz * n.uz;
  m[7] = m[7] - owx * o.uy + nwx * n.uy;
  m[8] = m[8] - owx * o.uz + nwx * n.uz;
  m[9] = m[9] - owy * o.uz + nwy * n.uz;
}

// Wing-angle term of one partner j with moments m seen along leg g.
template <typename T>
__device__ __forceinline__ T wing(const Leg<T>& g, const T m[10],
                                  const SW<T>& sw) {
  const T ux = g.ux, uy = g.uy, uz = g.uz;
  const T quad = ux * ux * m[4] + uy * uy * m[5] + uz * uz * m[6]
               + (T)2 * (ux * uy * m[7] + ux * uz * m[8] + uy * uz * m[9]);
  const T lin = ux * m[1] + uy * m[2] + uz * m[3];
  const T per = quad + sw.two_c0 * lin + sw.c0sq * m[0] - sw.omc2 * g.w;
  return g.w * per;
}
