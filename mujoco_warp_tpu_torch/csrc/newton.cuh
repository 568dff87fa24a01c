// The Newton solve: the device code kernels B3 and B3e (glue.cu) and B4
// and B4-elliptic (newton.cu) share, as the JAX package shares
// _newton_core (mujoco_warp_tpu/pallas/solver_kernels.py:103) between
// _glue_kernel, _glue_ell_kernel, _newton_kernel and _newton_ell_kernel.
// Each solve factors qM, solves for qacc_smooth, runs the Newton loop
// (init :446-466, loop :468-504, linesearch :398-444), writes the forces
// and, with an integration diagonal, re-solves (qM + diag) qacc_euler =
// qfrc_smooth + qfrc_constraint. Plain version:
// mujoco_warp_tpu_torch/solver.py, newton() (the cone: class Cone).
//
// The pyramidal cone (B3, B4) runs warp_newton(): one warp per world,
// lane i owning dof i (nv <= 32), the world's matrices and acting rows in
// shared memory (WarpMem), every sum over dofs or rows a warp reduction
// in a fixed order, so that two launches give the same bits. The
// elliptic cone (B3e, B4-elliptic) runs newton_solve<true>(): one thread
// per world, H and the rows' state in local memory, J read through the
// cache from the batch-first [W, ...] layout; it adds the cone's code
// (:139-178 precompute, :213-245 forces, :283-346 Hessian blocks,
// :351-390 linesearch terms) behind `if constexpr`.
//
// Both loop until their own world converges: a converged world stops,
// as the TPU kernel freezes it with alpha = 0 (:480). The rows that
// cannot act (D = 0 and frictionloss = 0: inactive limits, empty contact
// slots) are skipped, which changes no result.
#pragma once

#include <type_traits>

#include "common.cuh"

#define MAXNV 32
#define MAXNJ 256
#define MAXS 6               // rows of an elliptic contact (condim <= 6)
#define MAXCONE (MAXNJ / 2)  // elliptic contacts: each has >= 2 rows

// one world's solve: where its inputs and outputs lie, and the settings
struct Solve {
  const float* qM;           // (nv, nv)
  const float* J;            // (nj, nv)
  const float* D;            // (nj)
  const float* aref;         // (nj)
  const float* fl;           // (nj) frictionloss
  const float* warmstart;    // (nv)
  const float* ls_scales;    // (ls_k) linesearch bracket scales
  const float* hdiag;        // integration diagonal, dof i at
  int hdiag_stride;          //   hdiag[i * hdiag_stride]; null: none
  float* qacc;               // (nv)
  float* qfrc_constraint;    // (nv)
  float* efc_force;          // (nj)
  int* solver_niter;         // (1)
  float* qacc_smooth;        // (nv)
  float* qLD;                // (nv, nv) lower Cholesky factor of qM
  float* qacc_euler;         // (nv)
  float tolerance;
  float meaninertia;
  int nv;
  int nj;
  int ne;
  int nf;
  int iterations;
  int ls_k;
  int ls_polish;
  int use_ws;
};

// world w's Solve from a kernel's Params (B3's and B4's name these
// fields alike); the caller sets hdiag
template <class P>
DEV Solve world_solve(const P& p, int w) {
  const size_t vw = (size_t)w * p.nv, jw = (size_t)w * p.nj;
  Solve s;
  s.qM = p.qM + vw * p.nv;
  s.J = p.efc_J + jw * p.nv;
  s.D = p.efc_D + jw;
  s.aref = p.efc_aref + jw;
  s.fl = p.efc_frictionloss + jw;
  s.warmstart = p.qacc_warmstart + vw;
  s.ls_scales = p.ls_scales;
  s.hdiag = nullptr;
  s.hdiag_stride = 1;
  s.qacc = p.qacc + vw;
  s.qfrc_constraint = p.qfrc_constraint + vw;
  s.efc_force = p.efc_force + jw;
  s.solver_niter = p.solver_niter + w;
  s.qacc_smooth = p.qacc_smooth + vw;
  s.qLD = p.qLD + vw * p.nv;
  s.qacc_euler = p.qacc_euler + vw;
  s.tolerance = p.tolerance;
  s.meaninertia = p.meaninertia;
  s.nv = p.nv;
  s.nj = p.nj;
  s.ne = p.ne;
  s.nf = p.nf;
  s.iterations = p.iterations;
  s.ls_k = p.ls_k;
  s.ls_polish = p.ls_polish;
  s.use_ws = p.use_ws;
  return s;
}

// one world's contacts for the elliptic cone: the contact rows [base,
// base + C S) of the efc layout, S per contact
struct ConeIn {
  const float* friction;     // (C, 5)
  const int* dim;            // (C) 0 in an empty slot
  float impratio;
  int base;
  int S;
  int C;
};

// world w's ConeIn from an elliptic kernel's Params (B3e's and
// B4-elliptic's name these fields alike)
template <class P>
DEV ConeIn world_cone(const P& p, int w) {
  ConeIn c;
  c.friction = p.con_friction + (size_t)w * p.nconmax * 5;
  c.dim = p.con_dim + (size_t)w * p.nconmax;
  c.impratio = p.impratio;
  c.base = p.efc_base;
  c.S = p.stride;
  c.C = p.nconmax;
  return c;
}

// the efc rows that can act this step, with their solver state
struct Rows {
  int n;
  int idx[MAXNJ];
  unsigned char cls[MAXNJ];  // 0 equality, 1 friction, 2 one-sided,
                             // 3 a row of an elliptic contact
  float D[MAXNJ], fl[MAXNJ], rf[MAXNJ];
  float jaref[MAXNJ], jv[MAXNJ], force[MAXNJ];
  bool quad[MAXNJ];
};

// The elliptic contacts whose normal row acts: for each, the Rows index
// of its row r (-1: the row cannot act, and then contributes nothing:
// its D and its scale vanish together), the scales s (row 0: mu =
// friction[0] / sqrt(impratio); row r >= 1: friction[min(r - 1, 4)]), mu
// and Dm = D_0 / (mu^2 (1 + mu^2)).
struct Cone {
  int n;
  int S;
  short k[MAXCONE][MAXS];
  float s[MAXCONE][MAXS];
  float mu[MAXCONE], dm[MAXCONE];
};
struct NoCone {};
template <bool ELL>
using ConeOf = std::conditional_t<ELL, Cone, NoCone>;

// u = x s over contact j's rows (x indexed by Rows); returns sum_r>=1 u^2
DEV float cone_u(const Cone& K, int j, const float* x, float* u) {
  float t2 = 0.0f;
  for (int r = 0; r < K.S; ++r) {
    const int k = K.k[j][r];
    u[r] = k >= 0 ? x[k] * K.s[j][r] : 0.0f;
    if (r > 0) t2 += u[r] * u[r];
  }
  return t2;
}

enum { kTop = 0, kBottom = 1, kMiddle = 2 };

// the zone of a contact at normal N and tangential norm T (cone_zones)
DEV int cone_zone(float N, float T, float mu) {
  if (N >= mu * T) return kTop;
  if (mu * N + T <= 0.0f) return kBottom;
  return kMiddle;
}

// lower Cholesky factor in place (row-major, lower triangle read and
// written); pivots below kMinVal are floored (solver.cholesky)
DEV void cholesky(float* A, int n) {
  for (int j = 0; j < n; ++j) {
    float s = A[j * n + j];
    for (int k = 0; k < j; ++k) s -= A[j * n + k] * A[j * n + k];
    const float inv = rsqrtf(fmaxf(s, kMinVal));
    A[j * n + j] = s * inv;
    for (int i = j + 1; i < n; ++i) {
      float t = A[i * n + j];
      for (int k = 0; k < j; ++k) t -= A[i * n + k] * A[j * n + k];
      A[i * n + j] = t * inv;
    }
  }
}

// solve L L^T x = b with L from cholesky(); x may alias b
DEV void cho_solve(const float* L, int n, const float* b, float* x) {
  float y[MAXNV];
  for (int j = 0; j < n; ++j) {
    float t = b[j];
    for (int k = 0; k < j; ++k) t -= L[j * n + k] * y[k];
    y[j] = t / L[j * n + j];
  }
  for (int j = n - 1; j >= 0; --j) {
    float t = y[j];
    for (int k = j + 1; k < n; ++k) t -= L[k * n + j] * x[k];
    x[j] = t / L[j * n + j];
  }
}

DEV void matvec(const float* M, int n, const float* x, float* out) {
  for (int i = 0; i < n; ++i) {
    float s = 0.0f;
    for (int j = 0; j < n; ++j) s += M[i * n + j] * x[j];
    out[i] = s;
  }
}

// J x over the rows that can act
DEV void rows_dot(const Rows& R, const float* J, int nv, const float* x,
                  float* out) {
  for (int k = 0; k < R.n; ++k) {
    const float* Jr = J + (size_t)R.idx[k] * nv;
    float s = 0.0f;
    for (int i = 0; i < nv; ++i) s += Jr[i] * x[i];
    out[k] = s;
  }
}

// force, quad and the constraint cost of jaref (update_constraint); a
// row of an elliptic contact gets its cone force (ELL)
template <bool ELL>
DEV float update_constraint(Rows& R, const ConeOf<ELL>& K) {
  float cost = 0.0f;
  for (int k = 0; k < R.n; ++k) {
    const float x = R.jaref[k], D = R.D[k], fl = R.fl[k], rf = R.rf[k];
    const int c = R.cls[k];
    const bool lin_neg = c == 1 && x <= -rf;
    const bool lin_pos = c == 1 && x >= rf;
    const bool quad = c == 0 || (c == 1 && !lin_neg && !lin_pos) ||
                      (c == 2 && x < 0.0f);
    float f = 0.0f, cst = 0.0f;
    if (quad) { f = -D * x; cst = 0.5f * D * x * x; }
    if (lin_neg) { f = fl; cst = -fl * (0.5f * rf + x); }
    if (lin_pos) { f = -fl; cst = -fl * (0.5f * rf - x); }
    R.force[k] = f;
    R.quad[k] = quad;
    cost += cst;
  }
  if constexpr (ELL) {
    // per contact: the middle zone's cone-surface force, the bottom
    // zone's quadratic rows, nothing in the top zone (:213-245)
    float ccost = 0.0f;
    for (int j = 0; j < K.n; ++j) {
      float u[MAXS];
      const float T = sqrtf(fmaxf(cone_u(K, j, R.jaref, u), 0.0f));
      const float N = u[0], mu = K.mu[j];
      const int z = cone_zone(N, T, mu);
      if (z == kMiddle) {
        const float nmt = N - mu * T;
        const float f_norm = -K.dm[j] * nmt * mu;
        const float t_safe = fmaxf(T, kMinVal);
        for (int r = 0; r < K.S; ++r) {
          const int k = K.k[j][r];
          if (k < 0) continue;
          R.force[k] = r == 0 ? f_norm
                              : -(f_norm / t_safe) * (u[r] * K.s[j][r]);
        }
        ccost += 0.5f * K.dm[j] * nmt * nmt;
      } else if (z == kBottom) {
        for (int r = 0; r < K.S; ++r) {
          const int k = K.k[j][r];
          if (k < 0) continue;
          const float x = R.jaref[k];
          R.force[k] = -R.D[k] * x;
          R.quad[k] = true;
          ccost += 0.5f * R.D[k] * x * x;
        }
      }
    }
    cost += ccost;
  }
  return cost;
}

// grad = ma - qfrc_smooth - J^T force
DEV void gradient(const Rows& R, const float* J, int nv, const float* ma,
                  const float* qfs, float* grad) {
  for (int i = 0; i < nv; ++i) grad[i] = ma[i] - qfs[i];
  for (int k = 0; k < R.n; ++k) {
    const float f = R.force[k];
    if (f == 0.0f) continue;
    const float* Jr = J + (size_t)R.idx[k] * nv;
    for (int i = 0; i < nv; ++i) grad[i] -= Jr[i] * f;
  }
}

// Newton direction H^-1 grad with H = qM + J^T diag(D quad) J; for the
// elliptic cone (ELL) also the blocks J_c^T C J_c of the contacts in the
// middle zone, built on the fly, and the relative Tikhonov floor
// 1e-7 tr(H) / nv on the diagonal (:283-346)
template <bool ELL>
DEV void newton_dir(const Rows& R, const ConeOf<ELL>& K, const float* J,
                    const float* qM, int nv, const float* grad, float* H,
                    float* out) {
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j <= i; ++j) H[i * nv + j] = qM[i * nv + j];
  for (int k = 0; k < R.n; ++k) {
    if (!R.quad[k]) continue;
    const float* Jr = J + (size_t)R.idx[k] * nv;
    const float D = R.D[k];
    for (int i = 0; i < nv; ++i) {
      const float di = D * Jr[i];
      if (di == 0.0f) continue;
      for (int j = 0; j <= i; ++j) H[i * nv + j] += di * Jr[j];
    }
  }
  if constexpr (ELL) {
    for (int c = 0; c < K.n; ++c) {
      float u[MAXS];
      const float T = sqrtf(fmaxf(cone_u(K, c, R.jaref, u), 0.0f));
      const float N = u[0], mu = K.mu[c];
      if (cone_zone(N, T, mu) != kMiddle) continue;
      const float t_safe = fmaxf(T, kMinVal);
      const float t3 = fmaxf(T * t_safe * t_safe, kMinVal);
      const float mu_over_t = mu / t_safe, mnt3 = mu * N / t3;
      const float diag_add = mu * mu - mu * N / t_safe;
      for (int r = 0; r < K.S; ++r) {
        const int kr = K.k[c][r];
        if (kr < 0) continue;
        // w = sum_s C[r][s] J_s, then H += J_r w^T (lower triangle)
        float w[MAXNV];
        for (int i = 0; i < nv; ++i) w[i] = 0.0f;
        for (int q = 0; q < K.S; ++q) {
          const int kq = K.k[c][q];
          if (kq < 0) continue;
          float hc;
          if (r == 0 && q == 0) hc = 1.0f;
          else if (r == 0) hc = -mu_over_t * u[q];
          else if (q == 0) hc = -mu_over_t * u[r];
          else hc = mnt3 * u[r] * u[q] + (r == q ? diag_add : 0.0f);
          const float cc = hc * (K.dm[c] * K.s[c][r] * K.s[c][q]);
          const float* Jq = J + (size_t)R.idx[kq] * nv;
          for (int i = 0; i < nv; ++i) w[i] += cc * Jq[i];
        }
        const float* Jr = J + (size_t)R.idx[kr] * nv;
        for (int i = 0; i < nv; ++i) {
          const float ji = Jr[i];
          if (ji == 0.0f) continue;
          for (int j = 0; j <= i; ++j) H[i * nv + j] += ji * w[j];
        }
      }
    }
    float tr = 0.0f;
    for (int i = 0; i < nv; ++i) tr += H[i * nv + i] * (1.0f / nv);
    const float eps = 1e-7f * tr;
    for (int i = 0; i < nv; ++i) H[i * nv + i] += eps;
  }
  cholesky(H, nv);
  cho_solve(H, nv, grad, out);
}

// first and second derivative of the cost along the search direction;
// the elliptic contacts' terms per contact (ELL, :351-390)
template <bool ELL>
DEV float phi_d(const Rows& R, const ConeOf<ELL>& K, float alpha, float g0,
                float h0, float* d2) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int k = 0; k < R.n; ++k) {
    const float jv = R.jv[k], x = R.jaref[k] + alpha * jv;
    const int c = R.cls[k];
    const bool lin_neg = c == 1 && x <= -R.rf[k];
    const bool lin_pos = c == 1 && x >= R.rf[k];
    const bool quad = c == 0 || (c == 1 && !lin_neg && !lin_pos) ||
                      (c == 2 && x < 0.0f);
    if (quad) { s1 += R.D[k] * x * jv; s2 += R.D[k] * jv * jv; }
    if (lin_neg) s1 -= R.fl[k] * jv;
    if (lin_pos) s1 += R.fl[k] * jv;
  }
  if constexpr (ELL) {
    float c1 = 0.0f, c2 = 0.0f;
    for (int j = 0; j < K.n; ++j) {
      float xb[MAXS], jvb[MAXS], ub[MAXS], v[MAXS];
      float t2 = 0.0f, uv = 0.0f, vfr2 = 0.0f;
      for (int r = 0; r < K.S; ++r) {
        const int k = K.k[j][r];
        jvb[r] = k >= 0 ? R.jv[k] : 0.0f;
        xb[r] = k >= 0 ? R.jaref[k] + alpha * jvb[r] : 0.0f;
        ub[r] = xb[r] * K.s[j][r];
        v[r] = jvb[r] * K.s[j][r];
        if (r > 0) {
          t2 += ub[r] * ub[r];
          uv += ub[r] * v[r];
          vfr2 += v[r] * v[r];
        }
      }
      const float mu = K.mu[j], N = ub[0];
      const float T = sqrtf(fmaxf(t2, kMinVal));
      const int z = cone_zone(N, T, mu);
      if (z == kMiddle) {
        const float t1 = uv / T, tt2 = (vfr2 - t1 * t1) / T;
        const float nmt = N - mu * T, n1mt1 = v[0] - mu * t1;
        c1 += K.dm[j] * nmt * n1mt1;
        c2 += K.dm[j] * (n1mt1 * n1mt1 - nmt * mu * tt2);
      } else if (z == kBottom) {
        for (int r = 0; r < K.S; ++r) {
          const int k = K.k[j][r];
          if (k < 0) continue;
          c1 += R.D[k] * xb[r] * jvb[r];
          c2 += R.D[k] * jvb[r] * jvb[r];
        }
      }
    }
    *d2 = h0 + s2 + c2;
    return g0 + alpha * h0 + s1 + c1;
  }
  *d2 = h0 + s2;
  return g0 + alpha * h0 + s1;
}

// bracket of ls_k log-spaced alphas, secant, then ls_polish safeguarded
// Newton / bisection steps (_newton_core linesearch :398-444)
template <bool ELL>
DEV float linesearch(const Solve& p, const Rows& R, const ConeOf<ELL>& K,
                     float g0, float h0) {
  float p2;
  const float p1_0 = phi_d<ELL>(R, K, 0.0f, g0, h0, &p2);
  const float alpha0 = fmaxf(-p1_0 / fmaxf(p2, kMinVal), 0.0f);
  float lo = 0.0f, p1_lo = p1_0, hi = INFINITY, p1_hi = INFINITY;
  for (int s = 0; s < p.ls_k; ++s) {
    const float a = alpha0 * p.ls_scales[s];
    const float p1a = phi_d<ELL>(R, K, a, g0, h0, &p2);
    if (p1a < 0.0f) {
      lo = a; p1_lo = p1a;
    } else if (!isfinite(hi)) {
      hi = a; p1_hi = p1a;
    }
  }
  const float diff = p1_hi - p1_lo;
  const float secant = lo - p1_lo * (hi - lo) /
                                (fabsf(diff) < kMinVal ? 1.0f : diff);
  const float a_max = alpha0 * p.ls_scales[p.ls_k - 1];
  float p2m;
  const float p1m = phi_d<ELL>(R, K, a_max, g0, h0, &p2m);
  const float tail = a_max - p1m / fmaxf(p2m, kMinVal);
  float alpha = isfinite(hi) ? secant : fmaxf(tail, a_max);
  const float cap = 10.0f * a_max;
  for (int it = 0; it < p.ls_polish; ++it) {
    float p2a;
    const float p1a = phi_d<ELL>(R, K, alpha, g0, h0, &p2a);
    if (p1a < 0.0f) lo = fmaxf(lo, alpha); else hi = fminf(hi, alpha);
    const float step = alpha - p1a / fmaxf(p2a, kMinVal);
    if (step > lo && step < hi) alpha = step;
    else alpha = isfinite(hi) ? 0.5f * (lo + hi) : fmaxf(step, lo);
    alpha = fminf(fmaxf(alpha, 0.0f), cap);
  }
  return p1_0 >= 0.0f ? 0.0f : alpha;
}

// The whole solve of one world for qfrc_smooth qfs (nv, the thread's own
// array), with the elliptic cone of the contacts ci (ELL; unread
// otherwise). Writes every output of s; qacce (nv, the thread's own
// array) also receives qacc_euler, for the caller's advance.
template <bool ELL>
DEV void newton_solve(const Solve& p, const ConeIn& ci, const float* qfs,
                      float* qacce) {
  const int nv = p.nv, nj = p.nj;
  const float* qM = p.qM;
  const float* J = p.J;

  // ---- qM factor and qacc_smooth ----
  float* qld = p.qLD;
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j < nv; ++j) qld[i * nv + j] = j <= i ? qM[i * nv + j]
                                                          : 0.0f;
  cholesky(qld, nv);
  float qacc_smooth[MAXNV];
  cho_solve(qld, nv, qfs, qacc_smooth);

  // ---- the elliptic contacts whose normal row acts (ELL, :139-178) ----
  ConeOf<ELL> K;
  short slot[ELL ? MAXCONE : 1];  // K's index of each contact, or -1
  if constexpr (ELL) {
    K.n = 0;
    K.S = ci.S;
    for (int c = 0; c < ci.C; ++c) {
      slot[c] = -1;
      const float D0 = p.D[ci.base + c * ci.S];
      if (ci.dim[c] < 2 || D0 == 0.0f) continue;
      const int j = K.n++;
      slot[c] = j;
      const float* fr = ci.friction + 5 * c;
      const float mu = fr[0] / sqrtf(fmaxf(ci.impratio, kMinVal));
      const float mu2 = mu * mu;
      K.mu[j] = mu;
      K.dm[j] = D0 / fmaxf(mu2 * (1.0f + mu2), kMinVal);
      for (int r = 0; r < ci.S; ++r) {
        K.k[j][r] = -1;
        K.s[j][r] = r == 0 ? mu : fr[min(r - 1, 4)];
      }
    }
  }

  // ---- the rows that can act ----
  Rows R;
  R.n = 0;
  for (int r = 0; r < nj; ++r) {
    const float D = p.D[r], fl = p.fl[r];
    p.efc_force[r] = 0.0f;
    if (D == 0.0f && fl == 0.0f) continue;
    const int k = R.n++;
    R.idx[k] = r;
    R.cls[k] = r < p.ne ? 0 : (r < p.ne + p.nf ? 1 : 2);
    R.D[k] = D;
    R.fl[k] = fl;
    R.rf[k] = fl / fmaxf(D, kMinVal);
    if constexpr (ELL) {
      if (r >= ci.base) {
        const int j = slot[(r - ci.base) / ci.S];
        if (j >= 0) {
          R.cls[k] = 3;
          K.k[j][(r - ci.base) % ci.S] = k;
        }
      }
    }
  }

  // ---- Newton solve (_newton_core init :446-466, loop :468-504) ----
  const float rescale = fmaxf(p.meaninertia, kMinVal) * (float)max(1, nv);
  float qacc[MAXNV], ma[MAXNV], grad[MAXNV], search[MAXNV], mv[MAXNV];
  float H[MAXNV * MAXNV];
  for (int i = 0; i < nv; ++i)
    qacc[i] = p.use_ws ? p.warmstart[i] : qacc_smooth[i];
  matvec(qM, nv, qacc, ma);
  rows_dot(R, J, nv, qacc, R.jaref);
  for (int k = 0; k < R.n; ++k) R.jaref[k] -= p.aref[R.idx[k]];
  auto gauss = [&]() {
    float s = 0.0f;
    for (int i = 0; i < nv; ++i)
      s += (ma[i] - qfs[i]) * (qacc[i] - qacc_smooth[i]);
    return 0.5f * s;
  };
  auto norm = [&](const float* x) {
    float s = 0.0f;
    for (int i = 0; i < nv; ++i) s += x[i] * x[i];
    return sqrtf(s);
  };
  float cost = update_constraint<ELL>(R, K) + gauss();
  gradient(R, J, nv, ma, qfs, grad);
  newton_dir<ELL>(R, K, J, qM, nv, grad, H, search);
  for (int i = 0; i < nv; ++i) search[i] = -search[i];
  bool done = norm(grad) / rescale < p.tolerance;
  int niter = 0;
  while (!done) {
    rows_dot(R, J, nv, search, R.jv);
    matvec(qM, nv, search, mv);
    float g0 = 0.0f, h0 = 0.0f;
    for (int i = 0; i < nv; ++i) {
      g0 += search[i] * (ma[i] - qfs[i]);
      h0 += search[i] * mv[i];
    }
    const float alpha = linesearch<ELL>(p, R, K, g0, h0);
    for (int i = 0; i < nv; ++i) {
      qacc[i] += alpha * search[i];
      ma[i] += alpha * mv[i];
    }
    for (int k = 0; k < R.n; ++k) R.jaref[k] += alpha * R.jv[k];
    const float newcost = update_constraint<ELL>(R, K) + gauss();
    gradient(R, J, nv, ma, qfs, grad);
    const float improvement = (cost - newcost) / rescale;
    const float gradnorm = norm(grad) / rescale;
    ++niter;
    done = improvement < p.tolerance || gradnorm < p.tolerance ||
           niter >= p.iterations;
    if (!done) {
      newton_dir<ELL>(R, K, J, qM, nv, grad, H, search);
      for (int i = 0; i < nv; ++i) search[i] = -search[i];
    }
    cost = newcost;
  }
  *p.solver_niter = niter;

  // ---- constraint force, qfrc_constraint ----
  update_constraint<ELL>(R, K);
  float qfc[MAXNV];
  for (int i = 0; i < nv; ++i) qfc[i] = 0.0f;
  for (int k = 0; k < R.n; ++k) {
    const float f = R.force[k];
    p.efc_force[R.idx[k]] = f;
    const float* Jr = J + (size_t)R.idx[k] * nv;
    for (int i = 0; i < nv; ++i) qfc[i] += Jr[i] * f;
  }

  // ---- integration diagonal: (qM + diag(hdiag)) qacc_euler = qfs + qfc ----
  if (p.hdiag) {
    for (int i = 0; i < nv; ++i) {
      for (int j = 0; j <= i; ++j) H[i * nv + j] = qM[i * nv + j];
      H[i * nv + i] += p.hdiag[i * p.hdiag_stride];
      qacce[i] = qfs[i] + qfc[i];
    }
    cholesky(H, nv);
    cho_solve(H, nv, qacce, qacce);
  } else {
    for (int i = 0; i < nv; ++i) qacce[i] = qacc[i];
  }
  for (int i = 0; i < nv; ++i) {
    p.qacc[i] = qacc[i];
    p.qfrc_constraint[i] = qfc[i];
    p.qacc_smooth[i] = qacc_smooth[i];
    p.qacc_euler[i] = qacce[i];
  }
}


// ---------------------------------------------------------------------------
// The pyramidal solve, one warp per world.
//
// Lane i keeps dof i's qacc, ma, grad, search, mv, qfrc_smooth and
// qacc_smooth in registers. Shared memory holds, per world (WarpMem), qM
// and the matrix being factored, then its factor, at the odd row stride
// ld = nv | 1, so that lanes reading a column hit 32 banks; the acting
// rows' state, compacted by __ballot_sync; and efc_J of the first JCAP
// acting rows (the rest are read from global memory, one coalesced row
// at a time). Global loads are issued all at once where they can be (qM,
// D, frictionloss, the cached rows). Sums over dofs are warp reductions
// (warp_sum); a row's product with a dof vector runs in the row's owner
// lane (row k: lane k % 32), a dof's sum over rows in the dof's lane.
// H = qM + J^T D J builds row i in lane i (a register array unrolled at
// compile time); the Cholesky factor is formed column by column in
// shared memory, lane i forming row i, the pivot broadcast by
// __shfl_sync (warp_factor_solve); each substitution step is one shuffle
// and a multiply by the stored reciprocal root of the pivot. The
// linesearch evaluates its LS_K bracket points in one pass over the rows
// (one partial sum per point in each lane, then a reduction each): the
// point at 0 comes first, since the bracket scales multiply its alpha0.
// Every sum runs in a fixed order, without atomics.
//
// On the H100 at 8192 humanoid worlds: 16 worlds resident per SM (4
// blocks of 4, registers and shared memory both near their limit). The
// time is about four waves of the slowest world's dependent chain (the
// factor's columns, the substitutions' steps, the linesearch's
// reductions), not the bytes or the flops.

#define WARPS 4    // worlds (warps) per block
#define JCAP 32    // acting rows of efc_J kept in shared memory
#define MAXLSK 16  // cap of ls_k (the wrappers pass solver.LS_K = 10)

// The sum of v over the warp's lanes. Partners add the same two values,
// so every lane ends with the same bits.
DEV float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// one world's shared memory
struct WarpMem {
  float* qM;     // nv x ld
  float* L;      // nv x ld: a matrix to factor, then its lower factor
  float* dinv;   // 32: its pivots' reciprocal roots
  float* vec;    // 32: a dof vector, read by every lane
  float* aux;    // naux: the actuators' forces on their dofs (B3)
  float* Jc;     // jcap x ld: efc_J of the first jcap acting rows
  float* D;      // nj each: the acting rows' state
  float* fl;
  float* rf;
  float* jaref;
  float* jv;
  float* force;
  int* idx;      // efc row
  int* cls;      // 0 equality, 1 friction, 2 one-sided
  int* quad;
};

// floats (and ints) of one world's WarpMem
__host__ __device__ inline int warp_mem_words(int nv, int naux, int nj) {
  const int ld = nv | 1;
  return 2 * nv * ld + 64 + naux + (nj < JCAP ? nj : JCAP) * ld + 9 * nj;
}

DEV WarpMem warp_mem(float* base, int nv, int naux, int nj) {
  const int ld = nv | 1;
  WarpMem s;
  float* p = base;
  s.qM = p; p += nv * ld;
  s.L = p; p += nv * ld;
  s.dinv = p; p += 32;
  s.vec = p; p += 32;
  s.aux = p; p += naux;
  s.Jc = p; p += min(nj, JCAP) * ld;
  s.D = p; p += nj;
  s.fl = p; p += nj;
  s.rf = p; p += nj;
  s.jaref = p; p += nj;
  s.jv = p; p += nj;
  s.force = p; p += nj;
  s.idx = (int*)p; p += nj;
  s.cls = (int*)p; p += nj;
  s.quad = (int*)p;
  return s;
}

// x = A^-1 b for the n x n SPD matrix A in sm.L (row stride ld, lower
// triangle read), b and x one dof per lane. Factors A = L L^T in place
// (lane i forms row i column by column; pivots below kMinVal are floored,
// as solver.cholesky does), keeps the pivots' reciprocal roots in
// sm.dinv, then substitutes forward and backward, one shuffle a step.
DEV float warp_factor_solve(const WarpMem& sm, int n, int ld, float b,
                            int lane) {
  float* A = sm.L;
  const float* Ai = A + lane * ld;
  for (int j = 0; j < n; ++j) {
    const float* Aj = A + j * ld;
    float s = lane < n ? Ai[j] : 0.0f;
    if (lane < n) {
#pragma unroll 8
      for (int k = 0; k < j; ++k) s -= Ai[k] * Aj[k];
    }
    const float inv = rsqrtf(fmaxf(__shfl_sync(FULL_MASK, s, j), kMinVal));
    if (lane >= j && lane < n) A[lane * ld + j] = s * inv;
    if (lane == j) sm.dinv[j] = inv;
    __syncwarp();
  }
  float t = lane < n ? b : 0.0f;
  for (int j = 0; j < n; ++j) {
    const float l = lane > j && lane < n ? Ai[j] : 0.0f;
    const float y = __shfl_sync(FULL_MASK, t, j) * sm.dinv[j];
    t = lane == j ? y : t - l * y;
  }
  for (int j = n - 1; j >= 0; --j) {
    const float l = lane < j ? A[j * ld + lane] : 0.0f;
    const float x = __shfl_sync(FULL_MASK, t, j) * sm.dinv[j];
    t = lane == j ? x : t - l * x;
  }
  return lane < n ? t : 0.0f;
}

// The whole pyramidal solve of one world in its warp (newton_solve<false>
// in this layout) for the lane's qfrc_smooth qfs (0 past nv). Writes every
// output of s; returns the lane's qacc_euler, for the caller's advance.
DEV float warp_newton(const Solve& p, const WarpMem& sm, float qfs,
                      int lane) {
  const int nv = p.nv, nj = p.nj, ld = nv | 1;
  const bool own = lane < nv;

  // ---- qM in shared memory (all loads in flight at once: each lane
  // loads in bounds, and keeps what it needs) ----
  {
    float v[MAXNV * MAXNV / 32];
#pragma unroll
    for (int t = 0; t < MAXNV * MAXNV / 32; ++t)
      v[t] = __ldg(p.qM + min(t * 32 + lane, nv * nv - 1));
#pragma unroll
    for (int t = 0; t < MAXNV * MAXNV / 32; ++t) {
      const int e = t * 32 + lane, i = e / nv;
      if (e < nv * nv) sm.qM[i * ld + e - i * nv] = v[t];
    }
  }
  __syncwarp();
  // its factor (qLD) and qacc_smooth
  if (own)
    for (int j = 0; j <= lane; ++j) sm.L[lane * ld + j] = sm.qM[lane * ld + j];
  __syncwarp();
  const float qsm = warp_factor_solve(sm, nv, ld, qfs, lane);
  for (int e = lane; e < nv * nv; e += 32) {
    const int i = e / nv, j = e - i * nv;
    p.qLD[e] = j <= i ? sm.L[i * ld + j] : 0.0f;
  }

  // ---- the rows that can act, compacted in row order ----
  float Dr[MAXNJ / 32], flr[MAXNJ / 32];
#pragma unroll
  for (int c = 0; c < MAXNJ / 32; ++c) {
    const int r = min(c * 32 + lane, nj - 1);
    Dr[c] = c * 32 < nj ? __ldg(p.D + r) : 0.0f;
    flr[c] = c * 32 < nj ? __ldg(p.fl + r) : 0.0f;
  }
  int n = 0;
#pragma unroll
  for (int c = 0; c < MAXNJ / 32; ++c) {
    if (c * 32 >= nj) break;
    const int r = c * 32 + lane;
    const float D = Dr[c], fl = flr[c];
    const bool act = r < nj && (D != 0.0f || fl != 0.0f);
    if (r < nj && !act) p.efc_force[r] = 0.0f;
    const unsigned ballot = __ballot_sync(FULL_MASK, act);
    if (act) {
      const int k = n + __popc(ballot & ((1u << lane) - 1u));
      sm.idx[k] = r;
      sm.cls[k] = r < p.ne ? 0 : (r < p.ne + p.nf ? 1 : 2);
      sm.D[k] = D;
      sm.fl[k] = fl;
      sm.rf[k] = fl / fmaxf(D, kMinVal);
    }
    n += __popc(ballot);
  }
  __syncwarp();
  // efc_J of the first nc acting rows, one coalesced row per load, all
  // loads in flight at once; row k past nc is read from global memory
  const int nc = min(n, JCAP);
  if (nc > 0) {
    const int col = own ? lane : 0;
    float v[JCAP];
#pragma unroll
    for (int k = 0; k < JCAP; ++k)
      v[k] = __ldg(p.J + (size_t)sm.idx[k < nc ? k : 0] * nv + col);
#pragma unroll
    for (int k = 0; k < JCAP; ++k)
      if (k < nc && own) sm.Jc[k * ld + lane] = v[k];
  }
  __syncwarp();
  // row k's efc_J in global memory (k >= nc)
  auto jrow = [&](int k) { return p.J + (size_t)sm.idx[k] * nv; };

  // the lanes' dof values x to every lane
  auto share = [&](float x) {
    sm.vec[lane] = x;
    __syncwarp();
  };
  // out[k] = J_k . x over the lane's rows
  auto rows_dot = [&](float x, float* out) {
    share(x);
    for (int k = lane; k < n; k += 32) {
      float s = 0.0f;
      if (k < nc) {
        const float* Jr = sm.Jc + k * ld;
#pragma unroll
        for (int i = 0; i < MAXNV; ++i)
          if (i < nv) s += Jr[i] * sm.vec[i];
      } else {
        const float* Jr = jrow(k);
#pragma unroll
        for (int i = 0; i < MAXNV; ++i)
          if (i < nv) s += __ldg(Jr + i) * sm.vec[i];
      }
      out[k] = s;
    }
    __syncwarp();
  };
  // (qM x)_i in lane i
  auto qm_dot = [&](float x) {
    share(x);
    float s = 0.0f;
    if (own) {
      const float* Mi = sm.qM + lane * ld;
#pragma unroll
      for (int j = 0; j < MAXNV; ++j)
        if (j < nv) s += Mi[j] * sm.vec[j];
    }
    __syncwarp();
    return s;
  };
  // J^T y, dof i in lane i, for y over the rows in shared memory
  auto rows_t_dot = [&](const float* y) {
    float s = 0.0f;
    if (own) {
      int k = 0;
#pragma unroll 8
      for (; k < nc; ++k) s += sm.Jc[k * ld + lane] * y[k];
      for (; k < n; ++k) s += __ldg(jrow(k) + lane) * y[k];
    }
    return s;
  };
  // force, quad and the constraint cost of jaref (update_constraint)
  auto update_constraint = [&]() {
    float cost = 0.0f;
    for (int k = lane; k < n; k += 32) {
      const float x = sm.jaref[k], D = sm.D[k], fl = sm.fl[k], rf = sm.rf[k];
      const int c = sm.cls[k];
      const bool lin_neg = c == 1 && x <= -rf;
      const bool lin_pos = c == 1 && x >= rf;
      const bool quad = c == 0 || (c == 1 && !lin_neg && !lin_pos) ||
                        (c == 2 && x < 0.0f);
      float f = 0.0f, cst = 0.0f;
      if (quad) { f = -D * x; cst = 0.5f * D * x * x; }
      if (lin_neg) { f = fl; cst = -fl * (0.5f * rf + x); }
      if (lin_pos) { f = -fl; cst = -fl * (0.5f * rf - x); }
      sm.force[k] = f;
      sm.quad[k] = quad;
      cost += cst;
    }
    __syncwarp();
    return warp_sum(cost);
  };
  // H^-1 grad with H = qM + J^T diag(D quad) J, row i built in lane i
  auto newton_dir = [&](float grad) {
    if (own) {
      float h[MAXNV];
      const float* Mi = sm.qM + lane * ld;
#pragma unroll
      for (int j = 0; j < MAXNV; ++j) h[j] = j < nv ? Mi[j] : 0.0f;
      int k = 0;
      for (; k < nc; ++k) {
        if (!sm.quad[k]) continue;
        const float* Jr = sm.Jc + k * ld;
        const float di = sm.D[k] * Jr[lane];
#pragma unroll
        for (int j = 0; j < MAXNV; ++j)
          if (j < nv) h[j] += di * Jr[j];
      }
      for (; k < n; ++k) {
        if (!sm.quad[k]) continue;
        const float* Jr = jrow(k);
        const float di = sm.D[k] * __ldg(Jr + lane);
#pragma unroll
        for (int j = 0; j < MAXNV; ++j)
          if (j < nv) h[j] += di * __ldg(Jr + j);
      }
      float* Hi = sm.L + lane * ld;
#pragma unroll
      for (int j = 0; j < MAXNV; ++j)
        if (j < nv) Hi[j] = h[j];
    }
    __syncwarp();
    return warp_factor_solve(sm, nv, ld, grad, lane);
  };
  // the lane's rows' share of the cost's first (returned) and second
  // derivative along the search direction at alpha
  auto phi_rows = [&](float alpha, float* s2) {
    float s1 = 0.0f;
    *s2 = 0.0f;
    for (int k = lane; k < n; k += 32) {
      const float jv = sm.jv[k], x = sm.jaref[k] + alpha * jv;
      const int c = sm.cls[k];
      const float rf = sm.rf[k];
      const bool lin_neg = c == 1 && x <= -rf;
      const bool lin_pos = c == 1 && x >= rf;
      const bool quad = c == 0 || (c == 1 && !lin_neg && !lin_pos) ||
                        (c == 2 && x < 0.0f);
      if (quad) { s1 += sm.D[k] * x * jv; *s2 += sm.D[k] * jv * jv; }
      if (lin_neg) s1 -= sm.fl[k] * jv;
      if (lin_pos) s1 += sm.fl[k] * jv;
    }
    return s1;
  };
  auto phi_d = [&](float alpha, float g0, float h0, float* d2) {
    float s2;
    const float s1 = warp_sum(phi_rows(alpha, &s2));
    *d2 = h0 + warp_sum(s2);
    return g0 + alpha * h0 + s1;
  };
  // bracket of ls_k log-spaced alphas, secant, then ls_polish safeguarded
  // Newton / bisection steps (linesearch<false>, the same rules)
  auto linesearch = [&](float g0, float h0) {
    float p2;
    const float p1_0 = phi_d(0.0f, g0, h0, &p2);
    const float alpha0 = fmaxf(-p1_0 / fmaxf(p2, kMinVal), 0.0f);
    float a[MAXLSK], s1[MAXLSK], s2m = 0.0f;
#pragma unroll
    for (int s = 0; s < MAXLSK; ++s) {
      a[s] = s < p.ls_k ? alpha0 * p.ls_scales[s] : 0.0f;
      s1[s] = 0.0f;
    }
    for (int k = lane; k < n; k += 32) {
      const float jv = sm.jv[k], jaref = sm.jaref[k], D = sm.D[k];
      const float fl = sm.fl[k], rf = sm.rf[k];
      const int c = sm.cls[k];
#pragma unroll
      for (int s = 0; s < MAXLSK; ++s) {
        if (s >= p.ls_k) break;
        const float x = jaref + a[s] * jv;
        const bool lin_neg = c == 1 && x <= -rf;
        const bool lin_pos = c == 1 && x >= rf;
        const bool quad = c == 0 || (c == 1 && !lin_neg && !lin_pos) ||
                          (c == 2 && x < 0.0f);
        if (quad) {
          s1[s] += D * x * jv;
          if (s == p.ls_k - 1) s2m += D * jv * jv;
        }
        if (lin_neg) s1[s] -= fl * jv;
        if (lin_pos) s1[s] += fl * jv;
      }
    }
    float lo = 0.0f, p1_lo = p1_0, hi = INFINITY, p1_hi = INFINITY;
    float p1m = 0.0f;
#pragma unroll
    for (int s = 0; s < MAXLSK; ++s) {
      if (s >= p.ls_k) break;
      const float p1a = g0 + a[s] * h0 + warp_sum(s1[s]);
      if (p1a < 0.0f) {
        lo = a[s]; p1_lo = p1a;
      } else if (!isfinite(hi)) {
        hi = a[s]; p1_hi = p1a;
      }
      p1m = p1a;
    }
    const float diff = p1_hi - p1_lo;
    const float secant = lo - p1_lo * (hi - lo) /
                                  (fabsf(diff) < kMinVal ? 1.0f : diff);
    // a_max is the last bracket point
    const float a_max = alpha0 * p.ls_scales[p.ls_k - 1];
    const float p2m = h0 + warp_sum(s2m);
    const float tail = a_max - p1m / fmaxf(p2m, kMinVal);
    float alpha = isfinite(hi) ? secant : fmaxf(tail, a_max);
    const float cap = 10.0f * a_max;
    for (int it = 0; it < p.ls_polish; ++it) {
      float p2a;
      const float p1a = phi_d(alpha, g0, h0, &p2a);
      if (p1a < 0.0f) lo = fmaxf(lo, alpha); else hi = fminf(hi, alpha);
      const float step = alpha - p1a / fmaxf(p2a, kMinVal);
      if (step > lo && step < hi) alpha = step;
      else alpha = isfinite(hi) ? 0.5f * (lo + hi) : fmaxf(step, lo);
      alpha = fminf(fmaxf(alpha, 0.0f), cap);
    }
    return p1_0 >= 0.0f ? 0.0f : alpha;
  };

  // ---- Newton solve (_newton_core init :446-466, loop :468-504) ----
  const float rescale = fmaxf(p.meaninertia, kMinVal) * (float)max(1, nv);
  float qacc = own ? (p.use_ws ? p.warmstart[lane] : qsm) : 0.0f;
  float ma = qm_dot(qacc);
  rows_dot(qacc, sm.jaref);
  for (int k = lane; k < n; k += 32) sm.jaref[k] -= __ldg(p.aref + sm.idx[k]);
  auto gauss = [&]() {
    return 0.5f * warp_sum((ma - qfs) * (qacc - qsm));
  };
  float cost = update_constraint() + gauss();
  float grad = ma - qfs - rows_t_dot(sm.force);
  bool done = sqrtf(warp_sum(grad * grad)) / rescale < p.tolerance;
  int niter = 0;
  while (!done) {   // the direction of an iteration is the last one's
    const float search = -newton_dir(grad);
    rows_dot(search, sm.jv);
    const float mv = qm_dot(search);
    const float g0 = warp_sum(search * (ma - qfs));
    const float h0 = warp_sum(search * mv);
    const float alpha = linesearch(g0, h0);
    qacc += alpha * search;
    ma += alpha * mv;
    for (int k = lane; k < n; k += 32) sm.jaref[k] += alpha * sm.jv[k];
    const float newcost = update_constraint() + gauss();
    grad = ma - qfs - rows_t_dot(sm.force);
    const float improvement = (cost - newcost) / rescale;
    const float gradnorm = sqrtf(warp_sum(grad * grad)) / rescale;
    ++niter;
    done = improvement < p.tolerance || gradnorm < p.tolerance ||
           niter >= p.iterations;
    cost = newcost;
  }
  if (lane == 0) *p.solver_niter = niter;

  // ---- efc_force (the last update's) and qfrc_constraint ----
  for (int k = lane; k < n; k += 32) p.efc_force[sm.idx[k]] = sm.force[k];
  const float qfc = rows_t_dot(sm.force);

  // ---- integration diagonal: (qM + diag(hdiag)) qacc_euler = qfs + qfc ----
  float qacce = qacc;
  if (p.hdiag) {
    __syncwarp();
    if (own) {
      for (int j = 0; j <= lane; ++j)
        sm.L[lane * ld + j] = sm.qM[lane * ld + j];
      sm.L[lane * ld + lane] += p.hdiag[lane * p.hdiag_stride];
    }
    __syncwarp();
    qacce = warp_factor_solve(sm, nv, ld, qfs + qfc, lane);
  }
  if (own) {
    p.qacc[lane] = qacc;
    p.qfrc_constraint[lane] = qfc;
    p.qacc_smooth[lane] = qsm;
    p.qacc_euler[lane] = qacce;
  }
  return qacce;
}
