// The Newton solve for the pyramidal cone, one world per thread: the
// device code kernels B3 (glue.cu) and B4 (newton.cu) share, as the JAX
// package shares _newton_core
// (mujoco_warp_tpu/pallas/solver_kernels.py:103) between _glue_kernel
// and _newton_kernel. newton_solve() factors qM, solves for qacc_smooth,
// runs the Newton loop (init :446-466, loop :468-504, linesearch
// :398-444), writes the forces and, with an integration diagonal,
// re-solves (qM + diag) qacc_euler = qfrc_smooth + qfrc_constraint.
// Plain version: mujoco_warp_tpu_torch/solver.py, newton().
//
// A thread keeps H and its factor (nv x nv floats) and the acting rows'
// state in local memory and reads J, D and aref through the cache from
// the batch-first [W, ...] layout. It loops until its own world
// converges: a converged world stops, as the TPU kernel freezes it with
// alpha = 0 (:480). The rows that cannot act (D = 0 and frictionloss =
// 0: inactive limits, empty contact slots) are skipped, which changes no
// result.
#pragma once

#include "common.cuh"

#define MAXNV 32
#define MAXNJ 256

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

// the efc rows that can act this step, with their solver state
struct Rows {
  int n;
  int idx[MAXNJ];
  unsigned char cls[MAXNJ];  // 0 equality, 1 friction, 2 one-sided
  float D[MAXNJ], fl[MAXNJ], rf[MAXNJ];
  float jaref[MAXNJ], jv[MAXNJ], force[MAXNJ];
  bool quad[MAXNJ];
};

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

// force, quad and the constraint cost of jaref (update_constraint)
DEV float update_constraint(Rows& R) {
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

// Newton direction H^-1 grad with H = qM + J^T diag(D quad) J
DEV void newton_dir(const Rows& R, const float* J, const float* qM, int nv,
                    const float* grad, float* H, float* out) {
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
  cholesky(H, nv);
  cho_solve(H, nv, grad, out);
}

// first and second derivative of the cost along the search direction
DEV float phi_d(const Rows& R, float alpha, float g0, float h0, float* d2) {
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
  *d2 = h0 + s2;
  return g0 + alpha * h0 + s1;
}

// bracket of ls_k log-spaced alphas, secant, then ls_polish safeguarded
// Newton / bisection steps (_newton_core linesearch :398-444)
DEV float linesearch(const Solve& p, const Rows& R, float g0, float h0) {
  float p2;
  const float p1_0 = phi_d(R, 0.0f, g0, h0, &p2);
  const float alpha0 = fmaxf(-p1_0 / fmaxf(p2, kMinVal), 0.0f);
  float lo = 0.0f, p1_lo = p1_0, hi = INFINITY, p1_hi = INFINITY;
  for (int s = 0; s < p.ls_k; ++s) {
    const float a = alpha0 * p.ls_scales[s];
    const float p1a = phi_d(R, a, g0, h0, &p2);
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
  const float p1m = phi_d(R, a_max, g0, h0, &p2m);
  const float tail = a_max - p1m / fmaxf(p2m, kMinVal);
  float alpha = isfinite(hi) ? secant : fmaxf(tail, a_max);
  const float cap = 10.0f * a_max;
  for (int it = 0; it < p.ls_polish; ++it) {
    float p2a;
    const float p1a = phi_d(R, alpha, g0, h0, &p2a);
    if (p1a < 0.0f) lo = fmaxf(lo, alpha); else hi = fminf(hi, alpha);
    const float step = alpha - p1a / fmaxf(p2a, kMinVal);
    if (step > lo && step < hi) alpha = step;
    else alpha = isfinite(hi) ? 0.5f * (lo + hi) : fmaxf(step, lo);
    alpha = fminf(fmaxf(alpha, 0.0f), cap);
  }
  return p1_0 >= 0.0f ? 0.0f : alpha;
}

// The whole solve of one world for qfrc_smooth qfs (nv, the thread's own
// array). Writes every output of s; qacce (nv, the thread's own array)
// also receives qacc_euler, for the caller's advance.
DEV void newton_solve(const Solve& p, const float* qfs, float* qacce) {
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
  float cost = update_constraint(R) + gauss();
  gradient(R, J, nv, ma, qfs, grad);
  newton_dir(R, J, qM, nv, grad, H, search);
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
    const float alpha = linesearch(p, R, g0, h0);
    for (int i = 0; i < nv; ++i) {
      qacc[i] += alpha * search[i];
      ma[i] += alpha * mv[i];
    }
    for (int k = 0; k < R.n; ++k) R.jaref[k] += alpha * R.jv[k];
    const float newcost = update_constraint(R) + gauss();
    gradient(R, J, nv, ma, qfs, grad);
    const float improvement = (cost - newcost) / rescale;
    const float gradnorm = norm(grad) / rescale;
    ++niter;
    done = improvement < p.tolerance || gradnorm < p.tolerance ||
           niter >= p.iterations;
    if (!done) {
      newton_dir(R, J, qM, nv, grad, H, search);
      for (int i = 0; i < nv; ++i) search[i] = -search[i];
    }
    cost = newcost;
  }
  *p.solver_niter = niter;

  // ---- constraint force, qfrc_constraint ----
  update_constraint(R);
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
