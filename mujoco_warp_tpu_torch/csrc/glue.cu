// Kernel B3: the back half of the step for one world per thread —
// affine actuation on slide/hinge joints, joint springs and dampers,
// qfrc_smooth, the Cholesky factor of qM and qacc_smooth, the whole
// Newton solve for the pyramidal cone, the integration-diagonal
// re-solve (mode 1: Euler with implicit joint damping) and the
// semi-implicit Euler advance of qvel and qpos.
//
// Replaces: mujoco_warp_tpu/pallas/solver_kernels.py, make_glue_kernel
// -> run (:1207; body _glue_kernel / _glue_core :939 / :966, the solve
// _newton_core :103). Plain version: mujoco_warp_tpu_torch/forward.py,
// glue() (with solver.newton).
//
// What bounds it on the H100: the solve's dependent arithmetic, not the
// bytes. Per world it reads qM and efc_J (27x27 + 117x27 floats, 15.5 KB)
// once, 127 MB at 8192 worlds, 38 us at 3.35 TB/s; each Newton
// iteration then assembles H = qM + J^T D J over the active rows,
// factors it (about nv^3/6 = 3.3k multiply-adds) and runs a 16-point
// linesearch, a few tens of thousands of flops per iteration in a
// serial chain per thread.
//
// What this first cut does about it: little. One thread per world keeps
// H and its factor (27x27 floats) in local memory, reads J, D and aref
// through the cache from the batch-first [W, ...] layout (uncoalesced),
// and loops until its own world converges: a converged world stops, as
// the TPU kernel freezes it with alpha = 0 (:480). The only economy is to
// skip the rows that cannot act (D = 0 and frictionloss = 0: inactive
// limits, empty contact slots), which changes no result. A warp per
// world with shared-memory J tiles is later work.

#include "common.cuh"

#define MAXNV 32
#define MAXNJ 256

struct Params {
  const float* qM;
  const float* efc_J;
  const float* efc_D;
  const float* efc_aref;
  const float* efc_frictionloss;
  const float* qpos_in;
  const float* qvel_in;
  const float* ctrl;
  const float* qfx;
  const float* qacc_warmstart;
  const int* act_int;        // (nu, 2): qposadr dofadr
  const float* act_float;    // (nu, 11): gear0 ctrl_lo ctrl_hi gain3 bias3
                             //   frc_lo frc_hi
  const int* dof_int;        // (nv): qposadr of the dof's spring
  const float* dof_float;    // (nv, 6): damping stiffness springref
                             //   af_lo af_hi hdiag
  const int* jnt_int;        // (njnt, 3): type qposadr dofadr
  const float* ls_scales;    // (ls_k) linesearch bracket scales
  float* qacc;
  float* qfrc_constraint;
  float* efc_force;
  int* solver_niter;
  float* qacc_smooth;
  float* qLD;
  float* qacc_euler;
  float* actuator_force;
  float* qfrc_actuator;
  float* qfrc_spring;
  float* qfrc_damper;
  float* qfrc_passive;
  float* qfrc_smooth;
  float* qpos;
  float* qvel;
  float timestep;
  float tolerance;
  float meaninertia;
  int nworld;
  int nq;
  int nv;
  int nu;
  int njnt;
  int nj;
  int ne;
  int nf;
  int iterations;
  int ls_k;
  int ls_polish;
  int use_ws;
  int mode;
  int actuation_on;
};

enum { kFree = 0, kBall = 1 };

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
DEV float linesearch(const Params& p, const Rows& R, float g0, float h0) {
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

__global__ void glue_kernel(const Params p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.nworld) return;
  const int nv = p.nv, nq = p.nq, nu = p.nu, nj = p.nj;
  const float h = p.timestep;
  const float* qpos = p.qpos_in + (size_t)w * nq;
  const float* qvel = p.qvel_in + (size_t)w * nv;
  const float* qM = p.qM + (size_t)w * nv * nv;
  const float* J = p.efc_J + (size_t)w * nj * nv;
  const size_t vw = (size_t)w * nv;

  // ---- actuation (forward.fwd_actuation) ----
  float qfa[MAXNV];
  for (int i = 0; i < nv; ++i) qfa[i] = 0.0f;
  for (int u = 0; u < nu; ++u) {
    float f = 0.0f;
    if (p.actuation_on) {
      const float* a = p.act_float + 11 * u;
      const int qa = p.act_int[2 * u], da = p.act_int[2 * u + 1];
      const float len = qpos[qa] * a[0], vel = qvel[da] * a[0];
      const float c = fminf(fmaxf(p.ctrl[(size_t)w * nu + u], a[1]), a[2]);
      const float gain = a[3] + a[4] * len + a[5] * vel;
      const float bias = a[6] + a[7] * len + a[8] * vel;
      f = fminf(fmaxf(gain * c + bias, a[9]), a[10]);
      qfa[da] += f * a[0];
    }
    p.actuator_force[(size_t)w * nu + u] = f;
  }

  // ---- passive springs and dampers, qfrc_smooth ----
  float qfs[MAXNV];
  for (int i = 0; i < nv; ++i) {
    const float* d = p.dof_float + 6 * i;
    if (p.actuation_on) qfa[i] = fminf(fmaxf(qfa[i], d[3]), d[4]);
    const float spring = -d[1] * (qpos[p.dof_int[i]] - d[2]);
    const float damper = -d[0] * qvel[i];
    const float pas = spring + damper;
    qfs[i] = pas + qfa[i] + p.qfx[vw + i];
    p.qfrc_actuator[vw + i] = qfa[i];
    p.qfrc_spring[vw + i] = spring;
    p.qfrc_damper[vw + i] = damper;
    p.qfrc_passive[vw + i] = pas;
    p.qfrc_smooth[vw + i] = qfs[i];
  }

  // ---- qM factor and qacc_smooth ----
  float* qld = p.qLD + (size_t)w * nv * nv;
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
    const size_t g = (size_t)w * nj + r;
    const float D = p.efc_D[g], fl = p.efc_frictionloss[g];
    p.efc_force[g] = 0.0f;
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
    qacc[i] = p.use_ws ? p.qacc_warmstart[vw + i] : qacc_smooth[i];
  matvec(qM, nv, qacc, ma);
  rows_dot(R, J, nv, qacc, R.jaref);
  for (int k = 0; k < R.n; ++k)
    R.jaref[k] -= p.efc_aref[(size_t)w * nj + R.idx[k]];
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
  p.solver_niter[w] = niter;

  // ---- constraint force, qfrc_constraint ----
  update_constraint(R);
  float qfc[MAXNV];
  for (int i = 0; i < nv; ++i) qfc[i] = 0.0f;
  for (int k = 0; k < R.n; ++k) {
    const float f = R.force[k];
    p.efc_force[(size_t)w * nj + R.idx[k]] = f;
    const float* Jr = J + (size_t)R.idx[k] * nv;
    for (int i = 0; i < nv; ++i) qfc[i] += Jr[i] * f;
  }

  // ---- integration diagonal: (qM + diag(hdiag)) qacc_euler = qfs + qfc ----
  float qacce[MAXNV];
  if (p.mode == 1) {
    for (int i = 0; i < nv; ++i) {
      for (int j = 0; j <= i; ++j) H[i * nv + j] = qM[i * nv + j];
      H[i * nv + i] += p.dof_float[6 * i + 5];
      qacce[i] = qfs[i] + qfc[i];
    }
    cholesky(H, nv);
    cho_solve(H, nv, qacce, qacce);
  } else {
    for (int i = 0; i < nv; ++i) qacce[i] = qacc[i];
  }

  // ---- semi-implicit Euler advance (forward.integrate_pos) ----
  float* qvel_out = p.qvel + vw;
  for (int i = 0; i < nv; ++i) {
    p.qacc[vw + i] = qacc[i];
    p.qfrc_constraint[vw + i] = qfc[i];
    p.qacc_smooth[vw + i] = qacc_smooth[i];
    p.qacc_euler[vw + i] = qacce[i];
    qvel_out[i] = qvel[i] + h * qacce[i];
  }
  float* qpos_out = p.qpos + (size_t)w * nq;
  for (int i = 0; i < nq; ++i) qpos_out[i] = qpos[i];
  for (int j = 0; j < p.njnt; ++j) {
    const int type = p.jnt_int[3 * j];
    int qa = p.jnt_int[3 * j + 1], da = p.jnt_int[3 * j + 2];
    if (type == kFree) {
      for (int i = 0; i < 3; ++i)
        qpos_out[qa + i] = qpos[qa + i] + h * qvel_out[da + i];
      qa += 3;
      da += 3;
    } else if (type != kBall) {
      qpos_out[qa] = qpos[qa] + h * qvel_out[da];
      continue;
    }
    const float* wv = qvel_out + da;
    const float n = sqrtf(fmaxf(wv[0] * wv[0] + wv[1] * wv[1] +
                                wv[2] * wv[2], 1e-30f));
    const float half = 0.5f * n * h;
    const float s = sinf(half);
    float dq[4] = {cosf(half), wv[0] / n * s, wv[1] / n * s, wv[2] / n * s};
    float q[4];
    qmul(qpos + qa, dq, q);
    qnormalize(q);
    for (int i = 0; i < 4; ++i) qpos_out[qa + i] = q[i];
  }
}

PORT_C_INTERFACE(Params, glue_kernel, 32)
