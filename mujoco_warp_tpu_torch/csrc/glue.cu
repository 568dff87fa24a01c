// Kernels B3 and B3e: the back half of the step — affine actuation on
// slide/hinge joints, joint springs and dampers, qfrc_smooth, the
// Cholesky factor of qM and qacc_smooth, the whole Newton solve, the
// integration-diagonal re-solve (mode 1: Euler with implicit joint
// damping) and the semi-implicit Euler advance of qvel and qpos. B3
// (glue_kernel) solves with the pyramidal cone in one warp per world
// (glue_warp), B3e (glue_ell_kernel) with the elliptic cone of the
// contacts' friction and dim in one thread per world (glue_world<true>).
//
// Replaces: mujoco_warp_tpu/pallas/solver_kernels.py, make_glue_kernel
// -> run (:1207; bodies _glue_kernel / _glue_ell_kernel / _glue_core
// :939 / :954 / :966, the solve _newton_core :103). Plain version:
// mujoco_warp_tpu_torch/forward.py, glue() (with solver.newton). The
// solves are warp_newton() and newton_solve<true>() of newton.cuh, which
// kernels B4 and B4-elliptic (newton.cu) run too.
//
// What bounds it on the H100: the solve's dependent arithmetic, not the
// bytes. Per world it reads qM and the acting rows of efc_J (27x27 +
// about 20x27 floats on the humanoid) once; each Newton iteration then
// assembles H = qM + J^T D J over the active rows, factors it (about
// nv^3/6 = 3.3k multiply-adds) and runs a 16-point linesearch: a few tens
// of thousands of flops per iteration, most of them in dependent chains.
//
// What B3's design does about it: a warp per world puts the chains' inner
// loops across 32 lanes (a row of H, a column of the factor, a row's dot
// product, a linesearch point per partial sum), keeps qM, H, the acting
// rows and their efc_J in shared memory (about 13 KB a world on the
// humanoid; nothing in local memory), so that 16 worlds fit on an SM, and
// stops each warp at its own world's convergence (see newton.cuh). The
// actuation runs one actuator per lane, the passive forces and the
// advance one dof, then one joint, per lane. B3e keeps the one-thread
// design: H and the rows' state in local memory, J read through the cache
// from the batch-first [W, ...] layout; per contact it adds a few tens of
// flops to each constraint update and linesearch point and, in the middle
// zone, an S x S block to the Hessian, built on the fly from the
// contact's rows (S <= 6) rather than stored.

#include "newton.cuh"

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

// B3e's parameters: B3's and the contacts of the elliptic cone
struct EllParams {
  Params base;
  const float* con_friction;  // (nconmax, 5)
  const int* con_dim;         // (nconmax) 0 in an empty slot
  float impratio;
  int efc_base;               // first contact row
  int stride;                 // rows per contact
  int nconmax;
};

enum { kFree = 0, kBall = 1 };

template <bool ELL>
DEV void glue_world(const Params& p, const ConeIn& ci, int w) {
  const int nv = p.nv, nq = p.nq, nu = p.nu;
  const float h = p.timestep;
  const float* qpos = p.qpos_in + (size_t)w * nq;
  const float* qvel = p.qvel_in + (size_t)w * nv;
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

  // ---- qM factor, qacc_smooth, Newton solve, forces, re-solve ----
  Solve s = world_solve(p, w);
  if (p.mode == 1) {
    s.hdiag = p.dof_float + 5;
    s.hdiag_stride = 6;
  }
  float qacce[MAXNV];
  newton_solve<ELL>(s, ci, qfs, qacce);

  // ---- semi-implicit Euler advance (forward.integrate_pos) ----
  float* qvel_out = p.qvel + vw;
  for (int i = 0; i < nv; ++i) qvel_out[i] = qvel[i] + h * qacce[i];
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

// B3: world w in its warp; sm its shared memory
DEV void glue_warp(const Params& p, const WarpMem& sm, int w, int lane) {
  const int nv = p.nv, nq = p.nq, nu = p.nu;
  const bool own = lane < nv;
  const float h = p.timestep;
  const float* qpos = p.qpos_in + (size_t)w * nq;
  const float* qvel = p.qvel_in + (size_t)w * nv;
  const size_t vw = (size_t)w * nv;

  // ---- actuation (forward.fwd_actuation), one actuator per lane ----
  for (int u = lane; u < nu; u += 32) {
    float f = 0.0f, g = 0.0f;
    if (p.actuation_on) {
      const float* a = p.act_float + 11 * u;
      const int qa = p.act_int[2 * u], da = p.act_int[2 * u + 1];
      const float len = qpos[qa] * a[0], vel = qvel[da] * a[0];
      const float c = fminf(fmaxf(p.ctrl[(size_t)w * nu + u], a[1]), a[2]);
      const float gain = a[3] + a[4] * len + a[5] * vel;
      const float bias = a[6] + a[7] * len + a[8] * vel;
      f = fminf(fmaxf(gain * c + bias, a[9]), a[10]);
      g = f * a[0];
    }
    sm.aux[u] = g;
    p.actuator_force[(size_t)w * nu + u] = f;
  }
  __syncwarp();

  // ---- passive springs and dampers, qfrc_smooth, one dof per lane ----
  float qfs = 0.0f;
  if (own) {
    float qfa = 0.0f;    // the dof's actuator forces, in actuator order
    if (p.actuation_on)
      for (int u = 0; u < nu; ++u)
        if (p.act_int[2 * u + 1] == lane) qfa += sm.aux[u];
    const float* d = p.dof_float + 6 * lane;
    if (p.actuation_on) qfa = fminf(fmaxf(qfa, d[3]), d[4]);
    const float spring = -d[1] * (qpos[p.dof_int[lane]] - d[2]);
    const float damper = -d[0] * qvel[lane];
    const float pas = spring + damper;
    qfs = pas + qfa + p.qfx[vw + lane];
    p.qfrc_actuator[vw + lane] = qfa;
    p.qfrc_spring[vw + lane] = spring;
    p.qfrc_damper[vw + lane] = damper;
    p.qfrc_passive[vw + lane] = pas;
    p.qfrc_smooth[vw + lane] = qfs;
  }

  // ---- qM factor, qacc_smooth, Newton solve, forces, re-solve ----
  Solve s = world_solve(p, w);
  if (p.mode == 1) {
    s.hdiag = p.dof_float + 5;
    s.hdiag_stride = 6;
  }
  const float qacce = warp_newton(s, sm, qfs, lane);

  // ---- semi-implicit Euler advance (forward.integrate_pos) ----
  const float v = own ? qvel[lane] + h * qacce : 0.0f;
  if (own) p.qvel[vw + lane] = v;
  sm.vec[lane] = v;
  float* qpos_out = p.qpos + (size_t)w * nq;
  for (int i = lane; i < nq; i += 32) qpos_out[i] = qpos[i];
  __syncwarp();
  for (int j = lane; j < p.njnt; j += 32) {    // one joint per lane
    const int type = p.jnt_int[3 * j];
    int qa = p.jnt_int[3 * j + 1], da = p.jnt_int[3 * j + 2];
    if (type == kFree) {
      for (int i = 0; i < 3; ++i)
        qpos_out[qa + i] = qpos[qa + i] + h * sm.vec[da + i];
      qa += 3;
      da += 3;
    } else if (type != kBall) {
      qpos_out[qa] = qpos[qa] + h * sm.vec[da];
      continue;
    }
    const float* wv = sm.vec + da;
    const float n = sqrtf(fmaxf(wv[0] * wv[0] + wv[1] * wv[1] +
                                wv[2] * wv[2], 1e-30f));
    const float half = 0.5f * n * h;
    const float sn = sinf(half);
    float dq[4] = {cosf(half), wv[0] / n * sn, wv[1] / n * sn,
                   wv[2] / n * sn};
    float q[4];
    qmul(qpos + qa, dq, q);
    qnormalize(q);
    for (int i = 0; i < 4; ++i) qpos_out[qa + i] = q[i];
  }
}

__global__ void __launch_bounds__(WARPS * 32, 16 / WARPS)
glue_kernel(const Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int w = blockIdx.x * WARPS + wb;
  if (w >= p.nworld) return;
  const int words = warp_mem_words(p.nv, p.nu, p.nj);
  glue_warp(p, warp_mem(smem + wb * words, p.nv, p.nu, p.nj), w, lane);
}

__global__ void glue_ell_kernel(const EllParams p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.base.nworld) return;
  glue_world<true>(p.base, world_cone(p, w), w);
}

PORT_C_WARP_INTERFACE(Params, glue_kernel, WARPS,
                      4 * warp_mem_words(p->nv, p->nu, p->nj))
PORT_C_ENTRY(ell_, EllParams, glue_ell_kernel, 32, base.nworld)
