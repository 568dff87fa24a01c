// Kernels B3 and B3e: the back half of the step for one world per
// thread — affine actuation on slide/hinge joints, joint springs and
// dampers, qfrc_smooth, the Cholesky factor of qM and qacc_smooth, the
// whole Newton solve, the integration-diagonal re-solve (mode 1: Euler
// with implicit joint damping) and the semi-implicit Euler advance of
// qvel and qpos. B3 (glue_kernel) solves with the pyramidal cone, B3e
// (glue_ell_kernel) with the elliptic cone of the contacts' friction and
// dim; both are glue_world<ELL>().
//
// Replaces: mujoco_warp_tpu/pallas/solver_kernels.py, make_glue_kernel
// -> run (:1207; bodies _glue_kernel / _glue_ell_kernel / _glue_core
// :939 / :954 / :966, the solve _newton_core :103). Plain version:
// mujoco_warp_tpu_torch/forward.py, glue() (with solver.newton). The
// solve is newton_solve<ELL>() of newton.cuh, which kernels B4 and
// B4-elliptic (newton.cu) run too.
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
// and loops until its own world converges (see newton.cuh). A warp per
// world with shared-memory J tiles is later work. B3e adds per contact
// a few tens of flops to each constraint update and linesearch point
// and, in the middle zone, an S x S block to the Hessian, built on the
// fly from the contact's rows (S <= 6) rather than stored.

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

__global__ void glue_kernel(const Params p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.nworld) return;
  glue_world<false>(p, ConeIn{}, w);
}

__global__ void glue_ell_kernel(const EllParams p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.base.nworld) return;
  glue_world<true>(p.base, world_cone(p, w), w);
}

PORT_C_INTERFACE(Params, glue_kernel, 32)
PORT_C_ENTRY(ell_, EllParams, glue_ell_kernel, 32, base.nworld)
