// Kernels B3 and B3e: the back half of the step — affine actuation on
// slide/hinge joints, joint springs and dampers, qfrc_smooth, the
// Cholesky factor of qM and qacc_smooth, the whole Newton solve, the
// integration-diagonal re-solve (mode 1: Euler with implicit joint
// damping; mode 2: implicitfast, qM - h qDeriv with qDeriv diagonal, each
// world's from its ctrl, _glue_core :1146-1156) and the semi-implicit
// advance of qvel and qpos. Both run
// one warp per world (glue_warp<ELL>): B3 (glue_kernel) solves with the
// pyramidal cone, B3e (glue_ell_kernel) with the elliptic cone of the
// contacts' friction and dim.
//
// Replaces: mujoco_warp_tpu/pallas/solver_kernels.py, make_glue_kernel
// -> run (:1207; bodies _glue_kernel / _glue_ell_kernel / _glue_core
// :939 / :954 / :966, the solve _newton_core :103). Plain version:
// mujoco_warp_tpu_torch/forward.py, glue() (with solver.newton). The
// solve is warp_newton<ELL>() of newton.cuh, which kernels B4 and
// B4-elliptic (newton.cu) run too.
//
// What bounds it on the H100: the solve's dependent arithmetic, not the
// bytes. Per world it reads qM and the acting rows of efc_J (27x27 +
// about 20x27 floats on the humanoid) once; each Newton iteration then
// assembles H = qM + J^T D J over the active rows (with the elliptic
// cone, plus an S x S block per contact in the middle zone), factors it
// (about nv^3/6 = 3.3k multiply-adds) and runs a 16-point linesearch: a
// few tens of thousands of flops per iteration, most of them in
// dependent chains.
//
// What the design does about it: a warp per world puts the chains' inner
// loops across 32 lanes (a row of H, a column of the factor, a row's dot
// product, a linesearch point per partial sum; the cone's work one
// contact per lane), keeps qM, H, the acting rows, their efc_J and the
// cone's table in shared memory (about 13-15 KB a world on the humanoid;
// nothing in local memory), so that 12-16 worlds fit on an SM, and stops
// each warp at its own world's convergence (see newton.cuh). The
// actuation runs one actuator per lane, the passive forces and the
// advance one dof, then one joint, per lane.

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
                             //   af_lo af_hi hdiag (mode 1; mode 2: its
                             //   damping part)
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

using EllParams = ConeParams<Params>;   // B3e's

enum { kFree = 0, kBall = 1 };

// WarpMem's aux words a world: the actuators' forces on their dofs, and in
// mode 2 a slot of MAXNV for the world's integration diagonal, which no
// stage writes again before the re-solve reads it
__host__ __device__ inline int glue_aux(const Params& p) {
  return p.nu + (p.mode == 2 ? MAXNV : 0);
}

// world w in its warp, with the elliptic cone of the contacts ci (ELL;
// unread otherwise); sm its shared memory
template <bool ELL>
DEV void glue_warp(const Params& p, const ConeIn& ci, const WarpMem& sm,
                   int w, int lane) {
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
  float* hdiag = sm.aux + nu;    // mode 2's diagonal (glue_aux)
  if (own) {
    float qfa = 0.0f;    // the dof's actuator forces, in actuator order
    if (p.actuation_on)
      for (int u = 0; u < nu; ++u)
        if (p.act_int[2 * u + 1] == lane) qfa += sm.aux[u];
    const float* d = p.dof_float + 6 * lane;
    if (p.mode == 2) {
      // h damping - h sum gear0^2 (bias3[2] + gain3[2] ctrl) over the
      // dof's actuators in actuator order, from the raw ctrl
      float act = 0.0f;
      if (p.actuation_on)
        for (int u = 0; u < nu; ++u)
          if (p.act_int[2 * u + 1] == lane) {
            const float* a = p.act_float + 11 * u;
            act += (a[0] * a[0]) * (a[8] + a[5] * p.ctrl[(size_t)w * nu + u]);
          }
      hdiag[lane] = d[5] - h * act;
    }
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
  } else if (p.mode == 2) {
    s.hdiag = hdiag;
  }
  const float qacce = warp_newton<ELL>(s, ci, sm, qfs, lane);

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

// the world of the block's warp; with the elliptic cone (ELL) P is
// EllParams
template <bool ELL, class P>
DEV void glue_block(const P& p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int w = blockIdx.x * WARPS + wb;
  if (w >= p.nworld) return;
  ConeIn ci{};
  if constexpr (ELL) ci = world_cone(p, w);
  const int words = warp_mem_words(p.nv, glue_aux(p), p.nj, ci.C, ci.S);
  glue_warp<ELL>(p, ci, warp_mem(smem + wb * words, p.nv, glue_aux(p), p.nj,
                                 ci.C, ci.S), w, lane);
}

__global__ void __launch_bounds__(WARPS * 32, 16 / WARPS)
glue_kernel(const Params p) {
  glue_block<false>(p);
}

__global__ void __launch_bounds__(WARPS * 32, ELL_BLOCKS)
glue_ell_kernel(const EllParams p) {
  glue_block<true>(p);
}

PORT_C_WARP_INTERFACE(Params, glue_kernel, WARPS,
                      4 * warp_mem_words(p->nv, glue_aux(*p), p->nj))
PORT_C_WARP_ENTRY(ell_, EllParams, glue_ell_kernel, WARPS,
                  4 * warp_mem_words(p->nv, glue_aux(*p), p->nj, p->nconmax,
                                     p->stride))
