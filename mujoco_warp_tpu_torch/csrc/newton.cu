// Kernels B4 and B4-elliptic: the Newton solve of forward_batched — the
// Cholesky factor of qM and qacc_smooth, the whole Newton solve from a
// given qfrc_smooth, the forces and, with euler_damp, the re-solve
// (qM + diag(hb)) qacc_euler = qfrc_smooth + qfrc_constraint. B4
// (newton_kernel) solves with the pyramidal cone in one warp per world,
// B4-elliptic (newton_ell_kernel) with the elliptic cone of the contacts'
// friction and dim in one thread per world. They are kernels B3 and B3e
// (glue.cu) without the assembly of qfrc_smooth before the solve and
// without the advance after it: B4 runs warp_newton() of newton.cuh as
// B3 does, B4-elliptic newton_solve<true>() as B3e does.
//
// Replaces: mujoco_warp_tpu/pallas/solver_kernels.py,
// newton_solve_batched (:534; bodies _newton_kernel :72 and
// _newton_ell_kernel :88, the ell branch :593-599, the solve
// _newton_core :103). Plain version: mujoco_warp_tpu_torch/solver.py,
// newton_solve() (which is newton()).
//
// What bounds it on the H100: as B3, the solve's dependent arithmetic,
// not the bytes (qM and the acting rows of efc_J once per world). What
// the designs do about it: what B3's and B3e's do (glue.cu, newton.cuh).

#include "newton.cuh"

struct Params {
  const float* qM;
  const float* efc_J;
  const float* efc_D;
  const float* efc_aref;
  const float* efc_frictionloss;
  const float* qfrc_smooth;
  const float* qacc_warmstart;
  const float* hb;           // (nv) integration diagonal; read if euler_damp
  const float* ls_scales;    // (ls_k) linesearch bracket scales
  float* qacc;
  float* qfrc_constraint;
  float* efc_force;
  int* solver_niter;
  float* qacc_smooth;
  float* qLD;
  float* qacc_euler;
  float tolerance;
  float meaninertia;
  int nworld;
  int nv;
  int nj;
  int ne;
  int nf;
  int iterations;
  int ls_k;
  int ls_polish;
  int use_ws;
  int euler_damp;
};

// B4-elliptic's parameters: B4's and the contacts of the elliptic cone
struct EllParams {
  Params base;
  const float* con_friction;  // (nconmax, 5)
  const int* con_dim;         // (nconmax) 0 in an empty slot
  float impratio;
  int efc_base;               // first contact row
  int stride;                 // rows per contact
  int nconmax;
};

template <bool ELL>
DEV void newton_world(const Params& p, const ConeIn& ci, int w) {
  float qfs[MAXNV], qacce[MAXNV];
  for (int i = 0; i < p.nv; ++i)
    qfs[i] = p.qfrc_smooth[(size_t)w * p.nv + i];
  Solve s = world_solve(p, w);
  if (p.euler_damp) s.hdiag = p.hb;
  newton_solve<ELL>(s, ci, qfs, qacce);
}

__global__ void __launch_bounds__(WARPS * 32, 16 / WARPS)
newton_kernel(const Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int w = blockIdx.x * WARPS + wb;
  if (w >= p.nworld) return;
  const int words = warp_mem_words(p.nv, 0, p.nj);
  const WarpMem sm = warp_mem(smem + wb * words, p.nv, 0, p.nj);
  const float qfs = lane < p.nv ? p.qfrc_smooth[(size_t)w * p.nv + lane]
                                : 0.0f;
  Solve s = world_solve(p, w);
  if (p.euler_damp) s.hdiag = p.hb;
  warp_newton(s, sm, qfs, lane);
}

__global__ void newton_ell_kernel(const EllParams p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.base.nworld) return;
  newton_world<true>(p.base, world_cone(p, w), w);
}

PORT_C_WARP_INTERFACE(Params, newton_kernel, WARPS,
                      4 * warp_mem_words(p->nv, 0, p->nj))
PORT_C_ENTRY(ell_, EllParams, newton_ell_kernel, 32, base.nworld)
