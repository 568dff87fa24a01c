// Kernels B4 and B4-elliptic: the Newton solve of forward_batched — the
// Cholesky factor of qM and qacc_smooth, the whole Newton solve from a
// given qfrc_smooth, the forces and, with euler_damp, the re-solve
// (qM + diag(hb)) qacc_euler = qfrc_smooth + qfrc_constraint. Both run
// one warp per world: B4 (newton_kernel) solves with the pyramidal cone,
// B4-elliptic (newton_ell_kernel) with the elliptic cone of the contacts'
// friction and dim. They are kernels B3 and B3e (glue.cu) without the
// assembly of qfrc_smooth before the solve and without the advance after
// it: both run warp_newton<ELL>() of newton.cuh as B3 and B3e do, so each
// gives its glue kernel's bits on the same qfrc_smooth.
//
// Replaces: mujoco_warp_tpu/pallas/solver_kernels.py,
// newton_solve_batched (:534; bodies _newton_kernel :72 and
// _newton_ell_kernel :88, the ell branch :593-599, the solve
// _newton_core :103). Plain version: mujoco_warp_tpu_torch/solver.py,
// newton_solve() (which is newton()).
//
// What bounds it on the H100: as B3, the solve's dependent arithmetic,
// not the bytes (qM and the acting rows of efc_J once per world). What
// the design does about it: what B3's does (glue.cu, newton.cuh).

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

using EllParams = ConeParams<Params>;   // B4-elliptic's

// the world of the block's warp; with the elliptic cone (ELL) P is
// EllParams
template <bool ELL, class P>
DEV void newton_block(const P& p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int w = blockIdx.x * WARPS + wb;
  if (w >= p.nworld) return;
  ConeIn ci{};
  if constexpr (ELL) ci = world_cone(p, w);
  const int words = warp_mem_words(p.nv, 0, p.nj, ci.C, ci.S);
  const WarpMem sm = warp_mem(smem + wb * words, p.nv, 0, p.nj, ci.C, ci.S);
  const float qfs = lane < p.nv ? p.qfrc_smooth[(size_t)w * p.nv + lane]
                                : 0.0f;
  Solve s = world_solve(p, w);
  if (p.euler_damp) s.hdiag = p.hb;
  warp_newton<ELL>(s, ci, sm, qfs, lane);
}

__global__ void __launch_bounds__(WARPS * 32, 16 / WARPS)
newton_kernel(const Params p) {
  newton_block<false>(p);
}

__global__ void __launch_bounds__(WARPS * 32, ELL_BLOCKS)
newton_ell_kernel(const EllParams p) {
  newton_block<true>(p);
}

PORT_C_WARP_INTERFACE(Params, newton_kernel, WARPS,
                      4 * warp_mem_words(p->nv, 0, p->nj))
PORT_C_WARP_ENTRY(ell_, EllParams, newton_ell_kernel, WARPS,
                  4 * warp_mem_words(p->nv, 0, p->nj, p->nconmax, p->stride))
