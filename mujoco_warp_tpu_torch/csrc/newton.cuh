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
// All four run warp_newton<ELL>(): one warp per world, lane i owning dof
// i (nv <= 32), the world's matrices and acting rows in shared memory
// (WarpMem), every sum over dofs, rows or contacts a warp reduction in a
// fixed order, so that two launches give the same bits. The elliptic
// cone (ELL: B3e, B4-elliptic) adds, behind `if constexpr`, a table of
// its contacts in shared memory and the cone's code (:139-178
// precompute, :213-245 forces, :283-346 Hessian blocks, :351-390
// linesearch terms), one lane per contact.
//
// Each warp loops until its own world converges: a converged world
// stops, as the TPU kernel freezes it with alpha = 0 (:480). The rows
// that cannot act (D = 0 and frictionloss = 0: inactive limits, empty
// contact slots) are skipped, which changes no result.
#pragma once

#include "common.cuh"

#define MAXNV 32
#define MAXNJ 256
#define MAXS 6               // rows of an elliptic contact (condim <= 6)

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

// an elliptic kernel's parameters (B3e's, B4-elliptic's): its pyramidal
// kernel's P and the contacts of the elliptic cone
template <class P>
struct ConeParams : P {
  const float* con_friction;  // (nconmax, 5)
  const int* con_dim;         // (nconmax) 0 in an empty slot
  float impratio;
  int efc_base;               // first contact row
  int stride;                 // rows per contact
  int nconmax;
};

// world w's ConeIn from a ConeParams
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

enum { kTop = 0, kBottom = 1, kMiddle = 2 };

// the zone of a contact at normal N and tangential norm T (cone_zones)
DEV int cone_zone(float N, float T, float mu) {
  if (N >= mu * T) return kTop;
  if (mu * N + T <= 0.0f) return kBottom;
  return kMiddle;
}

// ---------------------------------------------------------------------------
// The solve, one warp per world.
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
// The elliptic cone (ELL) keeps a table of the world's C contacts in
// shared memory (WarpMem's c* arrays, C x S of them sized from the
// launch's nconmax and stride S): for each contact whose normal row acts
// its rows' compacted indices (-1: a row that cannot act), scales, mu, Dm
// and the zone of the last constraint update; its rows get class 3,
// which the row passes give nothing. The cone's work then runs one lane
// per contact: the constraint update (zone, the middle zone's
// cone-surface forces and S x S Hessian coefficients, the bottom zone's
// quadratic rows), and its terms at each linesearch point, added to the
// lane's partial sums. Lane i adds each middle-zone contact's block
// J_c^T C J_c to row i of H; the relative Tikhonov floor 1e-7 tr(H) / nv
// comes from a warp sum of the diagonal.
//
// On the H100 at 8192 humanoid worlds: 16 pyramidal worlds resident per
// SM (4 blocks of 4, registers and shared memory both near their limit);
// 12 elliptic ones (ELL_BLOCKS = 3 blocks of 4: the cone's code takes
// about 152 registers a thread, its table 432 more words of shared memory
// a world; the cone's Hessian blocks go into H's rows in shared memory:
// added to the register array h they needed more registers than that
// and spilled). The time is four to five waves of the slowest world's
// dependent chain (the factor's columns, the substitutions' steps, the
// linesearch's reductions), not the bytes or the flops.

#define WARPS 4    // worlds (warps) per block
#define ELL_BLOCKS 3  // blocks resident per SM the elliptic kernels ask for
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
  float* aux;    // naux: B3's (glue_aux: the actuators' forces on their
                 //   dofs, and mode 2's integration diagonal)
  float* Jc;     // jcap x ld: efc_J of the first jcap acting rows
  float* D;      // nj each: the acting rows' state
  float* fl;
  float* rf;
  float* jaref;
  float* jv;
  float* force;
  int* idx;      // efc row
  int* cls;      // 0 equality, 1 friction, 2 one-sided, 3 elliptic cone
  int* quad;
  // the elliptic cone's contacts (C of them, S rows each; ELL only)
  int* ck;       // C x S: the acting-row index of each row, or -1
  float* cs;     // C x S: the rows' scales
  float* cmu;    // C
  float* cdm;    // C
  int* cz;       // C: -1 (not a cone contact) or the last update's zone
  float* cc;     // C x S x S: the middle zone's Hessian coefficients
};

// floats (and ints) of one world's WarpMem; C contacts of S rows for the
// elliptic cone (0 without it)
__host__ __device__ inline int warp_mem_words(int nv, int naux, int nj,
                                              int C = 0, int S = 0) {
  const int ld = nv | 1;
  return 2 * nv * ld + 64 + naux + (nj < JCAP ? nj : JCAP) * ld + 9 * nj +
         C * (3 + 2 * S + S * S);
}

DEV WarpMem warp_mem(float* base, int nv, int naux, int nj, int C = 0,
                     int S = 0) {
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
  s.quad = (int*)p; p += nj;
  s.ck = (int*)p; p += C * S;
  s.cs = p; p += C * S;
  s.cmu = p; p += C;
  s.cdm = p; p += C;
  s.cz = (int*)p; p += C;
  s.cc = p;
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

// The whole solve of one world in its warp for the lane's qfrc_smooth qfs
// (0 past nv), with the elliptic cone of the contacts ci (ELL; unread
// otherwise). Writes every output of s; returns the lane's qacc_euler,
// for the caller's advance.
template <bool ELL>
DEV float warp_newton(const Solve& p, const ConeIn& ci, const WarpMem& sm,
                      float qfs, int lane) {
  const int nv = p.nv, nj = p.nj, ld = nv | 1;
  const bool own = lane < nv;
  const int S = ci.S;

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

  // ---- the elliptic contacts whose normal row acts (:139-178), one lane
  // per contact: scales s (row 0: mu = friction[0] / sqrt(impratio); row
  // r >= 1: friction[min(r - 1, 4)]), mu and Dm = D_0 / (mu^2 (1 +
  // mu^2)); the rows' indices follow from the compaction ----
  if constexpr (ELL) {
    for (int c = lane; c < ci.C; c += 32) {
      const float D0 = __ldg(p.D + ci.base + c * S);
      const float* fr = ci.friction + 5 * c;
      const float mu = __ldg(fr) / sqrtf(fmaxf(ci.impratio, kMinVal));
      const float mu2 = mu * mu;
      sm.cz[c] = __ldg(ci.dim + c) >= 2 && D0 != 0.0f ? kTop : -1;
      sm.cmu[c] = mu;
      sm.cdm[c] = D0 / fmaxf(mu2 * (1.0f + mu2), kMinVal);
      for (int r = 0; r < S; ++r) {
        sm.ck[c * S + r] = -1;
        sm.cs[c * S + r] = r == 0 ? mu : __ldg(fr + min(r - 1, 4));
      }
    }
    __syncwarp();
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
      if constexpr (ELL) {
        if (r >= ci.base && sm.cz[(r - ci.base) / S] >= 0) {
          sm.cls[k] = 3;
          sm.ck[r - ci.base] = k;    // contact (r - base) / S, its row
        }                            // (r - base) % S
      }
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
    if constexpr (ELL) {
      // per contact: the middle zone's cone-surface force and Hessian
      // coefficients C[r][q] Dm s_r s_q (:283-329), the bottom zone's
      // quadratic rows, nothing in the top zone (:213-245)
      for (int c = lane; c < ci.C; c += 32) {
        if (sm.cz[c] < 0) continue;
        const int* kc = sm.ck + c * S;
        const float* sc = sm.cs + c * S;
        float u[MAXS], t2 = 0.0f;
#pragma unroll
        for (int r = 0; r < MAXS; ++r) {
          if (r >= S) break;
          const int k = kc[r];
          u[r] = k >= 0 ? sm.jaref[k] * sc[r] : 0.0f;
          if (r > 0) t2 += u[r] * u[r];
        }
        const float T = sqrtf(fmaxf(t2, 0.0f)), N = u[0];
        const float mu = sm.cmu[c], dm = sm.cdm[c];
        const int z = cone_zone(N, T, mu);
        sm.cz[c] = z;
        if (z == kMiddle) {
          const float nmt = N - mu * T;
          const float f_norm = -dm * nmt * mu;
          const float t_safe = fmaxf(T, kMinVal);
          const float t3 = fmaxf(T * t_safe * t_safe, kMinVal);
          const float mu_over_t = mu / t_safe, mnt3 = mu * N / t3;
          const float diag_add = mu * mu - mu * N / t_safe;
          float* cc = sm.cc + c * S * S;
#pragma unroll
          for (int r = 0; r < MAXS; ++r) {
            if (r >= S) break;
            const int k = kc[r];
            if (k >= 0)
              sm.force[k] = r == 0 ? f_norm
                                   : -(f_norm / t_safe) * (u[r] * sc[r]);
#pragma unroll
            for (int q = 0; q < MAXS; ++q) {
              if (q >= S) break;
              float hc;
              if (r == 0 && q == 0) hc = 1.0f;
              else if (r == 0) hc = -mu_over_t * u[q];
              else if (q == 0) hc = -mu_over_t * u[r];
              else hc = mnt3 * u[r] * u[q] + (r == q ? diag_add : 0.0f);
              cc[r * S + q] = hc * (dm * sc[r] * sc[q]);
            }
          }
          cost += 0.5f * dm * nmt * nmt;
        } else if (z == kBottom) {
          for (int r = 0; r < S; ++r) {
            const int k = kc[r];
            if (k < 0) continue;
            const float x = sm.jaref[k];
            sm.force[k] = -sm.D[k] * x;
            sm.quad[k] = 1;
            cost += 0.5f * sm.D[k] * x * x;
          }
        }
      }
      __syncwarp();
    }
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
      if constexpr (ELL) {
        // each middle-zone contact's block J_c^T C J_c, added to the row
        // in shared memory (h is dead here): row i gains sum_q (sum_r
        // J_r[i] C[r][q]) J_q
        for (int c = 0; c < ci.C; ++c) {
          if (sm.cz[c] != kMiddle) continue;
          const int* kc = sm.ck + c * S;
          const float* cc = sm.cc + c * S * S;
          float ji[MAXS];
#pragma unroll
          for (int r = 0; r < MAXS; ++r) {
            const int kr = r < S ? kc[r] : -1;
            ji[r] = kr < 0 ? 0.0f : kr < nc ? sm.Jc[kr * ld + lane]
                                            : __ldg(jrow(kr) + lane);
          }
          for (int q = 0; q < S; ++q) {
            const int kq = kc[q];
            if (kq < 0) continue;
            float a = 0.0f;
#pragma unroll
            for (int r = 0; r < MAXS; ++r)
              if (r < S) a += ji[r] * cc[r * S + q];
            const float* Jq = kq < nc ? sm.Jc + kq * ld : jrow(kq);
            for (int j = 0; j < nv; ++j) Hi[j] += a * Jq[j];
          }
        }
      }
    }
    __syncwarp();
    if constexpr (ELL) {
      // the relative Tikhonov floor 1e-7 tr(H) / nv (:330-343)
      const float tr = warp_sum(own ? sm.L[lane * ld + lane] * (1.0f / nv)
                                    : 0.0f);
      if (own) sm.L[lane * ld + lane] += 1e-7f * tr;
      __syncwarp();
    }
    return warp_factor_solve(sm, nv, ld, grad, lane);
  };
  // contact c's share of the cost's first (returned) and second
  // derivative along the search direction at alpha (ELL, :351-390)
  auto cone_line = [&](int c, float alpha, float* d2) {
    const int* kc = sm.ck + c * S;
    const float* sc = sm.cs + c * S;
    float xb[MAXS], jvb[MAXS], ub[MAXS], v[MAXS];
    float t2 = 0.0f, uv = 0.0f, vfr2 = 0.0f;
#pragma unroll
    for (int r = 0; r < MAXS; ++r) {
      if (r >= S) break;
      const int k = kc[r];
      jvb[r] = k >= 0 ? sm.jv[k] : 0.0f;
      xb[r] = k >= 0 ? sm.jaref[k] + alpha * jvb[r] : 0.0f;
      ub[r] = xb[r] * sc[r];
      v[r] = jvb[r] * sc[r];
      if (r > 0) {
        t2 += ub[r] * ub[r];
        uv += ub[r] * v[r];
        vfr2 += v[r] * v[r];
      }
    }
    const float mu = sm.cmu[c], dm = sm.cdm[c], N = ub[0];
    const float T = sqrtf(fmaxf(t2, kMinVal));
    const int z = cone_zone(N, T, mu);
    float d1 = 0.0f;
    *d2 = 0.0f;
    if (z == kMiddle) {
      const float t1 = uv / T, tt2 = (vfr2 - t1 * t1) / T;
      const float nmt = N - mu * T, n1mt1 = v[0] - mu * t1;
      d1 = dm * nmt * n1mt1;
      *d2 = dm * (n1mt1 * n1mt1 - nmt * mu * tt2);
    } else if (z == kBottom) {
#pragma unroll
      for (int r = 0; r < MAXS; ++r) {
        if (r >= S) break;
        const int k = kc[r];
        if (k < 0) continue;
        d1 += sm.D[k] * xb[r] * jvb[r];
        *d2 += sm.D[k] * jvb[r] * jvb[r];
      }
    }
    return d1;
  };
  // the lane's rows' (and contacts') share of the cost's first (returned)
  // and second derivative along the search direction at alpha
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
    if constexpr (ELL) {
      for (int c = lane; c < ci.C; c += 32) {
        if (sm.cz[c] < 0) continue;
        float c2;
        s1 += cone_line(c, alpha, &c2);
        *s2 += c2;
      }
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
  // Newton / bisection steps (_newton_core :398-444)
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
    if constexpr (ELL) {
      for (int c = lane; c < ci.C; c += 32) {
        if (sm.cz[c] < 0) continue;
#pragma unroll
        for (int s = 0; s < MAXLSK; ++s) {
          if (s >= p.ls_k) break;
          float c2;
          s1[s] += cone_line(c, a[s], &c2);
          if (s == p.ls_k - 1) s2m += c2;
        }
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
