// Kernels B7, B8, B5 and B6: the batched linear solves of the unfused
// step; B7 and B8 one block per world, B5 and B6 one warp per world. B7
// and B5 factor and solve; B8 and B6 solve
// from the factor B7 or B5 wrote, with the same device code for the
// sweeps (tree_sweeps, chol_sweeps), so a solve from a factor repeats the
// factoring kernel's own solve operation for operation.
//
// B7 tree_ldl: the tree-sparse LDL factor of qM (+ an optional diagonal)
// and the solve (qM + diag) x = b.
//   Replaces: mujoco_warp_tpu/pallas/batch_linalg.py,
//   tree_ldl_solve_batched (:314; bodies ldl_factor_rows :257 and
//   ldl_solve_rows :276). Plain version:
//   mujoco_warp_tpu_torch/batch_linalg.py, tree_ldl_solve_batched().
//   The TPU kernel unrolls the (row, ancestor) schedule at trace time;
//   this one reads it from tables at run time, so one build serves every
//   tree. A world's nonzeros (row k: qM[k, k], then qM[k, i] for the
//   ancestors i of k from the parent up) sit packed in shared memory: 729
//   floats for three_humanoids (nv 81), not the dense 6,561. The rows
//   factor in reverse dof order; one row's updates of its ancestors' rows
//   are independent and run across the block's threads, with one barrier
//   per row. The packed factor LD, when asked for, is written dense:
//   L[k, i] at the ancestor columns, D[k] on the diagonal and zeros
//   everywhere else (the TPU kernel leaves garbage in the strict upper
//   triangle).
//
// B8 tree_solve: x from the packed factor LD that B7 wrote.
//   Replaces: mujoco_warp_tpu/pallas/batch_linalg.py,
//   tree_solve_from_factor_batched (:369; body ldl_solve_rows :276).
//   Plain version: mujoco_warp_tpu_torch/batch_linalg.py,
//   tree_solve_from_factor_batched(). It gathers only the packed entries
//   of a world's LD (729 of the dense 6,561 at nv 81) into shared memory
//   through B7's tables and runs B7's three sweeps.
//
// B5 spd_solve: the dense Cholesky factor of an SPD matrix (n <= 96) and
// the solve, one warp per world, SPD_WARPS worlds a block.
//   Replaces: mujoco_warp_tpu/pallas/batch_linalg.py, spd_solve_batched
//   (:103; body _cholesky_solve_body :62). Plain version:
//   mujoco_warp_tpu_torch/batch_linalg.py, spd_solve_batched().
//   A world's factor sits in shared memory by columns, packed: column k
//   holds rows k .. n - 1, at a word offset that is a multiple of 4
//   (spd_col_next), so that 8 consecutive rows of a column are two
//   aligned float4 and a column read by consecutive lanes hits distinct
//   banks: 3,452 words (13.8 KB) a world at n 81, 16 worlds a SM; 1,712
//   B at n 27. Column j of the factor starts from row j of the input (its
//   upper triangle, the TPU kernel's read; cp.async copies it in, 4 bytes
//   a lane). The factor is left-looking, SPD_COLS = 8 columns at a time
//   (warp_cholesky): lane l holds rows j0 + l, j0 + l + 32, j0 + l + 64 of
//   the block's columns j0 .. j0 + 7 in registers and subtracts L[i, k]
//   L[j0 + t, k] for k = 0 .. j0 - 1 (a float4 pair broadcasts L[j0 ..
//   j0 + 7, k]), then the products within the block, L[j0 + t, k] from
//   lane t by a shuffle, and each column's pivot rsqrt(max(s, kMinVal)),
//   lane t's s by a shuffle. Every entry loses the same products in the
//   same order (k ascending) as in the TPU kernel's right-looking factor;
//   a __syncwarp after each block of columns. Then the forward and
//   backward substitutions by columns in the warp (chol_sweeps): the
//   solution's entries in registers, entry k's value broadcast by a
//   shuffle at step k.
//
// B6 cho_solve: x from the lower Cholesky factor L that B5 wrote
// (n <= 96), one warp per world, SPD_WARPS worlds a block.
//   Replaces: mujoco_warp_tpu/pallas/batch_linalg.py, cho_solve_batched
//   (:177; body _solve_from_factor_body :153). Plain version:
//   mujoco_warp_tpu_torch/batch_linalg.py, cho_solve_batched(). L's lower
//   triangle is copied into B5's layout and B5's chol_sweeps run on it:
//   y[j] loses L[j, k] y[k] for k = 0 .. j - 1 in that order, which is
//   the order of the TPU kernel's row-oriented forward sweep, and the
//   backward sweep is its saxpy with row k of L; so B6's x is B5's for
//   the same b, bit for bit.
//
// What bounds them on the H100: bytes for B7, B8 and B6; for B5, its
// chains and the shared memory's rate. Per world B7 reads qM (26 KB at
// nv 81) and writes x and, with the factor, LD (26 KB); B5 reads the
// Hessian's upper triangle (13 KB) and writes x; B8 gathers the 729
// packed entries of LD (by 32-byte sectors that is most of the matrix)
// and B6 reads L (2.9 KB at n 27), and both write x alone. B7 does about
// 2,200 flops a world, B8 and B6 about 2 per factor entry; B5 n^3/3 =
// 177k at n 81, each multiply-add with a 4-byte shared-memory read of
// its lane's row, and per k and block of columns a broadcast of 8
// values: where a block's rows fit one pass of the warp (the last 32
// rows), that is about a shared-memory wavefront per multiply-add. The
// substitutions are 2n dependent steps (a shuffle and a division each).
// B7 and B8 run one block per world with chains of barriers (B7 one per
// dof, the sweeps one per row); a warp per world is later work.

#include "common.cuh"

#define SPD_MAXN 96
#define TREE_LDL_THREADS 32
#define SPD_WARPS 4      // worlds a block of B5 and B6
#define SPD_COLS 8       // columns B5 factors together

struct TreeLdlParams {
  const float* a;            // (nworld, nv, nv)
  const float* b;            // (nworld, nv)
  const float* diag;         // (nv) or null
  const int* chain;          // (nnz): row k's dofs, k first, then ancestors
  const int* row_of;         // (nnz): the row of each packed entry
  const int* row_start;      // (nv + 1): row k is [row_start[k], [k + 1])
  const int* depth;          // (nv): number of strict ancestors
  const unsigned char* anc;  // (nv, nv): column j is k or an ancestor of k
  float* x;                  // (nworld, nv)
  float* ld;                 // (nworld, nv, nv) or null
  int nworld;
  int nv;
  int nnz;
};

struct TreeSolveParams {
  const float* ld;           // (nworld, nv, nv), packed entries read
  const float* b;            // (nworld, nv)
  const int* chain;          // B7's tables
  const int* row_of;
  const int* row_start;
  float* x;                  // (nworld, nv)
  int nworld;
  int nv;
  int nnz;
};

struct SpdParams {
  const float* a;            // (nworld, n, n)
  const float* b;            // (nworld, n)
  float* x;                  // (nworld, n)
  float* l;                  // (nworld, n, n) or null
  int nworld;
  int n;
};

struct ChoSolveParams {
  const float* l;            // (nworld, n, n) lower factor
  const float* b;            // (nworld, n)
  float* x;                  // (nworld, n)
  int nworld;
  int n;
};

// The solve from a world's packed rows P (ldl_solve_rows): L^T z = b,
// y = z / D, L x = y, in place on x; P and x in shared memory. p is B7's
// or B8's Params (chain, row_start, nv).
template <class T>
DEV void tree_sweeps(const T& p, const float* P, float* x, int tid, int nt) {
  const int nv = p.nv;
  // L^T z = b, rows in reverse order
  for (int k = nv - 1; k >= 0; --k) {
    const int s = p.row_start[k], len = p.row_start[k + 1] - s;
    if (len == 1) continue;
    const float xk = x[k];
    for (int ia = 1 + tid; ia < len; ia += nt)
      x[p.chain[s + ia]] -= P[s + ia] * xk;
    __syncthreads();
  }
  // y = z / D
  for (int k = tid; k < nv; k += nt)
    x[k] = x[k] / fmaxf(P[p.row_start[k]], kMinVal);
  __syncthreads();
  // L x = y, rows in order: each row's sum over its short chain, in the
  // TPU kernel's order, by one thread
  if (tid == 0) {
    for (int k = 0; k < nv; ++k) {
      const int s = p.row_start[k], len = p.row_start[k + 1] - s;
      float v = x[k];
      for (int ia = 1; ia < len; ++ia) v -= P[s + ia] * x[p.chain[s + ia]];
      x[k] = v;
    }
  }
  __syncthreads();
}

// B5's and B6's layout of a factor in shared memory: column k holds rows
// k .. n - 1 at words cb(k) + k .. cb(k) + n - 1 with cb(0) = 0 and
// cb(k + 1) = spd_col_next(cb(k), k, n), the least multiple of 4 past
// column k's last row; 8 words of padding follow column n - 1, which
// B5's broadcast of the rows j0 .. j0 + 7 of a column may read past n.
__host__ __device__ inline int spd_col_next(int cb, int k, int n) {
  return (cb + n - k - 1 + 3) & ~3;
}

// words of a world's factor (a multiple of 4, so each world's starts
// 16-byte aligned)
__host__ __device__ inline int spd_words(int n) {
  int cb = 0;
  for (int k = 0; k + 1 < n; ++k) cb = spd_col_next(cb, k, n);
  return (cb + n + 8 + 3) & ~3;
}

// dynamic shared bytes a world of B5 or B6; past SPD_MAXN more than a
// block may have, which refuses the launch
inline int spd_world_bytes(int n) {
  return n > SPD_MAXN ? (1 << 30) : spd_words(n) * (int)sizeof(float);
}

// cb(i) of the columns i = lane, lane + 32, lane + 64 (0 past n)
DEV void spd_lane_columns(int n, int lane, int (&cbi)[3]) {
  cbi[0] = cbi[1] = cbi[2] = 0;
  int cb = 0;
  for (int k = 0; k < n; ++k) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (k == lane + 32 * q) cbi[q] = cb;
    cb = spd_col_next(cb, k, n);
  }
}

// The lower Cholesky factor, in place, of the matrix whose upper triangle
// S holds by columns (S[cb(k) + i] = a[k, i] for i >= k): column j of
// the factor starts from row j of a, its pivot is rsqrt(max(s_jj,
// kMinVal)) and every entry loses L[i, k] L[j, k] for k = 0 .. j - 1 in
// that order. Columns j0 .. j0 + SPD_COLS - 1 at a time; lane l owns
// rows i = j0 + l + 32 q of them.
DEV void warp_cholesky(float* S, int n, int lane) {
  int cb0 = 0;                         // cb(j0)
  for (int j0 = 0; j0 < n; j0 += SPD_COLS) {
    const int nc = min(SPD_COLS, n - j0), np = (n - j0 + 31) >> 5;
    int cbt[SPD_COLS + 1];
    cbt[0] = cb0;
#pragma unroll
    for (int t = 0; t < SPD_COLS; ++t)
      cbt[t + 1] = spd_col_next(cbt[t], j0 + t, n);
    float acc[3][SPD_COLS];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int i = j0 + lane + 32 * q;
#pragma unroll
      for (int t = 0; t < SPD_COLS; ++t)
        acc[q][t] = t < nc && i >= j0 + t && i < n
                        ? S[cbt[t] + i] : 0.0f;
    }
    // the columns left of the block, k = 0 .. j0 - 1 in order
    int cbk = 0;
#pragma unroll 2
    for (int k = 0; k < j0; ++k) {
      const float4 c0 = *reinterpret_cast<const float4*>(S + cbk + j0);
      const float4 c1 = *reinterpret_cast<const float4*>(S + cbk + j0 + 4);
      const float c[SPD_COLS] = {c0.x, c0.y, c0.z, c0.w,
                                 c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (q < np) {
          const int i = j0 + lane + 32 * q;
          const float l = i < n ? S[cbk + i] : 0.0f;
#pragma unroll
          for (int t = 0; t < SPD_COLS; ++t) acc[q][t] -= l * c[t];
        }
      }
      cbk = spd_col_next(cbk, k, n);
    }
    // the block's own columns: L[j0 + t, j0 + u] from lane t
    float lv[3][SPD_COLS];
#pragma unroll
    for (int t = 0; t < SPD_COLS; ++t) {
      if (t < nc) {
#pragma unroll
        for (int u = 0; u < t; ++u) {
          const float cu = __shfl_sync(FULL_MASK, lv[0][u], t);
#pragma unroll
          for (int q = 0; q < 3; ++q)
            acc[q][t] -= lv[q][u] * cu;
        }
        const float s = __shfl_sync(FULL_MASK, acc[0][t], t);
        const float inv = rsqrtf(fmaxf(s, kMinVal));
#pragma unroll
        for (int q = 0; q < 3; ++q) lv[q][t] = acc[q][t] * inv;
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int i = j0 + lane + 32 * q;
#pragma unroll
      for (int t = 0; t < SPD_COLS; ++t)
        if (t < nc && i >= j0 + t && i < n)
          S[cbt[t] + i] = lv[q][t];
    }
    __syncwarp();
    cb0 = cbt[SPD_COLS];
  }
}

// The solve from a lower factor in B5's layout S, in the warp: y holds
// the right-hand side's entries i = lane + 32 q and leaves with x's;
// cbi from spd_lane_columns. L y = b by columns: step k divides y[k] by
// L[k, k] and subtracts L[i, k] y[k] from the rows below; then L^T x = y
// by columns from the last: x[k] = y[k] / L[k, k] leaves L[k, i] x[k]
// in the rows above. Entry k reaches every lane by a shuffle.
DEV void chol_sweeps(const float* S, int n, const int (&cbi)[3],
                     float (&y)[3], int lane) {
  int cbk = 0;
  for (int k = 0; k < n; ++k) {
    const int qk = k >> 5;
    const float v = qk == 0 ? y[0] : (qk == 1 ? y[1] : y[2]);
    const float yk = __shfl_sync(FULL_MASK, v, k & 31) / S[cbk + k];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int i = lane + 32 * q;
      if (i > k && i < n) y[q] -= S[cbk + i] * yk;
      if (i == k) y[q] = yk;
    }
    cbk = spd_col_next(cbk, k, n);
  }
  for (int k = n - 1; k >= 0; --k) {
    const int qk = k >> 5;
    const float v = qk == 0 ? y[0] : (qk == 1 ? y[1] : y[2]);
    const int c = qk == 0 ? cbi[0] : (qk == 1 ? cbi[1] : cbi[2]);
    const float xk = __shfl_sync(FULL_MASK, v, k & 31) /
                     S[__shfl_sync(FULL_MASK, c, k & 31) + k];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int i = lane + 32 * q;
      if (i < k) y[q] -= S[cbi[q] + k] * xk;
      if (i == k) y[q] = xk;
    }
  }
}

__global__ void tree_ldl_kernel(const TreeLdlParams p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nv = p.nv, nnz = p.nnz;
  const size_t w = blockIdx.x;
  float* P = smem;           // packed rows
  float* x = smem + nnz;     // right-hand side, then the solution
  const float* a = p.a + w * nv * nv;
  for (int t = tid; t < nnz; t += nt) {
    const int k = p.row_of[t], j = p.chain[t];
    float v = a[k * nv + j];
    if (p.diag && j == k) v += p.diag[k];
    P[t] = v;
  }
  for (int k = tid; k < nv; k += nt) x[k] = p.b[w * nv + k];
  __syncthreads();

  // factor, rows in reverse order (ldl_factor_rows): for each ancestor i
  // of k, row i -= (qM[k, i] / D[k]) row k over i's own chain
  for (int k = nv - 1; k >= 0; --k) {
    const int s = p.row_start[k], len = p.row_start[k + 1] - s;
    if (len == 1) continue;
    const float inv = 1.0f / fmaxf(P[s], kMinVal);
    for (int ia = 1; ia < len; ++ia) {
      const int si = p.row_start[p.chain[s + ia]];
      const float c = P[s + ia] * inv;
      for (int jb = ia + tid; jb < len; jb += nt)
        P[si + jb - ia] -= c * P[s + jb];
    }
    __syncthreads();
    // row k is final now; no later row reads or writes it
    for (int ia = 1 + tid; ia < len; ia += nt) P[s + ia] *= inv;
  }
  __syncthreads();

  tree_sweeps(p, P, x, tid, nt);
  for (int k = tid; k < nv; k += nt) p.x[w * nv + k] = x[k];
  if (p.ld) {
    float* ld = p.ld + w * nv * nv;
    for (int e = tid; e < nv * nv; e += nt) {
      const int k = e / nv, j = e - k * nv;
      ld[e] = p.anc[e] ? P[p.row_start[k] + p.depth[k] - p.depth[j]] : 0.0f;
    }
  }
}

__global__ void tree_solve_kernel(const TreeSolveParams p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nv = p.nv, nnz = p.nnz;
  const size_t w = blockIdx.x;
  float* P = smem;           // packed rows of LD
  float* x = smem + nnz;     // right-hand side, then the solution
  const float* ld = p.ld + w * nv * nv;
  for (int t = tid; t < nnz; t += nt)
    P[t] = ld[p.row_of[t] * nv + p.chain[t]];
  for (int k = tid; k < nv; k += nt) x[k] = p.b[w * nv + k];
  __syncthreads();
  tree_sweeps(p, P, x, tid, nt);
  for (int k = tid; k < nv; k += nt) p.x[w * nv + k] = x[k];
}

__global__ void __launch_bounds__(32 * SPD_WARPS, 4)
    spd_solve_kernel(const SpdParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, n = p.n;
  const size_t w = (size_t)blockIdx.x * SPD_WARPS + (threadIdx.x >> 5);
  if (w >= (size_t)p.nworld) return;
  float* S = smem + (threadIdx.x >> 5) * spd_words(n);
  // row k of a from column k on becomes column k of S
  const float* a = p.a + w * n * n;
  int cb = 0;
  for (int k = 0; k < n; ++k) {
    for (int i = k + lane; i < n; i += 32) copy4_async(S + cb + i,
                                                       a + k * n + i);
    cb = spd_col_next(cb, k, n);
  }
  float y[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int i = lane + 32 * q;
    y[q] = i < n ? p.b[w * n + i] : 0.0f;
  }
  copy_async_wait();
  __syncwarp();
  warp_cholesky(S, n, lane);
  int cbi[3];
  spd_lane_columns(n, lane, cbi);
  chol_sweeps(S, n, cbi, y, lane);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int i = lane + 32 * q;
    if (i < n) p.x[w * n + i] = y[q];
  }
  if (p.l) {
    float* l = p.l + w * n * n;
    for (int r = 0; r < n; ++r) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int c = lane + 32 * q;
        if (c < n) l[r * n + c] = c <= r ? S[cbi[q] + r] : 0.0f;
      }
    }
  }
}

__global__ void __launch_bounds__(32 * SPD_WARPS, 4)
    cho_solve_kernel(const ChoSolveParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, n = p.n;
  const size_t w = (size_t)blockIdx.x * SPD_WARPS + (threadIdx.x >> 5);
  if (w >= (size_t)p.nworld) return;
  float* S = smem + (threadIdx.x >> 5) * spd_words(n);
  int cbi[3];
  spd_lane_columns(n, lane, cbi);
  // L's lower triangle into B5's layout, row r of L by the lanes
  const float* l = p.l + w * n * n;
  for (int r = 0; r < n; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int c = lane + 32 * q;
      if (c <= r) copy4_async(S + cbi[q] + r, l + r * n + c);
    }
  }
  float y[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int i = lane + 32 * q;
    y[q] = i < n ? p.b[w * n + i] : 0.0f;
  }
  copy_async_wait();
  __syncwarp();
  chol_sweeps(S, n, cbi, y, lane);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int i = lane + 32 * q;
    if (i < n) p.x[w * n + i] = y[q];
  }
}

PORT_C_ERROR_STRING

extern "C" int tree_ldl_params_size() { return (int)sizeof(TreeLdlParams); }

extern "C" int tree_ldl_launch(const TreeLdlParams* p, void* stream) {
  if (p->nworld <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(p->nnz + p->nv) * sizeof(float);
  PORT_LAUNCH(tree_ldl_kernel, p->nworld, TREE_LDL_THREADS, smem, stream,
              *p);
  return (int)cudaGetLastError();
}

extern "C" int tree_solve_params_size() {
  return (int)sizeof(TreeSolveParams);
}

extern "C" int tree_solve_launch(const TreeSolveParams* p, void* stream) {
  if (p->nworld <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(p->nnz + p->nv) * sizeof(float);
  PORT_LAUNCH(tree_solve_kernel, p->nworld, TREE_LDL_THREADS, smem, stream,
              *p);
  return (int)cudaGetLastError();
}

PORT_C_WARP_ENTRY(spd_solve_, SpdParams, spd_solve_kernel, SPD_WARPS,
                  spd_world_bytes(p->n))
PORT_C_WARP_ENTRY(cho_solve_, ChoSolveParams, cho_solve_kernel, SPD_WARPS,
                  spd_world_bytes(p->n))
