// Kernels B7, B8, B5 and B6: the batched linear solves of the unfused
// step, one block per world. B7 and B5 factor and solve; B8 and B6 solve
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
// the solve.
//   Replaces: mujoco_warp_tpu/pallas/batch_linalg.py, spd_solve_batched
//   (:103; body _cholesky_solve_body :62). Plain version:
//   mujoco_warp_tpu_torch/batch_linalg.py, spd_solve_batched().
//   The matrix sits in shared memory (row stride n | 1, so a column read
//   by consecutive threads hits distinct banks). Column j of the factor
//   starts from row j of the input, as the TPU kernel reads it; the
//   factor is right-looking, which subtracts the same products in the
//   same order as the TPU kernel's column loop. Then the forward and
//   backward substitutions by columns, one barrier per column.
//
// B6 cho_solve: x from the lower Cholesky factor L that B5 wrote
// (n <= 96).
//   Replaces: mujoco_warp_tpu/pallas/batch_linalg.py, cho_solve_batched
//   (:177; body _solve_from_factor_body :153). Plain version:
//   mujoco_warp_tpu_torch/batch_linalg.py, cho_solve_batched(). L sits in
//   shared memory (2.9 KB at n 27, 36 KB at the cap) and B5's two sweeps
//   run on it: y[j] loses L[j, k] y[k] for k = 0 .. j - 1 in that order,
//   which is the order of the TPU kernel's row-oriented forward sweep,
//   and the backward sweep is its saxpy with row k of L.
//
// What bounds them on the H100: bytes. Per world B7 reads qM (26 KB at
// nv 81) and writes x and, with the factor, LD (26 KB); B5 reads the
// Hessian (26 KB) and writes x; B8 gathers the 729 packed entries of LD
// (by 32-byte sectors that is most of the matrix) and B6 reads L (2.9 KB
// at n 27), and both write x alone. The arithmetic is small: B7 about
// 2,200 flops a world, B5 about n^3/3 = 177k, B8 and B6 about 2 flops per
// factor entry. What this first cut does about it: the reads of a world's
// matrix are row-contiguous and the writes of LD coalesced, but the
// factorizations and sweeps are latency-bound chains of barriers (B7 one
// per dof, B5 four per column, the sweeps one per row or column) with
// few threads busy; several worlds per block, or a warp per world, is
// later work.

#include "common.cuh"

#define SPD_MAXN 96
#define TREE_LDL_THREADS 32
#define SPD_THREADS 128
#define CHO_SOLVE_THREADS 32

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

// The solve from a lower Cholesky factor A (A[i * ld + j] = L[i, j],
// j <= i) with right-hand side y, both in shared memory; x to xout (n,
// global). Forward and backward substitution by columns, one barrier per
// column.
DEV void chol_sweeps(const float* A, int ld, float* y, int n, float* xout,
                     int tid, int nt) {
  // L y = b by columns: column k subtracts y[k] / L[k, k] below k
  for (int k = 0; k < n; ++k) {
    const float yk = y[k] / A[k * ld + k];
    for (int i = k + 1 + tid; i < n; i += nt) y[i] -= A[i * ld + k] * yk;
    __syncthreads();
    if (tid == 0) y[k] = yk;  // read again only by the backward pass
  }
  __syncthreads();
  // L^T x = y by columns: x[k] = y[k] / L[k, k] leaves row k's rest
  for (int k = n - 1; k >= 0; --k) {
    const float xk = y[k] / A[k * ld + k];
    for (int i = tid; i < k; i += nt) y[i] -= A[k * ld + i] * xk;
    __syncthreads();
    if (tid == 0) xout[k] = xk;
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

__global__ void spd_solve_kernel(const SpdParams p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = p.n, ld = n | 1;
  const size_t w = blockIdx.x;
  float* A = smem;           // A[i * ld + j], column j of the factor
  float* y = smem + n * ld;  // forward substitution
  const float* a = p.a + w * n * n;
  // row j of a becomes column j: A[c][r] = a[r][c]
  for (int e = tid; e < n * n; e += nt) {
    const int r = e / n, c = e - r * n;
    A[c * ld + r] = a[e];
  }
  for (int i = tid; i < n; i += nt) y[i] = p.b[w * n + i];
  const int nx = nt < 32 ? nt : 32, ny = nt / nx;
  const int tx = tid % nx, ty = tid / nx;

  for (int j = 0; j < n; ++j) {
    __syncthreads();         // the trailing update of column j - 1 is done
    const float sjj = A[j * ld + j];
    const float inv = rsqrtf(fmaxf(sjj, kMinVal));
    for (int i = j + 1 + tid; i < n; i += nt) A[i * ld + j] *= inv;
    __syncthreads();
    if (tid == 0) A[j * ld + j] = sjj * inv;
    // trailing update of the lower triangle (reads column j below j only)
    for (int r = j + 1 + ty; r < n; r += ny) {
      const float lr = A[r * ld + j];
      for (int c = j + 1 + tx; c <= r; c += nx)
        A[r * ld + c] -= lr * A[c * ld + j];
    }
  }
  __syncthreads();

  chol_sweeps(A, ld, y, n, p.x + w * n, tid, nt);
  if (p.l) {
    float* l = p.l + w * n * n;
    for (int e = tid; e < n * n; e += nt) {
      const int r = e / n, c = e - r * n;
      l[e] = c <= r ? A[r * ld + c] : 0.0f;
    }
  }
}

__global__ void cho_solve_kernel(const ChoSolveParams p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = p.n, ld = n | 1;
  const size_t w = blockIdx.x;
  float* A = smem;           // A[i * ld + j] = L[i, j]
  float* y = smem + n * ld;
  const float* l = p.l + w * n * n;
  for (int e = tid; e < n * n; e += nt) {
    const int r = e / n, c = e - r * n;
    A[r * ld + c] = l[e];
  }
  for (int i = tid; i < n; i += nt) y[i] = p.b[w * n + i];
  __syncthreads();
  chol_sweeps(A, ld, y, n, p.x + w * n, tid, nt);
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

extern "C" int spd_solve_params_size() { return (int)sizeof(SpdParams); }

extern "C" int spd_solve_launch(const SpdParams* p, void* stream) {
  if (p->nworld <= 0) return (int)cudaSuccess;
  if (p->n > SPD_MAXN) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(p->n * (p->n | 1) + p->n) * sizeof(float);
  PORT_LAUNCH(spd_solve_kernel, p->nworld, SPD_THREADS, smem, stream, *p);
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

extern "C" int cho_solve_params_size() { return (int)sizeof(ChoSolveParams); }

extern "C" int cho_solve_launch(const ChoSolveParams* p, void* stream) {
  if (p->nworld <= 0) return (int)cudaSuccess;
  if (p->n > SPD_MAXN) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(p->n * (p->n | 1) + p->n) * sizeof(float);
  PORT_LAUNCH(cho_solve_kernel, p->nworld, CHO_SOLVE_THREADS, smem, stream,
              *p);
  return (int)cudaGetLastError();
}
