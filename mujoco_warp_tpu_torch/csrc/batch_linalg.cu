// Kernels B7 and B5: the batched linear solves of the unfused step, one
// block per world.
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
// What bounds them on the H100: bytes. Per world B7 reads qM (26 KB at
// nv 81) and writes x and, with the factor, LD (26 KB); B5 reads the
// Hessian (26 KB) and writes x. The arithmetic is small: B7 about 2,200
// flops a world, B5 about n^3/3 = 177k. What this first cut does about
// it: the reads of a world's matrix are row-contiguous and the writes of
// LD coalesced, but the factorizations are latency-bound chains of
// barriers (B7 one per dof, B5 four per column) with few threads busy;
// several worlds per block, or a warp per world, is later work.

#include "common.cuh"

#define SPD_MAXN 96
#define TREE_LDL_THREADS 32
#define SPD_THREADS 128

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

struct SpdParams {
  const float* a;            // (nworld, n, n)
  const float* b;            // (nworld, n)
  float* x;                  // (nworld, n)
  float* l;                  // (nworld, n, n) or null
  int nworld;
  int n;
};

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

  // solve (ldl_solve_rows): L^T z = b, rows in reverse order
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
  for (int k = tid; k < nv; k += nt) p.x[w * nv + k] = x[k];
  if (p.ld) {
    float* ld = p.ld + w * nv * nv;
    for (int e = tid; e < nv * nv; e += nt) {
      const int k = e / nv, j = e - k * nv;
      ld[e] = p.anc[e] ? P[p.row_start[k] + p.depth[k] - p.depth[j]] : 0.0f;
    }
  }
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
    if (tid == 0) p.x[w * n + k] = xk;
  }
  if (p.l) {
    float* l = p.l + w * n * n;
    for (int e = tid; e < n * n; e += nt) {
      const int r = e / n, c = e - r * n;
      l[e] = c <= r ? A[r * ld + c] : 0.0f;
    }
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

extern "C" int spd_solve_params_size() { return (int)sizeof(SpdParams); }

extern "C" int spd_solve_launch(const SpdParams* p, void* stream) {
  if (p->nworld <= 0) return (int)cudaSuccess;
  if (p->n > SPD_MAXN) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(p->n * (p->n | 1) + p->n) * sizeof(float);
  PORT_LAUNCH(spd_solve_kernel, p->nworld, SPD_THREADS, smem, stream, *p);
  return (int)cudaGetLastError();
}
