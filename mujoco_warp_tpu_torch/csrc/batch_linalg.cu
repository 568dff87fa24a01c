// Kernels B7, B8, B5 and B6: the batched linear solves of the unfused
// step, one warp per world, TREE_WARPS or SPD_WARPS worlds a block. B7
// and B5 factor and solve; B8 and B6 solve from the factor B7 or B5
// wrote, with the same device code for the sweeps (tree_sweeps,
// chol_sweeps), so a solve from a factor repeats the factoring kernel's
// own solve operation for operation.
//
// B7 tree_ldl: the tree-sparse LDL factor of qM (+ an optional diagonal)
// and the solve (qM + diag) x = b.
//   Replaces: mujoco_warp_tpu/pallas/batch_linalg.py,
//   tree_ldl_solve_batched (:314; bodies ldl_factor_rows :257 and
//   ldl_solve_rows :276). Plain version:
//   mujoco_warp_tpu_torch/batch_linalg.py, tree_ldl_solve_batched().
//   The TPU kernel unrolls the (row, ancestor) schedule at trace time with
//   worlds in lanes; here a warp takes a world and reads the schedule from
//   tables at run time (TreeTables, built by kernels/batch_linalg.py's
//   tree_schedule), so one build serves every tree. A world's nonzeros
//   (row k: qM[k, k], then qM[k, i] for the ancestors i of k from the
//   parent up) sit packed in shared memory with x: (nnz + nv) words, 3.2
//   KB for three_humanoids (nv 81, 729 entries), not the dense 26 KB, so
//   64 worlds (warps) fit a SM. The lanes gather them with cp.async.
//   Factor (tree_factor): the rows in reverse dof order, each tree's rows
//   one step after another and the rows of different trees side by side
//   (they share no entry): 26 steps of 3 rows on three_humanoids, not 80
//   rows. In a step, lane r holds the reciprocal pivot of the step's row
//   r, and the lanes take the step's (ancestor, column) pairs one each
//   (3,510 in all): c = P[a] * inv (by a shuffle), P[dst] -= c * P[b];
//   then one __syncwarp and the row's scaling by inv. Every packed entry
//   loses its products in the order of ldl_factor_rows (descending k) and
//   in the same expressions, so the result is bit for bit the one-row-a-
//   time factor's. Sweeps (tree_sweeps): L^T z = b by the same steps, a
//   lane per off-diagonal entry and a __syncwarp a step; y = z / D by
//   lanes over rows; L x = y by depth levels (15), a lane per row of the
//   level summing its own chain in the row order of ldl_solve_rows. The
//   packed factor LD, when asked for, is written dense, each element
//   once, from the packed entry that `pos` names (zeros off the pattern,
//   where the TPU kernel leaves garbage in the strict upper triangle), by
//   16-byte stores.
//
// B8 tree_solve: x from the packed factor LD that B7 wrote.
//   Replaces: mujoco_warp_tpu/pallas/batch_linalg.py,
//   tree_solve_from_factor_batched (:369; body ldl_solve_rows :276).
//   Plain version: mujoco_warp_tpu_torch/batch_linalg.py,
//   tree_solve_from_factor_batched(). One warp per world: it gathers only
//   the packed entries of a world's LD (729 of the dense 6,561 at nv 81)
//   into shared memory through B7's tables and runs B7's tree_sweeps, so
//   its x is B7's for the same b, bit for bit.
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
// What bounds them on the H100: for B7 and B8, the SM's rate of shared-
// memory and L1 instructions and the gather's scattered reads; with the
// factor, B7's dense LD write; for B6, bytes; for B5, its chains and the
// shared memory's rate. Per world B7 gathers the 729 packed entries of qM
// (by 32-byte sectors about 6.5 KB of its 26 KB) and writes x and, with
// the factor, the dense LD (26 KB: 215 MB at 8192 worlds, 0.064 ms of the
// card's bytes); B5 reads the Hessian's upper triangle (13 KB) and writes
// x; B8 gathers LD's 729 packed entries and B6 reads L (2.9 KB at n 27),
// and both write x alone. B7 does about 10,000 flops a world, each
// multiply-add of its factor with three shared-memory reads, a write, a
// table read and a shuffle (3,510 of them in 123 warp passes at nv 81);
// B8 and B6 about 2 flops per factor entry; B5 n^3/3 = 177k at n 81, each
// multiply-add with a 4-byte shared-memory read of its lane's row, and
// per k and block of columns a broadcast of 8 values: where a block's
// rows fit one pass of the warp (the last 32 rows), that is about a
// shared-memory wavefront per multiply-add. B7 and B8 keep each world in
// one warp, 64 worlds a SM (one wave at 8192 worlds), so that the SM
// always has passes to issue between the __syncwarps of a world's 26
// factor steps and 26 + 15 sweep steps. The substitutions of B5 and B6
// are 2n dependent steps (a shuffle and a division each).

#include "common.cuh"

#define SPD_MAXN 96
#define SPD_WARPS 4      // worlds a block of B5 and B6
#define SPD_COLS 8       // columns B5 factors together
#define TREE_WARPS 4     // worlds a block of B7 and B8
// blocks of B7 and B8 a SM: 64 warps, the SM's most, so at most 32
// registers a thread
#define TREE_BLOCKS 16

// B7's and B8's schedule (kernels/batch_linalg.py, tree_schedule). A
// world's packed entry e is m[src[e]] of its (nv, nv) matrix m; row k is
// [row_start[k], row_start[k + 1]): k, then its ancestors (chain). Step t
// of the factor has the rows step_row[step_off[3 t] ..], each by its
// diagonal entry; its pairs pair[step_off[3 t + 1] ..] as (a | b << 16,
// dst | slot << 16); its rows' off-diagonal entries entry[step_off[3 t +
// 2] ..] as (e | slot << 16, i | k << 16) (entry e is L[k, i]); step t
// ends where step t + 1 begins. Depth level d holds the rows
// level_row[level_start[d] .. level_start[d + 1]), each with d ancestors.
// pos[k * nv + j] is the packed entry of (k, j), -1 off the pattern.
struct TreeTables {
  const int* src;            // (nnz)
  const int* row_start;      // (nv + 1)
  const int* chain;          // (nnz)
  const int* step_off;       // (nstep + 1, 3)
  const int* step_row;       // rows of the steps, by their diagonal entry
  const uint2* pair;         // the steps' pairs
  const uint2* entry;        // the steps' rows' off-diagonal entries
  const int* level_start;    // (nlevel + 1)
  const int* level_row;      // (nv)
  const short* pos;          // (nv * nv)
  int nv;
  int nnz;
  int nstep;
  int nlevel;
};

struct TreeLdlParams {
  TreeTables t;
  const float* a;            // (nworld, nv, nv)
  const float* b;            // (nworld, nv)
  const float* diag;         // (nv) or null
  float* x;                  // (nworld, nv)
  float* ld;                 // (nworld, nv, nv) or null
  int nworld;
};

struct TreeSolveParams {
  TreeTables t;
  const float* ld;           // (nworld, nv, nv), packed entries read
  const float* b;            // (nworld, nv)
  float* x;                  // (nworld, nv)
  int nworld;
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

// dynamic shared bytes a world of B7 or B8: its packed rows P, then x
inline int tree_world_bytes(const TreeTables& t) {
  return (t.nnz + t.nv) * (int)sizeof(float);
}

// A world's packed entries of m (qM or LD) into P and b into x, by all
// lanes at once
DEV void tree_gather(const TreeTables& t, const float* m, const float* b,
                     float* P, float* x, int lane) {
  for (int e = lane; e < t.nnz; e += 32) copy4_async(P + e, m + t.src[e]);
  for (int k = lane; k < t.nv; k += 32) copy4_async(x + k, b + k);
  copy_async_wait();
  __syncwarp();
}

// Element e of a world's dense LD: its packed entry, 0 off the pattern
DEV float tree_ld_at(const TreeTables& t, const float* P, int e) {
  const int q = t.pos[e];
  return q >= 0 ? P[q] : 0.0f;
}

// The packed factor P of a world written dense into ld (nv, nv), each
// element once: by 16-byte stores where ld is 16-byte aligned (a world's
// nv * nv floats start anywhere), 4-byte ones before and after.
DEV void tree_write_ld(const TreeTables& t, const float* P, float* ld,
                       int lane) {
  const int nn = t.nv * t.nv;
  const int head = min((int)((0 - ((size_t)ld >> 2)) & 3), nn);
  const int nvec = (nn - head) >> 2, tail = head + 4 * nvec;
  if (lane < head) ld[lane] = tree_ld_at(t, P, lane);
  float4* ld4 = reinterpret_cast<float4*>(ld + head);
  for (int i = lane; i < nvec; i += 32) {
    const int e = head + 4 * i;
    ld4[i] = make_float4(tree_ld_at(t, P, e), tree_ld_at(t, P, e + 1),
                         tree_ld_at(t, P, e + 2), tree_ld_at(t, P, e + 3));
  }
  if (tail + lane < nn) ld[tail + lane] = tree_ld_at(t, P, tail + lane);
}

// The factor of a world's packed rows P, in place (ldl_factor_rows): for
// each ancestor i of k, row i -= (qM[k, i] / D[k]) row k over i's own
// chain, rows k in reverse order; then row k's entries times 1 / D[k].
// Step by step (tree_schedule): lane r holds the reciprocal pivot of the
// step's row r; the step's pairs run across the lanes, one multiply-add
// each, then its rows' scaling. The scaling of step t writes rows that no
// later step reads or writes (a later step's rows and their ancestors
// have lower indices in each tree), so one __syncwarp a step suffices.
DEV void tree_factor(const TreeTables& t, float* P, int lane) {
  for (int st = 0; st < t.nstep; ++st) {
    const int* o = t.step_off + 3 * st;
    const int r0 = o[0], p0 = o[1], e0 = o[2], r1 = o[3], p1 = o[4],
              e1 = o[5];
    float inv = 0.0f;
    if (r0 + lane < r1)
      inv = 1.0f / fmaxf(P[t.step_row[r0 + lane]], kMinVal);
    for (int q = p0 + lane; q - lane < p1; q += 32) {
      const uint2 pr = q < p1 ? t.pair[q] : make_uint2(0u, 0u);
      const float iv = __shfl_sync(FULL_MASK, inv, (int)(pr.y >> 16));
      if (q < p1) {
        const float c = P[pr.x & 0xffffu] * iv;
        P[pr.y & 0xffffu] -= c * P[pr.x >> 16];
      }
    }
    __syncwarp();
    for (int q = e0 + lane; q - lane < e1; q += 32) {
      const uint2 en = q < e1 ? t.entry[q] : make_uint2(0u, 0u);
      const float iv = __shfl_sync(FULL_MASK, inv, (int)(en.x >> 16));
      if (q < e1) P[en.x & 0xffffu] *= iv;
    }
  }
  __syncwarp();
}

// The solve from a world's packed factor P (ldl_solve_rows): L^T z = b,
// y = z / D, L x = y, in place on x; P and x in shared memory. L^T z = b
// by the factor's steps (x[i] loses L[k, i] x[k] for the rows k of its
// subtree in descending order), a lane per entry; L x = y by depth
// levels, a lane per row, each row's chain in order.
DEV void tree_sweeps(const TreeTables& t, const float* P, float* x,
                     int lane) {
  for (int st = 0; st < t.nstep; ++st) {
    const int e1 = t.step_off[3 * st + 5];
    for (int q = t.step_off[3 * st + 2] + lane; q < e1; q += 32) {
      const uint2 en = t.entry[q];
      x[en.y & 0xffffu] -= P[en.x & 0xffffu] * x[en.y >> 16];
    }
    __syncwarp();
  }
  for (int k = lane; k < t.nv; k += 32)
    x[k] = x[k] / fmaxf(P[t.row_start[k]], kMinVal);
  __syncwarp();
  for (int lv = 1; lv < t.nlevel; ++lv) {
    const int q1 = t.level_start[lv + 1];
    for (int q = t.level_start[lv] + lane; q < q1; q += 32) {
      const int k = t.level_row[q], s = t.row_start[k];
      float v = x[k];
#pragma unroll 4
      for (int ia = 1; ia <= lv; ++ia) v -= P[s + ia] * x[t.chain[s + ia]];
      x[k] = v;
    }
    __syncwarp();
  }
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

__global__ void __launch_bounds__(32 * TREE_WARPS, TREE_BLOCKS)
    tree_ldl_kernel(const TreeLdlParams p) {
  extern __shared__ float smem[];
  const TreeTables& t = p.t;
  const int lane = threadIdx.x & 31, nv = t.nv;
  const size_t w = (size_t)blockIdx.x * TREE_WARPS + (threadIdx.x >> 5);
  if (w >= (size_t)p.nworld) return;
  float* P = smem + (threadIdx.x >> 5) * (t.nnz + nv);   // packed rows
  float* x = P + t.nnz;      // right-hand side, then the solution
  tree_gather(t, p.a + w * nv * nv, p.b + w * nv, P, x, lane);
  if (p.diag) {
    for (int k = lane; k < nv; k += 32) P[t.row_start[k]] += p.diag[k];
    __syncwarp();
  }
  tree_factor(t, P, lane);
  tree_sweeps(t, P, x, lane);
  for (int k = lane; k < nv; k += 32) p.x[w * nv + k] = x[k];
  if (p.ld) tree_write_ld(t, P, p.ld + w * nv * nv, lane);
}

__global__ void __launch_bounds__(32 * TREE_WARPS, TREE_BLOCKS)
    tree_solve_kernel(const TreeSolveParams p) {
  extern __shared__ float smem[];
  const TreeTables& t = p.t;
  const int lane = threadIdx.x & 31, nv = t.nv;
  const size_t w = (size_t)blockIdx.x * TREE_WARPS + (threadIdx.x >> 5);
  if (w >= (size_t)p.nworld) return;
  float* P = smem + (threadIdx.x >> 5) * (t.nnz + nv);   // packed rows
  float* x = P + t.nnz;
  tree_gather(t, p.ld + w * nv * nv, p.b + w * nv, P, x, lane);
  tree_sweeps(t, P, x, lane);
  for (int k = lane; k < nv; k += 32) p.x[w * nv + k] = x[k];
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

PORT_C_WARP_ENTRY(tree_ldl_, TreeLdlParams, tree_ldl_kernel, TREE_WARPS,
                  tree_world_bytes(p->t))
PORT_C_WARP_ENTRY(tree_solve_, TreeSolveParams, tree_solve_kernel,
                  TREE_WARPS, tree_world_bytes(p->t))
PORT_C_WARP_ENTRY(spd_solve_, SpdParams, spd_solve_kernel, SPD_WARPS,
                  spd_world_bytes(p->n))
PORT_C_WARP_ENTRY(cho_solve_, ChoSolveParams, cho_solve_kernel, SPD_WARPS,
                  spd_world_bytes(p->n))
