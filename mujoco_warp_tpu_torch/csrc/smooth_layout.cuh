// A world's shared memory in smooth.cu (SmoothLayout) and the worlds a
// block that it leaves room for. The header needs no CUDA header, so
// that a host compiler builds it as it is (tests/test_torch_kernels.py
// loads it as a host library and holds every committed model's layout).
#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define SMOOTH_WORLDS 4             // most worlds a block
#define SMOOTH_BLOCK_BYTES 232448   // the H100's shared memory a block

// A world's words of shared memory: cinert and cdof for the whole
// kernel, then one region that the position stages (qpos .. com and a
// scratch for G <= 32 geoms or sites) use first and crb with qM's packed
// rows, then rne's arrays, after them. P is smooth.cu's Params or any
// struct with its nq, nv, nbody, njnt and nnz.
struct SmoothLayout {
  int cinert, cdof;                                   // kept
  int qpos, xpos, xquat, xanchor, xaxis, xmat, xipos, ximat, com, scratch;
  int crb, qmp;                                       // crb stage
  int cvel, cdot, cacc, cfrc, qvel;                   // velocity stage
  int words;
};

template <class P>
__host__ __device__ inline SmoothLayout smooth_layout(const P& p) {
  SmoothLayout L;
  const int nb = p.nbody, nv = p.nv, nj = p.njnt;
  L.cinert = 0;
  L.cdof = 10 * nb;
  const int region = L.cdof + 6 * nv;
  L.qpos = region;
  L.xpos = L.qpos + p.nq;
  L.xquat = L.xpos + 3 * nb;
  L.xanchor = L.xquat + 4 * nb;
  L.xaxis = L.xanchor + 3 * nj;
  L.xmat = L.xaxis + 3 * nj;
  L.xipos = L.xmat + 9 * nb;
  L.ximat = L.xipos + 3 * nb;
  L.com = L.ximat + 9 * nb;
  L.scratch = L.com + 3 * nb;
  const int end_pos = L.scratch + 32 * 12;
  L.crb = region;
  L.qmp = L.crb + 10 * nb;
  const int end_crb = L.qmp + p.nnz;
  L.cvel = region;
  L.cdot = L.cvel + 6 * nb;
  L.cacc = L.cdot + 6 * nv;
  L.cfrc = L.cacc + 6 * nb;
  L.qvel = L.cfrc + 6 * nb;
  const int end_vel = L.qvel + nv;
  const int end = end_pos > end_crb ? end_pos : end_crb;
  L.words = ((end > end_vel ? end : end_vel) + 3) & ~3;
  return L;
}

// worlds a block: the most, up to SMOOTH_WORLDS, whose layouts fit
// SMOOTH_BLOCK_BYTES; 0 where one world does not fit
template <class P>
__host__ __device__ inline int smooth_worlds(const P& p) {
  const int fit = SMOOTH_BLOCK_BYTES /
                  (smooth_layout(p).words * (int)sizeof(float));
  return fit < SMOOTH_WORLDS ? fit : SMOOTH_WORLDS;
}

struct SmoothSizes {
  int nq, nv, nbody, njnt, nnz;
};

// smooth_worlds of a model of these sizes; a world's words to *words
extern "C" int smooth_block(int nq, int nv, int nbody, int njnt, int nnz,
                            int* words) {
  const SmoothSizes s{nq, nv, nbody, njnt, nnz};
  *words = smooth_layout(s).words;
  return smooth_worlds(s);
}
