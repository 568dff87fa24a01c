// Kernel B1: the smooth stage of the step, one group of lanes per world —
// qpos normalization, forward kinematics, body/geom/site frames,
// subtree com, cinert and cdof, composite inertia and the dense mass
// matrix qM (with armature), cvel and cdof_dot, and the bias forces of
// rne (cacc, qfrc_bias).
//
// Replaces: mujoco_warp_tpu/pallas/smooth_kernels.py, smooth_mega_batched
// (:557; body _smooth_mega_kernel :531). Plain version:
// mujoco_warp_tpu_torch/smooth.py, smooth().
//
// What bounds it on the H100: bytes, in principle. Per world it reads
// qpos and qvel and writes about 2,300 floats on the humanoid (qM alone
// is 27x27) and 12,000 on three_humanoids (qM 81x81): 79 MB and 395 MB
// at 8192 worlds, 24 and 118 us at 3.35 TB/s. The arithmetic is about
// 30k flops a humanoid world, most of it in chains along the tree.
//
// The design: G lanes per world (Params.lanes: 8, 16 or 32, the fewest
// that hold the model's widest tree level, kernels/smooth.py), 32 / G
// worlds a warp, smooth_worlds worlds a block (smooth_layout.cuh: the
// most, up to SMOOTH_WORLDS, whose layouts fit a block's 232,448 bytes:
// 3 on kitchen's 328 bodies, where G is 32 so that every warp is whole,
// 4 on the port's other models; a block's worlds are blockDim.x / G);
// the world's state in shared memory (SmoothLayout: 1,280 words a
// humanoid world, 3,360 on three_humanoids, 14,716 on kitchen, where
// the arrays of the position stages and those of crb and rne share one
// region); the lanes over the parallel work of each stage: the bodies
// of one tree level in kinematics and in com_vel with rne's forward
// pass, level by level with a __syncwarp between levels; bodies for
// the frames and cinert, geoms and sites G at a time, joints for cdof,
// one lane per dof down its ancestor chain for qM's packed rows, dofs
// for qfrc_bias. The tree sums (subtree com, crb, cfrc) run from the
// deepest level up, one lane per (parent, component), each parent adding
// its children in descending body index: the order of the one-thread
// loop `for b = nb - 1 .. 1`, so every sum keeps its order. Level and
// children tables come from the host (kernels/smooth.py, tree_tables),
// with qM's table: the packed slot of every dense entry, or
// none. Each output is stored from shared memory once it is final, a
// world's rows contiguous in [W, ...], so the stores coalesce; qM is
// written once, zeros included. The lanes exchange nothing but through
// shared memory, so a warp's worlds run side by side: a narrow tree
// (the humanoid's levels hold at most 3 bodies) keeps 8 lanes a world
// busy where it would leave most of a warp idle.
//
// Model tables arrive as device arrays and the kernel loops over them at
// run time; bodies are in topological order (parent < child).
//
// Four more entries are instantiations of B1's kernel, smooth_stages<S>,
// that run some of its stages on the same Params (the pointers an entry
// does not use are null), with the semantics of the TPU kernels they
// replace (pallas/smooth_kernels.py):
//   B10 kinematics_batched (:722)   smooth_stages<kKinematics>
//   B11 com_pos_batched (:243)      smooth_stages<kComPos>
//   B12 crb_batched (:353)          smooth_stages<kCrb>
//   B9  smooth_front_batched (:665) smooth_stages<kKinematics | kComPos |
//                                                kCrb>
// Their plain versions are smooth.kinematics, smooth.crb and
// kernels/smooth.py's plain_com_pos and plain_smooth_front. An entry
// copies its inputs into the shared layout and runs B1's own statements;
// on B1's normalized qpos they give B1's outputs bit for bit on the
// port's models, and as another instantiation may in principle fuse
// multiply-adds differently, chip_smoke.py checks each time.

#include "common.cuh"
#include "smooth_layout.cuh"

struct Params {
  const float* qpos;
  const float* qvel;
  const int* body_parentid;
  const int* body_rootid;
  const int* body_jntadr;
  const int* body_jntnum;
  const int* jnt_type;
  const int* jnt_qposadr;
  const int* jnt_dofadr;
  const int* jnt_bodyid;
  const int* dof_bodyid;
  const int* dof_parentid;
  const int* geom_bodyid;
  const int* site_bodyid;
  const int* level_start;      // (nlevel + 1): level l is [.. [l], [l + 1])
  const int* level_body;       // (nbody): bodies by tree level
  const int* child_start;      // (nbody + 1): body b's children are
  const int* child_body;       //   [child_start[b], [b + 1]), descending
  const int* qm_rowstart;      // (nv): packed row i of qM: i, ancestors
  const unsigned short* qm_slot;  // (nv * nv): packed slot, 0xffff: zero
  const float* body_pos;
  const float* body_quat;
  const float* body_ipos;
  const float* body_iquat;
  const float* body_mass;
  const float* body_subtreemass;
  const float* body_inertia;
  const float* jnt_pos;
  const float* jnt_axis;
  const float* qpos0;
  const float* dof_armature;
  const float* geom_pos;
  const float* geom_quat;
  const float* site_pos;
  const float* site_quat;
  const float* gravity;
  float* qpos_out;
  float* xpos;
  float* xquat;
  float* xmat;
  float* xipos;
  float* ximat;
  float* xanchor;
  float* xaxis;
  float* geom_xpos;
  float* geom_xmat;
  float* site_xpos;
  float* site_xmat;
  float* subtree_com;
  float* cinert;
  float* cdof;
  float* crb;
  float* qM;
  float* cvel;
  float* cdof_dot;
  float* cacc;
  float* qfrc_bias;
  int nworld;
  int nq;
  int nv;
  int nbody;
  int njnt;
  int ngeom;
  int nsite;
  int nlevel;
  int nnz;                     // packed entries of qM
  int lanes;                   // lanes per world: 8, 16 or 32
};

enum { kFree = 0, kBall = 1, kSlide = 2, kHinge = 3 };

DEV int jnt_ndof(int type) {
  return type == kFree ? 6 : (type == kBall ? 3 : 1);
}

// position and rotation matrix of a frame attached to a body
DEV void attach(const float* bpos, const float* bquat, const float* pos,
                const float* quat, float* out_pos, float* out_mat) {
  float p[3], q[4];
  qrot(pos, bquat, p);
  out_pos[0] = bpos[0] + p[0];
  out_pos[1] = bpos[1] + p[1];
  out_pos[2] = bpos[2] + p[2];
  qmul(bquat, quat, q);
  quat2mat(q, out_mat);
}

// a world's lanes' copy of n floats to global memory (coalesced) and from
// it: lane `sub` of G
DEV void group_store(float* dst, const float* src, int n, int sub, int G) {
  for (int i = sub; i < n; i += G) dst[i] = src[i];
}

DEV void group_load(float* dst, const float* src, int n, int sub, int G) {
  for (int i = sub; i < n; i += G) copy4_async(dst + i, src + i);
}

// The stages of the smooth kernels, run in this order for one world per
// group of lanes; B1 runs them all, B9-B12 the position stages (see above). Each
// stage holds the one-thread kernel's statements for one body, joint,
// geom or dof, in their order, under `if constexpr`, so that every
// instantiation runs the same statements (the compiler may fuse
// multiply-adds differently when they are split into functions).
enum : int {
  kNormalize = 1,    // qpos_out: qpos with normalized quaternions
  kKinematics = 2,   // xpos, xquat, xanchor, xaxis
  kFrames = 4,       // xmat, xipos, ximat, geom and site frames as outputs
  kComPos = 8,       // subtree_com, cinert, cdof
  kCrb = 16,         // crb, qM
  kVelocity = 32,    // cvel, cdof_dot, cacc, qfrc_bias
  kB1 = 63,
};

template <int S>
__global__ void __launch_bounds__(32 * SMOOTH_WORLDS, 4)
    smooth_stages(const Params p) {
  extern __shared__ float smem[];
  // G lanes per world; lane `sub` of its world's group
  const int G = p.lanes, sub = threadIdx.x & (G - 1);
  const int slot = threadIdx.x / G;
  const size_t w = (size_t)blockIdx.x * (blockDim.x / G) + slot;
  // the lanes of a world past nworld leave; `live` names the rest of the
  // warp, which every __syncwarp waits for
  const unsigned live = __ballot_sync(FULL_MASK, w < (size_t)p.nworld);
  if (w >= (size_t)p.nworld) return;
  const int nq = p.nq, nv = p.nv, nb = p.nbody, nj = p.njnt;
  const SmoothLayout L = smooth_layout(p);
  float* const base = smem + slot * L.words;

  // ---- qpos with normalized free/ball quaternions (normalize_qpos) ----
  // the entries without kNormalize take qpos normalized already
  float* qpos = base + L.qpos;
  if constexpr (S & (kNormalize | kKinematics)) {
    group_load(qpos, p.qpos + w * nq, nq, sub, G);
    copy_async_wait();
    __syncwarp(live);
  }
  if constexpr (S & kNormalize) {
    for (int j = sub; j < nj; j += G) {
      int t = p.jnt_type[j];
      if (t != kFree && t != kBall) continue;
      float* q = qpos + p.jnt_qposadr[j] + (t == kFree ? 3 : 0);
      float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] +
                      q[3] * q[3]);
      if (n < 1e-14f) {
        q[0] = 1.0f; q[1] = 0.0f; q[2] = 0.0f; q[3] = 0.0f;
      } else {
        q[0] /= n; q[1] /= n; q[2] /= n; q[3] /= n;
      }
    }
    __syncwarp(live);
    group_store(p.qpos_out + w * nq, qpos, nq, sub, G);
  }
  const float* qk = qpos;

  // ---- forward kinematics (smooth.kinematics), level by level ----
  float* xpos = base + L.xpos;
  float* xquat = base + L.xquat;
  float* xanchor = base + L.xanchor;
  float* xaxis = base + L.xaxis;
  if constexpr (S & kKinematics) {
    if (sub == 0) {
      xpos[0] = xpos[1] = xpos[2] = 0.0f;
      xquat[0] = 1.0f; xquat[1] = xquat[2] = xquat[3] = 0.0f;
    }
    __syncwarp(live);
    for (int lv = 1; lv < p.nlevel; ++lv) {
      for (int e = p.level_start[lv] + sub; e < p.level_start[lv + 1];
           e += G) {
        const int b = p.level_body[e];
        const int par = p.body_parentid[b];
        const float* pq = xquat + 4 * par;
        float xq[4], xp[3], t[3];
        qmul(pq, p.body_quat + 4 * b, xq);
        qrot(p.body_pos + 3 * b, pq, t);
        for (int i = 0; i < 3; ++i) xp[i] = xpos[3 * par + i] + t[i];
        const int ja = p.body_jntadr[b], jn = p.body_jntnum[b];
        for (int j = ja; j < ja + jn; ++j) {
          const int type = p.jnt_type[j], qa = p.jnt_qposadr[j];
          if (type == kFree) {
            for (int i = 0; i < 3; ++i) {
              xp[i] = qk[qa + i];
              xanchor[3 * j + i] = xp[i];
              xaxis[3 * j + i] = p.jnt_axis[3 * j + i];
            }
            for (int i = 0; i < 4; ++i) xq[i] = qk[qa + 3 + i];
            continue;
          }
          const float* jpos = p.jnt_pos + 3 * j;
          const float* jaxis = p.jnt_axis + 3 * j;
          float anchor[3], axis[3];
          qrot(jpos, xq, t);
          for (int i = 0; i < 3; ++i) anchor[i] = xp[i] + t[i];
          qrot(jaxis, xq, axis);
          if (type == kSlide) {
            float qs = qk[qa] - p.qpos0[qa];
            for (int i = 0; i < 3; ++i) xp[i] = xp[i] + axis[i] * qs;
          } else {
            float qloc[4];
            if (type == kHinge) {
              float half = 0.5f * (qk[qa] - p.qpos0[qa]);
              float s = sinf(half);
              qloc[0] = cosf(half);
              qloc[1] = s * jaxis[0]; qloc[2] = s * jaxis[1];
              qloc[3] = s * jaxis[2];
            } else {
              for (int i = 0; i < 4; ++i) qloc[i] = qk[qa + i];
              qnormalize(qloc);
            }
            qmul(xq, qloc, xq);
            qrot(jpos, xq, t);
            for (int i = 0; i < 3; ++i) xp[i] = anchor[i] - t[i];
          }
          for (int i = 0; i < 3; ++i) {
            xanchor[3 * j + i] = anchor[i];
            xaxis[3 * j + i] = axis[i];
          }
        }
        qnormalize(xq);
        for (int i = 0; i < 3; ++i) xpos[3 * b + i] = xp[i];
        for (int i = 0; i < 4; ++i) xquat[4 * b + i] = xq[i];
      }
      __syncwarp(live);
    }
    group_store(p.xpos + w * nb * 3, xpos, nb * 3, sub, G);
    group_store(p.xquat + w * nb * 4, xquat, nb * 4, sub, G);
    group_store(p.xanchor + w * nj * 3, xanchor, nj * 3, sub, G);
    group_store(p.xaxis + w * nj * 3, xaxis, nj * 3, sub, G);
  } else if constexpr (S & kComPos) {
    group_load(xpos, p.xpos + w * nb * 3, nb * 3, sub, G);
    group_load(xquat, p.xquat + w * nb * 4, nb * 4, sub, G);
    group_load(xanchor, p.xanchor + w * nj * 3, nj * 3, sub, G);
    group_load(xaxis, p.xaxis + w * nj * 3, nj * 3, sub, G);
    copy_async_wait();
    __syncwarp(live);
  }

  // ---- frames (smooth.frames) ----
  float* xmat = base + L.xmat;
  float* xipos = base + L.xipos;
  float* ximat = base + L.ximat;
  if constexpr (S & (kFrames | kComPos)) {
    for (int b = sub; b < nb; b += G) {
      quat2mat(xquat + 4 * b, xmat + 9 * b);
      attach(xpos + 3 * b, xquat + 4 * b, p.body_ipos + 3 * b,
             p.body_iquat + 4 * b, xipos + 3 * b, ximat + 9 * b);
    }
  }
  if constexpr (S & kFrames) {
    // geoms, then sites, G at a time through the scratch
    float* scr = base + L.scratch;
    for (int g0 = 0; g0 < p.ngeom; g0 += G) {
      const int g = g0 + sub, cnt = min(G, p.ngeom - g0);
      if (g < p.ngeom) {
        const int b = p.geom_bodyid[g];
        attach(xpos + 3 * b, xquat + 4 * b, p.geom_pos + 3 * g,
               p.geom_quat + 4 * g, scr + 3 * sub, scr + 3 * G + 9 * sub);
      }
      __syncwarp(live);
      group_store(p.geom_xpos + (w * p.ngeom + g0) * 3, scr, 3 * cnt, sub,
                  G);
      group_store(p.geom_xmat + (w * p.ngeom + g0) * 9, scr + 3 * G, 9 * cnt,
                  sub, G);
      __syncwarp(live);
    }
    for (int s0 = 0; s0 < p.nsite; s0 += G) {
      const int s = s0 + sub, cnt = min(G, p.nsite - s0);
      if (s < p.nsite) {
        const int b = p.site_bodyid[s];
        attach(xpos + 3 * b, xquat + 4 * b, p.site_pos + 3 * s,
               p.site_quat + 4 * s, scr + 3 * sub, scr + 3 * G + 9 * sub);
      }
      __syncwarp(live);
      group_store(p.site_xpos + (w * p.nsite + s0) * 3, scr, 3 * cnt, sub,
                  G);
      group_store(p.site_xmat + (w * p.nsite + s0) * 9, scr + 3 * G, 9 * cnt,
                  sub, G);
      __syncwarp(live);
    }
    group_store(p.xmat + w * nb * 9, xmat, nb * 9, sub, G);
    group_store(p.xipos + w * nb * 3, xipos, nb * 3, sub, G);
    group_store(p.ximat + w * nb * 9, ximat, nb * 9, sub, G);
  }
  __syncwarp(live);

  // ---- subtree com, cinert, cdof (smooth.com_pos) ----
  float* com = base + L.com;
  float* cinert = base + L.cinert;
  float* cdof = base + L.cdof;
  if constexpr (S & kComPos) {
    for (int e = sub; e < 3 * nb; e += G)
      com[e] = xipos[e] * p.body_mass[e / 3];
    __syncwarp(live);
    // subtree sums from the deepest level up: a parent adds its children
    // in descending index
    for (int lv = p.nlevel - 2; lv >= 0; --lv) {
      const int s0 = p.level_start[lv], s1 = p.level_start[lv + 1];
      for (int e = sub; e < 3 * (s1 - s0); e += G) {
        const int par = p.level_body[s0 + e / 3], i = e % 3;
        float v = com[3 * par + i];
        for (int c = p.child_start[par]; c < p.child_start[par + 1]; ++c)
          v += com[3 * p.child_body[c] + i];
        com[3 * par + i] = v;
      }
      __syncwarp(live);
    }
    for (int e = sub; e < 3 * nb; e += G) {
      float sm = fmaxf(p.body_subtreemass[e / 3], 1e-12f);
      com[e] /= sm;
    }
    __syncwarp(live);
    for (int b = sub; b < nb; b += G) {
      float* ci = cinert + 10 * b;
      if (b == 0) {
        for (int i = 0; i < 10; ++i) ci[i] = 0.0f;
        continue;
      }
      const float* R = ximat + 9 * b;
      const float* in = p.body_inertia + 3 * b;
      const float m = p.body_mass[b];
      const int root = p.body_rootid[b];
      float off[3];
      for (int i = 0; i < 3; ++i)
        off[i] = xipos[3 * b + i] - com[3 * root + i];
      float d2 = dot3(off, off);
      float I[3][3];
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c)
          I[r][c] = R[3 * r] * in[0] * R[3 * c] +
                    R[3 * r + 1] * in[1] * R[3 * c + 1] +
                    R[3 * r + 2] * in[2] * R[3 * c + 2] +
                    m * ((r == c ? d2 : 0.0f) - off[r] * off[c]);
      ci[0] = I[0][0]; ci[1] = I[1][1]; ci[2] = I[2][2];
      ci[3] = I[0][1]; ci[4] = I[0][2]; ci[5] = I[1][2];
      ci[6] = m * off[0]; ci[7] = m * off[1]; ci[8] = m * off[2];
      ci[9] = m;
    }
    for (int j = sub; j < nj; j += G) {
      const int b = p.jnt_bodyid[j], type = p.jnt_type[j];
      const int da = p.jnt_dofadr[j], root = p.body_rootid[b];
      float off[3];
      for (int i = 0; i < 3; ++i)
        off[i] = -(xanchor[3 * j + i] - com[3 * root + i]);
      if (type == kSlide) {
        float* c = cdof + 6 * da;
        c[0] = c[1] = c[2] = 0.0f;
        for (int i = 0; i < 3; ++i) c[3 + i] = xaxis[3 * j + i];
      } else if (type == kHinge) {
        float* c = cdof + 6 * da;
        for (int i = 0; i < 3; ++i) c[i] = xaxis[3 * j + i];
        cross3(c, off, c + 3);
      } else {
        int rot = da;
        if (type == kFree) {
          for (int k = 0; k < 3; ++k) {
            float* c = cdof + 6 * (da + k);
            for (int i = 0; i < 6; ++i) c[i] = (i == 3 + k) ? 1.0f : 0.0f;
          }
          rot = da + 3;
        }
        const float* M = xmat + 9 * b;
        for (int k = 0; k < 3; ++k) {
          float* c = cdof + 6 * (rot + k);
          c[0] = M[k]; c[1] = M[3 + k]; c[2] = M[6 + k];
          cross3(c, off, c + 3);
        }
      }
    }
    __syncwarp(live);
    group_store(p.subtree_com + w * nb * 3, com, nb * 3, sub, G);
    group_store(p.cinert + w * nb * 10, cinert, nb * 10, sub, G);
    group_store(p.cdof + w * nv * 6, cdof, nv * 6, sub, G);
  } else if constexpr (S & kCrb) {
    group_load(cinert, p.cinert + w * nb * 10, nb * 10, sub, G);
    group_load(cdof, p.cdof + w * nv * 6, nv * 6, sub, G);
    copy_async_wait();
  }
  // the position stages' region is free from here on
  __syncwarp(live);

  // ---- composite inertia and dense qM (smooth.crb): crb is cinert with
  // the subtree sums added into every parent but body 0; qM holds the
  // ancestor-chain entries, mirrored, and zeros elsewhere ----
  if constexpr (S & kCrb) {
    float* crb = base + L.crb;
    float* qmp = base + L.qmp;
    for (int e = sub; e < nb * 10; e += G) crb[e] = cinert[e];
    __syncwarp(live);
    for (int lv = p.nlevel - 2; lv >= 1; --lv) {
      const int s0 = p.level_start[lv], s1 = p.level_start[lv + 1];
      for (int e = sub; e < 10 * (s1 - s0); e += G) {
        const int par = p.level_body[s0 + e / 10], i = e % 10;
        float v = crb[10 * par + i];
        for (int c = p.child_start[par]; c < p.child_start[par + 1]; ++c)
          v += crb[10 * p.child_body[c] + i];
        crb[10 * par + i] = v;
      }
      __syncwarp(live);
    }
    // qM's packed row i: entry (i, j) for j = i and its ancestors
    for (int i = sub; i < nv; i += G) {
      float buf[6];
      inert_mul(crb + 10 * p.dof_bodyid[i], cdof + 6 * i, buf);
      int slot = p.qm_rowstart[i];
      for (int j = i; j >= 0; j = p.dof_parentid[j]) {
        const float* cj = cdof + 6 * j;
        float v = buf[0] * cj[0] + buf[1] * cj[1] + buf[2] * cj[2] +
                  buf[3] * cj[3] + buf[4] * cj[4] + buf[5] * cj[5];
        if (j == i) v += p.dof_armature[i];
        qmp[slot++] = v;
      }
    }
    __syncwarp(live);
    group_store(p.crb + w * nb * 10, crb, nb * 10, sub, G);
    float* qM = p.qM + w * nv * nv;
    for (int e = sub; e < nv * nv; e += G) {
      const unsigned short slot = p.qm_slot[e];
      qM[e] = slot == 0xffff ? 0.0f : qmp[slot];
    }
    // crb's region is rne's from here on
    __syncwarp(live);
  }

  if constexpr (S & kVelocity) {
    // ---- cvel and cdof_dot in C mj_comVel order (smooth.com_vel), with
    // rne's forward pass (cacc, qacc = 0), level by level ----
    float* qvel = base + L.qvel;
    float* cvel = base + L.cvel;
    float* cdot = base + L.cdot;
    float* cacc = base + L.cacc;
    float* cfrc = base + L.cfrc;
    group_load(qvel, p.qvel + w * nv, nv, sub, G);
    copy_async_wait();
    if (sub == 0) {
      for (int i = 0; i < 6; ++i) cvel[i] = 0.0f;
      cacc[0] = cacc[1] = cacc[2] = 0.0f;
      for (int i = 0; i < 3; ++i) cacc[3 + i] = -p.gravity[i];
    }
    __syncwarp(live);
    for (int lv = 1; lv < p.nlevel; ++lv) {
      for (int e = p.level_start[lv] + sub; e < p.level_start[lv + 1];
           e += G) {
        const int b = p.level_body[e];
        float v[6];
        for (int i = 0; i < 6; ++i) v[i] = cvel[6 * p.body_parentid[b] + i];
        const int ja = p.body_jntadr[b], jn = p.body_jntnum[b];
        for (int j = ja; j < ja + jn; ++j) {
          const int type = p.jnt_type[j], da = p.jnt_dofadr[j];
          const int lin = type == kFree ? 3 : 0, nd = jnt_ndof(type);
          for (int d = da; d < da + lin; ++d) {
            for (int i = 0; i < 6; ++i) cdot[6 * d + i] = 0.0f;
            for (int i = 0; i < 6; ++i) v[i] += cdof[6 * d + i] * qvel[d];
          }
          for (int d = da + lin; d < da + nd; ++d)
            motion_cross(v, cdof + 6 * d, cdot + 6 * d);
          for (int d = da + lin; d < da + nd; ++d)
            for (int i = 0; i < 6; ++i) v[i] += cdof[6 * d + i] * qvel[d];
        }
        for (int i = 0; i < 6; ++i) cvel[6 * b + i] = v[i];

        float a[6];
        for (int i = 0; i < 6; ++i) a[i] = cacc[6 * p.body_parentid[b] + i];
        for (int j = ja; j < ja + jn; ++j) {
          const int da = p.jnt_dofadr[j], nd = jnt_ndof(p.jnt_type[j]);
          for (int d = da; d < da + nd; ++d)
            for (int i = 0; i < 6; ++i) a[i] += cdot[6 * d + i] * qvel[d];
        }
        for (int i = 0; i < 6; ++i) cacc[6 * b + i] = a[i];
      }
      __syncwarp(live);
    }
    // ---- rne's backward pass (smooth.rne) ----
    for (int b = sub; b < nb; b += G) {
      float ia[6], iv[6], x[6];
      inert_mul(cinert + 10 * b, cacc + 6 * b, ia);
      inert_mul(cinert + 10 * b, cvel + 6 * b, iv);
      motion_cross_force(cvel + 6 * b, iv, x);
      for (int i = 0; i < 6; ++i) cfrc[6 * b + i] = ia[i] + x[i];
    }
    __syncwarp(live);
    for (int lv = p.nlevel - 2; lv >= 0; --lv) {
      const int s0 = p.level_start[lv], s1 = p.level_start[lv + 1];
      for (int e = sub; e < 6 * (s1 - s0); e += G) {
        const int par = p.level_body[s0 + e / 6], i = e % 6;
        float v = cfrc[6 * par + i];
        for (int c = p.child_start[par]; c < p.child_start[par + 1]; ++c)
          v += cfrc[6 * p.child_body[c] + i];
        cfrc[6 * par + i] = v;
      }
      __syncwarp(live);
    }
    float* bias = p.qfrc_bias + w * nv;
    for (int d = sub; d < nv; d += G) {
      const float* c = cdof + 6 * d;
      const float* f = cfrc + 6 * p.dof_bodyid[d];
      bias[d] = c[0] * f[0] + c[1] * f[1] + c[2] * f[2] + c[3] * f[3] +
                c[4] * f[4] + c[5] * f[5];
    }
    group_store(p.cvel + w * nb * 6, cvel, nb * 6, sub, G);
    group_store(p.cdof_dot + w * nv * 6, cdot, nv * 6, sub, G);
    group_store(p.cacc + w * nb * 6, cacc, nb * 6, sub, G);
  }
}

// B1; B10 (kinematics), B11 (com_pos), B12 (crb), B9 (smooth_front)
#define SMOOTH_BYTES (smooth_layout(*p).words * (int)sizeof(float))
#define SMOOTH_ENTRY(prefix, kernel)                                      \
  PORT_C_GROUP_ENTRY(prefix, Params, kernel, smooth_worlds(*p), p->lanes, \
                     SMOOTH_BYTES)
PORT_C_ERROR_STRING
SMOOTH_ENTRY(, smooth_stages<kB1>)
SMOOTH_ENTRY(kin_, smooth_stages<kKinematics>)
SMOOTH_ENTRY(com_, smooth_stages<kComPos>)
SMOOTH_ENTRY(crb_, smooth_stages<kCrb>)
SMOOTH_ENTRY(front_, smooth_stages<kKinematics | kComPos | kCrb>)
