// Kernel B1: the smooth stage of the step for one world per thread —
// qpos normalization, forward kinematics, body/geom/site frames,
// subtree com, cinert and cdof, composite inertia and the dense mass
// matrix qM (with armature), cvel and cdof_dot, and the bias forces of
// rne (cacc, qfrc_bias).
//
// Replaces: mujoco_warp_tpu/pallas/smooth_kernels.py, smooth_mega_batched
// (:557; body _smooth_mega_kernel :531). Plain version:
// mujoco_warp_tpu_torch/smooth.py, smooth().
//
// What bounds it on the H100: bytes. Per world it reads qpos and qvel
// (55 floats) and writes about 2,300 floats (qM alone is 27x27): about
// 9 KB per world, 75 MB at 8192 worlds, 22 us at 3.35 TB/s. The
// arithmetic is about 30k flops per world, 0.25 GFLOP in all, 4 us at
// the 67 TFLOP/s of float32 outside the tensor cores.
//
// What this first cut does about it: nothing yet. One thread walks one
// world's tree, so neighbouring threads touch addresses one world apart
// in the batch-first [W, ...] layout and no access is coalesced; the
// model tables are read through the cache by every thread. A warp per
// world or a world-fastest layout is later work.
//
// Model tables arrive as device arrays and the kernel loops over them at
// run time; bodies are in topological order (parent < child), so one
// forward and one backward pass over bodies cover every tree sum.
//
// Four more entries are instantiations of B1's kernel, smooth_stages<S>,
// that run some of its stages on the same Params (the pointers an entry
// does not use are null), one thread per world, with the semantics of
// the TPU kernels they replace (pallas/smooth_kernels.py):
//   B10 kinematics_batched (:722)   smooth_stages<kKinematics>
//   B11 com_pos_batched (:243)      smooth_stages<kComPos>
//   B12 crb_batched (:353)          smooth_stages<kCrb>
//   B9  smooth_front_batched (:665) smooth_stages<kKinematics | kComPos |
//                                                kCrb>
// Their plain versions are smooth.kinematics, smooth.crb and
// kernels/smooth.py's plain_com_pos and plain_smooth_front. On B1's
// normalized qpos they run B1's own statements and gave B1's outputs bit
// for bit on the port's models; another instantiation may in principle
// fuse multiply-adds differently, so chip_smoke.py checks each time.
// Bounded by bytes as B1: B12 and B9 write qM, nv x nv floats a world.

#include "common.cuh"

#define MAXBODY 64

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

// The stages of the smooth kernels, run in this order for one world per
// thread; B1 runs them all, B9-B12 the position stages (see above). The
// body holds B1's statements in their order before the entries were
// added, each stage under `if constexpr`, so the instantiation that runs
// every stage gives B1's earlier outputs bit for bit, with its registers
// and stack (the compiler may fuse multiply-adds differently when the
// same statements are split into functions).
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
__global__ void smooth_stages(const Params p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.nworld) return;
  const int nq = p.nq, nv = p.nv, nb = p.nbody, nj = p.njnt;

  // ---- qpos with normalized free/ball quaternions (normalize_qpos) ----
  const float* qin = p.qpos + (size_t)w * nq;
  float* qpos = p.qpos_out + (size_t)w * nq;
  if constexpr (S & kNormalize) {
    for (int i = 0; i < nq; ++i) qpos[i] = qin[i];
    for (int j = 0; j < nj; ++j) {
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
  }
  // the entries without kNormalize take qpos normalized already
  const float* qk = (S & kNormalize) ? qpos : qin;

  // ---- forward kinematics (smooth.kinematics) ----
  float* xpos = p.xpos + (size_t)w * nb * 3;
  float* xquat = p.xquat + (size_t)w * nb * 4;
  float* xanchor = p.xanchor + (size_t)w * nj * 3;
  float* xaxis = p.xaxis + (size_t)w * nj * 3;
  if constexpr (S & kKinematics) {
    xpos[0] = xpos[1] = xpos[2] = 0.0f;
    xquat[0] = 1.0f; xquat[1] = xquat[2] = xquat[3] = 0.0f;
    for (int b = 1; b < nb; ++b) {
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
  }

  // ---- frames (smooth.frames) ----
  // the entries without kFrames keep the body frames in local memory
  float local[(S & kFrames) ? 1 : MAXBODY * 21];
  float* xmat = (S & kFrames) ? p.xmat + (size_t)w * nb * 9 : local;
  float* xipos = (S & kFrames) ? p.xipos + (size_t)w * nb * 3
                               : local + MAXBODY * 9;
  float* ximat = (S & kFrames) ? p.ximat + (size_t)w * nb * 9
                               : local + MAXBODY * 12;
  if constexpr (S & (kFrames | kComPos)) {
    for (int b = 0; b < nb; ++b) {
      quat2mat(xquat + 4 * b, xmat + 9 * b);
      attach(xpos + 3 * b, xquat + 4 * b, p.body_ipos + 3 * b,
             p.body_iquat + 4 * b, xipos + 3 * b, ximat + 9 * b);
    }
  }
  if constexpr (S & kFrames) {
    for (int g = 0; g < p.ngeom; ++g) {
      const int b = p.geom_bodyid[g];
      attach(xpos + 3 * b, xquat + 4 * b, p.geom_pos + 3 * g,
             p.geom_quat + 4 * g,
             p.geom_xpos + ((size_t)w * p.ngeom + g) * 3,
             p.geom_xmat + ((size_t)w * p.ngeom + g) * 9);
    }
    for (int s = 0; s < p.nsite; ++s) {
      const int b = p.site_bodyid[s];
      attach(xpos + 3 * b, xquat + 4 * b, p.site_pos + 3 * s,
             p.site_quat + 4 * s,
             p.site_xpos + ((size_t)w * p.nsite + s) * 3,
             p.site_xmat + ((size_t)w * p.nsite + s) * 9);
    }
  }

  // ---- subtree com, cinert, cdof (smooth.com_pos) ----
  float* com = p.subtree_com + (size_t)w * nb * 3;
  float* cinert = p.cinert + (size_t)w * nb * 10;
  float* cdof = p.cdof + (size_t)w * nv * 6;
  if constexpr (S & kComPos) {
    for (int b = 0; b < nb; ++b)
      for (int i = 0; i < 3; ++i)
        com[3 * b + i] = xipos[3 * b + i] * p.body_mass[b];
    for (int b = nb - 1; b > 0; --b) {
      const int par = p.body_parentid[b];
      for (int i = 0; i < 3; ++i) com[3 * par + i] += com[3 * b + i];
    }
    for (int b = 0; b < nb; ++b) {
      float sm = fmaxf(p.body_subtreemass[b], 1e-12f);
      for (int i = 0; i < 3; ++i) com[3 * b + i] /= sm;
    }
    for (int i = 0; i < 10; ++i) cinert[i] = 0.0f;
    for (int b = 1; b < nb; ++b) {
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
      float* ci = cinert + 10 * b;
      ci[0] = I[0][0]; ci[1] = I[1][1]; ci[2] = I[2][2];
      ci[3] = I[0][1]; ci[4] = I[0][2]; ci[5] = I[1][2];
      ci[6] = m * off[0]; ci[7] = m * off[1]; ci[8] = m * off[2];
      ci[9] = m;
    }
    for (int j = 0; j < nj; ++j) {
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
  }

  // ---- composite inertia and dense qM (smooth.crb): crb is cinert with
  // the subtree sums added into every parent but body 0; qM holds the
  // ancestor-chain entries, mirrored, and zeros elsewhere ----
  float* crb = p.crb + (size_t)w * nb * 10;
  float* qM = p.qM + (size_t)w * nv * nv;
  if constexpr (S & kCrb) {
    for (int i = 0; i < nb * 10; ++i) crb[i] = cinert[i];
    for (int b = nb - 1; b > 0; --b) {
      const int par = p.body_parentid[b];
      if (par == 0) continue;
      for (int i = 0; i < 10; ++i) crb[10 * par + i] += crb[10 * b + i];
    }
    for (int i = 0; i < nv * nv; ++i) qM[i] = 0.0f;
    for (int i = 0; i < nv; ++i) {
      float buf[6];
      inert_mul(crb + 10 * p.dof_bodyid[i], cdof + 6 * i, buf);
      for (int j = i; j >= 0; j = p.dof_parentid[j]) {
        const float* cj = cdof + 6 * j;
        float v = buf[0] * cj[0] + buf[1] * cj[1] + buf[2] * cj[2] +
                  buf[3] * cj[3] + buf[4] * cj[4] + buf[5] * cj[5];
        if (j == i) v += p.dof_armature[i];
        qM[i * nv + j] = v;
        qM[j * nv + i] = v;
      }
    }
  }

  if constexpr (S & kVelocity) {
    // ---- cvel and cdof_dot in C mj_comVel order (smooth.com_vel) ----
    const float* qvel = p.qvel + (size_t)w * nv;
    float* cvel = p.cvel + (size_t)w * nb * 6;
    float* cdot = p.cdof_dot + (size_t)w * nv * 6;
    for (int i = 0; i < 6; ++i) cvel[i] = 0.0f;
    for (int b = 1; b < nb; ++b) {
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
    }

    // ---- rne with qacc = 0 (smooth.rne) ----
    float* cacc = p.cacc + (size_t)w * nb * 6;
    cacc[0] = cacc[1] = cacc[2] = 0.0f;
    for (int i = 0; i < 3; ++i) cacc[3 + i] = -p.gravity[i];
    for (int b = 1; b < nb; ++b) {
      float a[6];
      for (int i = 0; i < 6; ++i) a[i] = cacc[6 * p.body_parentid[b] + i];
      const int ja = p.body_jntadr[b], jn = p.body_jntnum[b];
      for (int j = ja; j < ja + jn; ++j) {
        const int da = p.jnt_dofadr[j], nd = jnt_ndof(p.jnt_type[j]);
        for (int d = da; d < da + nd; ++d)
          for (int i = 0; i < 6; ++i) a[i] += cdot[6 * d + i] * qvel[d];
      }
      for (int i = 0; i < 6; ++i) cacc[6 * b + i] = a[i];
    }
    float cfrc[MAXBODY * 6];
    for (int b = 0; b < nb; ++b) {
      float ia[6], iv[6], x[6];
      inert_mul(cinert + 10 * b, cacc + 6 * b, ia);
      inert_mul(cinert + 10 * b, cvel + 6 * b, iv);
      motion_cross_force(cvel + 6 * b, iv, x);
      for (int i = 0; i < 6; ++i) cfrc[6 * b + i] = ia[i] + x[i];
    }
    for (int b = nb - 1; b > 0; --b) {
      const int par = p.body_parentid[b];
      for (int i = 0; i < 6; ++i) cfrc[6 * par + i] += cfrc[6 * b + i];
    }
    float* bias = p.qfrc_bias + (size_t)w * nv;
    for (int d = 0; d < nv; ++d) {
      const float* c = cdof + 6 * d;
      const float* f = cfrc + 6 * p.dof_bodyid[d];
      bias[d] = c[0] * f[0] + c[1] * f[1] + c[2] * f[2] + c[3] * f[3] +
                c[4] * f[4] + c[5] * f[5];
    }
  }
}

// B1; B10 (kinematics), B11 (com_pos), B12 (crb), B9 (smooth_front)
PORT_C_INTERFACE(Params, smooth_stages<kB1>, 32)
PORT_C_ENTRY(kin_, Params, smooth_stages<kKinematics>, 32, nworld)
PORT_C_ENTRY(com_, Params, smooth_stages<kComPos>, 32, nworld)
PORT_C_ENTRY(crb_, Params, smooth_stages<kCrb>, 32, nworld)
PORT_C_ENTRY(front_, Params, smooth_stages<kKinematics | kComPos | kCrb>, 32,
             nworld)
