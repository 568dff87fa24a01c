// Kernel B2: collision and constraint rows for one world per thread —
// narrowphase over the static candidate pairs (plane, sphere and capsule
// primitives), order-keeping compaction of the contacts into the pool,
// and the efc rows: dof friction, joint limits and contacts of the
// pyramidal cone (contact_kernel) or of the elliptic cone
// (contact_ell_kernel); both are contact_world<ELL>(), so the pyramidal
// instantiation is the code it was before the elliptic rows came in.
// The JAX package builds elliptic rows with XLA (its contact kernel
// takes the pyramidal cone alone, contact_kernels.py:57); this kernel
// builds them as mujoco_warp_tpu/constraint.py:479-517 does.
//
// Replaces: mujoco_warp_tpu/pallas/contact_kernels.py, contact_efc
// (:1643; body built by make_contact_kernel :1061). Plain version:
// mujoco_warp_tpu_torch/kernels/contact.py, plain() (collision_driver +
// constraint).
//
// What bounds it on the H100: bytes. Per world it reads the geom frames,
// subtree com and cdof (about 450 floats) and writes the efc rows, of
// which efc_J alone is 117 x 27 floats = 12.6 KB at nconmax 24: about
// 14 KB per world, 115 MB at 8192 worlds, 34 us at 3.35 TB/s. The
// narrowphase of 177 candidates is about 20k flops per world.
//
// What this first cut does about it: nothing yet. One thread per world
// writes its rows in the batch-first [W, rows, nv] layout, so no store
// is coalesced, and rows that do not exist are written as zeros. A warp
// per world, or a world-fastest layout shared with kernel B3, is later
// work.
//
// Contacts keep candidate order: a candidate with dist < margin is
// appended to the pool in the order of the pair list, so slot k and efc
// block k match the JAX package (collision_driver.finalize). Candidates
// past nconmax are dropped and counted in ncollision.

#include "common.cuh"

#define MAXCON 128
#define MAXSTRIDE 10

struct Params {
  const float* qpos;
  const float* qvel;
  const float* geom_xpos;
  const float* geom_xmat;
  const float* subtree_com;
  const float* cdof;
  const int* pair_int;       // (npair, 8): t1 t2 g1 g2 b1 b2 condim -
  const float* pair_float;   // (npair, 18): friction5 solref2 solreffriction2
                             //   solimp5 margin includemargin invw invw_pyr
  const float* geom_size;
  const int* body_rootid;
  const float* body_dof_mask;  // (nbody, nv): dof moves body
  const int* fr_int;         // (nf): dof
  const float* fr_float;     // (nf, 9): solref2 solimp5 invweight loss
  const int* lim_int;        // (nl, 3): qposadr dofadr joint
  const float* lim_float;    // (nl, 11): lo hi margin solref2 solimp5 invw
  float* con_dist;
  float* con_pos;
  float* con_frame;
  float* con_includemargin;
  float* con_friction;
  float* con_solref;
  float* con_solreffriction;
  float* con_solimp;
  int* con_dim;
  int* con_geom;
  int* con_efc_address;
  float* efc_J;
  float* efc_pos;
  float* efc_margin;
  float* efc_D;
  float* efc_vel;
  float* efc_aref;
  float* efc_frictionloss;
  int* efc_type;
  int* efc_id;
  bool* efc_active;
  int* ncon;
  int* ncollision;
  int* ne;
  int* nf;
  int* nl;
  int* nefc;
  float timestep;
  float impratio;
  int nworld;
  int nq;
  int nv;
  int nbody;
  int ngeom;
  int npair;
  int nconmax;
  int nf_rows;
  int nl_rows;
  int stride;
  int njmax;
  int refsafe;
  int fr_on;
  int lim_on;
};

enum { kPlane = 0, kSphere = 2, kCapsule = 3 };
enum { kFrictionDof = 1, kLimitJoint = 3, kFrictionless = 5,
       kPyramidal = 6, kElliptic = 7 };

// column 2 (the z axis) of a row-major rotation matrix
DEV void zaxis(const float* m, float* z) {
  z[0] = m[2]; z[1] = m[5]; z[2] = m[8];
}

// sphere-vs-point tail: normal, distance and midpoint
DEV float sphere_like(const float* n_raw, float r1, float r2,
                      const float* ref, float* pos, float* n) {
  float cdist = sqrtf(dot3(n_raw, n_raw));
  if (cdist < 1e-12f) {
    n[0] = 1.0f; n[1] = 0.0f; n[2] = 0.0f;
  } else {
    for (int i = 0; i < 3; ++i) n[i] = n_raw[i] / cdist;
  }
  float dist = cdist - (r1 + r2);
  for (int i = 0; i < 3; ++i) pos[i] = ref[i] + n[i] * (r1 + 0.5f * dist);
  return dist;
}

DEV void closest_segment_point(const float* a, const float* b,
                               const float* pt, float* out) {
  float ab[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
  float ap[3] = {pt[0] - a[0], pt[1] - a[1], pt[2] - a[2]};
  float denom = dot3(ab, ab);
  float t = dot3(ap, ab) / (denom < 1e-14f ? 1.0f : denom);
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  for (int i = 0; i < 3; ++i) out[i] = a[i] + t * ab[i];
}

DEV void closest_segment_segment(const float* a0, const float* a1,
                                 const float* b0, const float* b1,
                                 float* pa, float* pb) {
  float d1[3], d2[3], r[3];
  for (int i = 0; i < 3; ++i) {
    d1[i] = a1[i] - a0[i]; d2[i] = b1[i] - b0[i]; r[i] = a0[i] - b0[i];
  }
  float a = dot3(d1, d1), e = dot3(d2, d2), f = dot3(d2, r);
  float c = dot3(d1, r), b = dot3(d1, d2);
  float denom = a * e - b * b;
  float s = denom > 1e-14f ?
      fminf(fmaxf((b * f - c * e) / denom, 0.0f), 1.0f) : 0.0f;
  float t = (b * s + f) / (e > 1e-14f ? e : 1.0f);
  float tc = fminf(fmaxf(t, 0.0f), 1.0f);
  if (t != tc) s = fminf(fmaxf((b * tc - c) / (a > 1e-14f ? a : 1.0f),
                               0.0f), 1.0f);
  for (int i = 0; i < 3; ++i) {
    pa[i] = a0[i] + d1[i] * s;
    pb[i] = b0[i] + d2[i] * tc;
  }
}

struct Pool {
  int count;                 // candidates with dist < margin
  int pair[MAXCON];          // pair of each filled slot
};

// append one candidate contact to the pool if it is within the margin
DEV void emit(const Params& p, int w, Pool& pool, int pr, float dist,
              const float* pos, const float* n) {
  const float* pf = p.pair_float + 18 * pr;
  const int* pi = p.pair_int + 8 * pr;
  if (!(dist < pf[14])) return;
  const int s = pool.count++;
  if (s >= p.nconmax) return;
  pool.pair[s] = pr;
  const size_t c = (size_t)w * p.nconmax + s;
  p.con_dist[c] = dist;
  for (int i = 0; i < 3; ++i) p.con_pos[3 * c + i] = pos[i];
  make_frame(n, p.con_frame + 9 * c);
  p.con_includemargin[c] = pf[15];
  for (int i = 0; i < 5; ++i) p.con_friction[5 * c + i] = pf[i];
  for (int i = 0; i < 2; ++i) p.con_solref[2 * c + i] = pf[5 + i];
  for (int i = 0; i < 2; ++i) p.con_solreffriction[2 * c + i] = pf[7 + i];
  for (int i = 0; i < 5; ++i) p.con_solimp[5 * c + i] = pf[9 + i];
  p.con_dim[c] = pi[6];
  p.con_geom[2 * c] = pi[2];
  p.con_geom[2 * c + 1] = pi[3];
}

// narrowphase of one candidate pair (collision_primitive colliders)
DEV void collide(const Params& p, int w, Pool& pool, int pr) {
  const int* pi = p.pair_int + 8 * pr;
  const int t1 = pi[0], t2 = pi[1], g1 = pi[2], g2 = pi[3];
  const float* p1 = p.geom_xpos + ((size_t)w * p.ngeom + g1) * 3;
  const float* p2 = p.geom_xpos + ((size_t)w * p.ngeom + g2) * 3;
  const float* m1 = p.geom_xmat + ((size_t)w * p.ngeom + g1) * 9;
  const float* m2 = p.geom_xmat + ((size_t)w * p.ngeom + g2) * 9;
  const float* s1 = p.geom_size + 3 * g1;
  const float* s2 = p.geom_size + 3 * g2;
  float n[3], pos[3], a[3], b[3];
  if (t1 == kPlane) {
    zaxis(m1, n);
    if (t2 == kSphere) {
      float d[3] = {p2[0] - p1[0], p2[1] - p1[1], p2[2] - p1[2]};
      float dist = dot3(d, n) - s2[0];
      for (int i = 0; i < 3; ++i) pos[i] = p2[i] - n[i] * (s2[0] + 0.5f * dist);
      emit(p, w, pool, pr, dist, pos, n);
    } else {                                   // capsule: both end caps
      float ax[3];
      zaxis(m2, ax);
      for (int e = 0; e < 2; ++e) {
        float sg = e == 0 ? 1.0f : -1.0f, end[3], d[3];
        for (int i = 0; i < 3; ++i) {
          end[i] = p2[i] + sg * (ax[i] * s2[1]);
          d[i] = end[i] - p1[i];
        }
        float dist = dot3(d, n) - s2[0];
        for (int i = 0; i < 3; ++i)
          pos[i] = end[i] - n[i] * (s2[0] + 0.5f * dist);
        emit(p, w, pool, pr, dist, pos, n);
      }
    }
    return;
  }
  float nraw[3];
  const float* ref = p1;
  if (t1 == kSphere && t2 == kSphere) {
    for (int i = 0; i < 3; ++i) nraw[i] = p2[i] - p1[i];
  } else if (t1 == kSphere) {                  // sphere - capsule
    float ax[3];
    zaxis(m2, ax);
    for (int i = 0; i < 3; ++i) {
      a[i] = p2[i] - ax[i] * s2[1];
      b[i] = p2[i] + ax[i] * s2[1];
    }
    float pt[3];
    closest_segment_point(a, b, p1, pt);
    for (int i = 0; i < 3; ++i) nraw[i] = pt[i] - p1[i];
  } else {                                     // capsule - capsule
    float ax1[3], ax2[3], a1[3], b1[3], pa[3], pb[3];
    zaxis(m1, ax1);
    zaxis(m2, ax2);
    for (int i = 0; i < 3; ++i) {
      a[i] = p1[i] - ax1[i] * s1[1];
      a1[i] = p1[i] + ax1[i] * s1[1];
      b[i] = p2[i] - ax2[i] * s2[1];
      b1[i] = p2[i] + ax2[i] * s2[1];
    }
    closest_segment_segment(a, a1, b, b1, pa, pb);
    for (int i = 0; i < 3; ++i) nraw[i] = pb[i] - pa[i];
    float dist = sphere_like(nraw, s1[0], s2[0], pa, pos, n);
    emit(p, w, pool, pr, dist, pos, n);
    return;
  }
  float dist = sphere_like(nraw, s1[0], s2[0], ref, pos, n);
  emit(p, w, pool, pr, dist, pos, n);
}

// finish one efc row whose Jacobian is already written
DEV void row(const Params& p, size_t r, float pos, float margin, float D,
             float vel, float aref, float loss, int type, int id,
             bool active) {
  p.efc_pos[r] = pos;
  p.efc_margin[r] = margin;
  p.efc_D[r] = D;
  p.efc_vel[r] = vel;
  p.efc_aref[r] = aref;
  p.efc_frictionloss[r] = loss;
  p.efc_type[r] = type;
  p.efc_id[r] = id;
  p.efc_active[r] = active;
}

template <bool ELL>
DEV void contact_world(const Params& p, int w) {
  const int nv = p.nv, K = p.nconmax, S = p.stride;
  const float* qpos = p.qpos + (size_t)w * p.nq;
  const float* qvel = p.qvel + (size_t)w * nv;
  const float* com = p.subtree_com + (size_t)w * p.nbody * 3;
  const float* cdof = p.cdof + (size_t)w * nv * 6;
  float* J = p.efc_J + (size_t)w * p.njmax * nv;
  const size_t r0 = (size_t)w * p.njmax;

  // ---- narrowphase + order-keeping compaction ----
  Pool pool;
  pool.count = 0;
  for (int pr = 0; pr < p.npair; ++pr) collide(p, w, pool, pr);
  const int ncon = min(pool.count, K);
  p.ncollision[w] = pool.count;
  p.ncon[w] = ncon;
  for (int s = ncon; s < K; ++s) {
    const size_t c = (size_t)w * K + s;
    p.con_dist[c] = 1e10f;
    for (int i = 0; i < 3; ++i) p.con_pos[3 * c + i] = 0.0f;
    for (int i = 0; i < 9; ++i) p.con_frame[9 * c + i] = 0.0f;
    p.con_includemargin[c] = 0.0f;
    for (int i = 0; i < 5; ++i) p.con_friction[5 * c + i] = 1.0f;
    for (int i = 0; i < 2; ++i) p.con_solref[2 * c + i] = 0.02f;
    for (int i = 0; i < 2; ++i) p.con_solreffriction[2 * c + i] = 0.0f;
    for (int i = 0; i < 5; ++i) p.con_solimp[5 * c + i] = 0.9f;
    p.con_dim[c] = 1;
    p.con_geom[2 * c] = -1;
    p.con_geom[2 * c + 1] = -1;
  }
  const int nrow_static = p.nf_rows + p.nl_rows;
  for (int s = 0; s < K; ++s)
    p.con_efc_address[(size_t)w * K + s] = s < ncon ? nrow_static + S * s : -1;

  int nf_act = 0, nl_act = 0, nefc = 0;
  float k, b, imp;

  // ---- dof friction rows ----
  for (int i = 0; i < p.nf_rows; ++i) {
    const float* f = p.fr_float + 9 * i;
    const int dof = p.fr_int[i];
    const bool on = p.fr_on != 0;
    for (int n = 0; n < nv; ++n) J[(size_t)i * nv + n] = 0.0f;
    if (on) J[(size_t)i * nv + dof] = 1.0f;
    const float vel = qvel[dof];
    kbi(f, f + 2, 0.0f, p.timestep, p.refsafe, &k, &b, &imp);
    const float act = on ? 1.0f : 0.0f;
    const float D = 1.0f / fmaxf(f[7] * (1.0f - imp) / imp, kMinVal) * act;
    row(p, r0 + i, 0.0f, 0.0f, D, vel, (-k * imp * 0.0f - b * vel) * act,
        f[8] * act, kFrictionDof, dof, on);
    nf_act += on;
  }

  // ---- joint limit rows ----
  for (int i = 0; i < p.nl_rows; ++i) {
    const int* li = p.lim_int + 3 * i;
    const float* lf = p.lim_float + 11 * i;
    const int r = p.nf_rows + i;
    const float q = qpos[li[0]];
    const float dmin = q - lf[0], dmax = lf[1] - q;
    const float pos = fminf(dmin, dmax) - lf[2];
    const bool on = (pos < 0.0f) && p.lim_on != 0;
    const float sign = dmin < dmax ? 1.0f : -1.0f;
    for (int n = 0; n < nv; ++n) J[(size_t)r * nv + n] = 0.0f;
    if (on) J[(size_t)r * nv + li[1]] = sign;
    const float vel = sign * qvel[li[1]];
    kbi(lf + 3, lf + 5, pos, p.timestep, p.refsafe, &k, &b, &imp);
    const float act = on ? 1.0f : 0.0f;
    const float D = 1.0f / fmaxf(lf[10] * (1.0f - imp) / imp, kMinVal) * act;
    row(p, r0 + r, pos + lf[2], lf[2], D, vel,
        (-k * imp * pos - b * vel) * act, 0.0f, kLimitJoint, li[2], on);
    nl_act += on;
  }

  // ---- contact rows, S per pool slot ----
  for (int s = 0; s < K; ++s) {
    const int base = nrow_static + S * s;
    const size_t c = (size_t)w * K + s;
    if (s >= ncon) {
      for (int r = 0; r < S; ++r) {
        for (int n = 0; n < nv; ++n) J[(size_t)(base + r) * nv + n] = 0.0f;
        row(p, r0 + base + r, 1e10f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
            kFrictionless, s, false);
      }
      continue;
    }
    const int pr = pool.pair[s];
    const int* pi = p.pair_int + 8 * pr;
    const float* pf = p.pair_float + 18 * pr;
    const int b1 = pi[4], b2 = pi[5], dim = pi[6];
    const float incl = pf[15];
    const float posv = p.con_dist[c] - incl;
    const bool active = posv < 0.0f;
    const float* f = p.con_frame + 9 * c;
    const float* cpos = p.con_pos + 3 * c;
    const float* com1 = com + 3 * p.body_rootid[b1];
    const float* com2 = com + 3 * p.body_rootid[b2];
    float off1[3], off2[3], q1[3][3], q2[3][3];
    for (int i = 0; i < 3; ++i) {
      off1[i] = cpos[i] - com1[i];
      off2[i] = cpos[i] - com2[i];
    }
    for (int fr = 0; fr < 3; ++fr) {
      cross3(f + 3 * fr, off1, q1[fr]);
      cross3(f + 3 * fr, off2, q2[fr]);
    }
    kbi(pf + 5, pf + 9, posv, p.timestep, p.refsafe, &k, &b, &imp);
    float vel[MAXSTRIDE];
    for (int r = 0; r < S; ++r) vel[r] = 0.0f;
    const float* mask1 = p.body_dof_mask + (size_t)b1 * nv;
    const float* mask2 = p.body_dof_mask + (size_t)b2 * nv;
    for (int n = 0; n < nv; ++n) {
      const float* A = cdof + 6 * n;
      const float* L = A + 3;
      const float m1 = mask1[n], m2 = mask2[n];
      // jp: translation rows of the normal and tangents; jr: rotation
      float jp[3], jr[3];
      for (int fr = 0; fr < 3; ++fr) {
        const float fl = dot3(f + 3 * fr, L);
        jp[fr] = m2 * (fl - dot3(q2[fr], A)) - m1 * (fl - dot3(q1[fr], A));
        jr[fr] = (m2 - m1) * dot3(f + 3 * fr, A);
      }
      const float jdir[5] = {jp[1], jp[2], jr[0], jr[1], jr[2]};
      for (int r = 0; r < S; ++r) {
        float v;
        bool exists;
        if constexpr (ELL) {       // row 0 the normal, then jdir[r - 1]
          v = r == 0 ? jp[0] : jdir[r - 1];
          exists = active && r < max(dim, 1);
        } else {
          const int kidx = r / 2;
          const float sign = (r % 2 == 0) ? 1.0f : -1.0f;
          const bool fl_row = dim == 1 && r == 0;
          exists = active && (fl_row || (dim > 1 && r < 2 * (dim - 1)));
          v = fl_row ? jp[0] : jp[0] + sign * pf[kidx] * jdir[kidx];
        }
        J[(size_t)(base + r) * nv + n] = exists ? v : 0.0f;
        vel[r] += v * qvel[n];
      }
    }
    if constexpr (ELL) {
      // row 0: the standard impedance on invw; row r >= 1: D_0 impratio
      // (mu_r / mu_1)^2 and aref = -b_f vel_r, b_f from solreffriction
      // when that is set
      const float d0 = 1.0f / fmaxf(pf[16] * (1.0f - imp) / imp, kMinVal);
      const float* srf = pf + 7;
      const bool use_srf = fabsf(srf[0]) > 1e-12f || fabsf(srf[1]) > 1e-12f;
      const float b_f = use_srf ?
          2.0f / fmaxf(fminf(fmaxf(pf[10], 0.0001f), 0.9999f) * srf[0],
                       kMinVal) : b;
      for (int r = 0; r < S; ++r) {
        const bool exists = active && r < max(dim, 1);
        const float act = exists ? 1.0f : 0.0f;
        float D, aref;
        if (r == 0) {
          D = d0;
          aref = -k * imp * posv - b * vel[0];
        } else {
          const float ratio = pf[min(r - 1, 4)] / fmaxf(pf[0], kMinVal);
          D = d0 * p.impratio * (ratio * ratio);
          aref = -b_f * vel[r];
        }
        row(p, r0 + base + r, posv + incl, incl, D * act, vel[r], aref * act,
            0.0f, dim == 1 ? kFrictionless : kElliptic, s, exists);
        nefc += exists;
      }
      continue;
    }
    const float iw = dim == 1 ? pf[16] : pf[17];
    const float dval = 1.0f / fmaxf(iw * (1.0f - imp) / imp, kMinVal);
    for (int r = 0; r < S; ++r) {
      const bool exists = active && ((dim == 1 && r == 0) ||
                                     (dim > 1 && r < 2 * (dim - 1)));
      const float act = exists ? 1.0f : 0.0f;
      row(p, r0 + base + r, posv + incl, incl, dval * act, vel[r],
          (-k * imp * posv - b * vel[r]) * act, 0.0f,
          dim == 1 ? kFrictionless : kPyramidal, s, exists);
      nefc += exists;
    }
  }
  p.ne[w] = 0;
  p.nf[w] = nf_act;
  p.nl[w] = nl_act;
  p.nefc[w] = nefc + nf_act + nl_act;
}

__global__ void contact_kernel(const Params p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.nworld) return;
  contact_world<false>(p, w);
}

__global__ void contact_ell_kernel(const Params p) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.nworld) return;
  contact_world<true>(p, w);
}

PORT_C_INTERFACE(Params, contact_kernel, 32)
PORT_C_ENTRY(ell_, Params, contact_ell_kernel, 32, nworld)
