// Kernel B2: collision and constraint rows, one warp per world (WARPS
// worlds a block) — narrowphase over the static candidate pairs (plane,
// sphere and capsule primitives, plane-box), order-keeping compaction of
// the contacts into the pool, and the efc rows: joint equalities, dof
// friction, joint limits and contacts of the pyramidal cone
// (contact_kernel) or of the elliptic cone (contact_ell_kernel); all run
// contact_warp<ELL, EQBOX>(). A model with joint equalities or plane-box
// pairs launches the EQBOX entries (contact_eqbox_kernel,
// contact_eqbox_ell_kernel), whose branches need more registers: the
// other entries keep 64 registers and their code. The JAX
// package builds elliptic rows with XLA (its contact kernel takes the
// pyramidal cone alone, contact_kernels.py:57); this kernel builds them
// as mujoco_warp_tpu/constraint.py:479-517 does.
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
// The design, one warp per world:
// - narrowphase: lane l takes the candidate rows 32k + l of the table (a
//   row per pair, or per contact of a plane-box pair: its row k holds the
//   corner of depth rank k); a warp scan of each lane's count of contacts
//   within the margin (a plane-capsule pair has two, its end caps in
//   order) gives every contact its slot, so slot k is the k-th candidate
//   with dist < margin in pair order, then rank order, as in the JAX
//   package (collision_driver.finalize); candidates past nconmax are
//   dropped and counted in ncollision. The slots stay in shared memory
//   (PoolMem);
// - lanes over slots (impedances, the empty slots' fields) and over rows
//   (the static rows' scalars: equalities, friction, limits; the empty
//   slots' rows); every row of
//   efc_J is written by lanes over dofs, so its stores are coalesced, and
//   the empty slots' rows are one zero run at the end of the world's
//   block;
// - each contact's rows: lane n on dof n (n + 32, ... where nv > 32);
//   efc_vel[r] = sum_n J[r, n] qvel[n] runs in dof order as one chain on
//   lane r, from the rows' entries in shared memory.
// Every output keeps the bits of the one-thread-per-world design this
// replaced (the same arithmetic per element; two products are rounded
// explicitly where that design's loops kept them apart).

#include "common.cuh"

// nconmax is capped at 128 by the wrapper (kernels/contact.py, MAXCON):
// a world's PoolMem is then at most 10 KB of shared memory
#define MAXSTRIDE 10         // rows of a pyramidal contact (condim <= 6)
#define WARPS 4              // worlds (warps) per block
#define MIN_BLOCKS 8         // blocks per SM: 64 registers, no spills
// the entries with equality rows and plane-box pairs (EQBOX): their
// branches need 72 registers (ptxas spilled them at 64)
#define MIN_BLOCKS_EQBOX 7

struct Params {
  const float* qpos;
  const float* qvel;
  const float* geom_xpos;
  const float* geom_xmat;
  const float* subtree_com;
  const float* cdof;
  const bool* eq_active;     // (nworld, ne_rows): the world's equalities
  const int* pair_int;       // (ncand, 8): t1 t2 g1 g2 b1 b2 condim rank
  const float* pair_float;   // (ncand, 18): friction5 solref2 solreffriction2
                             //   solimp5 margin includemargin invw invw_pyr
  const float* geom_size;
  const int* body_rootid;
  const float* body_dof_mask;  // (nbody, nv): dof moves body
  const int* eq_int;         // (ne, 4): dof1 qposadr1 dof2 qposadr2 (-1 -1
                             //   for one joint)
  const float* eq_float;     // (ne, 15): qpos0 1 and 2, polycoef5, invw,
                             //   solref2 solimp5
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
  int ncand;
  int nconmax;
  int ne_rows;
  int nf_rows;
  int nl_rows;
  int stride;
  int njmax;
  int refsafe;
  int eq_on;
  int fr_on;
  int lim_on;
};

enum { kPlane = 0, kSphere = 2, kCapsule = 3, kBox = 6 };
enum { kEquality = 0, kFrictionDof = 1, kLimitJoint = 3, kFrictionless = 5,
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

// A world's scratch in shared memory: per pool slot the pair, dist, pos
// and frame of its contact and its impedance (k, b, imp); and the entries
// of one contact's rows over 32 dofs (row r at v[33 r], padded against
// bank conflicts)
struct PoolMem {
  int* pair;
  float* dist;
  float* pos;
  float* frame;
  float* kbi;
  float* v;
};

__host__ __device__ inline int pool_words(int nconmax, int stride) {
  return 17 * nconmax + 33 * stride;
}

DEV PoolMem pool_at(float* base, int nconmax) {
  PoolMem s;
  s.pair = reinterpret_cast<int*>(base);
  s.dist = base + nconmax;
  s.pos = s.dist + nconmax;
  s.frame = s.pos + 3 * nconmax;
  s.kbi = s.frame + 9 * nconmax;
  s.v = s.kbi + 3 * nconmax;
  return s;
}

// the contacts of one candidate pair before the margin test: the plane-
// capsule pair gives its two end caps in order, the others one contact
struct Cand {
  int n;
  float dist[2], pos[2][3], nrm[2][3];
};

DEV void cand(Cand& c, int e, float dist, const float* pos, const float* n) {
  c.dist[e] = dist;
  for (int i = 0; i < 3; ++i) {
    c.pos[e][i] = pos[i];
    c.nrm[e][i] = n[i];
  }
}

// corner i (x slowest, b = 0 the negative side: 4 bx + 2 by + bz) of a
// box, each product rounded and the sums in one order, as
// collision_primitive.plane_box computes it
DEV void box_corner(const float* pos, const float* mat, const float* size,
                    int i, float* c) {
  const float h[3] = {(i & 4) ? size[0] : -size[0],
                      (i & 2) ? size[1] : -size[1],
                      (i & 1) ? size[2] : -size[2]};
  for (int r = 0; r < 3; ++r)
    c[r] = pos[r] + ((__fmul_rn(mat[3 * r], h[0]) +
                      __fmul_rn(mat[3 * r + 1], h[1])) +
                     __fmul_rn(mat[3 * r + 2], h[2]));
}

// a . n, the products rounded and summed in order
DEV float dot3_rn(float a0, float a1, float a2, const float* n) {
  return (__fmul_rn(a0, n[0]) + __fmul_rn(a1, n[1])) + __fmul_rn(a2, n[2]);
}

// depth below the plane of corner i of a box whose center lies at depth
// `base`, the half-extent c along the box axis c adding +-a[c]: the sums
// in one order, as collision_primitive.plane_box, so that corners at
// equal depth tie in both versions
DEV float corner_depth(float base, const float* a, int i) {
  return base + (((i & 4) ? a[0] : -a[0]) + ((i & 2) ? a[1] : -a[1]) +
                 ((i & 1) ? a[2] : -a[2]));
}

// narrowphase of one candidate row (collision_primitive colliders; the
// plane-box pair with EQBOX)
template <bool EQBOX>
DEV void collide(const Params& p, int w, int pr, Cand& c) {
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
      cand(c, 0, dist, pos, n);
      c.n = 1;
    } else if (EQBOX && t2 == kBox) {
      // the corner of depth rank pi[7] among the 8, ties to the lower
      // corner index (the order of jax.lax.top_k): pi[7] + 1 passes, each
      // taking the least (depth, index) past the last pass's, so that no
      // lane holds the 8 depths (B2's 64 registers)
      const float base = dot3_rn(p2[0] - p1[0], p2[1] - p1[1], p2[2] - p1[2],
                                 n);
      for (int k = 0; k < 3; ++k)
        b[k] = __fmul_rn(s2[k], dot3_rn(m2[k], m2[3 + k], m2[6 + k], n));
      int pick = -1;
      float dist = 0.0f;
      for (int r = 0; r <= pi[7]; ++r) {
        int best = -1;
        float least = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = corner_depth(base, b, i);
          const bool past = pick < 0 || d > dist || (d == dist && i > pick);
          if (past && (best < 0 || d < least)) {
            best = i;
            least = d;
          }
        }
        pick = best;
        dist = least;
      }
      box_corner(p2, m2, s2, pick, a);
      for (int i = 0; i < 3; ++i) pos[i] = a[i] - __fmul_rn(0.5f * dist, n[i]);
      cand(c, 0, dist, pos, n);
      c.n = 1;
    } else {                                   // capsule: both end caps
      float ax[3];
      zaxis(m2, ax);
      // ax s2[1] is rounded before the sign multiplies it, as in the
      // one-thread design whose loop over the caps ran with a run-time
      // sign; unrolled, the sign would fold and the product contract
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sg = e == 0 ? 1.0f : -1.0f, end[3], d[3];
        for (int i = 0; i < 3; ++i) {
          end[i] = p2[i] + sg * __fmul_rn(ax[i], s2[1]);
          d[i] = end[i] - p1[i];
        }
        float dist = dot3(d, n) - s2[0];
        for (int i = 0; i < 3; ++i)
          pos[i] = end[i] - n[i] * (s2[0] + 0.5f * dist);
        cand(c, e, dist, pos, n);
      }
      c.n = 2;
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
    cand(c, 0, dist, pos, n);
    c.n = 1;
    return;
  }
  float dist = sphere_like(nraw, s1[0], s2[0], ref, pos, n);
  cand(c, 0, dist, pos, n);
  c.n = 1;
}

// slot s of world w's pool, if below nconmax, takes a contact of pair pr
DEV void store(const Params& p, const PoolMem& pool, int w, int s,
               int pr, float dist, const float* pos, const float* n) {
  if (s >= p.nconmax) return;
  const float* pf = p.pair_float + 18 * pr;
  const int* pi = p.pair_int + 8 * pr;
  const size_t c = (size_t)w * p.nconmax + s;
  float f[9];
  make_frame(n, f);
  pool.pair[s] = pr;
  pool.dist[s] = dist;
  p.con_dist[c] = dist;
  for (int i = 0; i < 3; ++i) {
    pool.pos[3 * s + i] = pos[i];
    p.con_pos[3 * c + i] = pos[i];
  }
  for (int i = 0; i < 9; ++i) {
    pool.frame[9 * s + i] = f[i];
    p.con_frame[9 * c + i] = f[i];
  }
  p.con_includemargin[c] = pf[15];
  for (int i = 0; i < 5; ++i) p.con_friction[5 * c + i] = pf[i];
  for (int i = 0; i < 2; ++i) p.con_solref[2 * c + i] = pf[5 + i];
  for (int i = 0; i < 2; ++i) p.con_solreffriction[2 * c + i] = pf[7 + i];
  for (int i = 0; i < 5; ++i) p.con_solimp[5 * c + i] = pf[9 + i];
  p.con_dim[c] = pi[6];
  p.con_geom[2 * c] = pi[2];
  p.con_geom[2 * c + 1] = pi[3];
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

// a joint equality's pos = q1 - qpos0_1 - poly(dif), dif = q2 - qpos0_2
// (poly(dif) = polycoef[0] for one joint), and deriv = poly'(dif), each
// product rounded as constraint._equality_rows rounds it
DEV float eq_joint(const int* ei, const float* ef, const float* qpos,
                   float* deriv) {
  const float* c = ef + 2;
  const float q1 = qpos[ei[1]] - ef[0];
  if (ei[2] < 0) {
    *deriv = 0.0f;
    return q1 - c[0];
  }
  const float dif = qpos[ei[3]] - ef[1];
  const float rhs = c[0] + __fmul_rn(dif, c[1] + __fmul_rn(dif, c[2] +
      __fmul_rn(dif, c[3] + __fmul_rn(dif, c[4]))));
  *deriv = c[1] + __fmul_rn(dif, 2.0f * c[2] + __fmul_rn(
      dif, __fmul_rn(3.0f, c[3]) + __fmul_rn(dif * 4.0f, c[4])));
  return q1 - rhs;
}

// the equality rows (none without EQBOX), read from the parameters where
// they are used: a local copy held a register through the rows
#define NE (EQBOX ? p.ne_rows : 0)
#define NEF (NE + p.nf_rows)

template <bool ELL, bool EQBOX>
DEV void contact_warp(const Params& p, const PoolMem& pool, int w,
                      int lane) {
  const int nv = p.nv, K = p.nconmax, S = p.stride;
  const float* qpos = p.qpos + (size_t)w * p.nq;
  const float* qvel = p.qvel + (size_t)w * nv;
  const float* com = p.subtree_com + (size_t)w * p.nbody * 3;
  const float* cdof = p.cdof + (size_t)w * nv * 6;
  float* J = p.efc_J + (size_t)w * p.njmax * nv;
  const size_t r0 = (size_t)w * p.njmax;

  // ---- narrowphase + order-keeping compaction, 32 candidates a round ----
  int count = 0;               // candidates with dist < margin so far
  for (int k0 = 0; k0 < p.ncand; k0 += 32) {
    const int pr = k0 + lane;
    Cand c;
    c.n = 0;
    if (pr < p.ncand) collide<EQBOX>(p, w, pr, c);
    const float margin = pr < p.ncand ? p.pair_float[18 * pr + 14] : 0.0f;
    const bool keep0 = c.n > 0 && c.dist[0] < margin;
    const bool keep1 = c.n > 1 && c.dist[1] < margin;
    const int mine = (int)keep0 + (int)keep1;
    int incl = mine;             // inclusive scan over the lanes
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(FULL_MASK, incl, d);
      if (lane >= d) incl += up;
    }
    const int s = count + incl - mine;
    if (keep0) store(p, pool, w, s, pr, c.dist[0], c.pos[0], c.nrm[0]);
    if (keep1)
      store(p, pool, w, s + (int)keep0, pr, c.dist[1], c.pos[1], c.nrm[1]);
    count += __shfl_sync(FULL_MASK, incl, 31);
  }
  const int ncon = min(count, K);
  const int nrow_static = NEF + p.nl_rows;
  __syncwarp();

  // ---- per slot: efc address, impedance, the empty slots' fields ----
  for (int s = lane; s < K; s += 32) {
    const size_t c = (size_t)w * K + s;
    p.con_efc_address[c] = s < ncon ? nrow_static + S * s : -1;
    if (s < ncon) {
      const float* pf = p.pair_float + 18 * pool.pair[s];
      float* kb = pool.kbi + 3 * s;
      kbi(pf + 5, pf + 9, pool.dist[s] - pf[15], p.timestep, p.refsafe,
          kb, kb + 1, kb + 2);
      continue;
    }
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

  // ---- equality, dof friction and joint limit rows: scalars a row per
  // lane ----
  int nl_act = 0;
  for (int i0 = 0; i0 < nrow_static; i0 += 32) {
    const int i = i0 + lane;
    bool lim_act = false;
    float k, b, imp;
    if (EQBOX && i < NE) {
      const int* ei = p.eq_int + 4 * i;
      const float* ef = p.eq_float + 15 * i;
      float deriv;
      const float pos = eq_joint(ei, ef, qpos, &deriv);
      const float vel = ei[2] < 0 ? qvel[ei[0]] :
          qvel[ei[0]] - __fmul_rn(deriv, qvel[ei[2]]);
      const bool on = p.eq_on != 0 && p.eq_active[(size_t)w * NE + i];
      kbi(ef + 8, ef + 10, pos, p.timestep, p.refsafe, &k, &b, &imp);
      const float act = on ? 1.0f : 0.0f;
      const float D = 1.0f / fmaxf(ef[7] * (1.0f - imp) / imp, kMinVal) *
                      act;
      row(p, r0 + i, pos, 0.0f, D, vel, (-k * imp * pos - b * vel) * act,
          0.0f, kEquality, i, on);
    } else if (i < NEF) {
      const float* f = p.fr_float + 9 * (i - NE);
      const int dof = p.fr_int[i - NE];
      const bool on = p.fr_on != 0;
      const float vel = qvel[dof];
      kbi(f, f + 2, 0.0f, p.timestep, p.refsafe, &k, &b, &imp);
      const float act = on ? 1.0f : 0.0f;
      const float D = 1.0f / fmaxf(f[7] * (1.0f - imp) / imp, kMinVal) * act;
      row(p, r0 + i, 0.0f, 0.0f, D, vel, (-k * imp * 0.0f - b * vel) * act,
          f[8] * act, kFrictionDof, dof, on);
    } else if (i < nrow_static) {
      const int* li = p.lim_int + 3 * (i - NEF);
      const float* lf = p.lim_float + 11 * (i - NEF);
      const float q = qpos[li[0]];
      const float dmin = q - lf[0], dmax = lf[1] - q;
      const float pos = fminf(dmin, dmax) - lf[2];
      const bool on = (pos < 0.0f) && p.lim_on != 0;
      const float sign = dmin < dmax ? 1.0f : -1.0f;
      const float vel = sign * qvel[li[1]];
      kbi(lf + 3, lf + 5, pos, p.timestep, p.refsafe, &k, &b, &imp);
      const float act = on ? 1.0f : 0.0f;
      const float D = 1.0f / fmaxf(lf[10] * (1.0f - imp) / imp, kMinVal) *
                      act;
      row(p, r0 + i, pos + lf[2], lf[2], D, vel,
          (-k * imp * pos - b * vel) * act, 0.0f, kLimitJoint, li[2], on);
      lim_act = on;
    }
    nl_act += __popc(__ballot_sync(FULL_MASK, lim_act));
  }
  const int nf_act = p.fr_on != 0 ? p.nf_rows : 0;
  // their Jacobian rows, lanes over dofs: one nonzero where the row acts
  // (two for an equality of two joints: 1 at dof 1, -deriv at dof 2)
  for (int i = 0; i < nrow_static; ++i) {
    int dof, dof2 = -1;
    float one, two = 0.0f;
    if (EQBOX && i < NE) {
      const int* ei = p.eq_int + 4 * i;
      const bool on = p.eq_on != 0 && p.eq_active[(size_t)w * NE + i];
      float deriv;
      eq_joint(ei, p.eq_float + 15 * i, qpos, &deriv);
      dof = ei[0];
      dof2 = ei[2];
      one = on ? 1.0f : 0.0f;
      two = on ? -deriv : 0.0f;
    } else if (i < NEF) {
      dof = p.fr_int[i - NE];
      one = p.fr_on != 0 ? 1.0f : 0.0f;
    } else {
      const int* li = p.lim_int + 3 * (i - NEF);
      const float* lf = p.lim_float + 11 * (i - NEF);
      const float q = qpos[li[0]];
      const float dmin = q - lf[0], dmax = lf[1] - q;
      const bool on = (fminf(dmin, dmax) - lf[2] < 0.0f) && p.lim_on != 0;
      dof = li[1];
      one = on ? (dmin < dmax ? 1.0f : -1.0f) : 0.0f;
    }
    for (int n = lane; n < nv; n += 32)
      J[(size_t)i * nv + n] = n == dof2 ? two : (n == dof ? one : 0.0f);
  }

  // ---- the empty slots' rows: scalars a row per lane, J one zero run ----
  const int rows_end = nrow_static + S * K;
  const int empty = nrow_static + S * ncon;
  for (int r = empty + lane; r < rows_end; r += 32)
    row(p, r0 + r, 1e10f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, kFrictionless,
        (r - nrow_static) / S, false);
  for (size_t e = (size_t)empty * nv + lane; e < (size_t)rows_end * nv;
       e += 32)
    J[e] = 0.0f;

  // ---- contact rows, S per filled slot: lane n on dof n ----
  int nefc = 0;
  constexpr int RMAX = ELL ? 6 : MAXSTRIDE;
  for (int s = 0; s < ncon; ++s) {
    const int base = nrow_static + S * s;
    const int pr = pool.pair[s];
    const int* pi = p.pair_int + 8 * pr;
    const float* pf = p.pair_float + 18 * pr;
    const int b1 = pi[4], b2 = pi[5], dim = pi[6];
    const float incl = pf[15];
    const float posv = pool.dist[s] - incl;
    const bool active = posv < 0.0f;
    const float* f = pool.frame + 9 * s;
    const float* cpos = pool.pos + 3 * s;
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
    const float* mask1 = p.body_dof_mask + (size_t)b1 * nv;
    const float* mask2 = p.body_dof_mask + (size_t)b2 * nv;
    float vel = 0.0f;            // row `lane`'s, for lane < S
    for (int n0 = 0; n0 < nv; n0 += 32) {
      const int n = n0 + lane;
      if (n < nv) {
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
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r >= S) break;
          float v;
          bool exists;
          if constexpr (ELL) {     // row 0 the normal, then jdir[r - 1]
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
          pool.v[33 * r + lane] = v;
        }
      }
      __syncwarp();
      if (lane < S) {            // efc_vel in dof order, one chain a row
        const float* vr = pool.v + 33 * lane;
        const int len = min(32, nv - n0);
        for (int j = 0; j < len; ++j) vel += vr[j] * qvel[n0 + j];
      }
      __syncwarp();
    }
    const int r = lane;
    bool exists = false;
    if (r < S) {
      const float k = pool.kbi[3 * s], b = pool.kbi[3 * s + 1];
      const float imp = pool.kbi[3 * s + 2];
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
        exists = active && r < max(dim, 1);
        const float act = exists ? 1.0f : 0.0f;
        float D, aref;
        if (r == 0) {
          D = d0;
          aref = -k * imp * posv - b * vel;
        } else {
          const float ratio = pf[min(r - 1, 4)] / fmaxf(pf[0], kMinVal);
          D = d0 * p.impratio * (ratio * ratio);
          aref = -b_f * vel;
        }
        row(p, r0 + base + r, posv + incl, incl, D * act, vel, aref * act,
            0.0f, dim == 1 ? kFrictionless : kElliptic, s, exists);
      } else {
        const float iw = dim == 1 ? pf[16] : pf[17];
        const float dval = 1.0f / fmaxf(iw * (1.0f - imp) / imp, kMinVal);
        exists = active && ((dim == 1 && r == 0) ||
                            (dim > 1 && r < 2 * (dim - 1)));
        const float act = exists ? 1.0f : 0.0f;
        // -k imp posv rounded, then one fma with b vel: the one-thread
        // design computed the first product once outside its loop over
        // the rows
        const float aref = __fmaf_rn(-b, vel, __fmul_rn(-k * imp, posv));
        row(p, r0 + base + r, posv + incl, incl, dval * act, vel,
            aref * act, 0.0f,
            dim == 1 ? kFrictionless : kPyramidal, s, exists);
      }
    }
    nefc += __popc(__ballot_sync(FULL_MASK, exists));
  }
  // the active equality rows, counted here so that no register holds the
  // count through the contact rows
  int ne_act = 0;
  for (int i0 = 0; EQBOX && i0 < NE; i0 += 32) {
    const int i = i0 + lane;
    ne_act += __popc(__ballot_sync(FULL_MASK, i < NE && p.eq_on != 0 &&
                                   p.eq_active[(size_t)w * NE + i]));
  }
  if (lane == 0) {
    // nconmax 0: no pool, no collision (collision_driver.collision)
    p.ncollision[w] = K > 0 ? count : 0;
    p.ncon[w] = ncon;
    p.ne[w] = ne_act;
    p.nf[w] = nf_act;
    p.nl[w] = nl_act;
    p.nefc[w] = nefc + ne_act + nf_act + nl_act;
  }
}

#undef NE
#undef NEF

template <bool ELL, bool EQBOX>
DEV void contact_block(const Params& p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int w = blockIdx.x * WARPS + wb;
  if (w >= p.nworld) return;
  const int words = pool_words(p.nconmax, p.stride);
  contact_warp<ELL, EQBOX>(p, pool_at(smem + wb * words, p.nconmax), w,
                           lane);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
contact_kernel(const Params p) {
  contact_block<false, false>(p);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
contact_ell_kernel(const Params p) {
  contact_block<true, false>(p);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS_EQBOX)
contact_eqbox_kernel(const Params p) {
  contact_block<false, true>(p);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS_EQBOX)
contact_eqbox_ell_kernel(const Params p) {
  contact_block<true, true>(p);
}

PORT_C_WARP_INTERFACE(Params, contact_kernel, WARPS,
                      4 * pool_words(p->nconmax, p->stride))
PORT_C_WARP_ENTRY(ell_, Params, contact_ell_kernel, WARPS,
                  4 * pool_words(p->nconmax, p->stride))
PORT_C_WARP_ENTRY(eqbox_, Params, contact_eqbox_kernel, WARPS,
                  4 * pool_words(p->nconmax, p->stride))
PORT_C_WARP_ENTRY(eqbox_ell_, Params, contact_eqbox_ell_kernel, WARPS,
                  4 * pool_words(p->nconmax, p->stride))
