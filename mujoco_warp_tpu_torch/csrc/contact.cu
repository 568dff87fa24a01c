// Kernel B2: collision and constraint rows, one warp per world (WARPS
// worlds a block) — narrowphase over the static candidate pairs (plane,
// sphere and capsule primitives, plane-box), order-keeping compaction of
// the contacts into the pool, and the efc rows: joint equalities, dof
// friction, joint limits and contacts of the pyramidal cone
// (contact_kernel) or of the elliptic cone (contact_ell_kernel); all run
// contact_warp<ELL, EQBOX, BOXES>(). A model with joint equalities or
// plane-box pairs launches the EQBOX entries (contact_eqbox_kernel,
// contact_eqbox_ell_kernel), whose branches need more registers: the
// other entries keep 64 registers and their code. A model with
// capsule-box or box-box pairs launches the BOXES entries
// (contact_box_kernel, contact_box_ell_kernel), which also take EQBOX's
// branches, at their own launch bound. The JAX
// package builds elliptic rows with XLA (its contact kernel takes the
// pyramidal cone alone, contact_kernels.py:57); this kernel builds them
// as mujoco_warp_tpu/constraint.py:479-517 does.
//
// Replaces: mujoco_warp_tpu/pallas/contact_kernels.py, contact_efc
// (:1643; body built by make_contact_kernel :1061; the capsule-box and
// box-box colliders _capsule_box_batch :260 and _box_box_batch :410).
// Plain version:
// mujoco_warp_tpu_torch/kernels/contact.py, plain() (collision_driver +
// constraint).
//
// What bounds it on the H100: bytes. Per world it reads the geom frames,
// subtree com and cdof (about 450 floats) and writes the efc rows, of
// which efc_J alone is 117 x 27 floats = 12.6 KB at nconmax 24: about
// 14 KB per world, 115 MB at 8192 worlds, 34 us at 3.35 TB/s. The
// narrowphase of 177 candidates is about 20k flops per world; a
// capsule-box pair takes 123 point-box distances, a box-box row the
// separating axes and a manifold of 24 candidates, so on apollo (48 and
// 6 such pairs) the narrowphase's instructions, not the bytes, set the
// time.
//
// The design, one warp per world:
// - narrowphase: lane l takes the candidate rows 32k + l of the table (a
//   row per pair, or per contact of a plane-box or a box-box pair: its row
//   k holds the contact of depth rank k, a box-box lane repeating the
//   separating-axis test and the manifold, its 24 candidates in local
//   memory, for its rank, so that the pool order needs no second pass and
//   a lane holds at most two contacts); a warp scan of each lane's count
//   of contacts within the margin (a plane-capsule or a capsule-box pair
//   has two, in order) gives every contact its slot, so slot k is the
//   k-th candidate with dist < margin in pair order, then rank order, as
//   in the JAX package (collision_driver.finalize); candidates past
//   nconmax are
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
// the entries with capsule-box and box-box pairs (BOXES): up to 168
// registers (ptxas spilled them at 128), the box-box candidates in local
// memory
#define MIN_BLOCKS_BOX 3

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

// ---- capsule-box and box-box (the BOXES entries) ----
// Every product that feeds a sum is rounded (__fmul_rn: no fused
// multiply-add) and the sums run in the order of collision_primitive's
// capsule_box and collision_box.box_box, so that the kernel keeps the
// plain version's bits: which samples reach a flat minimum, or which
// candidate is valid at a clipping boundary, decides a contact.

// a . b, the products rounded and summed in order
DEV float dot3r(const float* a, const float* b) {
  return (__fmul_rn(a[0], b[0]) + __fmul_rn(a[1], b[1])) +
         __fmul_rn(a[2], b[2]);
}

// signed distance from the surface of a box of half-sizes h (box frame)
// to the point c, the closest point and the normal from the box toward c
// (collision_primitive._point_box): a point inside is pushed out through
// the face of least clearance, the first of equal ones
DEV float point_box(const float* c, const float* h, float* closest,
                    float* normal) {
  float cl[3], dv[3], clear[3];
  bool inside = true;
  for (int i = 0; i < 3; ++i) {
    cl[i] = fminf(fmaxf(c[i], -h[i]), h[i]);
    dv[i] = c[i] - cl[i];
    clear[i] = h[i] - fabsf(c[i]);
    inside = inside && fabsf(c[i]) < h[i];
  }
  if (inside) {
    int ax = 0;
    if (clear[1] < clear[ax]) ax = 1;
    if (clear[2] < clear[ax]) ax = 2;
    const float sign = c[ax] >= 0.0f ? 1.0f : -1.0f;
    for (int i = 0; i < 3; ++i) {
      closest[i] = i == ax ? sign * h[ax] : c[i];
      normal[i] = i == ax ? sign : 0.0f;
    }
    return -clear[ax];
  }
  const float dn = sqrtf(dot3r(dv, dv));
  const float inv = dn < 1e-12f ? 1.0f : dn;
  for (int i = 0; i < 3; ++i) {
    closest[i] = cl[i];
    normal[i] = dv[i] / inv;
  }
  return dn;
}

// point_box's distance alone, at a + t seg
DEV float point_box_sd(const float* a, const float* seg, float t,
                       const float* h) {
  float c[3], cl[3], nrm[3];
  for (int i = 0; i < 3; ++i) c[i] = a[i] + __fmul_rn(t, seg[i]);
  return point_box(c, h, cl, nrm);
}

// m^T v and m v of a row-major 3x3 matrix
DEV void mtv3(const float* m, const float* v, float* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = (__fmul_rn(m[i], v[0]) + __fmul_rn(m[3 + i], v[1])) +
             __fmul_rn(m[6 + i], v[2]);
}

DEV void mv3(const float* m, const float* v, float* out) {
  for (int i = 0; i < 3; ++i) out[i] = dot3r(m + 3 * i, v);
}

// capsule (1) - box (2), two candidates (collision_primitive.capsule_box):
// the least signed distance of the capsule's segment to the box over 33
// samples, the first and the last sample within 1e-4 (1 + |min|) of it,
// each refined by 5 rounds of a shrinking 9-point window
DEV void capsule_box(const float* p1, const float* m1, const float* s1,
                     const float* p2, const float* m2, const float* s2,
                     Cand& c) {
  float ax[3], d[3], a[3], b[3], seg[3];
  zaxis(m1, ax);
  for (int i = 0; i < 3; ++i) d[i] = (p1[i] + __fmul_rn(ax[i], s1[1])) - p2[i];
  mtv3(m2, d, a);
  for (int i = 0; i < 3; ++i) d[i] = (p1[i] - __fmul_rn(ax[i], s1[1])) - p2[i];
  mtv3(m2, d, b);
  for (int i = 0; i < 3; ++i) seg[i] = b[i] - a[i];
  float sds[33];
  float sdmin = 0.0f;
  for (int i = 0; i < 33; ++i) {
    sds[i] = point_box_sd(a, seg, (float)i * (1.0f / 32.0f), s2);
    sdmin = i == 0 ? sds[i] : fminf(sdmin, sds[i]);
  }
  const float tol = __fmul_rn(1e-4f, 1.0f + fabsf(sdmin));
  int first = 33, last = -1;
  for (int i = 0; i < 33; ++i) {
    if (sds[i] <= sdmin + tol) {
      first = min(first, i);
      last = i;
    }
  }
  float ends[2] = {(float)first * (1.0f / 32.0f),
                   (float)last * (1.0f / 32.0f)};
  for (int e = 0; e < 2; ++e) {
    float t = ends[e], delta = 1.0f / 32.0f;
    for (int r = 0; r < 5; ++r) {
      float best = 0.0f, tbest = 0.0f;
      for (int o = 0; o < 9; ++o) {
        const float cand = fminf(fmaxf(
            t + __fmul_rn(((float)o - 4.0f) * 0.25f, delta), 0.0f), 1.0f);
        const float v = point_box_sd(a, seg, cand, s2) +
                        __fmul_rn(1e-6f, fabsf(cand - t));
        if (o == 0 || v < best) {
          best = v;
          tbest = cand;
        }
      }
      t = tbest;
      delta = delta * 0.25f;
    }
    float pt[3], cp[3], nl[3], nw[3], off[3], pos[3];
    for (int i = 0; i < 3; ++i) pt[i] = a[i] + __fmul_rn(t, seg[i]);
    const float dist = point_box(pt, s2, cp, nl) - s1[0];
    mv3(m2, nl, nw);
    mv3(m2, cp, off);
    for (int i = 0; i < 3; ++i) {
      pos[i] = (p2[i] + off[i]) + __fmul_rn(0.5f * dist, nw[i]);
      nw[i] = -nw[i];
    }
    cand(c, e, dist, pos, nw);
  }
  c.n = 2;
}

// the rotations that take face k of a box to +z (C mjc_BoxBox's rotmore;
// collision_box.ROTMORE), row-major
__device__ const float kRotmore[6][9] = {
    {0, 0, -1, 0, 1, 0, 1, 0, 0}, {1, 0, 0, 0, 0, -1, 0, 1, 0},
    {1, 0, 0, 0, 1, 0, 0, 0, 1},  {0, 0, 1, 0, 1, 0, -1, 0, 0},
    {1, 0, 0, 0, 0, 1, 0, -1, 0}, {-1, 0, 0, 0, 1, 0, 0, 0, -1}};

// a b of row-major 3x3 matrices, and a b^T
DEV void mm3(const float* a, const float* b, float* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = (__fmul_rn(a[3 * i], b[j]) +
                        __fmul_rn(a[3 * i + 1], b[3 + j])) +
                       __fmul_rn(a[3 * i + 2], b[6 + j]);
}

DEV void mmt3(const float* a, const float* b, float* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = dot3r(a + 3 * i, b + 3 * j);
}

// The 24 candidates of a box-box manifold: depth, world point (the
// point in the reference face's frame until the last loop of box_face or
// box_edge moves it), validity, and the pair's normal; in local memory
struct BoxCands {
  float depth[24];
  float world[24][3];
  bool valid[24];
  float normal[3];
};

// the separating-axis scan (collision_box._sat); returns whether the
// boxes are apart
DEV bool box_sat(const float* pos21, const float* pos12, const float* r21,
                 const float* a21, const float* s1, const float* s2,
                 float margin, int* code, float* clnorm, bool* inv,
                 int* cle1, int* cle2) {
  float plen1[3], plen2[3];
  for (int i = 0; i < 3; ++i) {
    plen2[i] = dot3r(a21 + 3 * i, s2);
  }
  mtv3(a21, s1, plen1);
  float sep = margin + __fmul_rn(3.0f, (s1[0] + s2[0]) + (s1[1] + s2[1]) +
                                           (s1[2] + s2[2]));
  bool fail = false;
  *code = -1;
  for (int i = 0; i < 3; ++i) {
    const float c1 = -fabsf(pos21[i]) + s1[i] + plen2[i];
    const float c2 = -fabsf(pos12[i]) + s2[i] + plen1[i];
    fail = fail || c1 < -margin || c2 < -margin;
    if (c1 < sep) {
      *code = i + (pos21[i] < 0.0f ? 3 : 0);
      sep = c1;
    }
    if (c2 < sep) {
      *code = i + (pos12[i] < 0.0f ? 3 : 0) + 6;
      sep = c2;
    }
  }
  clnorm[0] = clnorm[1] = clnorm[2] = 0.0f;
  *inv = false;
  *cle1 = *cle2 = 0;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      // rot12 row j = rot21 column j
      const float r0 = r21[j], r1 = r21[3 + j], r2 = r21[6 + j];
      float cr[3];
      if (i == 0) {
        cr[0] = 0.0f; cr[1] = -r2; cr[2] = r1;
      } else if (i == 1) {
        cr[0] = r2; cr[1] = 0.0f; cr[2] = -r0;
      } else {
        cr[0] = -r1; cr[1] = r0; cr[2] = 0.0f;
      }
      const float clen = sqrtf(dot3r(cr, cr));
      const bool ok = clen >= 1e-9f;
      const float clen_s = ok ? clen : 1.0f;
      float axis[3];
      for (int k = 0; k < 3; ++k) axis[k] = cr[k] / clen_s;
      const float box_dist = dot3r(pos21, axis);
      float c3 = -fabsf(box_dist);
      for (int k = 0; k < 3; ++k) {
        if (k != i) c3 = c3 + __fmul_rn(s1[k], fabsf(axis[k]));
        if (k != j) c3 = c3 + s2[k] * a21[3 * i + 3 - k - j] / clen_s;
      }
      fail = fail || (ok && c3 < -margin);
      if (ok && c3 < sep * (1.0f - 1e-12f)) {
        int b1 = 0, b2 = 0;
        for (int k = 0; k < 3; ++k) {
          if (k != i && ((axis[k] > 0.0f) != (box_dist < 0.0f)))
            b1 += 1 << k;
          if (k != j && (((r21[3 * i + 3 - k - j] > 0.0f) !=
                          (box_dist < 0.0f)) != ((k - j + 3) % 3 == 1)))
            b2 += 1 << k;
        }
        sep = c3;
        *code = 12 + 3 * i + j;
        for (int k = 0; k < 3; ++k) clnorm[k] = axis[k];
        *inv = box_dist < 0.0f;
        *cle1 = b1;
        *cle2 = b2;
      }
    }
  }
  return fail || *code < 0;
}

// the manifold of a face axis (collision_box._face_case)
DEV void box_face(int axis_code, const float* pos21, const float* pos12,
                  const float* r21, const float* p1, const float* m1,
                  const float* s1, const float* p2, const float* m2,
                  const float* s2, float margin, BoxCands& bc) {
  const int code = min(max(axis_code, 0), 11);
  const float* R = kRotmore[code % 6];
  const bool bi = code / 6 == 1;
  float rsel[9], r[9], p[3], ss[3], s_o[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      rsel[3 * i + j] = bi ? r21[3 * j + i] : r21[3 * i + j];
  mm3(R, rsel, r);
  mv3(R, bi ? pos12 : pos21, p);
  mv3(R, bi ? s2 : s1, ss);
  for (int i = 0; i < 3; ++i) {
    ss[i] = fabsf(ss[i]);
    s_o[i] = bi ? s1[i] : s2[i];
  }
  const float lx = ss[0], ly = ss[1], hz = ss[2];
  p[2] = p[2] - hz;
  float lp[3] = {p[0], p[1], p[2]};
  float cns[3][3];
  bool w[3];
  int dirs = 0;
  for (int i = 0; i < 3; ++i) {
    const bool clc = r[6 + i] < 0.0f;
    for (int k = 0; k < 3; ++k) {
      const float rs = r[3 * k + i] * s_o[i];
      lp[k] = lp[k] + rs * (clc ? 1.0f : -1.0f);
      cns[i][k] = rs * (clc ? -2.0f : 2.0f);
    }
    w[i] = fabsf(r[6 + i]) < 0.5f;
    dirs += w[i];
  }
  // the first and the second lateral direction (zero where none)
  float cn1[3] = {0.0f, 0.0f, 0.0f}, cn2[3] = {0.0f, 0.0f, 0.0f};
  int found = 0;
  for (int i = 0; i < 3; ++i) {
    if (!w[i]) continue;
    for (int k = 0; k < 3; ++k) (found == 0 ? cn1 : cn2)[k] = cns[i][k];
    ++found;
    if (found == 2) break;
  }
  const bool dirs2 = dirs == 2;
  float (*pts)[3] = bc.world;
  int n = 0;
  for (int line = 0; line < 4; ++line) {
    float la[3], lb[3];
    bool lex = line == 0 ? dirs >= 1 : dirs2;
    for (int k = 0; k < 3; ++k) {
      la[k] = line == 2 ? lp[k] + cn1[k] :
              line == 3 ? lp[k] + cn2[k] : lp[k];
      lb[k] = (line == 0 || line == 3) ? cn1[k] : cn2[k];
    }
    for (int q = 0; q < 2; ++q) {
      const bool denom_ok = fabsf(lb[q]) > 1e-9f;
      const float br = 1.0f / (denom_ok ? lb[q] : 1.0f);
      for (int jj = 0; jj < 2; ++jj) {
        const float l = ss[q] * (jj == 0 ? -1.0f : 1.0f);
        const float c1 = (l - la[q]) * br;
        const float c2 = la[1 - q] + __fmul_rn(lb[1 - q], c1);
        bc.valid[n] = lex && denom_ok && c1 >= 0.0f && c1 <= 1.0f &&
                      fabsf(c2) <= ss[1 - q];
        for (int k = 0; k < 3; ++k) pts[n][k] = la[k] + __fmul_rn(c1, lb[k]);
        ++n;
      }
    }
  }
  const float ax_ = cn1[0], bx_ = cn2[0], ay_ = cn1[1], by_ = cn2[1];
  const float det = __fmul_rn(ax_, by_) - __fmul_rn(bx_, ay_);
  const float cdet = 1.0f / (fabsf(det) < 1e-12f ? 1.0f : det);
  for (int i = 0; i < 4; ++i) {
    const float llx = i / 2 ? lx : -lx, lly = i % 2 ? ly : -ly;
    const float x = llx - lp[0], y = lly - lp[1];
    const float u = (__fmul_rn(x, by_) - __fmul_rn(y, bx_)) * cdet;
    const float v = (__fmul_rn(y, ax_) - __fmul_rn(x, ay_)) * cdet;
    bc.valid[n] = dirs2 && u > 0.0f && v > 0.0f && u < 1.0f && v < 1.0f;
    pts[n][0] = llx;
    pts[n][1] = lly;
    pts[n][2] = (lp[2] + __fmul_rn(u, cn1[2])) + __fmul_rn(v, cn2[2]);
    ++n;
  }
  for (int i = 0; i < 4; ++i) {
    const bool exist = dirs2 || i < 2;
    const float f1 = (float)(i & 1), f2 = (i & 2) ? 1.0f : 0.0f;
    for (int k = 0; k < 3; ++k)
      pts[n][k] = (lp[k] + __fmul_rn(f1, cn1[k])) + __fmul_rn(f2, cn2[k]);
    bc.valid[n] = exist && pts[n][0] > -lx && pts[n][0] < lx &&
                  pts[n][1] > -ly && pts[n][1] < ly;
    ++n;
  }
  // rw = (bi ? m2 : m1) R^T; the normal is its column 2
  float rw[9];
  mmt3(bi ? m2 : m1, R, rw);
  const float* pw = bi ? p2 : p1;
  for (int k = 0; k < 3; ++k)
    bc.normal[k] = (bi ? -1.0f : 1.0f) * rw[3 * k + 2];
  for (int c = 0; c < 24; ++c) {
    bc.depth[c] = pts[c][2];
    bc.valid[c] = bc.valid[c] && pts[c][2] <= margin;
    const float loc[3] = {pts[c][0], pts[c][1], pts[c][2] * 0.5f + hz};
    for (int k = 0; k < 3; ++k) pts[c][k] = dot3r(rw + 3 * k, loc) + pw[k];
  }
}

// the manifold of an edge-edge axis (collision_box._edge_case)
DEV void box_edge(int axis_code, const float* pos21, const float* r21,
                  const float* a21, const float* clnorm, bool inv, int cle1,
                  int cle2, const float* p1, const float* m1,
                  const float* s1, const float* s2, float margin,
                  BoxCands& bc) {
  const int code = min(max(axis_code - 12, 0), 8);
  const int edge1 = code / 3, edge2 = code % 3;
  int ax1 = 1 - (edge2 & 1), ax2 = 2 - (edge2 & 2);
  if (a21[3 * edge1 + ax1] < a21[3 * edge1 + ax2]) {
    const int t = ax1; ax1 = ax2; ax2 = t;
  }
  int pax1 = 1 - (edge1 & 1), pax2 = 2 - (edge1 & 2);
  if (a21[3 * pax1 + edge2] < a21[3 * pax2 + edge2]) {
    const int t = pax1; pax1 = pax2; pax2 = t;
  }
  const float* R = kRotmore[((cle1 >> pax2) & 1) ? pax2 : pax2 + 3];
  float p[3], rnorm[3], r[9], s[3], st[3];
  mv3(R, pos21, p);
  mv3(R, clnorm, rnorm);
  mm3(R, r21, r);
  mtv3(R, s1, st);
  for (int i = 0; i < 3; ++i) s[i] = fabsf(st[i]);
  const float lx = s[0], ly = s[1], hz = s[2];
  p[2] = p[2] - hz;
  // rows ax1, ax2 and edge2 of r^T: columns of r
  const float sg1 = ((cle2 >> ax1) & 1) ? 1.0f : -1.0f;
  const float sg2 = ((cle2 >> ax2) & 1) ? 1.0f : -1.0f;
  float quad[4][3];
  for (int k = 0; k < 3; ++k) {
    const float e1 = __fmul_rn(r[3 * k + ax1], s2[ax1]);
    const float e2 = __fmul_rn(r[3 * k + ax2], s2[ax2]);
    const float ee = __fmul_rn(r[3 * k + edge2], s2[edge2]);
    const float q0 = (p[k] + __fmul_rn(e1, sg1)) + __fmul_rn(e2, sg2);
    const float q2 = (p[k] + __fmul_rn(e1, -sg1)) + __fmul_rn(e2, sg2);
    quad[1][k] = q0 - ee;
    quad[0][k] = q0 + ee;
    quad[3][k] = q2 - ee;
    quad[2][k] = q2 + ee;
  }
  float axi_cn1[3], axi_cn2[3];
  for (int k = 0; k < 3; ++k) {
    axi_cn1[k] = quad[1][k] - quad[0][k];
    axi_cn2[k] = quad[2][k] - quad[0][k];
  }
  const bool norm_ok = fabsf(rnorm[2]) >= 1e-9f;
  const float isign = inv ? -1.0f : 1.0f;
  const float innorm = isign / (norm_ok ? rnorm[2] : 1.0f);
  float proj[3][3];
  for (int i = 0; i < 3; ++i) {
    const float c_scl = quad[i][2] * isign * innorm;
    for (int k = 0; k < 3; ++k)
      proj[i][k] = quad[i][k] - __fmul_rn(rnorm[k], c_scl);
  }
  float pts_cn1[3], pts_cn2[3];
  for (int k = 0; k < 3; ++k) {
    pts_cn1[k] = proj[1][k] - proj[0][k];
    pts_cn2[k] = proj[2][k] - proj[0][k];
  }
  float (*pts)[3] = bc.world;
  int n = 0, nl = 0;
  for (int line = 0; line < 4; ++line) {
    float la[3], lb[3], lua[3], lub[3];
    for (int k = 0; k < 3; ++k) {
      la[k] = line == 2 ? proj[0][k] + pts_cn1[k] :
              line == 3 ? proj[0][k] + pts_cn2[k] : proj[0][k];
      lb[k] = (line == 0 || line == 3) ? pts_cn1[k] : pts_cn2[k];
      lua[k] = line == 2 ? quad[0][k] + axi_cn1[k] :
               line == 3 ? quad[0][k] + axi_cn2[k] : quad[0][k];
      lub[k] = (line == 0 || line == 3) ? axi_cn1[k] : axi_cn2[k];
    }
    for (int q = 0; q < 2; ++q) {
      const bool denom_ok = fabsf(lb[q]) > 1e-9f;
      const float br = 1.0f / (denom_ok ? lb[q] : 1.0f);
      for (int jj = 0; jj < 2; ++jj) {
        const float l = s[q] * (jj == 0 ? -1.0f : 1.0f);
        const float c1 = (l - la[q]) * br;
        const float c2 = la[1 - q] + __fmul_rn(lb[1 - q], c1);
        const float zval = (lua[2] + __fmul_rn(lub[2], c1)) * innorm;
        bc.valid[n] = denom_ok && c1 >= 0.0f && c1 <= 1.0f &&
                      fabsf(c2) <= s[1 - q] && zval <= margin;
        for (int k = 0; k < 3; ++k)
          pts[n][k] = __fmul_rn(lua[k], 0.5f) +
                      __fmul_rn(__fmul_rn(c1, lub[k]), 0.5f);
        pts[n][q] = pts[n][q] + __fmul_rn(0.5f, l);
        pts[n][1 - q] = pts[n][1 - q] + __fmul_rn(0.5f, c2);
        bc.depth[n] = pts[n][2] * innorm * 2.0f;
        nl += bc.valid[n];
        ++n;
      }
    }
  }
  const float ax_ = pts_cn1[0], bx_ = pts_cn2[0];
  const float ay_ = pts_cn1[1], by_ = pts_cn2[1];
  const float det = __fmul_rn(ax_, by_) - __fmul_rn(bx_, ay_);
  const float cdet = 1.0f / (fabsf(det) < 1e-12f ? 1.0f : det);
  int nf = 0;
  for (int i = 0; i < 4; ++i) {
    const float llx = i / 2 ? lx : -lx, lly = i % 2 ? ly : -ly;
    const float x = llx - proj[0][0], y = lly - proj[0][1];
    const float u = (__fmul_rn(x, by_) - __fmul_rn(y, bx_)) * cdet;
    const float v = (__fmul_rn(y, ax_) - __fmul_rn(x, ay_)) * cdet;
    const bool loose = !((u < 0.0f || u > 1.0f) && (v < 0.0f || v > 1.0f));
    const bool strict = u >= 0.0f && v >= 0.0f && u <= 1.0f && v <= 1.0f;
    bool accept = nl == 0 ? loose : strict;
    const float uc = fminf(fmaxf(u, 0.0f), 1.0f);
    const float vc = fminf(fmaxf(v, 0.0f), 1.0f);
    const float wc = 1.0f - uc - vc;
    float vtmp[3], dvec[3];
    for (int k = 0; k < 3; ++k)
      vtmp[k] = (__fmul_rn(quad[0][k], wc) + __fmul_rn(quad[1][k], uc)) +
                __fmul_rn(quad[2][k], vc);
    const float pt[3] = {llx, lly, 0.0f};
    for (int k = 0; k < 3; ++k) dvec[k] = pt[k] - vtmp[k];
    const float tc1 = dot3r(dvec, dvec);
    accept = accept && !(vtmp[2] > 0.0f && tc1 > margin * margin);
    for (int k = 0; k < 3; ++k) pts[n][k] = 0.5f * (pt[k] + vtmp[k]);
    bc.depth[n] = sqrtf(tc1) * (vtmp[2] < 0.0f ? -1.0f : 1.0f);
    bc.valid[n] = accept;
    nf += accept;
    ++n;
  }
  for (int i = 0; i < 4; ++i) {
    const float* pu = quad[i];
    const float x = pu[0], y = pu[1];
    const bool loose = !((x < -lx || x > lx) && (y < -ly || y > ly));
    const bool strict = x >= -lx && x <= lx && y >= -ly && y <= ly;
    bool accept = (nl == 0 && nf != 0) ? loose : strict;
    float c1v = 0.0f;
    float tmp[2] = {x, y};
    for (int jq = 0; jq < 2; ++jq) {
      const bool below = pu[jq] < -s[jq], above = pu[jq] > s[jq];
      const float lo = pu[jq] + s[jq], hi = pu[jq] - s[jq];
      c1v = c1v + (below ? __fmul_rn(lo, lo) : above ? __fmul_rn(hi, hi)
                                                     : 0.0f);
      tmp[jq] = below ? -s[jq] * 0.5f : above ? s[jq] * 0.5f : tmp[jq];
    }
    const float zn = pu[2] * innorm;
    c1v = c1v + __fmul_rn(zn, zn);
    accept = accept && !(pu[2] > 0.0f && c1v > margin * margin);
    pts[n][0] = (tmp[0] + pu[0]) * 0.5f;
    pts[n][1] = (tmp[1] + pu[1]) * 0.5f;
    pts[n][2] = (0.0f + pu[2]) * 0.5f;
    bc.depth[n] = sqrtf(c1v) * (pu[2] < 0.0f ? -1.0f : 1.0f);
    bc.valid[n] = accept;
    ++n;
  }
  float rw[9], nl3[3];
  mmt3(m1, R, rw);
  mv3(rw, rnorm, nl3);
  for (int k = 0; k < 3; ++k) bc.normal[k] = isign * nl3[k];
  for (int c = 0; c < 24; ++c) {
    bc.valid[c] = bc.valid[c] && norm_ok;
    const float loc[3] = {pts[c][0], pts[c][1], pts[c][2] + hz};
    for (int k = 0; k < 3; ++k) pts[c][k] = dot3r(rw + 3 * k, loc) + p1[k];
  }
}

// box (1) - box (2): the contact of depth rank `rank` among the 8 deepest
// valid candidates (collision_box.box_box; ties to the lower candidate
// index, as jax.lax.top_k); dist 1e10 where that slot is empty
DEV void box_box(const float* p1, const float* m1, const float* s1,
                 const float* p2, const float* m2, const float* s2,
                 float margin, int rank, Cand& c) {
  float d[3], pos21[3], pos12[3], r21[9], a21[9];
  for (int i = 0; i < 3; ++i) d[i] = p2[i] - p1[i];
  mtv3(m1, d, pos21);
  for (int i = 0; i < 3; ++i) d[i] = p1[i] - p2[i];
  mtv3(m2, d, pos12);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      r21[3 * i + j] = (__fmul_rn(m1[i], m2[j]) +
                        __fmul_rn(m1[3 + i], m2[3 + j])) +
                       __fmul_rn(m1[6 + i], m2[6 + j]);
      a21[3 * i + j] = fabsf(r21[3 * i + j]);
    }
  int code, cle1, cle2;
  float clnorm[3];
  bool inv;
  const bool fail = box_sat(pos21, pos12, r21, a21, s1, s2, margin, &code,
                            clnorm, &inv, &cle1, &cle2);
  BoxCands bc;
  if (code < 12)
    box_face(code, pos21, pos12, r21, p1, m1, s1, p2, m2, s2, margin, bc);
  else
    box_edge(code, pos21, r21, a21, clnorm, inv, cle1, cle2, p1, m1, s1, s2,
             margin, bc);
  // rank + 1 passes, each taking the least (depth, index) of the valid
  // candidates past the last pass's
  int pick = -1;
  float dist = 0.0f;
  for (int r = 0; r <= rank; ++r) {
    int best = -1;
    float least = 0.0f;
    for (int i = 0; i < 24; ++i) {
      if (fail || !bc.valid[i]) continue;
      const float dd = bc.depth[i];
      const bool past = pick < 0 || dd > dist || (dd == dist && i > pick);
      if (past && (best < 0 || dd < least)) {
        best = i;
        least = dd;
      }
    }
    pick = best;
    dist = least;
    if (pick < 0) break;
  }
  const float zero[3] = {0.0f, 0.0f, 0.0f};
  cand(c, 0, pick < 0 ? 1e10f : dist, pick < 0 ? zero : bc.world[pick],
       bc.normal);
  c.n = 1;
}

// capsule (1) - capsule (2) as the BOXES entries compute it: closest
// points of the axes and the sphere-vs-point tail with every product
// rounded and the sums in collision_primitive.capsule_capsule's order, so
// that a pair whose axes nearly cross (its normal turns with the last
// bits of pb - pa) keeps the plain version's bits. The other entries keep
// closest_segment_segment and sphere_like, and their bits.
DEV void capsule_capsule_rn(const float* p1, const float* m1,
                            const float* s1, const float* p2,
                            const float* m2, const float* s2, float* pos,
                            float* n, float* dist) {
  float ax1[3], ax2[3], a0[3], a1[3], b0[3], b1[3];
  zaxis(m1, ax1);
  zaxis(m2, ax2);
  for (int i = 0; i < 3; ++i) {
    const float h1 = __fmul_rn(ax1[i], s1[1]), h2 = __fmul_rn(ax2[i], s2[1]);
    a0[i] = p1[i] - h1;
    a1[i] = p1[i] + h1;
    b0[i] = p2[i] - h2;
    b1[i] = p2[i] + h2;
  }
  float d1[3], d2[3], r[3];
  for (int i = 0; i < 3; ++i) {
    d1[i] = a1[i] - a0[i]; d2[i] = b1[i] - b0[i]; r[i] = a0[i] - b0[i];
  }
  const float a = dot3r(d1, d1), e = dot3r(d2, d2), f = dot3r(d2, r);
  const float c = dot3r(d1, r), b = dot3r(d1, d2);
  const float denom = __fmul_rn(a, e) - __fmul_rn(b, b);
  float s = denom > 1e-14f ? fminf(fmaxf(
      (__fmul_rn(b, f) - __fmul_rn(c, e)) / denom, 0.0f), 1.0f) : 0.0f;
  const float t = (__fmul_rn(b, s) + f) / (e > 1e-14f ? e : 1.0f);
  const float tc = fminf(fmaxf(t, 0.0f), 1.0f);
  if (t != tc)
    s = fminf(fmaxf((__fmul_rn(b, tc) - c) / (a > 1e-14f ? a : 1.0f),
                    0.0f), 1.0f);
  float pa[3], nraw[3];
  for (int i = 0; i < 3; ++i) {
    pa[i] = a0[i] + __fmul_rn(d1[i], s);
    nraw[i] = (b0[i] + __fmul_rn(d2[i], tc)) - pa[i];
  }
  const float cdist = sqrtf(dot3r(nraw, nraw));
  if (cdist < 1e-12f) {
    n[0] = 1.0f; n[1] = 0.0f; n[2] = 0.0f;
  } else {
    for (int i = 0; i < 3; ++i) n[i] = nraw[i] / cdist;
  }
  *dist = cdist - (s1[0] + s2[0]);
  for (int i = 0; i < 3; ++i)
    pos[i] = pa[i] + __fmul_rn(n[i], s1[0] + 0.5f * *dist);
}

// narrowphase of one candidate row (collision_primitive colliders; the
// plane-box pair with EQBOX, capsule-box and box-box with BOXES)
template <bool EQBOX, bool BOXES>
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
  if (BOXES && t2 == kBox) {
    if (t1 == kCapsule)
      capsule_box(p1, m1, s1, p2, m2, s2, c);
    else
      box_box(p1, m1, s1, p2, m2, s2, p.pair_float[18 * pr + 14], pi[7], c);
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
    if constexpr (BOXES) {
      float dist;
      capsule_capsule_rn(p1, m1, s1, p2, m2, s2, pos, n, &dist);
      cand(c, 0, dist, pos, n);
      c.n = 1;
      return;
    }
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

template <bool ELL, bool EQBOX, bool BOXES>
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
    if (pr < p.ncand) collide<EQBOX, BOXES>(p, w, pr, c);
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

template <bool ELL, bool EQBOX, bool BOXES>
DEV void contact_block(const Params& p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int w = blockIdx.x * WARPS + wb;
  if (w >= p.nworld) return;
  const int words = pool_words(p.nconmax, p.stride);
  contact_warp<ELL, EQBOX, BOXES>(p, pool_at(smem + wb * words, p.nconmax),
                                  w, lane);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
contact_kernel(const Params p) {
  contact_block<false, false, false>(p);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
contact_ell_kernel(const Params p) {
  contact_block<true, false, false>(p);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS_EQBOX)
contact_eqbox_kernel(const Params p) {
  contact_block<false, true, false>(p);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS_EQBOX)
contact_eqbox_ell_kernel(const Params p) {
  contact_block<true, true, false>(p);
}

// the entries with capsule-box or box-box pairs (BOXES, which also takes
// EQBOX's branches): their candidates live in local memory
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS_BOX)
contact_box_kernel(const Params p) {
  contact_block<false, true, true>(p);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS_BOX)
contact_box_ell_kernel(const Params p) {
  contact_block<true, true, true>(p);
}

PORT_C_WARP_INTERFACE(Params, contact_kernel, WARPS,
                      4 * pool_words(p->nconmax, p->stride))
PORT_C_WARP_ENTRY(ell_, Params, contact_ell_kernel, WARPS,
                  4 * pool_words(p->nconmax, p->stride))
PORT_C_WARP_ENTRY(eqbox_, Params, contact_eqbox_kernel, WARPS,
                  4 * pool_words(p->nconmax, p->stride))
PORT_C_WARP_ENTRY(eqbox_ell_, Params, contact_eqbox_ell_kernel, WARPS,
                  4 * pool_words(p->nconmax, p->stride))
PORT_C_WARP_ENTRY(box_, Params, contact_box_kernel, WARPS,
                  4 * pool_words(p->nconmax, p->stride))
PORT_C_WARP_ENTRY(box_ell_, Params, contact_box_ell_kernel, WARPS,
                  4 * pool_words(p->nconmax, p->stride))
