"""Analytic narrowphase for the plane / sphere / capsule pairs,
plane-box, sphere-box, capsule-box, box-box (`collision_box`) and
plane-mesh.

Each collider takes batched geometry (pos (..., 3), mat (..., 3, 3),
size (..., 3) of both geoms) and returns a fixed number K of candidate
contacts: dist (..., K), pos (..., K, 3), frame (..., K, 3, 3). A
candidate is a contact when dist < margin; `collision_driver` masks the
rest.
Mirrors `mujoco_warp_tpu/collision_primitive.py:45-91`, `plane_box`
(:137), `_point_box` (:152), `sphere_box` (:174), `capsule_box` (:217),
`plane_mesh` (:272) and `_box_box_entry` (:287). A collider in
NEEDS_MARGIN also takes the pair's margin; one in NEEDS_HULLS the padded
hulls of both geoms (None for a geom without one).
"""

from __future__ import annotations

import torch

from . import collision_box
from . import math
from .io import MAX_CONTACTS
from .types import GeomType


def _sphere_like(p1, n_raw, r1, r2, ref):
  """Shared tail of the sphere-vs-point colliders (the sums in one order,
  as kernel B2's box entries sum them)."""
  cdist = torch.sqrt(math.dot3(n_raw, n_raw))
  small = (cdist < 1e-12)[..., None]
  n = n_raw / torch.where(small, torch.ones_like(cdist[..., None]),
                          cdist[..., None])
  ex = torch.cat([torch.ones_like(n[..., :1]), torch.zeros_like(n[..., 1:])],
                 -1)
  n = torch.where(small, ex, n)
  dist = cdist - (r1 + r2)
  pos = ref + n * (r1 + 0.5 * dist)[..., None]
  return dist[..., None], pos[..., None, :], math.make_frame(n)[..., None,
                                                                  :, :]


def plane_sphere(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  dist = math.dot(p2 - p1, n) - s2[..., 0]
  pos = p2 - n * (s2[..., 0] + 0.5 * dist)[..., None]
  return dist[..., None], pos[..., None, :], math.make_frame(n)[..., None,
                                                                  :, :]


def plane_capsule(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  axis = m2[..., :, 2]
  half = (axis * s2[..., 1:2])
  ends = torch.stack([p2 + half, p2 - half], dim=-2)          # (..., 2, 3)
  dist = math.dot(ends - p1[..., None, :], n[..., None, :]) - s2[..., :1]
  pos = ends - n[..., None, :] * (s2[..., :1] + 0.5 * dist)[..., None]
  frame = math.make_frame(n)[..., None, :, :].expand(
      dist.shape + (3, 3))
  return dist, pos, frame


# the box's corners, x slowest: corner i = 4 bx + 2 by + bz, b = 0 for
# the negative side (the JAX package's order)
_SIGNS = tuple((sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
               for sz in (-1.0, 1.0))


def plane_box(p1, m1, s1, p2, m2, s2):
  """The box's 4 deepest corners against the plane (C mjc_PlaneBox's
  manifold), deepest first, ties to the lower corner index (the order of
  `jax.lax.top_k` and of kernel B2's selection). A corner's depth is the
  center's plus +-a_c along each box axis c, a_c = size_c (axis_c . n),
  each product rounded and the sums in one order, as kernel B2 sums them
  without contraction, so that a tie breaks the same way in both."""
  n = m1[..., :, 2]
  rel = p2 - p1
  base = (rel[..., 0] * n[..., 0] + rel[..., 1] * n[..., 1]) + \
      rel[..., 2] * n[..., 2]
  # the box's axes (m2's columns) along n, row by row
  nn = n[..., None, :]
  axes = (m2[..., 0, :] * nn[..., 0] + m2[..., 1, :] * nn[..., 1]) + \
      m2[..., 2, :] * nn[..., 2]
  a = s2[..., :3] * axes                                  # (..., 3)
  signs = torch.tensor(_SIGNS, dtype=p2.dtype, device=p2.device)
  sa = signs * a[..., None, :]                            # (..., 8, 3)
  dist8 = base[..., None] + ((sa[..., 0] + sa[..., 1]) + sa[..., 2])
  idx = torch.sort(dist8, dim=-1, stable=True).indices[..., :4]
  dist = torch.gather(dist8, -1, idx)
  half = signs * s2[..., None, :3]
  rot = m2[..., None, :, :]
  corners = p2[..., None, :] + (
      (rot[..., 0] * half[..., 0:1] + rot[..., 1] * half[..., 1:2]) +
      rot[..., 2] * half[..., 2:3])
  pts = torch.gather(corners, -2, idx[..., None].expand(idx.shape + (3,)))
  pos = pts - (0.5 * dist)[..., None] * n[..., None, :]
  frame = math.make_frame(n)[..., None, :, :].expand(dist.shape + (3, 3))
  return dist, pos, frame


def plane_mesh(p1, m1, s1, p2, m2, s2, v1, v2):
  """The 4 hull vertices of the mesh deepest below the plane, deepest
  first, ties to the lower vertex (the order of `jax.lax.top_k`), padding
  at 1e10 (`math.top_k` of the negated depths). A vertex's depth is the
  mesh origin's plus the vertex along the normal in the mesh frame (the
  JAX package moves every vertex into the world first: the same value to
  rounding); the hull v2 (...,
  V, 4) may be shared by leading axes of the poses (the worlds), whose
  depths then come from one batched product."""
  n = m1[..., :, 2]
  dl = math.mtv3(m2, n)
  batch, nv = v2.shape[:-2], v2.shape[-2]
  lead = dl.shape[:dl.dim() - 1 - len(batch)]
  nl = 1
  for x in lead:
    nl *= x
  xt = dl.reshape((nl,) + batch + (3,)).movedim(0, -1)      # (batch, 3, L)
  dots = (v2[..., :3] @ xt).movedim(-1, 0).reshape(lead + batch + (nv,))
  dists = math.dot3(p2 - p1, n)[..., None] + dots
  dists = torch.where(v2[..., 3] > 0, dists, 1e10)
  idx = math.top_k(-dists, 4)
  dist = torch.gather(dists, -1, idx)
  verts = torch.gather(v2[..., :3].expand(idx.shape[:-1] + (nv, 3)), -2,
                       idx[..., None].expand(idx.shape + (3,)))
  pts = p2[..., None, :] + math.mv3(m2[..., None, :, :], verts)
  pos = pts - (0.5 * dist)[..., None] * n[..., None, :]
  frame = math.make_frame(n)[..., None, :, :].expand(dist.shape + (3, 3))
  return dist, pos, frame


def sphere_sphere(p1, m1, s1, p2, m2, s2):
  return _sphere_like(p1, p2 - p1, s1[..., 0], s2[..., 0], p1)


def sphere_capsule(p1, m1, s1, p2, m2, s2):
  seg = m2[..., :, 2] * s2[..., 1:2]
  pt = math.closest_segment_point(p2 - seg, p2 + seg, p1)
  return _sphere_like(p1, pt - p1, s1[..., 0], s2[..., 0], p1)


def capsule_capsule(p1, m1, s1, p2, m2, s2):
  seg1 = m1[..., :, 2] * s1[..., 1:2]
  seg2 = m2[..., :, 2] * s2[..., 1:2]
  pa, pb = math.closest_segment_segment(p1 - seg1, p1 + seg1, p2 - seg2,
                                        p2 + seg2)
  return _sphere_like(p1, pb - pa, s1[..., 0], s2[..., 0], pa)


def _point_box(c, half):
  """Closest point on boxes of half-sizes half (..., 3) (box frames) to
  the points c (..., 3): (closest (..., 3), normal from the box toward c
  (..., 3), signed distance from the surface (...)); a point inside is
  pushed out through the face of least clearance (the first of equal
  ones). The sums run in one order, as kernel B2 runs them."""
  c, half = torch.broadcast_tensors(c, half)
  clamped = torch.minimum(torch.maximum(c, -half), half)
  inside = torch.all(torch.abs(c) < half, dim=-1)
  dvec = c - clamped
  dn = torch.sqrt(math.dot3(dvec, dvec))
  n_out = dvec / torch.where(dn < 1e-12, torch.ones_like(dn), dn)[..., None]
  clearance = half - torch.abs(c)
  ax = torch.argmin(clearance, dim=-1, keepdim=True)
  c_ax = torch.gather(c, -1, ax)
  sign = torch.where(c_ax >= 0, 1.0, -1.0).to(c.dtype)
  onehot = torch.zeros_like(c).scatter_(-1, ax, 1.0)
  n_in = onehot * sign
  surf_in = torch.where(onehot > 0, sign * torch.gather(half, -1, ax), c)
  closest = torch.where(inside[..., None], surf_in, clamped)
  normal = torch.where(inside[..., None], n_in, n_out)
  sdist = torch.where(inside, -torch.gather(clearance, -1, ax)[..., 0], dn)
  return closest, normal, sdist


def sphere_box(p1, m1, s1, p2, m2, s2):
  """Sphere vs box: the closest point of the box to the sphere's center
  (`_point_box`), one candidate."""
  closest, normal, sdist = _point_box(math.mtv3(m2, p1 - p2), s2[..., :3])
  dist = sdist - s1[..., 0]
  n_world = math.mv3(m2, normal)
  pos = (p2 + math.mv3(m2, closest)) + (0.5 * dist)[..., None] * n_world
  return (dist[..., None], pos[..., None, :],
          math.make_frame(-n_world)[..., None, :, :])


def capsule_box(p1, m1, s1, p2, m2, s2):
  """Capsule vs box, 2 candidates: the least signed distance from the
  capsule's segment to the box over 33 samples, the first and the last
  sample within 1e-4 (1 + |min|) of it, each refined by 5 rounds of a
  shrinking 9-point window (ties to the point nearest the current one);
  a capsule lying on a face gives the two ends of the flat interval.
  Each product is rounded and the sums run in one order, as kernel B2
  computes them without contraction: which samples reach the minimum
  decides the contact point of a capsule lying on a face."""
  half = s2[..., :3]
  ax = m1[..., :, 2] * s1[..., 1:2]
  a_loc = math.mtv3(m2, (p1 + ax) - p2)
  b_loc = math.mtv3(m2, (p1 - ax) - p2)
  seg = b_loc - a_loc
  dt = p1.dtype

  def sdist_at(t):                                  # t (..., k)
    pts = a_loc[..., None, :] + t[..., None] * seg[..., None, :]
    return _point_box(pts, half[..., None, :])[2]

  ts = torch.arange(33, dtype=dt, device=p1.device) * (1.0 / 32.0)
  sds = sdist_at(ts.expand(p1.shape[:-1] + (33,)))
  sdmin = torch.min(sds, dim=-1, keepdim=True).values
  tol = 1e-4 * (1.0 + torch.abs(sdmin))
  at_min = sds <= sdmin + tol
  t_first = torch.min(torch.where(at_min, ts, 2.0), dim=-1).values
  t_last = torch.max(torch.where(at_min, ts, -1.0), dim=-1).values
  offs = (torch.arange(9, dtype=dt, device=p1.device) - 4.0) * 0.25

  def refine(t):
    delta = 1.0 / 32.0
    for _ in range(5):
      cand = torch.clamp(t[..., None] + offs * delta, 0.0, 1.0)
      vals = sdist_at(cand) + 1e-6 * torch.abs(cand - t[..., None])
      t = torch.gather(cand, -1, torch.argmin(vals, -1, keepdim=True)
                       )[..., 0]
      delta = delta * 0.25
    return t

  dists, poss, frames = [], [], []
  for t in (refine(t_first), refine(t_last)):
    pt = a_loc + t[..., None] * seg
    cp, normal, sdist = _point_box(pt, half)
    dist = sdist - s1[..., 0]
    n_world = math.mv3(m2, normal)
    dists.append(dist)
    poss.append((p2 + math.mv3(m2, cp)) + (0.5 * dist)[..., None] * n_world)
    frames.append(math.make_frame(-n_world))
  return (torch.stack(dists, -1), torch.stack(poss, -2),
          torch.stack(frames, -3))


# colliders that take the pair's margin, and the hulls
NEEDS_MARGIN = frozenset({(GeomType.BOX, GeomType.BOX)})
NEEDS_HULLS = frozenset({(GeomType.PLANE, GeomType.MESH)})

COLLIDERS = {
    (GeomType.PLANE, GeomType.SPHERE): plane_sphere,
    (GeomType.PLANE, GeomType.CAPSULE): plane_capsule,
    (GeomType.PLANE, GeomType.BOX): plane_box,
    (GeomType.SPHERE, GeomType.SPHERE): sphere_sphere,
    (GeomType.SPHERE, GeomType.CAPSULE): sphere_capsule,
    (GeomType.CAPSULE, GeomType.CAPSULE): capsule_capsule,
    (GeomType.CAPSULE, GeomType.BOX): capsule_box,
    (GeomType.BOX, GeomType.BOX): collision_box.box_box,
    (GeomType.SPHERE, GeomType.BOX): sphere_box,
    (GeomType.PLANE, GeomType.MESH): plane_mesh,
}
assert COLLIDERS.keys() == MAX_CONTACTS.keys()
