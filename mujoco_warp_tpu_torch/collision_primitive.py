"""Analytic narrowphase for the plane / sphere / capsule pairs and
plane-box.

Each collider takes batched geometry (pos (..., 3), mat (..., 3, 3),
size (..., 3) of both geoms) and returns a fixed number K of candidate
contacts: dist (..., K), pos (..., K, 3), frame (..., K, 3, 3). A
candidate is a contact when dist < margin; `collision_driver` masks the
rest.
Mirrors `mujoco_warp_tpu/collision_primitive.py:45-91` and `plane_box`
(:137).
"""

from __future__ import annotations

import torch

from . import math
from .io import MAX_CONTACTS
from .types import GeomType


def _sphere_like(p1, n_raw, r1, r2, ref):
  """Shared tail of the sphere-vs-point colliders."""
  cdist = math.norm(n_raw)
  small = (cdist < 1e-12)[..., None]
  n = n_raw / torch.where(small, torch.ones_like(cdist[..., None]),
                          cdist[..., None])
  ex = torch.zeros_like(n)
  ex[..., 0] = 1.0
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


COLLIDERS = {
    (GeomType.PLANE, GeomType.SPHERE): plane_sphere,
    (GeomType.PLANE, GeomType.CAPSULE): plane_capsule,
    (GeomType.PLANE, GeomType.BOX): plane_box,
    (GeomType.SPHERE, GeomType.SPHERE): sphere_sphere,
    (GeomType.SPHERE, GeomType.CAPSULE): sphere_capsule,
    (GeomType.CAPSULE, GeomType.CAPSULE): capsule_capsule,
}
assert COLLIDERS.keys() == MAX_CONTACTS.keys()
