"""Analytic narrowphase for the plane / sphere / capsule pairs.

Each collider takes batched geometry (pos (..., 3), mat (..., 3, 3),
size (..., 3) of both geoms) and returns a fixed number K of candidate
contacts: dist (..., K), pos (..., K, 3), frame (..., K, 3, 3). A
candidate is a contact when dist < margin; `collision_driver` masks the
rest.
Mirrors `mujoco_warp_tpu/collision_primitive.py:45-91`.
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
    (GeomType.SPHERE, GeomType.SPHERE): sphere_sphere,
    (GeomType.SPHERE, GeomType.CAPSULE): sphere_capsule,
    (GeomType.CAPSULE, GeomType.CAPSULE): capsule_capsule,
}
assert COLLIDERS.keys() == MAX_CONTACTS.keys()
