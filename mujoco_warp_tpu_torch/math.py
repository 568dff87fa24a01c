"""Quaternion and spatial (Plücker) algebra on batched tensors.

Every function works on the last axis and broadcasts over leading axes,
so one call covers all worlds (the JAX package writes single-world
functions and adds the world axis with vmap).

Conventions follow MuJoCo: quaternions are (w, x, y, z); motion vectors
are (angular[3], linear[3]); force vectors (torque[3], force[3]);
10-vector inertias (Ixx, Iyy, Izz, Ixy, Ixz, Iyz, m*cx, m*cy, m*cz, m).
"""

from __future__ import annotations

import torch

# below this norm a quaternion or axis normalizes to the identity
_EPS = 1e-14


def norm(x: torch.Tensor) -> torch.Tensor:
  return torch.sqrt(torch.sum(x * x, dim=-1))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.sum(a * b, dim=-1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """a . b of 3-vectors, each product rounded and the sums in order (as
  kernel B2's box entries sum them, where `dot` leaves the order to the
  reduction)."""
  return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def mv3(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """mat v of (..., 3, 3) matrices, summed as dot3."""
  return torch.stack([dot3(mat[..., i, :], v) for i in range(3)], -1)


def mtv3(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """mat^T v of (..., 3, 3) matrices, summed as dot3."""
  return torch.stack([dot3(mat[..., :, i], v) for i in range(3)], -1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  a, b = torch.broadcast_tensors(a, b)
  return torch.stack([
      a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
      a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
      a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def normalize(x: torch.Tensor) -> torch.Tensor:
  n = norm(x)[..., None]
  return x / torch.where(n < _EPS, torch.ones_like(n), n)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
  """Normalize; a zero quaternion maps to the identity (MuJoCo rule)."""
  n = norm(q)[..., None]
  unit = torch.zeros_like(q)
  unit[..., 0] = 1.0
  return torch.where(n < _EPS, unit,
                     q / torch.where(n < _EPS, torch.ones_like(n), n))


def quat_normalize_rsqrt(q: torch.Tensor) -> torch.Tensor:
  """q / |q| with the 1e-28 floor on |q|^2 that the kernels use."""
  n2 = torch.sum(q * q, dim=-1, keepdim=True)
  return q * torch.rsqrt(torch.clamp(n2, min=1e-28))


def mul_quat(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Hamilton product u*v (wxyz)."""
  u, v = torch.broadcast_tensors(u, v)
  u0, u1, u2, u3 = u.unbind(-1)
  v0, v1, v2, v3 = v.unbind(-1)
  return torch.stack([
      u0 * v0 - u1 * v1 - u2 * v2 - u3 * v3,
      u0 * v1 + u1 * v0 + u2 * v3 - u3 * v2,
      u0 * v2 - u1 * v3 + u2 * v0 + u3 * v1,
      u0 * v3 + u1 * v2 - u2 * v1 + u3 * v0], dim=-1)


def rot_vec_quat(vec: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
  """Rotate 3-vectors by quaternions: v + 2w(qv x v) + 2 qv x (qv x v)."""
  w, qv = quat[..., :1], quat[..., 1:]
  t = 2.0 * cross(qv, vec)
  return vec + w * t + cross(qv, t)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """Quaternions (..., 4) -> rotation matrices (..., 3, 3)."""
  w, x, y, z = q.unbind(-1)
  rows = [
      1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
      2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
      2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]
  return torch.stack(rows, dim=-1).reshape(q.shape[:-1] + (3, 3))


def motion_cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Spatial cross product of motion vectors u x v."""
  ang = cross(u[..., :3], v[..., :3])
  lin = cross(u[..., :3], v[..., 3:]) + cross(u[..., 3:], v[..., :3])
  return torch.cat([ang, lin], dim=-1)


def motion_cross_force(u: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """Spatial cross product of a motion with a force vector u x* f."""
  ang = cross(u[..., :3], f[..., :3]) + cross(u[..., 3:], f[..., 3:])
  lin = cross(u[..., :3], f[..., 3:])
  return torch.cat([ang, lin], dim=-1)


def inert_mul(i10: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """10-vector spatial inertia times motion vector -> force vector."""
  ang, lin = v[..., :3], v[..., 3:]
  ixx, iyy, izz, ixy, ixz, iyz = i10[..., 0:6].unbind(-1)
  mc, mm = i10[..., 6:9], i10[..., 9:10]
  a0, a1, a2 = ang.unbind(-1)
  oa = torch.stack([ixx * a0 + ixy * a1 + ixz * a2,
                    ixy * a0 + iyy * a1 + iyz * a2,
                    ixz * a0 + iyz * a1 + izz * a2], dim=-1)
  return torch.cat([oa + cross(mc, lin), mm * lin - cross(mc, ang)], dim=-1)


def make_frame(a: torch.Tensor) -> torch.Tensor:
  """(..., 3, 3) frames whose first row is the normalized input; the
  other rows span the orthogonal plane (MuJoCo mju_makeFrame order)."""
  a = normalize(a)
  near_vert = (torch.abs(a[..., 2:3]) >= 0.5).to(a.dtype)
  helper = torch.cat([torch.zeros_like(near_vert), near_vert,
                      1.0 - near_vert], dim=-1)
  b = normalize(helper - a * dot(a, helper)[..., None])
  c = cross(a, b)
  return torch.stack([a, b, c], dim=-2)


def closest_segment_point(a, b, pt):
  """Closest point on segments [a, b] to points pt."""
  ab = b - a
  denom = dot(ab, ab)
  t = dot(pt - a, ab) / torch.where(denom < _EPS, torch.ones_like(denom),
                                     denom)
  t = torch.clamp(t, 0.0, 1.0)
  return a + t[..., None] * ab


def closest_segment_segment(a0, a1, b0, b1):
  """Closest points between segments [a0, a1] and [b0, b1], each product
  rounded and the sums in one order (dot3), as kernel B2 computes them:
  where two axes nearly cross, the normal turns with the last bits of
  pb - pa."""
  d1 = a1 - a0
  d2 = b1 - b0
  r = a0 - b0
  a = dot3(d1, d1)
  e = dot3(d2, d2)
  f = dot3(d2, r)
  c = dot3(d1, r)
  b = dot3(d1, d2)
  denom = a * e - b * b
  one = torch.ones_like(denom)
  s = torch.where(denom > _EPS, torch.clamp(
      (b * f - c * e) / torch.where(denom > _EPS, denom, one), 0.0, 1.0),
      torch.zeros_like(denom))
  t = (b * s + f) / torch.where(e > _EPS, e, one)
  t_clamped = torch.clamp(t, 0.0, 1.0)
  a_safe = torch.where(a > _EPS, a, one)
  s = torch.where(t != t_clamped,
                  torch.clamp((b * t_clamped - c) / a_safe, 0.0, 1.0), s)
  return a0 + d1 * s[..., None], b0 + d2 * t_clamped[..., None]


def top_k(key: torch.Tensor, k: int) -> torch.Tensor:
  """(..., k) indices of the k greatest of key (..., N), greatest first,
  ties to the lower index (`jax.lax.top_k`'s rule): k rounds of
  `torch.argmax`, which takes the first of equal values, each taking
  its pick out."""
  out = []
  for _ in range(k):
    i = torch.argmax(key, -1, keepdim=True)
    out.append(i)
    key = key.scatter(-1, i, float('-inf'))
  return torch.cat(out, -1)
