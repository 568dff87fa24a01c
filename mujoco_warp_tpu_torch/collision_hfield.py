"""The height-field narrowphase: sphere, capsule, box, cylinder and
ellipsoid against a height field.

Mirrors `mujoco_warp_tpu/collision_hfield.py` (`_tri_closest` :25,
`sphere_hfield` :75, `_cell_prisms` :147, `prism_mpr_hfield` :191,
`hfield_collider` :228) on batched tensors: each function takes the
height field geom's (..., 3) position and (..., 3, 3) frame and the other
geom's (..., 3) position, (..., 3, 3) frame and (..., 3) size, the
leading axes being the batch (worlds, pairs). A geom tests the STATIC
5 x 5 neighbourhood of grid cells around its (x, y) in the height
field's frame (`_K` = 3), two triangles a cell: a sphere by the closest
point on each triangle, a capsule as three spheres along its axis, the
other types by MPR (`collision_convex`) against each triangle's prism,
extruded down to the field's base. Each pair keeps NCONH contacts: the
candidates nearest the surface (sphere, capsule) or the deepest (the
prisms), ties to the lower candidate (as `jax.lax.top_k`), with a
candidate within 1e-5 of an earlier kept one dropped (dist 1e10).

The heights are gathered from the field's (nrow, ncol) grid by index:
no tensor of the whole grid is made per world, and nothing syncs with
the host. Contacts follow the other colliders: dist (..., NCONH), pos
(..., NCONH, 3), frame (..., NCONH, 3, 3), frame[..., 0, :] the normal
from the height field into the geom.
"""

from __future__ import annotations

import torch

from . import collision_convex
from . import math
from .types import GeomType

# the neighbourhood's half width in cells, and the contacts of a pair
# (`_K`, `_NCONH`)
_K = 3
NCONH = 4
# a candidate within this distance of an earlier kept one is dropped
_DUPLICATE = 1e-5
_NONE = 1e10


def _dot(a, b):
  return (a * b).sum(-1)


def _tri_closest(a, b, c, p):
  """The closest point on triangles (a, b, c) to p, all (..., 3),
  branch-free (the JAX function's cases and their order)."""
  ab, ac = b - a, c - a
  ap, bp, cp = p - a, p - b, p - c
  d1, d2 = _dot(ab, ap), _dot(ac, ap)
  d3, d4 = _dot(ab, bp), _dot(ac, bp)
  d5, d6 = _dot(ab, cp), _dot(ac, cp)

  va = d3 * d6 - d5 * d4
  vb = d5 * d2 - d1 * d6
  vc = d1 * d4 - d3 * d2
  denom_v = torch.clamp(va + vb + vc, min=1e-12)
  v_face = (vb / denom_v)[..., None]
  w_face = (vc / denom_v)[..., None]
  face = a + ab * v_face + ac * w_face

  t_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=1e-12), 0.0, 1.0)
  on_ab = a + t_ab[..., None] * ab
  t_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=1e-12), 0.0, 1.0)
  on_ac = a + t_ac[..., None] * ac
  t_bc = torch.clamp((d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6),
                                             min=1e-12), 0.0, 1.0)
  on_bc = b + t_bc[..., None] * (c - b)

  vert_a = (d1 <= 0) & (d2 <= 0)
  vert_b = (d3 >= 0) & (d4 <= d3)
  vert_c = (d6 >= 0) & (d5 <= d6)
  edge_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
  edge_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
  edge_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

  out = face
  for case, point in ((edge_bc, on_bc), (edge_ac, on_ac), (edge_ab, on_ab),
                      (vert_c, c), (vert_b, b), (vert_a, a)):
    out = torch.where(case[..., None], point, out)
  return out


def _take(x, idx):
  """x (..., N, *rest) at the indices idx (..., k) of its axis -1 - len
  (rest)."""
  rest = x.shape[idx.dim():]
  g = idx.reshape(idx.shape + (1,) * len(rest)).expand(idx.shape + rest)
  return torch.gather(x, idx.dim() - 1, g)


def _drop_duplicates(dist, pos):
  """dist (..., k) at _NONE where pos (..., k, 3) lies within _DUPLICATE of
  an earlier candidate's (kept or not, as the JAX function compares)."""
  out = [dist[..., 0]]
  for i in range(1, dist.shape[-1]):
    same = (math.norm(pos[..., i:i + 1, :] - pos[..., :i, :]) <
            _DUPLICATE).any(-1)
    out.append(torch.where(same, _NONE, dist[..., i]))
  return torch.stack(out, -1)


def _cells(data, nrow: int, ncol: int, hsize, c_loc):
  """The 2 x 25 triangles (a, b, c), each (..., 50, 3) in the height
  field's frame, of the 5 x 5 cells around the local point c_loc (...,
  3): cells by row offset, then column offset, two triangles a cell.
  data is the field's (max nrow, max ncol) padded grid, hsize its (4,)
  size."""
  dtype = c_loc.dtype
  sx, sy, sz = hsize[0], hsize[1], hsize[2]
  dx = 2.0 * sx / (ncol - 1)
  dy = 2.0 * sy / (nrow - 1)
  # the cell under the point; clamped before the cast, which leaves every
  # cell index the clip below keeps as it is
  fx = torch.clamp((c_loc[..., 0] + sx) / dx, -1.0, float(ncol))
  fy = torch.clamp((c_loc[..., 1] + sy) / dy, -1.0, float(nrow))
  ci = torch.clamp(torch.floor(fx).long(), 0, ncol - 2)
  ri = torch.clamp(torch.floor(fy).long(), 0, nrow - 2)
  offs = torch.arange(-_K + 1, _K, device=c_loc.device)
  n = len(range(-_K + 1, _K))
  r0 = torch.clamp(ri[..., None, None] + offs[:, None], 0, nrow - 2)
  c0 = torch.clamp(ci[..., None, None] + offs[None, :], 0, ncol - 2)
  r0, c0 = (x.expand(ri.shape + (n, n)).reshape(ri.shape + (n * n,))
            for x in (r0, c0))
  x0 = -sx + c0.to(dtype) * dx
  y0 = -sy + r0.to(dtype) * dy
  flat = data.to(dtype).reshape(-1)
  stride = data.shape[1]
  z = lambda dr, dc: torch.take(flat, (r0 + dr) * stride + (c0 + dc)) * sz
  p00 = torch.stack([x0, y0, z(0, 0)], -1)
  p01 = torch.stack([x0 + dx, y0, z(0, 1)], -1)
  p10 = torch.stack([x0, y0 + dy, z(1, 0)], -1)
  p11 = torch.stack([x0 + dx, y0 + dy, z(1, 1)], -1)
  tri = lambda u, v: torch.stack([u, v], -2).reshape(
      ri.shape + (2 * n * n, 3))
  return tri(p00, p00), tri(p01, p11), tri(p11, p10)


def sphere_hfield(data, nrow: int, ncol: int, hpos, hmat, hsize, center,
                  radius):
  """Spheres of (...,) radius at (..., 3) centers against a height field
  at (..., 3) hpos, (..., 3, 3) hmat: (dist (..., NCONH), pos (...,
  NCONH, 3), frame (..., NCONH, 3, 3)), the NCONH of the 50 triangle
  candidates nearest the surface by |dist| (a point deep below the
  surface lies below far triangles' planes too, which report spurious
  depths)."""
  dtype = center.dtype
  c_loc = collision_convex._mtv(hmat, center - hpos)
  a, b, c = _cells(data, nrow, ncol, hsize, c_loc)
  p = c_loc[..., None, :]
  q = _tri_closest(a, b, c, p)
  dvec = p - q
  dn = math.norm(dvec)
  small = dn < 1e-12
  n_loc = dvec / torch.where(small, 1.0, dn)[..., None]
  up = collision_convex._const('up', [0.0, 0.0, 1.0], dvec)
  n_loc = torch.where(small[..., None], up, n_loc)
  # a center below the triangle's plane: the surface normal, depth < 0
  tn = math.normalize(torch.linalg.cross(b - a, c - a))
  below = _dot(dvec, tn) < 0
  dist = torch.where(below, -dn, dn) - radius[..., None]
  n_loc = torch.where(below[..., None], tn, n_loc)
  pos = q + 0.5 * dist[..., None] * n_loc
  tie = torch.arange(dist.shape[-1], device=dist.device).to(dtype) * 1e-7
  idx = math.top_k(-(torch.abs(dist) + tie), NCONH)
  pos_k = collision_convex._mv(hmat[..., None, :, :], _take(pos, idx)) + \
      hpos[..., None, :]
  n_k = collision_convex._mv(hmat[..., None, :, :], _take(n_loc, idx))
  dist_k = _drop_duplicates(_take(dist, idx), pos_k)
  return dist_k, pos_k, math.make_frame(n_k)


def capsule_hfield(data, nrow: int, ncol: int, hpos, hmat, hsize, p2, m2,
                   s2):
  """Capsules as three spheres at their axis's ends and middle
  (`hfield_collider`, :239-254): the NCONH of the spheres' 3 NCONH
  contacts nearest the surface by |dist|."""
  axis = m2[..., :, 2] * s2[..., 1:2]
  e = collision_convex._const('capsule_ends', [-1.0, 0.0, 1.0], p2)
  centers = p2[..., None, :] + e[:, None] * axis[..., None, :]
  lift = lambda x: x[..., None, :].expand(centers.shape)
  dist, pos, frame = sphere_hfield(
      data, nrow, ncol, lift(hpos), hmat[..., None, :, :].expand(
          centers.shape + (3,)), hsize, centers,
      s2[..., None, 0].expand(centers.shape[:-1]))
  lead = dist.shape[:-2]
  dist, pos, frame = (dist.reshape(lead + (-1,)), pos.reshape(lead + (-1, 3)),
                      frame.reshape(lead + (-1, 3, 3)))
  idx = math.top_k(-torch.abs(dist), NCONH)
  return _take(dist, idx), _take(pos, idx), _take(frame, idx)


def _cell_prisms(data, nrow: int, ncol: int, hmat, hpos, hsize, center):
  """(..., 50, 6, 4) the prisms under the 50 triangles around center
  (..., 3), in the height field's frame and the mesh hull layout (xyz,
  valid): each triangle and its copy at the field's base, z = -size[3]
  (the prisms C MuJoCo's mjc_ConvexHField collides)."""
  c_loc = collision_convex._mtv(hmat, center - hpos)
  top = torch.stack(_cells(data, nrow, ncol, hsize, c_loc), -2)
  base = (-hsize[3]).expand(top.shape[:-1] + (1,))
  bot = torch.cat([top[..., :2], base], -1)
  verts = torch.cat([top, bot], -2)
  return torch.cat([verts, torch.ones_like(verts[..., :1])], -1)


def prism_contacts(data, nrow: int, ncol: int, t2: int, p1, m1, hsize, p2,
                   m2, s2):
  """Every candidate of `prism_mpr_hfield`: (dist (..., 50, K), pos (...,
  50, K, 3), frame (..., 50, K, 3, 3)), MPR of geoms of type t2 against
  each of the 50 prisms around them, the prism as a mesh hull:
  `mpr_multi`'s K = 5 contacts for box and cylinder, which can touch a
  face flat, `mpr`'s K = 1 for the ellipsoid."""
  prisms = _cell_prisms(data, nrow, ncol, m1, p1, hsize, p2)
  if GeomType(t2) in collision_convex._FLAT_CAPABLE:
    collide = collision_convex.mpr_multi(GeomType.MESH, t2)
  else:
    collide = collision_convex.mpr(GeomType.MESH, t2)
  ex = lambda x, k: x.unsqueeze(-2 - k).expand(
      prisms.shape[:-2] + x.shape[x.dim() - 1 - k:])
  p1e = ex(p1, 0)
  return collide(p1e, ex(m1, 1), torch.zeros_like(p1e), ex(p2, 0),
                 ex(m2, 1), ex(s2, 0), v1=prisms,
                 margin=torch.zeros_like(p1e[..., 0]))


def deepest(dist, pos, frame):
  """The NCONH deepest of a pair's prism candidates (`prism_contacts`'s
  outputs), in the prisms' order, then each prism's: (dist (..., NCONH),
  pos, frame), a candidate within _DUPLICATE of an earlier kept one
  dropped (a deep vertex lies in several prisms)."""
  lead = dist.shape[:-2]
  dist = dist.reshape(lead + (-1,))
  pos = pos.reshape(lead + (-1, 3))
  frame = frame.reshape(lead + (-1, 3, 3))
  idx = math.top_k(-dist, NCONH)
  pos_k = _take(pos, idx)
  return (_drop_duplicates(_take(dist, idx), pos_k), pos_k,
          _take(frame, idx))


def prism_mpr_hfield(data, nrow: int, ncol: int, t2: int, p1, m1, hsize,
                     p2, m2, s2):
  """Geoms of type t2 (box, cylinder, ellipsoid) against a height field
  by MPR against the prisms around them (C MuJoCo's mjc_ConvexHField
  collides the same prisms): the NCONH deepest, (dist, pos, frame)."""
  return deepest(*prism_contacts(data, nrow, ncol, t2, p1, m1, hsize, p2,
                                 m2, s2))


def candidates(t2: int) -> int:
  """(pair, candidate) work of one pair of (HFIELD, t2), in units of a
  (..., 3) float temporary: the 50 triangles of a sphere, three times
  that for a capsule, and 6 hull vertices a prism, times MPR's 5 portals
  for box and cylinder. The driver's chunks of worlds take it."""
  tri = (2 * _K - 1) ** 2 * 2
  if t2 == GeomType.SPHERE:
    return tri
  if t2 == GeomType.CAPSULE:
    return 3 * tri
  portals = 5 if GeomType(t2) in collision_convex._FLAT_CAPABLE else 1
  return tri * 6 * portals


def collide(t2: int, data, nrow: int, ncol: int, hsize, p1, m1, p2, m2, s2):
  """(HFIELD, t2) contacts of the height field with grid data (max nrow,
  max ncol), nrow x ncol, size hsize (4,), at (..., 3) p1, (..., 3, 3)
  m1, against geoms at p2, m2 with sizes s2 (..., 3) (`hfield_collider`):
  (dist (..., NCONH), pos (..., NCONH, 3), frame (..., NCONH, 3, 3))."""
  if t2 == GeomType.SPHERE:
    return sphere_hfield(data, nrow, ncol, p1, m1, hsize, p2, s2[..., 0])
  if t2 == GeomType.CAPSULE:
    return capsule_hfield(data, nrow, ncol, p1, m1, hsize, p2, m2, s2)
  if t2 in (GeomType.BOX, GeomType.CYLINDER, GeomType.ELLIPSOID):
    return prism_mpr_hfield(data, nrow, ncol, t2, p1, m1, hsize, p2, m2, s2)
  raise NotImplementedError(f'height field against geom type {t2}')
