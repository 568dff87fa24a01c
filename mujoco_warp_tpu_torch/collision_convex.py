"""The convex narrowphase of the pairs without an analytic collider:
support functions and MPR (Minkowski portal refinement), with a
multi-contact variant (four tilted re-portals).

Mirrors `mujoco_warp_tpu/collision_convex.py` (the support functions of
the sphere, box and mesh :46-97, `_CENTER` :101, `manifold_ncon` :117,
`collider` :133, `mpr` :139, `mpr_multi` :331) on batched tensors: each
function takes (..., 3) positions, (..., 3, 3) frames, (..., 3) sizes
and (..., V, 4) padded hull vertices (xyz, valid) of mesh geoms (None
for the others), and the leading axes are the batch (worlds, pairs,
tilts). The JAX loops are `lax.while_loop`s that stop when every lane is
done; a done lane's state does not change, so here they run their fixed
counts (12 discovery, 24 refinement iterations) with masked updates,
which keeps the stage free of host syncs. The four tilts of `mpr_multi`
are a leading axis of 4.

Contacts follow the analytic colliders: dist (..., K), pos (..., K, 3),
frame (..., K, 3, 3), frame[..., 0, :] the normal from geom 1 into geom
2, dist 1e10 where there is no contact.
"""

from __future__ import annotations

import torch

from . import math
from .types import DisableBit, GeomType

_DISCOVERY_ITERATIONS = 12
_MPR_ITERATIONS = 24
_TOL = 1e-6
# the multi-contact re-portals' tilt (radians)
_MULTI_TILT = 1e-3
_NONE = 1e10


_CONSTS: dict = {}


def _const(name: str, values, like):
  """A constant tensor on like's device and dtype, made once: a step
  builds no tensor from host data (a CUDA graph captures it)."""
  key = (name, like.device, like.dtype)
  if key not in _CONSTS:
    _CONSTS[key] = torch.tensor(values, dtype=like.dtype, device=like.device)
  return _CONSTS[key]


# small vector algebra as products and sums over the last axes: a batched
# matmul of (1, 3) x (3, 3) pieces broadcast over (tilt, world, pair)
# takes 4.09 ms against 0.19 ms at 8192 worlds, 96 pairs and 4 tilts
# (`utils/mpr_ops.py`, NVIDIA H100 80GB HBM3, 700 W)
def _mv(R, v):
  """R v of (..., 3, 3) frames."""
  return (R * v[..., None, :]).sum(-1)


def _mtv(R, v):
  """R^T v of (..., 3, 3) frames."""
  return (R * v[..., :, None]).sum(-2)


def _dot(a, b):
  return (a * b).sum(-1)


def _normalize(x):
  n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
  return x / torch.where(n < 1e-14, 1.0, n)


def _cross(a, b):
  a, b = torch.broadcast_tensors(a, b)
  return torch.linalg.cross(a, b)


def _supp_sphere(p, R, s, vert, d):
  return p + s[..., :1] * _normalize(d)


def _supp_box(p, R, s, vert, d):
  return p + _mv(R, s[..., :3] * torch.sign(_mtv(R, d)))


def bias_hull(vert):
  """(..., V, 4) padded hull (xyz, valid) -> (4, ..., V) planes x, y, z
  and bias: bias 0 at a vertex, -inf at padding, so that bias + x d_x +
  y d_y + z d_z is each vertex's dot with d, padding at -inf."""
  planes = vert.movedim(-1, 0)
  return torch.cat([planes[:3], torch.where(planes[3:] > 0, 0.0,
                                            float('-inf'))], 0)


def _supp_mesh(p, R, s, planes, d):
  """The hull vertex farthest along d: the first of equal ones, padding
  at -inf (`jnp.argmax`'s rule, which `torch.argmax` keeps). planes is
  `bias_hull`'s (4, batch..., V); d (lead..., batch..., 3) may lead with
  more axes (the tilts, or the worlds of a hull that the worlds share).
  The dots are three multiply-adds over the planes: with the argmax they
  take 1.03 ms for one portal at 8192 worlds and 96 pairs, where a
  batched product of the hull (xyz, bias) with (d, 1) takes 2.95 ms (a
  cuBLAS gemv), and 4.09 ms for four tilts against its 3.45
  (`utils/mpr_ops.py`, NVIDIA H100 80GB HBM3, 700 W)."""
  dl = _mtv(R, d)
  dots = torch.addcmul(torch.addcmul(torch.addcmul(
      planes[3], planes[0], dl[..., 0, None]), planes[1], dl[..., 1, None]),
      planes[2], dl[..., 2, None])
  i = torch.argmax(dots, -1, keepdim=True)
  v = torch.cat([torch.gather(planes[k].expand(dots.shape), -1, i)
                 for k in range(3)], -1)
  return p + _mv(R, v)


SUPPORT = {
    GeomType.SPHERE: _supp_sphere,
    GeomType.BOX: _supp_box,
    GeomType.MESH: _supp_mesh,
}


def _center(t, p, R, s, vert):
  """An interior point of the geom: its origin, or a mesh's hull
  centroid."""
  if t != GeomType.MESH:
    return p
  valid = vert[..., 3:]
  c = (vert[..., :3] * (valid > 0)).sum(-2) / torch.clamp(
      (valid[..., 0] > 0).sum(-1, keepdim=True), min=1)
  return p + _mv(R, c)


# geom types whose contact patch can be a face, and those that touch at
# a point
_FLAT_CAPABLE = {GeomType.BOX, GeomType.MESH, GeomType.CYLINDER}
_POINT_LIKE = {GeomType.SPHERE, GeomType.ELLIPSOID}


def manifold_ncon(t1: int, t2: int, disableflags: int) -> int:
  """Contact slots of an MPR pair type: 5 where a flat patch can touch a
  flat patch and multi-contact CCD is on (the default; the MULTICCD
  disable bit turns it off), else 1."""
  if disableflags & DisableBit.MULTICCD:
    return 1
  t1, t2 = GeomType(t1), GeomType(t2)
  if t1 in _POINT_LIKE or t2 in _POINT_LIKE:
    return 1
  if t1 in _FLAT_CAPABLE or t2 in _FLAT_CAPABLE:
    return 5
  return 1


def collider(t1: int, t2: int, disableflags: int):
  """(collide, slots) of an MPR pair type: `mpr_multi` where
  `manifold_ncon` gives 5, else `mpr`."""
  k = manifold_ncon(t1, t2, disableflags)
  return (mpr_multi(t1, t2) if k > 1 else mpr(t1, t2)), k


def _where(c, x, y):
  return torch.where(c[..., None], x, y)


def _mpr_core(t1, t2, p1, m1, s1, v1, p2, m2, s2, v2, margin):
  """MPR of geom 2 inflated by margin against geom 1: (dist (...),
  pos (..., 3), n (..., 3)), n the final portal's outward normal."""
  supp1, supp2 = SUPPORT[GeomType(t1)], SUPPORT[GeomType(t2)]
  dt, dev = p1.dtype, p1.device
  batch = torch.broadcast_shapes(p1.shape, p2.shape)[:-1]
  margin = torch.as_tensor(margin, dtype=dt, device=dev).expand(batch)
  h1 = None if v1 is None else bias_hull(v1)
  h2 = None if v2 is None else bias_hull(v2)

  def S(d):
    a = supp1(p1, m1, s1, h1, -d)
    b = supp2(p2, m2, s2, h2, d) + margin[..., None] * _normalize(d)
    return b - a, a, b

  v0 = _center(t2, p2, m2, s2, v2) - _center(t1, p1, m1, s1, v1)
  v0 = v0.expand(batch + (3,))
  tiny = _const('tiny', [1e-5, 0.0, 0.0], p1)
  v0 = _where(math.norm(v0) < 1e-10, tiny, v0)

  # the initial portal, wound so that cross(w2 - w1, w3 - w1) points away
  # from v0
  d1 = _normalize(-v0)
  w1, a1, b1 = S(d1)
  miss = _dot(w1, d1) < 0
  d2 = _cross(v0, w1)
  d2n = math.norm(d2)
  axis = _const('axis', [0.57, 0.62, 0.53], p1)
  d2 = _where(d2n < 1e-10, _normalize(_cross(v0, axis)),
              d2 / torch.where(d2n < 1e-10, 1.0, d2n)[..., None])
  w2, a2, b2 = S(d2)
  miss = miss | (_dot(w2, d2) < 0)
  d3 = _cross(w1 - v0, w2 - v0)
  swap = _dot(d3, v0) > 0
  w1, w2 = _where(swap, w2, w1), _where(swap, w1, w2)
  a1, a2 = _where(swap, a2, a1), _where(swap, a1, a2)
  b1, b2 = _where(swap, b2, b1), _where(swap, b1, b2)
  d3 = _normalize(_where(swap, -d3, d3))
  w3, a3, b3 = S(d3)

  # portal discovery: turn the portal about the origin ray until the ray
  # v0 -> O passes through it
  dirn = d3
  done = torch.zeros(batch, dtype=torch.bool, device=dev)
  for _ in range(_DISCOVERY_ITERATIONS):
    w3n, a3n, b3n = S(dirn)
    miss_i = _dot(w3n, dirn) < 0
    cA = _dot(_cross(w1, w3n), v0) < 0
    cB = ~cA & (_dot(_cross(w3n, w2), v0) < 0)
    fin = ~cA & ~cB
    upd = ~done & ~miss_i
    onA, onB = cA & upd, cB & upd
    w2, a2, b2 = _where(onA, w3n, w2), _where(onA, a3n, a2), _where(onA, b3n,
                                                                    b2)
    w1, a1, b1 = _where(onB, w3n, w1), _where(onB, a3n, a1), _where(onB, b3n,
                                                                    b1)
    w3, a3, b3 = _where(upd, w3n, w3), _where(upd, a3n, a3), _where(upd, b3n,
                                                                    b3)
    dir_a = _normalize(_cross(w1 - v0, w3n - v0))
    dir_b = _normalize(_cross(w3n - v0, w2 - v0))
    dirn = _where(onA, dir_a, _where(onB, dir_b, dirn))
    miss = miss | (miss_i & ~done)
    done = done | miss_i | (fin & ~done)

  # refinement toward the origin, keeping the outward winding
  done = torch.zeros(batch, dtype=torch.bool, device=dev)
  for _ in range(_MPR_ITERATIONS):
    n = _normalize(_cross(w2 - w1, w3 - w1))
    w4, a4, b4 = S(n)
    sep = _dot(w4, n) < 0
    prog = _dot(n, w4 - w3)
    new_done = done | sep | (prog < _TOL)
    miss = miss | (sep & ~done)
    v4v0 = _cross(w4, v0)
    e1 = _dot(w1, v4v0) > 0
    e2 = _dot(w2, v4v0) > 0
    e3 = _dot(w3, v4v0) > 0
    go = ~new_done
    r1 = ((e1 & e2) | (~e1 & ~e3)) & go
    r2 = (~e1 & e3) & go
    r3 = (e1 & ~e2) & go
    w1, a1, b1 = _where(r1, w4, w1), _where(r1, a4, a1), _where(r1, b4, b1)
    w2, a2, b2 = _where(r2, w4, w2), _where(r2, a4, a2), _where(r2, b4, b2)
    w3, a3, b3 = _where(r3, w4, w3), _where(r3, a4, a3), _where(r3, b4, b3)
    done = new_done

  n = _normalize(_cross(w2 - w1, w3 - w1))
  plane_d = _dot(n, w1)
  w_sa, _, _ = S(n)
  penetrating = (plane_d >= 0) & ~miss & (_dot(n, w_sa) >= 0)

  # the origin's projection on the portal in barycentric coordinates,
  # applied to the witness points on either geom
  q = -n * (-plane_d)[..., None]
  e1, e2, qp = w2 - w1, w3 - w1, q - w1
  d11, d12, d22 = _dot(e1, e1), _dot(e1, e2), _dot(e2, e2)
  dq1, dq2 = _dot(qp, e1), _dot(qp, e2)
  det = torch.clamp(d11 * d22 - d12 * d12, min=1e-12)
  l2 = (d22 * dq1 - d12 * dq2) / det
  l3 = (d11 * dq2 - d12 * dq1) / det
  l1 = 1.0 - l2 - l3
  l1, l2, l3 = (torch.clamp(x, 0.0, 1.0) for x in (l1, l2, l3))
  lsum = torch.clamp(l1 + l2 + l3, min=1e-12)
  l1, l2, l3 = (x[..., None] / lsum[..., None] for x in (l1, l2, l3))
  pa = l1 * a1 + l2 * a2 + l3 * a3
  pb = l1 * b1 + l2 * b2 + l3 * b3
  dist = torch.where(penetrating, margin - plane_d, _NONE)
  pos = 0.5 * (pa + pb) - (0.5 * margin)[..., None] * n
  return dist, pos, n


def mpr(t1: int, t2: int):
  """The MPR collider of a pair type: collide(p1, m1, s1, p2, m2, s2,
  v1, v2, margin) -> (dist (..., 1), pos (..., 1, 3), frame (..., 1, 3,
  3)); geom 2's support is pushed out by margin along each query
  direction, so that a pair within the margin gives dist = margin -
  depth."""
  def collide(p1, m1, s1, p2, m2, s2, v1=None, v2=None, margin=0.0):
    dist, pos, n = _mpr_core(t1, t2, p1, m1, s1, v1, p2, m2, s2, v2, margin)
    return dist[..., None], pos[..., None, :], math.make_frame(-n)[
        ..., None, :, :]
  return collide


def _axis_angle(u, angle):
  """(..., 3, 3) rotations by angle (...) about the unit axes u (..., 3)
  (Rodrigues)."""
  c, s = torch.cos(angle)[..., None, None], torch.sin(angle)[..., None, None]
  z = torch.zeros_like(u[..., 0])
  ux = torch.stack([torch.stack([z, -u[..., 2], u[..., 1]], -1),
                    torch.stack([u[..., 2], z, -u[..., 0]], -1),
                    torch.stack([-u[..., 1], u[..., 0], z], -1)], -2)
  eye = torch.eye(3, dtype=u.dtype, device=u.device)
  return c * eye + s * ux + (1.0 - c) * (u[..., :, None] * u[..., None, :])


def _scale(s, v):
  """The geom's extent: its largest size, or its farthest hull vertex."""
  r = torch.amax(torch.abs(s), -1)
  if v is not None:
    vn = math.norm(v[..., :3]) * (v[..., 3] > 0)
    r = torch.maximum(r, torch.amax(vn, -1))
  return r


def _tangential(x, n):
  return math.norm(x - n * _dot(x, n)[..., None])


# the four tilts: (tangent row of the base frame, sign)
_TILTS = ((1, 1.0), (1, -1.0), (2, 1.0), (2, -1.0))


def mpr_multi(t1: int, t2: int):
  """The multi-contact MPR collider, 5 slots: the base contact, then
  geom 2 tilted by +-_MULTI_TILT about each tangent of the base frame
  (about the base contact point) and MPR again, each tilted contact
  mapped back to the untilted pose to first order and kept where it
  lies farther than 10 _MULTI_TILT times the pair's extent from the base
  contact and the kept ones, tangentially. A flat patch gives its
  corners, a curved surface one point."""
  base = mpr(t1, t2)

  def collide(p1, m1, s1, p2, m2, s2, v1=None, v2=None, margin=0.0):
    dist0, pos0, frame0 = base(p1, m1, s1, p2, m2, s2, v1, v2, margin)
    dist0, c0, frame0 = dist0[..., 0], pos0[..., 0, :], frame0[..., 0, :, :]
    n = frame0[..., 0, :]
    base_hit = dist0 < 1e9
    rmax = torch.clamp(torch.maximum(_scale(s1, v1), _scale(s2, v2)),
                       min=1e-3)
    tol = 10.0 * _MULTI_TILT * rmax

    us = torch.stack([frame0[..., row, :] for row, _ in _TILTS])
    angs = _const('tilts', [sg * _MULTI_TILT for _, sg in _TILTS], p1)
    angs = angs.reshape((4,) + (1,) * (c0.dim() - 1)).expand(us.shape[:-1])
    rots = _axis_angle(us, angs)                         # (4, ..., 3, 3)
    p2r = c0 + _mv(rots, p2 - c0)
    m2r = rots @ m2
    dks, pks, _ = base(p1, m1, s1, p2r, m2r, s2, v1, v2, margin)
    dks, pks = dks[..., 0], pks[..., 0, :]
    half = _axis_angle(us, -0.5 * angs)
    pk_true = c0 + _mv(half, pks - c0)
    dk_true = dks - angs * _dot(_cross(us, pk_true - c0), n)

    dists, poss, valids = [dist0], [c0], [base_hit]
    for ti in range(4):
      pk = pk_true[ti]
      distinct = _tangential(pk - c0, n) > tol
      for j in range(1, len(poss)):
        distinct = distinct & (~valids[j] | (_tangential(pk - poss[j], n) >
                                             tol))
      ok = base_hit & (dks[ti] < 1e9) & distinct
      dists.append(torch.where(ok, dk_true[ti], _NONE))
      poss.append(_where(ok, pk, c0))
      valids.append(ok)
    return (torch.stack(dists, -1), torch.stack(poss, -2),
            frame0[..., None, :, :].expand(dist0.shape + (5, 3, 3)))

  return collide
