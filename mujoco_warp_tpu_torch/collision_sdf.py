"""SDF narrowphase: contacts found by gradient descent on the clearance
sdf1(p) + sdf2(p) + |max(sdf1, sdf2)| from Halton-scattered points in the
intersection of the two geoms' boxes.

Mirrors `mujoco_warp_tpu/collision_sdf.py` (`_halton` :65,
`_primitive_sdf` :73, `_grid_sdf` :100, `_transformed_aabb` :124, the
collider of `sdf_pair_collider` :131) on batched tensors: a group's
(world, pair, starting point) descents run at once, in chunks of at
most SDF_ELEMENTS candidate points (a descent tries 15 step sizes a
pass). A mesh's distance is a trilinear sample of its voxel grid
(`io._build_sdf_grids`, the 8 corners of the sample's cell read by one
`torch.take`), plus the distance to the grid's box outside it.

The JAX package takes every gradient with `jax.grad`; here each is
written out, with jax.grad's choices where a derivative is not unique:
d|x|/dx is +1 at 0; a tie of maximum, minimum or clip sends half to each
side (and a tie of k entries of a max over a vector 1/k to each); floor
passes nothing; |v| has a zero gradient at v = 0. The loops have their
fixed lengths and masked updates (no host sync), so a step that runs them
replays as one CUDA graph.

Contacts follow the other colliders: dist (W, P, N), pos (W, P, N, 3),
frame (W, P, N, 3, 3) for W worlds, P pairs and N = sdf_initpoints
starting points, frame[..., 0, :] the normal from geom 1 into geom 2,
dist _BIG where the two boxes do not meet.
"""

from __future__ import annotations

import numpy as np
import torch

from . import math
from .collision_convex import _const, _mtv, _mv
from .types import GeomType

_BIG = 1e10
# the Armijo test's constant and the 15 step sizes 2 * 0.5^k, k = 1..15
_WOLFE_C = 0.1
_ALPHAS = (2.0 * 0.5 ** np.arange(1, 16)).astype(np.float32)
# candidate points (world, pair, starting point, step size) of one chunk:
# the corners' index, the largest temporary, is 64 bytes a point (1 GB)
SDF_ELEMENTS = 1 << 24


def halton(i: int, base: int) -> float:
  f, r = 1.0, 0.0
  while i > 0:
    f /= base
    r += f * (i % base)
    i //= base
  return r


def starts(ninit: int) -> np.ndarray:
  """(ninit, 3) float32 Halton points in the unit cube (bases 2, 3, 5),
  from Python floats as the JAX collider builds them."""
  return np.array([[halton(i, 2), halton(i, 3), halton(i, 5)]
                   for i in range(ninit)], np.float32)


# ---- small helpers ------------------------------------------------------

def _norm(v):
  """|v| over the last axis (0 at v = 0, as `_safe_norm`)."""
  return torch.linalg.vector_norm(v, dim=-1)


def _unit(v, n):
  """v / n where n > 0, else 0: `_safe_norm`'s gradient."""
  return torch.where(n[..., None] > 0, v / torch.where(
      n > 0, n, torch.ones_like(n))[..., None], torch.zeros_like(v))


def _sgn(x):
  """d|x|/dx: +1 at 0, as jax.grad(jnp.abs)."""
  return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _step(x, y):
  """d max(x, y)/dx: 1 where x > y, 0.5 at a tie, 0 where x < y."""
  return (x > y).to(x.dtype) + 0.5 * (x == y).to(x.dtype)


def _clip_d(x, lo, hi):
  """d clip(x, lo, hi)/dx (jnp.clip: min(max(x, lo), hi))."""
  return _step(x, lo) * _step(hi, torch.maximum(x, lo))


def _max_d(q):
  """d max(q)/dq over the last axis: 1/k to each of k tied maxima."""
  on = (q == q.amax(-1, keepdim=True)).to(q.dtype)
  return on / on.sum(-1, keepdim=True)


def _outside(q, grad: bool = True):
  """|max(q, 0)|; with grad, (it, its gradient in q)."""
  r = torch.clamp(q, min=0.0)
  n = _norm(r)
  if not grad:
    return n
  return n, _unit(r, n) * _step(q, torch.zeros_like(q))


# ---- primitive distances ------------------------------------------------

def primitive_sdf(gtype: int, p, size, grad: bool = False):
  """Signed distance of points p (..., 3) in the frame of a geom of type
  gtype and sizes size (..., 3) (`_primitive_sdf`); with grad, (value,
  gradient in p)."""
  if gtype == GeomType.PLANE:
    v = p[..., 2]
    if not grad:
      return v
    return v, torch.cat([torch.zeros_like(p[..., :2]),
                         torch.ones_like(p[..., 2:])], -1)
  if gtype == GeomType.SPHERE:
    n = _norm(p)
    v = n - size[..., 0]
    return (v, _unit(p, n)) if grad else v
  if gtype == GeomType.BOX:
    q = p.abs() - size
    qmax = q.amax(-1)
    if not grad:
      return _outside(q, False) + torch.clamp(qmax, max=0.0)
    out, dout = _outside(q)
    v = out + torch.clamp(qmax, max=0.0)
    dq = dout + _step(torch.zeros_like(qmax), qmax)[..., None] * _max_d(q)
    return v, _sgn(p) * dq
  if gtype == GeomType.ELLIPSOID:
    a, b = p / size, p / (size * size)
    k0, k1 = _norm(a), _norm(b)
    den = torch.clamp(k1, min=1e-12)
    v = k0 * (k0 - 1.0) / den
    if not grad:
      return v
    dk0 = _unit(a, k0) / size
    dk1 = _unit(b, k1) / (size * size) * _step(k1, torch.full_like(
        k1, 1e-12))[..., None]
    dv = ((2.0 * k0 - 1.0) / den)[..., None] * dk0 - \
        (v / den)[..., None] * dk1
    return v, dv
  if gtype == GeomType.CAPSULE:
    half = size[..., 1]
    z = torch.minimum(torch.maximum(p[..., 2], -half), half)
    w = torch.cat([p[..., :2], (p[..., 2] - z)[..., None]], -1)
    n = _norm(w)
    v = n - size[..., 0]
    if not grad:
      return v
    u = _unit(w, n)
    dz = _clip_d(p[..., 2], -half, half)
    return v, torch.cat([u[..., :2], (u[..., 2] * (1.0 - dz))[..., None]],
                        -1)
  if gtype == GeomType.CYLINDER:
    nxy = _norm(p[..., :2])
    q = torch.stack([nxy - size[..., 0], p[..., 2].abs() - size[..., 1]], -1)
    qmax = q.amax(-1)
    if not grad:
      return torch.clamp(qmax, max=0.0) + _outside(q, False)
    out, dout = _outside(q)
    v = torch.clamp(qmax, max=0.0) + out
    dq = dout + _step(torch.zeros_like(qmax), qmax)[..., None] * _max_d(q)
    uxy = _unit(p[..., :2], nxy)
    return v, torch.cat([uxy * dq[..., :1],
                         (_sgn(p[..., 2]) * dq[..., 1])[..., None]], -1)
  raise NotImplementedError(f'sdf for geom type {gtype}')


# ---- voxel grids ----------------------------------------------------------

class Grid:
  """One side's voxel grids in a group of pairs: the grids (G, R, R, R),
  flat, each pair's grid index gi (P,) and its grid's box (center, half
  (P, 3)), with the per-pair constants of the sample in the same layout.
  A sample reads its cell's 8 corners by `torch.take` of the flat grids
  (8 values a sample at the corner offsets): on the card that takes 0.61
  ms for 2^24 samples, where a gather of rows of a table of each cell's
  corners (any of indexing, index_select, gather, embedding) takes 10.1
  ms (`utils/sdf_ops.py`, NVIDIA H100 80GB HBM3, 700 W)."""

  PER_PAIR = ('center', 'half', 'lo', 'hi', 'ext', 'base')
  FLOATS = ('flat', 'center', 'half', 'lo', 'hi', 'ext')

  def __init__(self, grids, gi, center, half):
    R = grids.shape[1]
    self.flat, self.res = grids.reshape(-1), R
    self.center, self.half = center, half
    self.lo, self.hi = center - half, center + half
    self.ext = torch.clamp(self.hi - self.lo, min=1e-12)
    # the flat index in int64: a float32 one is exact only below 2^24
    self.base = gi.long() * R ** 3
    self.stride = torch.tensor([R * R, R, 1], device=center.device)
    self.corners = torch.tensor([(j & 1) * R * R + (j >> 1 & 1) * R +
                                 (j >> 2 & 1) for j in range(8)],
                                device=center.device)

  def _map(self, fn, keys=PER_PAIR) -> 'Grid':
    """A copy with fn applied to the tensors `keys` (the per-pair ones)."""
    out = Grid.__new__(Grid)
    out.__dict__.update(self.__dict__)
    for k in keys:
      setattr(out, k, fn(getattr(self, k)))
    return out

  def to(self, dtype) -> 'Grid':
    """The same grids in dtype."""
    return self._map(lambda x: x.to(dtype), self.FLOATS)

  def pairs(self, s: int, e: int) -> 'Grid':
    """The grids of pairs s..e-1."""
    return self._map(lambda x: x[s:e])

  def view(self, lead: int, tail: int) -> 'Grid':
    """The per-pair tensors with `lead` axes before the pair axis and
    `tail` after it (broadcast over worlds, starting points, steps)."""
    return self._map(lambda x: x.reshape((1,) * lead + (x.shape[0],) +
                                         (1,) * tail + x.shape[1:]))


def grid_sdf(grid: Grid, p, grad: bool = False):
  """The grid's signed distance at points p (..., 3) in its mesh's frame
  (`_grid_sdf`): the trilinear sample at p clamped into the grid's box
  (three lerps, along x, y, z), plus p's distance to the box; with grad,
  (value, gradient in p)."""
  R = grid.res
  q = (p - grid.center).abs() - grid.half
  pc = torch.clamp(p, min=grid.lo, max=grid.hi)
  u = (pc - grid.lo) / grid.ext * (R - 1)
  i0 = torch.clamp(torch.floor(u), 0, R - 2)
  f = u - i0
  corner = (i0.long() * grid.stride).sum(-1) + grid.base
  v = torch.take(grid.flat, corner[..., None] + grid.corners).reshape(
      f.shape[:-1] + (2, 2, 2))                                  # z, y, x
  a = torch.lerp(v[..., 0], v[..., 1], f[..., 0, None, None])   # (z, y)
  b = torch.lerp(a[..., 0], a[..., 1], f[..., 1, None])         # (z,)
  c = torch.lerp(b[..., 0], b[..., 1], f[..., 2])
  if not grad:
    return _outside(q, False) + c
  out, dout = _outside(q)
  dx = v[..., 1] - v[..., 0]
  dx = torch.lerp(dx[..., 0], dx[..., 1], f[..., 1, None])
  dfx = torch.lerp(dx[..., 0], dx[..., 1], f[..., 2])
  dy = a[..., 1] - a[..., 0]
  dfy = torch.lerp(dy[..., 0], dy[..., 1], f[..., 2])
  dfz = b[..., 1] - b[..., 0]
  dc = torch.stack([dfx, dfy, dfz], -1) * ((R - 1) / grid.ext) * \
      _clip_d(p, grid.lo, grid.hi)
  return out + c, _sgn(p - grid.center) * dout + dc


def transformed_aabb(center, half, pos, mat):
  """The axis-aligned box (center, half) of a box (center, half) moved
  by (pos, mat) (`_transformed_aabb`)."""
  return _mv(mat, center) + pos, _mv(mat.abs(), half)


# ---- the collider -----------------------------------------------------------

class Side:
  """One side of a group of pairs: its geom type and, per pair, its sizes
  (P, 3), its box in its frame (P, 2, 3) and its Grid (None for a
  primitive)."""

  def __init__(self, gtype: int, size, aabb, grid: Grid | None):
    self.gtype, self.size, self.aabb, self.grid = gtype, size, aabb, grid

  def to(self, dtype) -> 'Side':
    """The same side in dtype."""
    return Side(self.gtype, self.size.to(dtype), self.aabb.to(dtype),
                None if self.grid is None else self.grid.to(dtype))

  def pairs(self, s: int, e: int) -> 'Side':
    """The side of pairs s..e-1."""
    return Side(self.gtype, self.size[s:e], self.aabb[s:e],
                None if self.grid is None else self.grid.pairs(s, e))

  def sdf(self, p, tail: int, grad: bool = False):
    """The distance at points p (W, P, tail axes..., 3)."""
    if self.grid is not None:
      return grid_sdf(self.grid.view(1, tail), p, grad)
    size = self.size.reshape((1, -1) + (1,) * tail + (3,))
    return primitive_sdf(self.gtype, p, size, grad)


def _clearance(s1, s2, total: bool):
  """The clearance of the two distances: s1 + s2 + |max(s1, s2)| (total)
  or max(s1, s2)."""
  mx = torch.maximum(s1, s2)
  return (s1 + s2) + mx.abs() if total else mx


def _clearance_grad(s1, s2, g1, g2, total: bool):
  """(clearance, its gradient) from the distances and their gradients."""
  mx = torch.maximum(s1, s2)
  d1, d2 = _step(s1, s2), _step(s2, s1)
  if total:
    sg = _sgn(mx)
    d1, d2 = 1.0 + sg * d1, 1.0 + sg * d2
  val = (s1 + s2) + mx.abs() if total else mx
  return val, d1[..., None] * g1 + d2[..., None] * g2


def _descend(side1: Side, side2: Side, rel_mat, rel_pos, x, iters: int,
             choices=None):
  """The descents from x (W, P, N, 3) in geom 2's frame: `iters` passes
  on the clearance sum, then one on the max; (dist (W, P, N), x). With a
  list `choices`, each pass appends its step size's index (W, P, N), -1
  where the pass makes no step."""
  R = rel_mat[:, :, None]                                  # (W, P, 1, 3, 3)
  t = rel_pos[:, :, None]
  alphas = _const('sdf_alphas', _ALPHAS, x)
  accept_c = _const('sdf_armijo', np.float32(-_WOLFE_C) * _ALPHAS, x)
  last = _const('sdf_last', _ALPHAS <= 1e-4, x) > 0

  def gradstep(xx, stopped, dist, total):
    p1 = _mv(R, xx) + t
    s1, g1 = side1.sdf(p1, 1, True)
    s2, g2 = side2.sdf(xx, 1, True)
    d0, g = _clearance_grad(s1, s2, _mtv(R, g1), g2, total)
    gd = (g * g).sum(-1)
    a = alphas[:, None]
    cand = xx[..., None, :] - g[..., None, :] * a
    # geom 1's frame: rel_mat (x - a g) + rel_pos, as (rel_mat x +
    # rel_pos) - a (rel_mat g), the product taken once a descent
    cand1 = p1[..., None, :] - _mv(R, g)[..., None, :] * a
    dvals = _clearance(side1.sdf(cand1, 2), side2.sdf(cand, 2),
                       total)                               # (W, P, N, 15)
    accept = ((dvals - d0[..., None]) <= accept_c * gd[..., None]) | last
    first = accept.to(torch.uint8).argmax(-1, keepdim=True)
    xn = torch.gather(cand, -2, first[..., None].expand(
        first.shape + (3,)))[..., 0, :]
    dn = torch.gather(dvals, -1, first)[..., 0]
    tiny = gd < 1e-12
    worse = dn > d0
    if choices is not None:
      choices.append(torch.where(stopped | tiny, -1, first[..., 0]))
    xx = torch.where((stopped | tiny)[..., None], xx, xn)
    dist = torch.where(stopped, dist, torch.where(tiny, d0, dn))
    return xx, stopped | tiny | worse, dist

  fresh = lambda: (torch.zeros(x.shape[:-1], dtype=torch.bool,
                               device=x.device),
                   torch.full(x.shape[:-1], _BIG, dtype=x.dtype,
                              device=x.device))
  stopped, dist = fresh()
  for _ in range(iters):
    x, stopped, dist = gradstep(x, stopped, dist, True)
  stopped, dist = fresh()
  x, _, dist = gradstep(x, stopped, dist, False)
  return dist, x


def _collide_chunk(side1: Side, side2: Side, starts_t, iters: int, pos1,
                   mat1, pos2, mat2, trace: bool = False):
  """The collider on worlds' geom frames pos (W, P, 3), mat (W, P, 3, 3)
  of both sides."""
  rel_mat = (mat1[..., :, :, None] * mat2[..., :, None, :]).sum(-3)  # g2->g1
  rel_pos = _mtv(mat1, pos2 - pos1)
  c2g1, h2g1 = transformed_aabb(side2.aabb[:, 0], side2.aabb[:, 1],
                                rel_pos, rel_mat)
  c1, h1 = side1.aabb[:, 0], side1.aabb[:, 1]
  imin = torch.maximum(c1 - h1, c2g1 - h2g1)
  imax = torch.minimum(c1 + h1, c2g1 + h2g1)
  x_g1 = imin[:, :, None] + (imax - imin)[:, :, None] * starts_t
  x_w = _mv(mat1[:, :, None], x_g1) + pos1[:, :, None]
  x0 = _mtv(mat2[:, :, None], x_w - pos2[:, :, None])
  choices = [] if trace else None
  dist, x = _descend(side1, side2, rel_mat, rel_pos, x0, iters, choices)
  R = rel_mat[:, :, None]
  _, g1 = side1.sdf(_mv(R, x) + rel_pos[:, :, None], 1, True)
  _, g2 = side2.sdf(x, 1, True)
  n = math.normalize(math.normalize(_mtv(R, g1)) - math.normalize(g2))
  M2 = mat2[:, :, None]
  n_w = _mv(M2, n)
  pos = (_mv(M2, x) + pos2[:, :, None]) - n_w * dist[..., None] * 0.5
  empty = (imax < imin).any(-1)
  dist = torch.where(empty[..., None], _BIG, dist)
  out = dist, pos, math.make_frame(n_w)
  return out + (torch.stack(choices, -1),) if trace else out


def collide(side1: Side, side2: Side, ninit: int, iters: int, pos1, mat1,
            pos2, mat2, trace: bool = False):
  """Contacts (dist, pos, frame) of the pairs whose geom frames are pos1,
  pos2 (W, P, 3) and mat1, mat2 (W, P, 3, 3), from ninit starting points
  a pair (the collider of `sdf_pair_collider`); with trace, also each
  descent's step-size choices (W, P, N, iters + 1), -1 where a pass makes
  no step. It runs in chunks of at most SDF_ELEMENTS candidate points:
  runs of neighbouring pairs in every world, so that a chunk samples few
  grids and their corners stay in the card's L2 (a pair's worlds in
  chunks where one pair's are more)."""
  W, P = pos1.shape[:2]
  starts_t = _const(f'sdf_starts{ninit}', starts(ninit), pos1)
  per_pair = ninit * len(_ALPHAS)
  pc = max(1, SDF_ELEMENTS // (W * per_pair))
  wc = W if W * per_pair <= SDF_ELEMENTS else max(1, SDF_ELEMENTS //
                                                  per_pair)
  parts = []
  for s in range(0, P, pc):
    e = min(s + pc, P)
    a, b = side1.pairs(s, e), side2.pairs(s, e)
    outs = [_collide_chunk(a, b, starts_t, iters, pos1[w:w + wc, s:e],
                           mat1[w:w + wc, s:e], pos2[w:w + wc, s:e],
                           mat2[w:w + wc, s:e], trace)
            for w in range(0, W, wc)]
    parts.append(tuple(torch.cat(x, 0) for x in zip(*outs)))
  return tuple(torch.cat(x, 1) for x in zip(*parts))
