"""Model compiler and state allocation for the PyTorch port.

`put_model` turns a C-compiled `mujoco.MjModel` into the port's Model
(mirrors `mujoco_warp_tpu/io.py:794`). It only reads the compiled
model's arrays and never imports the `mujoco` bindings itself: a machine
without `mujoco` loads a model saved with `save_model` (`load_model`).
`model_from_numpy` / `data_from_numpy` build Model and Data from plain
numpy arrays, which is also how the parity tests carry state over from
the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from . import collision_convex
from . import collision_hfield
from . import types
from .types import (BiasType, ConeType, Contact, Data, DisableBit, DynType,
                    EnableBit, EqType, GainType, GeomType, IntegratorType,
                    JointType, Model, ObjType, Option, SensorType,
                    SolverType, Statistic, TrnType)

# candidate contacts per supported geom-type pair (keys sorted by type)
MAX_CONTACTS = {
    (GeomType.PLANE, GeomType.SPHERE): 1,
    (GeomType.PLANE, GeomType.CAPSULE): 2,
    (GeomType.PLANE, GeomType.BOX): 4,
    (GeomType.SPHERE, GeomType.SPHERE): 1,
    (GeomType.SPHERE, GeomType.CAPSULE): 1,
    (GeomType.CAPSULE, GeomType.CAPSULE): 1,
    (GeomType.CAPSULE, GeomType.BOX): 2,
    (GeomType.BOX, GeomType.BOX): 8,
    (GeomType.SPHERE, GeomType.BOX): 1,
    (GeomType.PLANE, GeomType.MESH): 4,
}
# pair types without an analytic collider that go through MPR
# (`collision_convex`; their slots: `collision_convex.manifold_ncon`), in
# the static driver and in the large-scene broadphase alike. The other
# cylinder pairs (capsule-, sphere-, plane-cylinder, cylinder-mesh) are
# refused: no scene of the port holds one
MPR_PAIRS = frozenset({(GeomType.SPHERE, GeomType.MESH),
                       (GeomType.BOX, GeomType.MESH),
                       (GeomType.MESH, GeomType.MESH),
                       (GeomType.CYLINDER, GeomType.BOX),
                       (GeomType.CYLINDER, GeomType.CYLINDER)})
# the types an SDF geom pairs with (`mujoco_warp_tpu/io.py:395-399`); such
# a pair runs the SDF narrowphase (`collision_sdf.py`) with
# Option.sdf_initpoints candidate contacts
SDF_PARTNERS = frozenset({GeomType.PLANE, GeomType.SPHERE, GeomType.CAPSULE,
                          GeomType.ELLIPSOID, GeomType.CYLINDER,
                          GeomType.BOX, GeomType.MESH, GeomType.SDF})
# the types a height field pairs with (`mujoco_warp_tpu/io.py:391-394`,
# :412 for a <pair>); such a pair runs the height-field narrowphase
# (`collision_hfield.py`) with collision_hfield.NCONH candidate contacts
HFIELD_PARTNERS = frozenset({GeomType.SPHERE, GeomType.CAPSULE,
                             GeomType.ELLIPSOID, GeomType.CYLINDER,
                             GeomType.BOX})
# the voxel grids' resolution when MJWT_SDF_RES is unset (the JAX
# package's default, `mujoco_warp_tpu/io.py:716`)
SDF_RES = 48

# vertices of a decimated hull (`mesh_hullvert_small`), which the culled
# narrowphase gathers per world (the JAX package's `MJWT_HULL_MAX`
# default, `mujoco_warp_tpu/io.py:196`)
HULL_SMALL = 64

# the sensor types the port evaluates (`sensor.py`), and the objects they
# may sit on
SENSOR_TYPES = (SensorType.FRAMEQUAT, SensorType.GYRO,
                SensorType.ACCELEROMETER, SensorType.MAGNETOMETER)
SENSOR_OBJECTS = (ObjType.BODY, ObjType.XBODY, ObjType.SITE)


def _tup(x) -> tuple:
  """numpy int array -> nested tuple of python ints."""
  a = np.asarray(x)
  if a.ndim == 1:
    return tuple(int(v) for v in a)
  return tuple(_tup(r) for r in a)


def _need(ok, what):
  if not ok:
    raise NotImplementedError(f'{what} is not ported yet')


def check_options(opt):
  """Raise NotImplementedError for options outside the port's gate: opt
  is a compiled model's `opt` or a Model's Option (so options changed on
  a loaded Model, `override_model` or `m.replace(opt=...)`, are held to
  the same gate when the model is stepped)."""
  _need(opt.cone in (ConeType.PYRAMIDAL, ConeType.ELLIPTIC),
        f'cone {int(opt.cone)}')
  _need(opt.integrator in (IntegratorType.EULER, IntegratorType.RK4,
                           IntegratorType.IMPLICITFAST),
        f'integrator {int(opt.integrator)}')
  _need(opt.solver in (SolverType.NEWTON, SolverType.CG),
        f'solver {int(opt.solver)}')
  _need(opt.enableflags == 0, 'enable flags')
  for bit in (DisableBit.CONSTRAINT, DisableBit.CONTACT):
    _need(not opt.disableflags & bit, f'disable flag {bit.name}')


def _validate(mjm):
  """Raise NotImplementedError for anything outside the port's gate."""
  need = _need
  for s in range(mjm.nsensor):
    st = SensorType(int(mjm.sensor_type[s]))
    need(st in SENSOR_TYPES, f'sensor type {st.name}')
    for kind, obj in (('object', mjm.sensor_objtype[s]),
                      ('reference', mjm.sensor_reftype[s])):
      need(obj in SENSOR_OBJECTS or (kind == 'reference' and
                                     mjm.sensor_refid[s] < 0),
           f'sensor {kind} type {int(obj)}')
  need(mjm.ntendon == 0, 'tendons')
  need(mjm.na == 0, 'actuator activation states')
  need(mjm.nflex == 0, 'flex')
  need(mjm.nmocap == 0, 'mocap bodies')
  need(mjm.ngravcomp == 0, 'gravity compensation')
  for g in range(mjm.ngeom):
    if mjm.geom_type[g] == GeomType.SDF:
      need(mjm.geom_plugin[g] < 0, f'SDF geom plugins (geom {g})')
      need(mjm.geom_dataid[g] >= 0, f'SDF geoms without a mesh (geom {g})')
  need(mjm.nplugin == 0, 'plugins')
  need(mjm.opt.density == 0 and mjm.opt.viscosity == 0 and
       not np.any(mjm.opt.wind != 0), 'fluid forces')
  check_options(mjm.opt)
  scalar_joint = lambda j: mjm.jnt_type[j] in (JointType.SLIDE,
                                               JointType.HINGE)
  for i in range(mjm.neq):
    need(mjm.eq_type[i] == EqType.JOINT,
         f'equality type {int(mjm.eq_type[i])}')
    need(scalar_joint(mjm.eq_obj1id[i]) and (
        mjm.eq_obj2id[i] < 0 or scalar_joint(mjm.eq_obj2id[i])),
         'joint equalities other than on slide/hinge joints')
  for j in range(mjm.njnt):
    jt = int(mjm.jnt_type[j])
    scalar = jt in (JointType.SLIDE, JointType.HINGE)
    need(scalar or not mjm.jnt_limited[j], f'limits on joint type {jt}')
    need(scalar or mjm.jnt_stiffness[j] == 0, f'springs on joint type {jt}')
  for u in range(mjm.nu):
    need(mjm.actuator_trntype[u] == TrnType.JOINT and
         mjm.jnt_type[mjm.actuator_trnid[u, 0]] in (JointType.SLIDE,
                                                    JointType.HINGE),
         'actuators other than on slide/hinge joints')
    need(mjm.actuator_gaintype[u] in (GainType.FIXED, GainType.AFFINE),
         f'gain type {mjm.actuator_gaintype[u]}')
    need(mjm.actuator_biastype[u] in (BiasType.NONE, BiasType.AFFINE),
         f'bias type {mjm.actuator_biastype[u]}')
    need(mjm.actuator_dyntype[u] == DynType.NONE,
         f'dynamics type {mjm.actuator_dyntype[u]}')


def _body_levels(parentid) -> tuple:
  """Bodies 1..nbody-1 grouped by tree depth."""
  nbody = len(parentid)
  depth = np.zeros(nbody, dtype=int)
  for b in range(1, nbody):
    depth[b] = depth[parentid[b]] + 1
  levels = []
  for lvl in range(1, depth.max() + 1 if nbody > 1 else 1):
    ids = tuple(int(b) for b in np.nonzero(depth == lvl)[0])
    if ids:
      levels.append(ids)
  return tuple(levels)


def _dof_vpre_mask(mjm) -> np.ndarray:
  """V[j, k] = 1 iff dof k adds to the partial velocity that dof j sees
  in cdof_dot[j] (strict ancestors, except same-joint dofs; a free
  joint's rotational dofs see its linear dofs)."""
  nv = mjm.nv
  V = np.zeros((nv, nv), dtype=np.float32)
  for j in range(nv):
    jnt_j = int(mjm.dof_jntid[j])
    k = int(mjm.dof_parentid[j])
    while k >= 0:
      if int(mjm.dof_jntid[k]) != jnt_j:
        V[j, k] = 1.0
      else:
        dadr = int(mjm.jnt_dofadr[jnt_j])
        if (int(mjm.jnt_type[jnt_j]) == JointType.FREE and j - dadr >= 3 and
            k - dadr < 3):
          V[j, k] = 1.0
      k = int(mjm.dof_parentid[k])
  return V


def _dof_ancestry(dof_parentid) -> tuple:
  """Per-dof ancestor chains (incl. self) and the (nv, nv) mask."""
  nv = len(dof_parentid)
  rows = []
  mask = np.zeros((nv, nv), dtype=np.float32)
  for i in range(nv):
    chain = []
    j = i
    while j >= 0:
      chain.append(int(j))
      mask[i, j] = 1.0
      j = int(dof_parentid[j])
    rows.append(tuple(reversed(chain)))
  return tuple(rows), mask


def _filter_matrix(mjm) -> np.ndarray:
  """(ngeom, ngeom) bool: the geom pairs that the contype/conaffinity,
  same-weld, parent-child and <exclude> filters admit, explicit <pair>s
  aside (the predicate of `mujoco_warp_tpu/io.py:221`)."""
  ct = np.asarray(mjm.geom_contype, np.int64)
  ca = np.asarray(mjm.geom_conaffinity, np.int64)
  ok = ((ct[:, None] & ca[None, :]) | (ct[None, :] & ca[:, None])) != 0
  bid = np.asarray(mjm.geom_bodyid)
  weld = mjm.body_weldid[bid]
  ok &= weld[:, None] != weld[None, :]
  if not mjm.opt.disableflags & DisableBit.FILTERPARENT:
    wpar = mjm.body_weldid[mjm.body_parentid[mjm.body_weldid]][bid]
    par = (wpar[:, None] == weld[None, :]) | (wpar[None, :] == weld[:, None])
    ok &= ~(par & (weld[:, None] != 0) & (weld[None, :] != 0))
  for s in mjm.exclude_signature:
    on1, on2 = bid == int(s) >> 16, bid == int(s) & 0xFFFF
    ok &= ~((on1[:, None] & on2[None, :]) | (on2[:, None] & on1[None, :]))
  np.fill_diagonal(ok, False)
  return ok


def _pair_filter_matrices(mjm):
  """(ok, pairid): the filter matrix with the explicit <pair>s admitted,
  and each pair's <pair> id (-1 for none), both (ngeom, ngeom)
  (`mujoco_warp_tpu/io.py:221`)."""
  ok = _filter_matrix(mjm)
  pairid = np.full(ok.shape, -1, np.int32)
  for p in range(mjm.npair):
    g1, g2 = int(mjm.pair_geom1[p]), int(mjm.pair_geom2[p])
    ok[g1, g2] = ok[g2, g1] = True
    pairid[g1, g2] = pairid[g2, g1] = p
  np.fill_diagonal(ok, False)
  return ok, pairid


def is_sdf_pair(t1: int, t2: int) -> bool:
  """Whether a (t1, t2) pair, t1 <= t2, runs the SDF narrowphase."""
  return t2 == GeomType.SDF and t1 in SDF_PARTNERS


def is_hfield_pair(t1: int, t2: int) -> bool:
  """Whether a (t1, t2) pair, t1 <= t2, runs the height-field
  narrowphase."""
  return t1 == GeomType.HFIELD and t2 in HFIELD_PARTNERS


def pair_slots(t1: int, t2: int, opt) -> int:
  """Candidate contacts of one pair of types (t1, t2) under the options
  opt (a compiled model's or a Model's): MAX_CONTACTS for an analytic
  collider, `collision_convex.manifold_ncon` for MPR, sdf_initpoints for
  an SDF pair, NCONH for a height-field pair (JAX `_k`,
  `mujoco_warp_tpu/io.py:423-432`)."""
  if is_hfield_pair(t1, t2):
    return collision_hfield.NCONH
  if (t1, t2) in MAX_CONTACTS:
    return MAX_CONTACTS[(t1, t2)]
  if is_sdf_pair(t1, t2):
    return int(opt.sdf_initpoints)
  return collision_convex.manifold_ncon(t1, t2, int(opt.disableflags))


def _refuse_unported(keys, explicit=False):
  """Raise for the first (type1, type2) of keys without a collider; an
  SDF pair only as an explicit <pair>, which the JAX package refuses
  (`mujoco_warp_tpu/io.py:409-418`)."""
  for key in keys:
    if explicit and GeomType.SDF in key:
      raise NotImplementedError(
          f'explicit <pair> with an SDF geom {key} is not ported')
    if (key not in MAX_CONTACTS and key not in MPR_PAIRS and
        not is_sdf_pair(*key) and not is_hfield_pair(*key)):
      raise NotImplementedError(f'collision pair type {key} is not ported')


def _mesh_hulls(mjm) -> np.ndarray:
  """(nmesh, VMAX, 4) float32 each mesh's convex-hull vertices in the
  geom frame, padded (xyz, 1 valid or 0 padding): the compiler's hull
  graph (`mesh_graph`'s vert_globalid) where the mesh has one, else all
  its vertices; (0, 1, 4) without meshes (mirrors
  `mujoco_warp_tpu/io.py:160`)."""
  hulls = []
  for i in range(mjm.nmesh):
    vadr, vnum = int(mjm.mesh_vertadr[i]), int(mjm.mesh_vertnum[i])
    verts = mjm.mesh_vert[vadr:vadr + vnum]
    gadr = int(mjm.mesh_graphadr[i])
    if gadr >= 0:
      numvert = int(mjm.mesh_graph[gadr])
      verts = verts[mjm.mesh_graph[gadr + 2 + numvert:
                                   gadr + 2 + 2 * numvert]]
    hulls.append(verts)
  out = np.zeros((len(hulls), max([len(h) for h in hulls], default=1), 4),
                 np.float32)
  for i, h in enumerate(hulls):
    out[i, :len(h), :3] = h
    out[i, :len(h), 3] = 1.0
  return out


def _decimate_hulls(hulls: np.ndarray, vmax: int = HULL_SMALL
                    ) -> np.ndarray:
  """Each padded hull cut to at most vmax vertices by farthest-point
  sampling from its vertex of greatest x; the hulls as they are where
  none is longer (mirrors `mujoco_warp_tpu/io.py:186`)."""
  nmesh, v, _ = hulls.shape
  if v <= vmax:
    return hulls
  out = np.zeros((nmesh, vmax, 4), dtype=hulls.dtype)
  for i in range(nmesh):
    verts = hulls[i][hulls[i, :, 3] > 0, :3]
    n = len(verts)
    if n <= vmax:
      out[i, :n, :3] = verts
      out[i, :n, 3] = 1.0
      continue
    chosen = [int(np.argmax(verts[:, 0]))]
    dist = np.linalg.norm(verts - verts[chosen[0]], axis=1)
    for _ in range(vmax - 1):
      nxt = int(np.argmax(dist))
      chosen.append(nxt)
      dist = np.minimum(dist, np.linalg.norm(verts - verts[nxt], axis=1))
    out[i, :vmax, :3] = verts[chosen]
    out[i, :vmax, 3] = 1.0
  return out


def _sample_octree_grid(mjm, meshid: int, res: int):
  """(grid (res, res, res) float32, aabb (2, 3) float32 center and half
  sizes): the compiled model's octree SDF of mesh meshid (`oct_*`)
  sampled at the res^3 points of its root box, each point clamped just
  inside the box and interpolated in its leaf (a copy of
  `mujoco_warp_tpu/io.py:478`, numpy)."""
  root = int(mjm.mesh_octadr[meshid])
  aabb = np.asarray(mjm.oct_aabb).reshape(-1, 2, 3)
  child = np.asarray(mjm.oct_child).reshape(-1, 8)
  coeff = np.asarray(mjm.oct_coeff).reshape(-1, 8)
  center, half = aabb[root, 0], aabb[root, 1]
  lo, hi = center - half, center + half
  axes = [np.linspace(lo[k], hi[k], res) for k in range(3)]
  gx, gy, gz = np.meshgrid(*axes, indexing='ij')
  pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
  eps = 1e-6
  pts = np.clip(pts, lo + eps * (hi - lo), hi - eps * (hi - lo))

  node = np.full(len(pts), root, dtype=np.int64)
  for _ in range(24):  # the octree's depth bound
    vmin = aabb[node, 0] - aabb[node, 1]
    vmax = aabb[node, 0] + aabb[node, 1]
    coord = (pts - vmin) / np.maximum(vmax - vmin, 1e-12)
    is_leaf = (child[node] == -1).all(axis=1)
    oct_idx = ((coord[:, 0] >= 0.5).astype(np.int64) +
               2 * (coord[:, 1] >= 0.5).astype(np.int64) +
               4 * (coord[:, 2] >= 0.5).astype(np.int64))
    nxt = child[node, oct_idx]
    step = ~is_leaf & (nxt != -1)
    node = np.where(step, nxt + root, node)
    if not step.any():
      break
  vmin = aabb[node, 0] - aabb[node, 1]
  vmax = aabb[node, 0] + aabb[node, 1]
  t = (pts - vmin) / np.maximum(vmax - vmin, 1e-12)
  w = np.ones((len(pts), 8))
  for j in range(8):
    w[:, j] = ((t[:, 0] if j & 1 else 1 - t[:, 0]) *
               (t[:, 1] if j & 2 else 1 - t[:, 1]) *
               (t[:, 2] if j & 4 else 1 - t[:, 2]))
  vals = np.sum(w * coeff[node], axis=1)
  grid = vals.reshape(res, res, res).astype(np.float32)
  return grid, np.stack([center, half]).astype(np.float32)


def _voxel_chunk_dist(p: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
  """Signed distance of points p (P, 3) to the closed triangle mesh tri
  (F, 3, 3), float32: the distance to the nearest triangle (the closest
  point by the barycentric region tests), negative where a ray from the
  point along +x crosses the mesh an odd number of times (Moller-Trumbore).
  The operations of `mujoco_warp_tpu/io.py:524` in their order, each dot
  product of 3-vectors summed left to right. The distance is taken in
  float64 and rounded: on a sliver face the region tests' products
  cancel, and on aloha_sdf's extrusion a float32 distance lies up to
  5e-5 off the float64 one (the JAX package's too). The ray's parity is
  taken in float32, as JAX takes it."""
  dot = lambda x, y: (x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1]) + \
      x[..., 2] * y[..., 2]
  p32, tri32 = p, tri
  p, tri = p.double(), tri.double()
  a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
  ab, ac = b - a, c - a
  ap = p[:, None, :] - a[None]                                 # (P, F, 3)
  bp = p[:, None, :] - b[None]
  cp = p[:, None, :] - c[None]
  d1, d2 = dot(ab, ap), dot(ac, ap)
  d3, d4 = dot(ab, bp), dot(ac, bp)
  d5, d6 = dot(ab, cp), dot(ac, cp)
  va = d3 * d6 - d5 * d4
  vb = d5 * d2 - d1 * d6
  vc = d1 * d4 - d3 * d2
  denom = torch.clamp(va + vb + vc, min=1e-20)
  v = torch.clamp(vb / denom, 0.0, 1.0)
  w = torch.clamp(vc / denom, 0.0, 1.0)
  zero, one = torch.zeros((), dtype=p.dtype), torch.ones((), dtype=p.dtype)
  at_a = (d1 <= 0) & (d2 <= 0)
  v, w = torch.where(at_a, zero, v), torch.where(at_a, zero, w)
  at_b = (d3 >= 0) & (d4 <= d3)
  v, w = torch.where(at_b, one, v), torch.where(at_b, zero, w)
  at_c = (d6 >= 0) & (d5 <= d6)
  v, w = torch.where(at_c, zero, v), torch.where(at_c, one, w)
  e_ab = torch.clamp(torch.where((d1 - d3).abs() > 1e-20,
                                 d1 / torch.clamp(d1 - d3, min=1e-20), zero),
                     0.0, 1.0)
  on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
  v, w = torch.where(on_ab, e_ab, v), torch.where(on_ab, zero, w)
  e_ac = torch.clamp(torch.where((d2 - d6).abs() > 1e-20,
                                 d2 / torch.clamp(d2 - d6, min=1e-20), zero),
                     0.0, 1.0)
  on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
  v, w = torch.where(on_ac, zero, v), torch.where(on_ac, e_ac, w)
  e_bc = torch.clamp((d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6),
                                             min=1e-20), 0.0, 1.0)
  on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
  v, w = torch.where(on_bc, 1.0 - e_bc, v), torch.where(on_bc, e_bc, w)
  closest = a[None] + v[..., None] * ab[None] + w[..., None] * ac[None]
  off = p[:, None, :] - closest
  dist = torch.sqrt(dot(off, off)).amin(1).float()
  # the sign: the +x ray's crossings; its direction's cross product with
  # ac is (0, -ac_z, ac_y), and the ray's component of q is q_x
  p, a, b, c = p32, tri32[:, 0], tri32[:, 1], tri32[:, 2]
  ab, ac = b - a, c - a
  ap = p[:, None, :] - a[None]
  one = torch.ones((), dtype=p.dtype)
  eps = 1e-12
  pvec = torch.stack([torch.zeros_like(ac[:, 0]), -ac[:, 2], ac[:, 1]], -1)
  det = dot(ab, pvec)
  inv = 1.0 / torch.where(det.abs() < eps, one, det)
  u = dot(ap, pvec) * inv
  qvec = torch.linalg.cross(ap, ab[None].expand_as(ap))
  vv = qvec[..., 0] * inv
  tt = dot(qvec, ac) * inv
  hit = ((det.abs() >= eps) & (u >= 0) & (vv >= 0) & (u + vv <= 1) &
         (tt > 0))
  inside = hit.sum(1) % 2 == 1
  return torch.where(inside, -dist, dist)


# (point, face) pairs of one chunk of the voxelization
VOXEL_CHUNK = 1 << 18


def _voxelize_mesh_grid(mjm, meshid: int, res: int):
  """(grid (res, res, res) float32, aabb (2, 3) float32): the signed
  distance (`_voxel_chunk_dist`) of a plain mesh at the res^3 points of
  its vertices' box padded by 0.15 of its longest side (a copy of
  `mujoco_warp_tpu/io.py:600`, in torch on the CPU, without its disk
  cache and without its padding faces, which change no value)."""
  vadr, vnum = int(mjm.mesh_vertadr[meshid]), int(mjm.mesh_vertnum[meshid])
  fadr, fnum = int(mjm.mesh_faceadr[meshid]), int(mjm.mesh_facenum[meshid])
  verts = np.asarray(mjm.mesh_vert[vadr:vadr + vnum], np.float32)
  faces = np.asarray(mjm.mesh_face[fadr:fadr + fnum], np.int64)
  lo = verts.min(0)
  hi = verts.max(0)
  pad = 0.15 * (hi - lo).max() + 1e-4
  lo, hi = lo - pad, hi + pad
  center = 0.5 * (lo + hi)
  half = 0.5 * (hi - lo)
  axes = [np.linspace(lo[k], hi[k], res, dtype=np.float32)
          for k in range(3)]
  gx, gy, gz = np.meshgrid(*axes, indexing='ij')
  pts = torch.as_tensor(np.stack([gx, gy, gz], axis=-1).reshape(-1, 3))
  tri = torch.as_tensor(verts[faces])                       # (F, 3, 3)
  step = max(1, VOXEL_CHUNK // len(tri))
  out = torch.cat([_voxel_chunk_dist(pts[i:i + step], tri)
                   for i in range(0, len(pts), step)])
  grid = out.numpy().reshape(res, res, res)
  return grid, np.stack([center, half]).astype(np.float32)


def _build_sdf_grids(mjm):
  """(grids (G, R, R, R), aabbs (G, 2, 3), grid_of_mesh (max(nmesh, 1),)
  with -1 for none) of the meshes an SDF pair reads: each SDF geom's
  mesh (sampled from its octree where the compiler built one) and each
  plain mesh whose geom's contype/conaffinity admits an SDF geom
  (voxelized), in mesh order (a copy of `mujoco_warp_tpu/io.py:713`;
  the gate admits no plugin)."""
  # MJWT_SDF_RES, read as the JAX package reads it: one setting moves both
  res = int(os.environ.get('MJWT_SDF_RES', SDF_RES))
  gtype = np.asarray(mjm.geom_type)
  dataid = np.asarray(mjm.geom_dataid)
  sdf_geoms = np.nonzero(gtype == GeomType.SDF)[0]
  grid_of_mesh = [-1] * max(mjm.nmesh, 1)
  empty = (np.zeros((1, 1, 1, 1), np.float32),
           np.zeros((1, 2, 3), np.float32), grid_of_mesh)
  if not len(sdf_geoms):
    return empty
  need = {int(dataid[g]) for g in sdf_geoms if dataid[g] >= 0}
  ct = np.asarray(mjm.geom_contype)
  ca = np.asarray(mjm.geom_conaffinity)
  for g in np.nonzero((gtype == GeomType.MESH) & (dataid >= 0))[0]:
    if ((ct[g] & ca[sdf_geoms]) | (ct[sdf_geoms] & ca[g])).any():
      need.add(int(dataid[g]))
  if not need:
    return empty
  grids, aabbs = [], []
  for meshid in sorted(need):
    if mjm.mesh_octadr[meshid] >= 0:
      grid, aabb = _sample_octree_grid(mjm, meshid, res)
    else:
      grid, aabb = _voxelize_mesh_grid(mjm, meshid, res)
    grid_of_mesh[meshid] = len(grids)
    grids.append(grid)
    aabbs.append(aabb)
  return np.stack(grids), np.stack(aabbs), grid_of_mesh


def _hfield_data(mjm) -> np.ndarray:
  """(nhfield, max nrow, max ncol) float32 each height field's
  normalized heights, zero-padded; (0, 1, 1) without (mirrors
  `mujoco_warp_tpu/io.py:780`)."""
  if mjm.nhfield == 0:
    return np.zeros((0, 1, 1), np.float32)
  out = np.zeros((mjm.nhfield, int(mjm.hfield_nrow.max()),
                  int(mjm.hfield_ncol.max())), np.float32)
  for i in range(mjm.nhfield):
    nr, nc = int(mjm.hfield_nrow[i]), int(mjm.hfield_ncol[i])
    adr = int(mjm.hfield_adr[i])
    out[i, :nr, :nc] = mjm.hfield_data[adr:adr + nr * nc].reshape(nr, nc)
  return out


def _collision_pairs(mjm):
  """Filtered geom pairs grouped by (type1, type2): contype/conaffinity,
  same-weld, parent-child and <exclude> filters, then explicit <pair>s
  (mirrors `mujoco_warp_tpu/io.py:344`). Within a group the filtered
  pairs keep the order of the reference's loop over g1 < g2, each pair
  ordered by type, and the explicit pairs follow by (g1, g2)."""
  explicit = {}
  for p in range(mjm.npair):
    g1, g2 = int(mjm.pair_geom1[p]), int(mjm.pair_geom2[p])
    if mjm.geom_type[g1] > mjm.geom_type[g2]:
      g1, g2 = g2, g1
    explicit[(g1, g2)] = p
  gtype = np.asarray(mjm.geom_type, np.int64)
  i, j = np.nonzero(np.triu(_filter_matrix(mjm), 1))   # the loop's order
  swap = gtype[i] > gtype[j]
  g1, g2 = np.where(swap, j, i), np.where(swap, i, j)
  if explicit:   # a pair listed as a <pair> takes its own parameters
    keep = ~np.isin(g1 * mjm.ngeom + g2,
                    [a * mjm.ngeom + b for a, b in explicit])
    g1, g2 = g1[keep], g2[keep]
  t1, t2 = gtype[g1], gtype[g2]
  _refuse_unported(zip(t1.tolist(), t2.tolist()))
  groups: dict = {}
  for key in sorted({(int(a), int(b)) for a, b in zip(t1, t2)}):
    on = (t1 == key[0]) & (t2 == key[1])
    groups[key] = [(int(a), int(b), -1) for a, b in zip(g1[on], g2[on])]
  for (a, b), p in sorted(explicit.items()):
    key = (int(mjm.geom_type[a]), int(mjm.geom_type[b]))
    _refuse_unported([key], explicit=True)
    groups.setdefault(key, []).append((a, b, p))
  pairs = tuple((k[0], k[1], tuple(v)) for k, v in sorted(groups.items()))
  ncand = sum(pair_slots(t1, t2, mjm.opt) * len(v) for t1, t2, v in pairs)
  return pairs, ncand


# admissible geom pairs (explicit <pair>s included) from which put_model
# takes the large-scene broadphase (`collision_sap.py`) over the static
# pair list (`mujoco_warp_tpu/io.py:254`)
SAP_THRESHOLD = 10_000


def _sap_precompute(mjm):
  """(families, sap_pairs, sap_pairid, count) of the large-scene
  broadphase (mirrors `mujoco_warp_tpu/io.py:257`): families is
  ((type1, type2, start, count), ...) over the rows of sap_pairs (P, 2)
  int32, g1 of type1 (the colliders' argument order), sap_pairid (P,)
  int32 the rows' <pair> ids, count the admissible pairs. families is ()
  where the static pair list serves: fewer than SAP_THRESHOLD pairs, or
  an hfield or SDF geom."""
  empty = ((), np.zeros((0, 2), np.int32), np.zeros((0,), np.int32), 0)
  ok, pairid = _pair_filter_matrices(mjm)
  upper = np.triu(ok, 1)
  count = int(upper.sum())
  gtype = np.asarray(mjm.geom_type, np.int32)
  if count < SAP_THRESHOLD or np.isin(
      gtype, (GeomType.HFIELD, GeomType.SDF)).any():
    return empty
  i, j = np.nonzero(upper)
  kmin = np.minimum(gtype[i], gtype[j])
  kmax = np.maximum(gtype[i], gtype[j])
  present = sorted({(int(a), int(b)) for a, b in zip(kmin, kmax)})
  _refuse_unported(present)
  _need(all(a != GeomType.PLANE for a, _ in present),
        'plane pairs under the large-scene broadphase')
  rows, pids, families = [], [], []
  start = 0
  for a, b in present:
    on = (kmin == a) & (kmax == b)
    i1, i2 = i[on], j[on]
    swap = gtype[i1] != a
    rows.append(np.stack([np.where(swap, i2, i1), np.where(swap, i1, i2)],
                         1).astype(np.int32))
    pids.append(pairid[i1, i2])
    families.append((a, b, start, int(on.sum())))
    start += int(on.sum())
  return (tuple(families), np.concatenate(rows, 0),
          np.concatenate(pids, 0).astype(np.int32), count)


def _condim_max(mjm) -> int:
  """The largest condim of a contact the model can make: each admissible
  pair's condim (a <pair>'s own, else the geoms' by priority), the
  static pairs and the large-scene broadphase's alike
  (`mujoco_warp_tpu/io.py:887-900`)."""
  ok, pairid = _pair_filter_matrices(mjm)
  if not ok.any():
    return 1
  pr = np.asarray(mjm.geom_priority, np.int32)
  cd = np.asarray(mjm.geom_condim, np.int32)
  mixed = np.where(pr[:, None] > pr[None, :], cd[:, None],
                   np.where(pr[None, :] > pr[:, None], cd[None, :],
                            np.maximum(cd[:, None], cd[None, :])))
  if mjm.npair:
    mixed = np.where(pairid >= 0, mjm.pair_dim[np.maximum(pairid, 0)], mixed)
  return int(mixed[ok].max())


_MJ_FLOAT_LEAVES = (
    'qpos0', 'qpos_spring', 'body_pos', 'body_quat', 'body_ipos',
    'body_iquat', 'body_mass', 'body_subtreemass', 'body_inertia',
    'body_invweight0', 'jnt_solref', 'jnt_solimp', 'jnt_pos', 'jnt_axis',
    'jnt_stiffness', 'jnt_range', 'jnt_actfrcrange', 'jnt_margin',
    'dof_solref', 'dof_solimp', 'dof_frictionloss', 'dof_armature',
    'dof_damping', 'dof_invweight0', 'geom_pos', 'geom_quat', 'geom_size',
    'geom_friction', 'geom_solref', 'geom_solimp', 'geom_solmix',
    'geom_margin', 'geom_gap', 'site_pos', 'site_quat', 'cam_pos',
    'cam_quat', 'cam_poscom0', 'cam_pos0', 'light_pos', 'light_dir',
    'light_poscom0', 'light_pos0', 'light_dir0',
    'actuator_gainprm', 'actuator_biasprm', 'actuator_ctrlrange',
    'actuator_forcerange', 'actuator_gear', 'pair_solref',
    'pair_solreffriction', 'pair_solimp', 'pair_margin', 'pair_gap',
    'pair_friction', 'eq_data', 'eq_solref', 'eq_solimp')


def put_model(mjm, device='cuda') -> Model:
  """mujoco.MjModel -> Model on `device`. Reads the compiled model's
  arrays only, so the `mujoco` module itself is never imported here."""
  _validate(mjm)
  f32 = lambda x: np.asarray(x, np.float32)
  leaves = {k: f32(getattr(mjm, k)) for k in _MJ_FLOAT_LEAVES}
  leaves['cam_mat0'] = f32(mjm.cam_mat0).reshape(mjm.ncam, 3, 3)
  leaves['eq_active0'] = np.asarray(mjm.eq_active0, bool)
  leaves['sensor_cutoff'] = f32(mjm.sensor_cutoff)
  leaves['opt.magnetic'] = f32(mjm.opt.magnetic)
  leaves['opt.timestep'] = f32(mjm.opt.timestep)
  leaves['opt.tolerance'] = f32(max(mjm.opt.tolerance, 1e-6))  # f32 floor
  leaves['opt.ls_tolerance'] = f32(mjm.opt.ls_tolerance)
  leaves['opt.gravity'] = f32(mjm.opt.gravity)
  leaves['opt.impratio'] = f32(mjm.opt.impratio)
  leaves['stat.meaninertia'] = f32(mjm.stat.meaninertia)
  nkey = mjm.nkey
  leaves.update(
      key_time=f32(mjm.key_time), key_qpos=f32(mjm.key_qpos).reshape(
          nkey, mjm.nq), key_qvel=f32(mjm.key_qvel).reshape(nkey, mjm.nv),
      key_act=f32(mjm.key_act).reshape(nkey, mjm.na),
      key_ctrl=f32(mjm.key_ctrl).reshape(nkey, mjm.nu),
      key_mpos=f32(mjm.key_mpos).reshape(nkey, mjm.nmocap, 3),
      key_mquat=f32(mjm.key_mquat).reshape(nkey, mjm.nmocap, 4))

  dof_ancestor_rows, ancestor_mask = _dof_ancestry(mjm.dof_parentid)
  nbody = mjm.nbody
  subtree_mask = np.zeros((nbody, nbody), dtype=np.float32)
  for c in range(nbody):
    b = c
    while b >= 0:
      subtree_mask[b, c] = 1.0
      if b == 0:
        break
      b = int(mjm.body_parentid[b])
  body_dof_mask = np.zeros((nbody, mjm.nv), dtype=np.float32)
  for b in range(nbody):
    bb = b
    while bb > 0:
      adr, num = int(mjm.body_dofadr[bb]), int(mjm.body_dofnum[bb])
      body_dof_mask[b, adr:adr + num] = 1.0
      bb = int(mjm.body_parentid[bb])
  leaves.update(dof_ancestor_mask=ancestor_mask,
                body_subtree_mask=subtree_mask,
                body_dof_ancestor_mask=body_dof_mask,
                dof_vpre_mask=_dof_vpre_mask(mjm))

  sap_families, sap_pairs, sap_pairid, sap_count = _sap_precompute(mjm)
  if sap_families:
    collision_pairs, nxn_candidates = (), sap_count
  else:
    collision_pairs, nxn_candidates = _collision_pairs(mjm)
  hulls = _mesh_hulls(mjm)
  sdf_grids, sdf_grid_aabb, sdf_grid_of_mesh = _build_sdf_grids(mjm)
  leaves.update(sdf_grids=sdf_grids, sdf_grid_aabb=sdf_grid_aabb,
                hfield_size=f32(mjm.hfield_size).reshape(mjm.nhfield, 4),
                hfield_data=_hfield_data(mjm))
  leaves.update(sap_pairs=sap_pairs, sap_pairid=sap_pairid,
                geom_aabb=f32(mjm.geom_aabb).reshape(mjm.ngeom, 2, 3),
                geom_rbound=f32(mjm.geom_rbound), mesh_hullvert=hulls,
                mesh_hullvert_small=_decimate_hulls(hulls))
  statics = dict(
      nq=mjm.nq, nv=mjm.nv, nu=mjm.nu, na=mjm.na, nbody=mjm.nbody,
      njnt=mjm.njnt, ngeom=mjm.ngeom, nsite=mjm.nsite, ncam=mjm.ncam,
      nlight=mjm.nlight, neq=mjm.neq, nmocap=mjm.nmocap,
      ngravcomp=mjm.ngravcomp, nsensor=mjm.nsensor, npair=mjm.npair,
      nexclude=mjm.nexclude, ntendon=mjm.ntendon, nkey=mjm.nkey,
      key_names=tuple(mjm.key(k).name for k in range(mjm.nkey)),
      body_parentid=_tup(mjm.body_parentid),
      body_rootid=_tup(mjm.body_rootid),
      body_weldid=_tup(mjm.body_weldid),
      body_mocapid=_tup(mjm.body_mocapid),
      body_jntadr=_tup(mjm.body_jntadr),
      body_jntnum=_tup(mjm.body_jntnum),
      body_dofadr=_tup(mjm.body_dofadr),
      body_dofnum=_tup(mjm.body_dofnum),
      body_levels=_body_levels(mjm.body_parentid),
      jnt_type=_tup(mjm.jnt_type),
      jnt_qposadr=_tup(mjm.jnt_qposadr),
      jnt_dofadr=_tup(mjm.jnt_dofadr),
      jnt_bodyid=_tup(mjm.jnt_bodyid),
      jnt_limited=_tup(mjm.jnt_limited),
      jnt_actfrclimited=_tup(mjm.jnt_actfrclimited),
      dof_bodyid=_tup(mjm.dof_bodyid),
      dof_jntid=_tup(mjm.dof_jntid),
      dof_parentid=_tup(mjm.dof_parentid),
      dof_ancestor_rows=dof_ancestor_rows,
      dof_hasfrictionloss=_tup(mjm.dof_frictionloss > 0),
      geom_type=_tup(mjm.geom_type),
      geom_bodyid=_tup(mjm.geom_bodyid),
      geom_dataid=_tup(mjm.geom_dataid),
      geom_condim=_tup(mjm.geom_condim),
      geom_priority=_tup(mjm.geom_priority),
      site_bodyid=_tup(mjm.site_bodyid),
      cam_mode=_tup(mjm.cam_mode),
      cam_bodyid=_tup(mjm.cam_bodyid),
      cam_targetbodyid=_tup(mjm.cam_targetbodyid),
      light_mode=_tup(mjm.light_mode),
      light_bodyid=_tup(mjm.light_bodyid),
      light_targetbodyid=_tup(mjm.light_targetbodyid),
      actuator_trntype=_tup(mjm.actuator_trntype),
      actuator_dyntype=_tup(mjm.actuator_dyntype),
      actuator_gaintype=_tup(mjm.actuator_gaintype),
      actuator_biastype=_tup(mjm.actuator_biastype),
      actuator_trnid=_tup(mjm.actuator_trnid),
      actuator_ctrllimited=_tup(mjm.actuator_ctrllimited),
      actuator_forcelimited=_tup(mjm.actuator_forcelimited),
      eq_type=_tup(mjm.eq_type),
      eq_obj1id=_tup(mjm.eq_obj1id),
      eq_obj2id=_tup(mjm.eq_obj2id),
      collision_pairs=collision_pairs,
      nxn_candidates=nxn_candidates,
      sap_families=sap_families,
      sdf_grid_of_mesh=tuple(sdf_grid_of_mesh),
      nhfield=mjm.nhfield,
      hfield_nrow=_tup(mjm.hfield_nrow),
      hfield_ncol=_tup(mjm.hfield_ncol),
      condim_max=_condim_max(mjm),
      pair_dim=_tup(mjm.pair_dim),
      has_damping=bool(np.any(mjm.dof_damping > 0)),
      sensor_type=_tup(mjm.sensor_type),
      sensor_datatype=_tup(mjm.sensor_datatype),
      sensor_needstage=_tup(mjm.sensor_needstage),
      sensor_objtype=_tup(mjm.sensor_objtype),
      sensor_objid=_tup(mjm.sensor_objid),
      sensor_reftype=_tup(mjm.sensor_reftype),
      sensor_refid=_tup(mjm.sensor_refid),
      sensor_adr=_tup(mjm.sensor_adr),
      sensor_dim=_tup(mjm.sensor_dim),
      nsensordata=int(mjm.nsensordata),
      opt=dict(integrator=int(mjm.opt.integrator), cone=int(mjm.opt.cone),
               solver=int(mjm.opt.solver),
               iterations=int(mjm.opt.iterations),
               ls_iterations=int(mjm.opt.ls_iterations),
               ls_parallel=int(mjm.opt.cone != ConeType.ELLIPTIC),
               disableflags=int(mjm.opt.disableflags),
               enableflags=int(mjm.opt.enableflags),
               sdf_iterations=int(mjm.opt.sdf_iterations),
               sdf_initpoints=int(mjm.opt.sdf_initpoints)))
  return model_from_numpy(leaves, statics, device=device)


def _as_tuple(x):
  if isinstance(x, (list, tuple)):
    return tuple(_as_tuple(v) for v in x)
  return x


def model_from_numpy(leaves: dict, statics: dict, device='cuda') -> Model:
  """Model from numpy leaves (names as in the JAX Model; Option and
  Statistic leaves as 'opt.<name>' / 'stat.<name>') and static fields
  (the JAX Model's meta fields; Option statics under statics['opt'])."""
  t = lambda name, dtype=np.float32: torch.tensor(
      np.asarray(leaves[name], dtype), device=device)
  ostat = statics['opt']
  opt = Option(**{k: t('opt.' + k) for k in types.OPTION_TENSORS},
               **{k: int(ostat[k]) for k in types.OPTION_STATICS})
  stat = Statistic(meaninertia=t('stat.meaninertia'))
  kw = {k: t(k) for k in types.MODEL_TENSORS}
  kw['eq_active0'] = t('eq_active0', bool)
  kw.update(sap_pairs=t('sap_pairs', np.int32).reshape(-1, 2),
            sap_pairid=t('sap_pairid', np.int32))
  kw.update({k: _as_tuple(statics[k]) for k in types.MODEL_STATICS})
  kw['has_damping'] = bool(kw['has_damping'])
  return Model(opt=opt, stat=stat, **kw)


def model_to_numpy(m: Model) -> tuple[dict, dict]:
  """Inverse of model_from_numpy."""
  leaves = {k: getattr(m, k).cpu().numpy() for k in types.MODEL_TENSORS}
  leaves.update({'opt.' + k: getattr(m.opt, k).cpu().numpy()
                 for k in types.OPTION_TENSORS})
  leaves['stat.meaninertia'] = m.stat.meaninertia.cpu().numpy()
  statics = {k: getattr(m, k) for k in types.MODEL_STATICS}
  statics['opt'] = {k: getattr(m.opt, k) for k in types.OPTION_STATICS}
  return leaves, statics


def save_model(m: Model, path: str):
  """Write one .npz holding the model's leaves and its statics (JSON)."""
  leaves, statics = model_to_numpy(m)
  np.savez_compressed(path, __statics__=np.asarray(json.dumps(statics)),
                      **leaves)


def load_model(path: str, device='cuda') -> Model:
  with np.load(path) as z:
    statics = json.loads(str(z['__statics__']))
    leaves = {k: z[k] for k in z.files if k != '__statics__'}
  return model_from_numpy(leaves, statics, device=device)


_ENUM_FIELDS = {
    'solver': {'cg': SolverType.CG, 'newton': SolverType.NEWTON},
    'integrator': {'euler': IntegratorType.EULER,
                   'rk4': IntegratorType.RK4,
                   'implicitfast': IntegratorType.IMPLICITFAST},
    'cone': {'pyramidal': ConeType.PYRAMIDAL,
             'elliptic': ConeType.ELLIPTIC},
}
_FLAG_FIELDS = {'disableflags': DisableBit, 'enableflags': EnableBit}
_INT_OPT = {'iterations', 'ls_iterations'}
_BOOL_OPT = {'ls_parallel'}


def override_model(m: Model, overrides: list[str] | str) -> Model:
  """Model with "opt.field=value" overrides applied (mirrors
  `mujoco_warp_tpu/io.py:1503`): enum names, '|' unions of flag names,
  ints, bools and floats (a space-separated list for a vector). A change
  of cone also sets ls_parallel: the parallel linesearch is for the
  pyramidal cone's piecewise-linear phi' (as `put_model` sets it)."""
  if isinstance(overrides, str):
    overrides = [overrides]
  opt = m.opt
  for ov in overrides:
    path, _, value = ov.partition('=')
    path, value = path.strip(), value.strip()
    if not path.startswith('opt.'):
      raise ValueError(f'only opt.* overrides supported, got {path}')
    field = path[4:]
    if field in _ENUM_FIELDS:
      new = int(_ENUM_FIELDS[field][value.lower()])
      if field == 'cone':
        opt = dataclasses.replace(opt,
                                  ls_parallel=int(new != ConeType.ELLIPTIC))
    elif field in _FLAG_FIELDS:
      new = 0
      for part in value.split('|'):
        new |= int(_FLAG_FIELDS[field][part.strip().upper()])
    elif field in _INT_OPT:
      new = int(value)
    elif field in _BOOL_OPT:
      new = int(value.lower() in ('1', 'true', 'yes'))
    elif field in types.OPTION_TENSORS:
      cur = getattr(opt, field)
      vals = [float(v) for v in value.split()]
      new = torch.tensor(vals[0] if len(vals) == 1 else vals,
                         dtype=torch.float32, device=cur.device)
      new = new.expand(cur.shape).clone() if cur.dim() else new
    else:
      raise ValueError(f'unknown option {field}')
    opt = dataclasses.replace(opt, **{field: new})
  return dataclasses.replace(m, opt=opt)


def efc_layout(m: Model, nconmax: int):
  """Static efc row layout (ne, nf, nl, contact row stride, njmax):
  rows live at fixed addresses, equality | friction | limit | contact;
  one row per equality, all of type JOINT (the gate)."""
  ne = m.neq
  nf = sum(m.dof_hasfrictionloss)
  nl = sum(m.jnt_limited)
  if m.opt.cone == ConeType.PYRAMIDAL:
    stride = max(2 * (m.condim_max - 1), 1)
  else:
    stride = m.condim_max
  return ne, nf, nl, stride, ne + nf + nl + nconmax * stride


def _moment0(m: Model) -> torch.Tensor:
  """actuator_moment: constant one-hot x gear for the scalar-joint
  transmission of every ported actuator."""
  moment = torch.zeros((m.nu, m.nv), dtype=torch.float32, device=m.device)
  for u in range(m.nu):
    moment[u, m.jnt_dofadr[m.actuator_trnid[u][0]]] = m.actuator_gear[u, 0]
  return moment


def make_data(m: Model, nconmax: int | None = None, nworld: int = 1) -> Data:
  """Data for `nworld` worlds at qpos0 on the model's device."""
  ncand = m.nxn_candidates
  if nconmax is None:
    nconmax = max(min(ncand, 64), 1)
  nconmax = max(nconmax, 1)
  if m.ngeom == 0 or ncand == 0:
    nconmax = 0
  _, _, _, _, njmax = efc_layout(m, nconmax)
  W, nv, nbody = nworld, m.nv, m.nbody
  dev = m.device
  z = lambda *s: torch.zeros((W,) + s, dtype=torch.float32, device=dev)
  zi = lambda *s: torch.zeros((W,) + s, dtype=torch.int32, device=dev)
  mi = lambda *s: torch.full((W,) + s, -1, dtype=torch.int32, device=dev)
  contact = Contact(
      dist=z(nconmax), pos=z(nconmax, 3), frame=z(nconmax, 3, 3),
      includemargin=z(nconmax), friction=z(nconmax, 5),
      solref=z(nconmax, 2), solreffriction=z(nconmax, 2),
      solimp=z(nconmax, 5), dim=zi(nconmax), geom=mi(nconmax, 2),
      efc_address=mi(nconmax))
  return Data(
      time=z(), ncon=zi(), ne=zi(), nf=zi(), nl=zi(), nefc=zi(),
      ncollision=zi(), solver_niter=zi(),
      qpos=m.qpos0[None].repeat(W, 1), qvel=z(nv), act=z(m.na), ctrl=z(m.nu),
      qacc_warmstart=z(nv), qfrc_applied=z(nv), xfrc_applied=z(nbody, 6),
      eq_active=m.eq_active0[None].repeat(W, 1),
      xpos=z(nbody, 3), xquat=z(nbody, 4), xmat=z(nbody, 3, 3),
      xipos=z(nbody, 3), ximat=z(nbody, 3, 3), xanchor=z(m.njnt, 3),
      xaxis=z(m.njnt, 3), geom_xpos=z(m.ngeom, 3),
      geom_xmat=z(m.ngeom, 3, 3), site_xpos=z(m.nsite, 3),
      site_xmat=z(m.nsite, 3, 3), cam_xpos=z(m.ncam, 3),
      cam_xmat=z(m.ncam, 3, 3), light_xpos=z(m.nlight, 3),
      light_xdir=z(m.nlight, 3), subtree_com=z(nbody, 3),
      cinert=z(nbody, 10), cdof=z(nv, 6), crb=z(nbody, 10),
      cvel=z(nbody, 6), cdof_dot=z(nv, 6), cacc=z(nbody, 6),
      qM=z(nv, nv), qLD=z(nv, nv), actuator_length=z(m.nu),
      actuator_moment=_moment0(m)[None].repeat(W, 1, 1),
      actuator_velocity=z(m.nu), actuator_force=z(m.nu), act_dot=z(m.na),
      qfrc_spring=z(nv), qfrc_damper=z(nv), qfrc_passive=z(nv),
      qfrc_bias=z(nv), qfrc_actuator=z(nv), qfrc_smooth=z(nv),
      qacc_smooth=z(nv), qacc_euler=z(nv), qfrc_constraint=z(nv),
      qacc=z(nv), contact=contact, efc_type=zi(njmax), efc_id=zi(njmax),
      efc_J=z(njmax, nv), efc_pos=z(njmax), efc_margin=z(njmax),
      efc_D=z(njmax), efc_vel=z(njmax), efc_aref=z(njmax),
      efc_frictionloss=z(njmax), efc_force=z(njmax),
      efc_active=torch.zeros((W, njmax), dtype=torch.bool, device=dev),
      cfrc_ext=z(nbody, 6), cfrc_int=z(nbody, 6),
      sensordata=z(m.nsensordata))


def reset_data(m: Model, d: Data, keyframe: int | None = None) -> Data:
  """Data of d's nworld and nconmax reset to qpos0, or to a keyframe's
  time, qpos, qvel, act and ctrl, in every world (mirrors
  `mujoco_warp_tpu/io.py:1436`; the port has no mocap bodies)."""
  fresh = make_data(m, nconmax=d.contact.dist.shape[1], nworld=d.nworld)
  if keyframe is None:
    return fresh
  rows = dict(time=m.key_time, qpos=m.key_qpos, qvel=m.key_qvel,
              act=m.key_act, ctrl=m.key_ctrl)
  return fresh.replace(**{
      k: v[keyframe].expand_as(getattr(fresh, k)).clone()
      for k, v in rows.items()})


def reset_data_masked(m: Model, d: Data, reset_mask: torch.Tensor,
                      keyframe: int | None = None) -> Data:
  """The worlds where reset_mask (nworld,) is True reset as `reset_data`
  resets them; the others keep their state (`mujoco_warp_tpu/io.py:1450`)."""
  fresh = reset_data(m, d, keyframe)

  def mix(f, b):
    mask = reset_mask.reshape((-1,) + (1,) * (b.dim() - 1))
    return torch.where(mask, f, b)

  def mix_all(fr, old):
    return {f.name: mix(getattr(fr, f.name), getattr(old, f.name))
            for f in dataclasses.fields(old) if f.name != 'contact'}
  return d.replace(contact=d.contact.replace(**mix_all(fresh.contact,
                                                       d.contact)),
                   **mix_all(fresh, d))


def find_keys(m: Model, prefix: str) -> list[int]:
  """Ids of the keyframes whose name (`m.key_names`, which a saved `.npz`
  keeps) starts with prefix (mirrors `mujoco_warp_tpu/io.py:1466`)."""
  return [k for k, name in enumerate(m.key_names)
          if name and name.startswith(prefix)]


def make_trajectory(m: Model, keys: list[int]) -> np.ndarray:
  """The keyframes' ctrl rows stacked into a (len(keys), nu) replay
  trajectory (mirrors `mujoco_warp_tpu/io.py:1476`)."""
  return m.key_ctrl[list(keys)].cpu().numpy()


def data_from_numpy(m: Model, fields: dict, nconmax: int | None = None
                    ) -> Data:
  """Data whose state fields (qpos, qvel, ctrl, qacc_warmstart, ...) come
  from (nworld, ...) numpy arrays; the rest as make_data."""
  nworld = next(iter(fields.values())).shape[0]
  d = make_data(m, nconmax=nconmax, nworld=nworld)
  kw = {}
  for k, v in fields.items():
    ref = getattr(d, k)
    kw[k] = torch.as_tensor(np.asarray(v), dtype=ref.dtype,
                            device=ref.device).reshape(ref.shape)
  return d.replace(**kw)
