"""The port's mesh colliders (`collision_primitive.plane_mesh`,
`sphere_box`, `collision_convex.mpr` and `mpr_multi`) against the JAX
package's and against C MuJoCo.

* Against JAX, on seeded poses of a cube mesh, a wedge mesh, a sphere, a
  box and a plane (the meshes of tests/test_convex.py, their hulls from
  `io._mesh_hulls`, equal to the JAX package's):
  - sphere_box and plane_mesh at the reference tolerance 5e-5
    (tests/fixtures.py:140) in every pair; plane_mesh also on a regular
    layout (a cube flat on the plane, turned by quarter turns), where the
    four bottom vertices tie and both keep them in vertex order;
  - mpr and mpr_multi in float64 and float32 (both packages in each):
    the base contact (slot 0) is found in the same pairs; its dist and
    normal are within 1e-9 in float64, within 5e-5 in float32 in all but
    F32_SHARE of the pairs (measured: 5 of 109 sphere-mesh contacts, in
    the normal, up to 1e-4); its point differs only along the contact
    plane (within 1e-9 or 5e-5 along the normal), and not at all in
    float64 where no flat support is involved (sphere-mesh). Where a
    support runs along a face normal (a box's sign(d) or a hull's argmax
    of near-equal dots), the face's corner is picked by rounding, in
    float64 too: the two witness points can lie a face's width apart in
    the plane (4e-2 here), and the four tilted contacts of mpr_multi,
    which turn about that point, follow. The pairs whose number of
    contacts differs are counted, at most SLOT_SHARE of the pairs
    (measured: 16 of 149 box-mesh pairs in float64, 13 in float32).
    Cylinder-box and cylinder-cylinder (kitchen's families) too, their
    float64 held as float32 is: a cylinder's cap and side are flat
    supports, and its MPR parts after a change of 1e-15 (in float64,
    cylinder-box: 7 of 91 base contacts off by more than 1e-9).
* Against C MuJoCo: the mesh cases of tests/test_convex.py (`mesh_plane`,
  `mesh_plane_tilt`, `mesh_box`, `mesh_sphere`), the port's `collision`
  on its own kinematics, at that file's tolerances: deepest dist within
  4e-3, its normal's |cos| > 0.95.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import collision_convex as jcc
from mujoco_warp_tpu import collision_primitive as jcp
from mujoco_warp_tpu import io as jio
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import collision_convex as cc
from mujoco_warp_tpu_torch import collision_driver
from mujoco_warp_tpu_torch import collision_primitive as cp
from mujoco_warp_tpu_torch import io, smooth

from test_convex import CASES, CUBE_MESH, WEDGE_MESH, _xml

TOL = 5e-5
TOL64 = 1e-9
N = 256
# shares of the base contacts: float32 ones off by more than TOL in dist
# or normal (measured 4 and 5 of 109 sphere-mesh contacts, as the mesh
# support's dots were summed two ways), pairs with another number of
# contacts (measured 16-18 of 149 box-mesh pairs)
F32_SHARE = 0.08
SLOT_SHARE = 0.15
# pairs with another number of contacts where a cylinder meets a box
# (measured: 15 of 91 cylinder-box pairs in float32, 9 in float64): both
# the cap's and the face's supports are flat
SLOT_SHARE_CYLINDER = 0.2


def _hulls():
  xml = ('<mujoco>' + CUBE_MESH + WEDGE_MESH + '<worldbody><geom type="mesh" '
         'mesh="cube"/><geom type="mesh" mesh="wedge" pos="1 0 0"/>'
         '</worldbody></mujoco>')
  mjm = mujoco.MjModel.from_xml_string(xml)
  hulls = io._mesh_hulls(mjm)
  np.testing.assert_array_equal(hulls, jio._mesh_hulls(mjm))
  return hulls[0], hulls[1]


def _rot(rng, n):
  q = rng.standard_normal((n, 4))
  w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
  return np.stack([
      np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                2 * (x * z + y * w)], -1),
      np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                2 * (y * z - x * w)], -1),
      np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                1 - 2 * (x * x + y * y)], -1)], 1).astype(np.float32)


def _poses(size1, size2, spread, seed):
  """N seeded pairs: geom 1 near the origin, geom 2 within `spread` of
  it, both turned at random."""
  rng = np.random.default_rng(seed)
  p1 = (0.02 * rng.standard_normal((N, 3))).astype(np.float32)
  p2 = (p1 + spread * rng.standard_normal((N, 3))).astype(np.float32)
  s = lambda v: np.tile(np.asarray(v, np.float32), (N, 1))
  return p1, _rot(rng, N), s(size1), p2, _rot(rng, N), s(size2)


def _jax(fn, args, v1=None, v2=None, margin=False):
  """jax.vmap(fn) over the pairs, the hulls shared (a zero hull for a
  geom without one, as the JAX driver passes)."""
  dt = args[0].dtype
  z = np.zeros((1, 4), dt)
  extra = ()
  if v2 is not None or margin:
    extra = (jnp.asarray(z if v1 is None else v1.astype(dt)),
             jnp.asarray(z if v2 is None else v2.astype(dt)))
  if margin:
    extra += (jnp.zeros((), dt),)
  axes = (0,) * 6 + (None,) * len(extra)
  out = jax.jit(jax.vmap(fn, in_axes=axes))(*[jnp.asarray(a) for a in args],
                                             *extra)
  return [np.asarray(x) for x in out]


def _port(fn, args, v1=None, v2=None, margin=False):
  dt = torch.float64 if args[0].dtype == np.float64 else torch.float32
  t = lambda x: None if x is None else torch.tensor(x, dtype=dt)
  extra = (t(v1), t(v2)) if (v2 is not None or margin) else ()
  if margin:
    extra += (torch.zeros(N, dtype=dt),)
  return [x.numpy() for x in fn(*[torch.tensor(a) for a in args], *extra)]


def _assert_all(out, ref, tol):
  for name, a, b in zip(('dist', 'pos', 'frame'), out, ref):
    np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def test_sphere_box_matches_jax():
  args = _poses([0.1, 0, 0], [0.1, 0.15, 0.05], 0.15, 0)
  out, ref = _port(cp.sphere_box, args), _jax(jcp.sphere_box, args)
  assert (ref[0] < 0).sum() > N // 4           # many in contact
  _assert_all(out, ref, TOL)


@pytest.mark.parametrize('mesh', ['cube', 'wedge'])
def test_plane_mesh_matches_jax(mesh):
  hull = dict(zip(('cube', 'wedge'), _hulls()))[mesh]
  args = list(_poses([1, 1, 1], [0.1, 0.1, 0.1], 0.1, 1))
  # a regular layout: the cube upright on a level plane, turned by
  # quarter turns about z (exact matrices): its four bottom vertices tie
  quarter = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
  for i in range(16):
    args[1][i] = np.eye(3, dtype=np.float32)
    args[4][i] = np.linalg.matrix_power(quarter, i % 4)
    args[3][i] = args[0][i] + np.float32([0.01 * i, -0.02, 0.095])
  out = _port(cp.plane_mesh, args, None, hull)
  ref = _jax(jcp.plane_mesh, args, None, hull)
  _assert_all(out, ref, TOL)
  if mesh == 'cube':
    d = ref[0][:16]
    assert (d == d[:, :1]).all()                  # the ties
    # the same four vertices in the same order: the first four of the
    # hull's bottom face by index
    np.testing.assert_allclose(out[1][:16], ref[1][:16], rtol=0, atol=1e-6)


_MPR_CASES = {
    'sphere_mesh': (2, 7, [0.1, 0, 0], [0.1, 0.1, 0.1], False, 'cube'),
    'box_mesh': (6, 7, [0.1, 0.15, 0.05], [0.1, 0.1, 0.1], True, 'cube'),
    'mesh_mesh': (7, 7, [0.1, 0.1, 0.1], [0.1, 0.1, 0.1], True, 'wedge'),
    'cylinder_box': (5, 6, [0.05, 0.1, 0], [0.1, 0.15, 0.05], True, None),
    'cylinder_cylinder': (5, 5, [0.08, 0.1, 0], [0.1, 0.08, 0], True,
                          None),
}


@pytest.mark.parametrize('case', sorted(_MPR_CASES))
def test_mpr_matches_jax(case):
  t1, t2, s1, s2, multi, mesh2 = _MPR_CASES[case]
  cube, wedge = _hulls()
  v1 = cube if t1 == 7 else None
  v2 = dict(cube=cube, wedge=wedge).get(mesh2)
  # a cylinder's cap and side are flat supports whose sign() turns on the
  # last bit of the direction: its MPR takes another path after a change
  # of 1e-15, in float64 too, and ends within its tolerance elsewhere, so
  # float64 is held as float32 is (measured, cylinder-box in float64: 7
  # of 91 base contacts off by more than 1e-9, the points 1.4e-6 apart
  # along the normal)
  chaotic = 5 in (t1, t2)
  assert cc.manifold_ncon(t1, t2, 0) == (5 if multi else 1)
  jfn = (jcc.mpr_multi if multi else jcc.mpr)(t1, t2)
  fn = cc.collider(t1, t2, 0)[0]
  for dt, tol in ((np.float64, TOL if chaotic else TOL64),
                  (np.float32, TOL)):
    args = [a.astype(dt) for a in _poses(s1, s2, 0.15, 2)]
    with jax.enable_x64(dt == np.float64):
      ref = _jax(jfn, args, v1, v2, margin=True)
    out = _port(fn, args, v1, v2, margin=True)
    if dt == np.float64:
      ref64 = ref
    hit = ref[0][:, 0] < 1e9
    np.testing.assert_array_equal(out[0][:, 0] < 1e9, hit)
    assert hit.sum() > N // 4
    normal = ref[2][hit, 0, 0]
    off = ((np.abs(out[0][hit, 0] - ref[0][hit, 0]) > tol) |
           (np.abs(out[2][hit, 0, 0] - normal) > tol).any(-1))
    # the witness points part along the contact plane only
    dpos = out[1][hit, 0] - ref[1][hit, 0]
    np.testing.assert_allclose((dpos * normal).sum(-1), 0, rtol=0, atol=tol)
    moved = int((np.abs(dpos) > tol).any(-1).sum())
    slots = int(((out[0] < 1e9).sum(1) != (ref[0] < 1e9).sum(1)).sum())
    print(f'{case} {dt.__name__}: {int(hit.sum())} base contacts, '
          f'{int(off.sum())} off by more than {tol} in dist or normal, '
          f'{moved} moved along the contact plane; pairs with another '
          f'number of contacts: {slots}')
    if dt == np.float64 and not chaotic:
      assert not off.any()
      if not multi:                  # no flat support: the same point
        assert moved == 0
    else:
      allowed = F32_SHARE * hit.sum()
      if chaotic and dt == np.float32:
        # float32 MPR between two cylinders parts from float64 by up to
        # 2.6e-3 in both packages (measured: 13 of 96 base contacts the
        # port's, 9 JAX's): at most twice JAX's own count
        both = hit & (ref64[0][:, 0] < 1e9)
        own = ((np.abs(ref[0][both, 0] - ref64[0][both, 0]) > tol) |
               (np.abs(ref[2][both, 0, 0] - ref64[2][both, 0, 0]) >
                tol).any(-1)).sum()
        allowed = max(allowed, 2 * own)
      assert off.sum() <= allowed, (off.sum(), allowed)
    assert slots <= (SLOT_SHARE_CYLINDER if chaotic else
                     SLOT_SHARE) * hit.sum(), slots


MESH_CASES = [c for c in CASES if c[0].startswith('mesh_')]


@pytest.mark.parametrize('name,assets,g1,g2,pos2,euler2', MESH_CASES,
                         ids=[c[0] for c in MESH_CASES])
def test_mesh_contacts_match_mujoco(name, assets, g1, g2, pos2, euler2):
  """The deepest contact's dist and normal against C MuJoCo
  (tests/test_convex.py's test_convex_depth and test_convex_normal)."""
  mjm = mujoco.MjModel.from_xml_string(_xml(assets, g1, g2, pos2, euler2))
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  assert mjd.ncon > 0
  m = mt.put_model(mjm, device='cpu')
  sm = smooth.smooth(m, torch.tensor(mjd.qpos[None], dtype=torch.float32),
                     torch.zeros((1, m.nv)))
  con = collision_driver.collision(m, sm['geom_xpos'], sm['geom_xmat'], 8)
  n = int(con['ncon'][0])
  assert n > 0
  dist = con['dist'][0, :n].numpy()
  i, i_ref = int(np.argmin(dist)), int(np.argmin(mjd.contact.dist))
  np.testing.assert_allclose(dist[i], mjd.contact.dist[i_ref], atol=4e-3)
  normal = con['frame'][0, i, 0].numpy()
  cos = abs(float(normal @ mjd.contact.frame.reshape(-1, 3, 3)[i_ref, 0]))
  assert cos > 0.95, cos
