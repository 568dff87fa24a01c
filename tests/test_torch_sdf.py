"""The SDF narrowphase (`collision_sdf.py`) and its voxel grids
(`io._build_sdf_grids`) against the JAX package and C MuJoCo, on the CPU.

* The distances: each primitive's SDF and the grid's trilinear sample,
  values and hand-written gradients against JAX's values and `jax.grad`
  in float64 at 1e-12, on seeded points, points outside the grid's box and
  points exactly on a tie (|x| at 0, a tie of maximum, of clip, of a max
  over the axes, a face of the grid's box); away from ties the gradients
  also agree with `torch.autograd` on the port's own values.
* The collider, on the scenes of tests/test_sdf.py (the octahedron SDF
  on a plane and under a sphere, with a second octahedron and an
  octahedron mesh for an SDF-SDF and a mesh-SDF pair) at seeded poses:
  in float64 every candidate's dist, pos and frame agree with
  `sdf_pair_collider` at 1e-9 of scale; in float32 a descent whose
  Armijo choices part from JAX's (any of dist, pos, frame off by more than
  F32_TOL) counts, and there are at most F32_SHARE of them; where the
  boxes do not meet (a world with geom 2 moved 5 m up) both give _BIG.
* Against C MuJoCo, tests/test_sdf.py's two checks: a sphere pressed into
  the SDF gives a depth within 8e-3 of C's, and 25 steps of the
  octahedron on the floor give qpos[2] within 5e-3 of C's.
"""

import mujoco
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import collision_sdf as jsdf
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import collision_driver, collision_sdf as sdf
from mujoco_warp_tpu_torch import smooth
from mujoco_warp_tpu_torch.types import GeomType

TOL64 = 1e-12
TOL_COLLIDER64 = 1e-9
# float32: a descent whose dist, pos or frame parts from the JAX
# collider's by more than F32_TOL of scale took another step somewhere;
# at most F32_SHARE of the descents may
F32_TOL = 5e-5
F32_SHARE = 0.05

OCTA = """<mesh name="octa" vertex="0.12 0 0  -0.12 0 0  0 0.12 0  0 -0.12 0
                                   0 0 0.1  0 0 -0.1"/>"""

# tests/test_sdf.py's scene, with a second octahedron SDF and an
# octahedron mesh: plane-SDF, sphere-SDF, mesh-SDF and SDF-SDF pairs
COLLIDER_XML = f"""
<mujoco>
  <option sdf_iterations="10" sdf_initpoints="20"/>
  <asset>{OCTA}<mesh name="octa_mesh" vertex="0.1 0 0  -0.1 0 0  0 0.1 0
      0 -0.1 0  0 0 0.08  0 0 -0.08"/></asset>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 0.1"/>
    <body pos="0 0 0.3"><freejoint/><geom type="sdf" mesh="octa"/></body>
    <body pos="0.05 0.03 0.5"><freejoint/><geom type="sdf" mesh="octa"/></body>
    <body pos="0.05 0.03 0.7"><freejoint/>
      <geom type="sphere" size="0.06"/></body>
    <body pos="0.3 0 0.5"><freejoint/><geom type="mesh" mesh="octa_mesh"/>
    </body>
  </worldbody>
</mujoco>
"""


def _rot(rng, n):
  q = rng.standard_normal((n, 4))
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  w, x, y, z = q.T
  return np.stack([
      np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                2 * (x * z + w * y)], -1),
      np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                2 * (y * z - w * x)], -1),
      np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                1 - 2 * (x * x + y * y)], -1)], -2)


# ---- the distances ----------------------------------------------------------

SIZES = {GeomType.PLANE: [1.0, 1.0, 0.1], GeomType.SPHERE: [0.3, 0, 0],
         GeomType.BOX: [0.2, 0.2, 0.3], GeomType.ELLIPSOID: [0.2, 0.3, 0.4],
         GeomType.CAPSULE: [0.1, 0.25, 0], GeomType.CYLINDER: [0.15, 0.2, 0]}


def _tie_points(gtype):
  """Points exactly on each tie of the type's SDF."""
  s = SIZES[gtype]
  pts = [[0.0, 0.0, 0.0], [0.0, 0.05, -0.1]]       # |x| at 0, |v| at 0
  if gtype == GeomType.BOX:
    pts += [[0.2, 0.2, 0.1],            # a tie of the max over the axes
            [0.1, 0.1, 0.0],            # ... of two of three inside
            [0.2, -0.05, 0.1],          # on a face: max(q, 0) at 0
            [0.25, 0.25, 0.35]]         # outside, past a corner
  if gtype == GeomType.CAPSULE:
    pts += [[0.05, 0.0, 0.25], [0.0, -0.2, -0.25]]      # clip's ties
  if gtype == GeomType.CYLINDER:
    pts += [[0.15, 0.0, 0.2],           # a tie of the max, at 0
            [0.0, 0.1, -0.15],          # inside, dxy = dz
            [0.3, 0.0, 0.0]]
  if gtype == GeomType.SPHERE:
    pts += [[0.3, 0.0, 0.0]]
  return np.asarray(pts, np.float64)


def _jax_sdf(fn, p):
  """(values, jax.grad) of fn over points p (K, 3), float64."""
  with jax.enable_x64(True):
    pj = jnp.asarray(p, jnp.float64)
    val = jax.vmap(fn)(pj)
    grad = jax.vmap(jax.grad(fn))(pj)
    return np.asarray(val), np.asarray(grad)


@pytest.mark.parametrize('gtype', sorted(SIZES))
def test_primitive_sdf_matches_jax(gtype):
  rng = np.random.default_rng(int(gtype))
  size = np.asarray(SIZES[gtype], np.float64)
  p = np.concatenate([rng.uniform(-0.5, 0.5, (64, 3)), _tie_points(gtype)])
  with jax.enable_x64(True):
    ref = _jax_sdf(lambda x: jsdf._primitive_sdf(gtype, x, jnp.asarray(
        size)), p)
  pt = torch.tensor(p)
  st = torch.tensor(size).expand(len(p), 3)
  val, grad = sdf.primitive_sdf(gtype, pt, st, grad=True)
  np.testing.assert_allclose(val.numpy(), ref[0], rtol=0, atol=TOL64)
  np.testing.assert_allclose(sdf.primitive_sdf(gtype, pt, st).numpy(),
                             ref[0], rtol=0, atol=TOL64)
  np.testing.assert_allclose(grad.numpy(), ref[1], rtol=0, atol=TOL64)
  # torch.autograd on the port's own value, away from the ties
  q = torch.tensor(p[:64], requires_grad=True)
  sdf.primitive_sdf(gtype, q, st[:64]).sum().backward()
  np.testing.assert_allclose(q.grad.numpy(), grad[:64].numpy(), rtol=0,
                             atol=TOL64)


def _one_grid(res=6, seed=0):
  """A small seeded grid (res^3) and its box (center, half)."""
  rng = np.random.default_rng(seed)
  grid = rng.standard_normal((res, res, res))
  return grid, np.array([0.1, -0.05, 0.2]), np.array([0.3, 0.2, 0.25])


def test_grid_sdf_matches_jax():
  grid, center, half = _one_grid()
  rng = np.random.default_rng(1)
  lo, hi = center - half, center + half
  inside = rng.uniform(lo, hi, (64, 3))
  outside = center + rng.uniform(-2, 2, (32, 3)) * half
  ties = np.array([center, lo, hi, [lo[0], center[1], hi[2]],
                   # on a cell's face inside, and on the box's faces
                   lo + (hi - lo) * np.array([0.4, 0.2, 0.6]),
                   [hi[0], center[1] + 0.01, center[2]],
                   [center[0], lo[1], center[2] - 0.02]])
  p = np.concatenate([inside, outside, ties])
  ref = _jax_sdf(lambda x: jsdf._grid_sdf(jnp.asarray(grid), jnp.asarray(
      center), jnp.asarray(half), x), p)
  gt = torch.tensor(grid)[None]
  g = sdf.Grid(gt, torch.tensor([0]), torch.tensor(center)[None],
               torch.tensor(half)[None])
  pt = torch.tensor(p)[None]                                  # (P=1, K, 3)
  val, grad = sdf.grid_sdf(g.view(0, 1), pt, grad=True)
  np.testing.assert_allclose(val[0].numpy(), ref[0], rtol=0, atol=TOL64)
  np.testing.assert_allclose(grad[0].numpy(), ref[1], rtol=0, atol=TOL64)
  np.testing.assert_allclose(sdf.grid_sdf(g.view(0, 1), pt)[0].numpy(),
                             ref[0], rtol=0, atol=TOL64)
  q = torch.tensor(p[:96], requires_grad=True)[None]
  q.retain_grad()
  sdf.grid_sdf(g.view(0, 1), q).sum().backward()
  np.testing.assert_allclose(q.grad[0].numpy(), grad[0, :96].numpy(),
                             rtol=0, atol=TOL64)


def test_grid_sdf_indexes_past_2_24():
  """A grid whose flat index passes 2^24 (where float32 stops holding
  odd integers) is read at the right corners: the last of 4,100 grids of
  16^3 samples as the same grid alone, bit for bit."""
  rng = np.random.default_rng(3)
  G, R = 4100, 16
  assert G * R ** 3 > 1 << 24
  grids = torch.zeros((G, R, R, R))
  grids[-1] = torch.tensor(rng.normal(0, 0.05, (R, R, R)), dtype=torch.float32)
  center = torch.tensor([[0.01, -0.02, 0.03]])
  half = torch.tensor([[0.1, 0.12, 0.08]])
  p = torch.tensor(rng.uniform(-0.15, 0.15, (1, 512, 3)), dtype=torch.float32)
  far = sdf.Grid(grids, torch.tensor([G - 1]), center, half)
  alone = sdf.Grid(grids[-1:].clone(), torch.tensor([0]), center, half)
  for grad in (False, True):
    got = sdf.grid_sdf(far.view(0, 1), p, grad)
    want = sdf.grid_sdf(alone.view(0, 1), p, grad)
    for x, y in zip(*((got, want) if grad else ((got,), (want,)))):
      assert torch.equal(x, y)


# ---- the collider -----------------------------------------------------------

@pytest.fixture(scope='module')
def collider_models():
  mjm = mujoco.MjModel.from_xml_string(COLLIDER_XML)
  return mjm, mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')


def _poses(rng, W, P, t1):
  """Seeded poses of W worlds' P pairs: the two geoms within a few cm,
  turned at random (a plane stays at the origin, level)."""
  pos1 = rng.normal(0, 0.03, (W, P, 3))
  pos2 = rng.normal(0, 0.03, (W, P, 3))
  mat1 = _rot(rng, W * P).reshape(W, P, 3, 3)
  mat2 = _rot(rng, W * P).reshape(W, P, 3, 3)
  if t1 == GeomType.PLANE:
    pos1[...] = 0.0
    mat1[...] = np.eye(3)
  return pos1, mat1, pos2, mat2


def _jax_collider(jm, t1, t2, g1, g2, args, dtype):
  """JAX sdf_pair_collider over (W, P) poses args, in dtype."""
  gom, did = np.asarray(jm.sdf_grid_of_mesh), np.asarray(jm.geom_dataid)

  def grid(g, t):
    if t not in (GeomType.MESH, GeomType.SDF):
      return jnp.zeros_like(jm.sdf_grids[0]), jnp.zeros_like(
          jm.sdf_grid_aabb[0]), -1
    gi = gom[did[g[0]]]
    assert (gom[did[g]] == gi).all()
    return jm.sdf_grids[gi], jm.sdf_grid_aabb[gi], 0
  gr1, ga1, d1 = grid(g1, t1)
  gr2, ga2, d2 = grid(g2, t2)
  fn = jsdf.sdf_pair_collider(jm, t1, t2, d1, d2, 20, 10)
  pair = jax.vmap(fn, in_axes=(0, 0, 0, 0, None, None, 0) * 2)
  world = jax.vmap(pair, in_axes=(0, 0) + (None,) * 5 + (0, 0) + (None,) * 5)
  with jax.enable_x64(dtype == np.float64):
    a = lambda x: jnp.asarray(np.asarray(x), dtype)
    pos1, mat1, pos2, mat2 = args
    out = jax.jit(world)(
        a(pos1), a(mat1), a(jm.geom_size[g1]), a(jm.geom_aabb[g1]), a(gr1),
        a(ga1), a(jm.geom_plugin_attr[g1]), a(pos2), a(mat2),
        a(jm.geom_size[g2]), a(jm.geom_aabb[g2]), a(gr2), a(ga2),
        a(jm.geom_plugin_attr[g2]))
    return [np.asarray(x) for x in out]


def _as(side: sdf.Side, dtype, grids) -> sdf.Side:
  """side in dtype, its grids' table built from grids (the JAX Model's:
  the two packages' voxelizations part by rounding, see
  test_torch_sdf_grids.py)."""
  g = side.grid
  if g is not None:
    g = sdf.Grid(torch.tensor(np.asarray(grids), dtype=dtype),
                 g.base // g.res ** 3, g.center.to(dtype),
                 g.half.to(dtype))
  return sdf.Side(side.gtype, side.size.to(dtype), side.aabb.to(dtype), g)


def _port_collider(m, jm, t1, t2, args, dtype):
  grp = [g for (a, b, _), g in zip(m.collision_pairs,
                                   collision_driver._group_tables(m))
         if (a, b) == (t1, t2)][0]
  t = lambda x: torch.tensor(np.asarray(x), dtype=dtype)
  out = sdf.collide(_as(grp['side1'], dtype, jm.sdf_grids),
                    _as(grp['side2'], dtype, jm.sdf_grids),
                    grp['slots'], m.opt.sdf_iterations, *map(t, args))
  return [x.numpy() for x in out], grp


SDF_GROUPS = [(GeomType.PLANE, GeomType.SDF), (GeomType.SPHERE, GeomType.SDF),
              (GeomType.MESH, GeomType.SDF), (GeomType.SDF, GeomType.SDF)]


@pytest.mark.parametrize('t1,t2', SDF_GROUPS,
                         ids=['plane', 'sphere', 'mesh', 'sdf'])
def test_collider_matches_jax(collider_models, t1, t2):
  mjm, jm, m = collider_models
  (_, _, gl), = [x for x in m.collision_pairs if x[:2] == (t1, t2)]
  g1, g2 = np.array([a for a, _, _ in gl]), np.array([b for _, b, _ in gl])
  rng = np.random.default_rng(int(t1) + 10)
  W, P = 6, len(gl)
  args = _poses(rng, W, P, t1)
  args[2][-1, :, 2] += 5.0         # the last world's boxes do not meet
  for dtype, tdtype in ((np.float64, torch.float64),
                        (np.float32, torch.float32)):
    a = [x.astype(dtype) for x in args]
    ref = _jax_collider(jm, t1, t2, g1, g2, a, dtype)
    out, _ = _port_collider(m, jm, t1, t2, a, tdtype)
    hit = ref[0] < 1e9
    np.testing.assert_array_equal(out[0] < 1e9, hit)
    assert hit.any()
    assert (ref[0][-1] == sdf._BIG).all() and (out[0][-1] == sdf._BIG).all()
    scale = max(1.0, float(np.abs(ref[1]).max()))
    off = np.zeros(ref[0].shape, bool)
    for x, y in zip(out, ref):
      off |= (np.abs(x - y) > (TOL_COLLIDER64 if dtype == np.float64 else
                               F32_TOL) * scale).reshape(
                                   ref[0].shape + (-1,)).any(-1)
    print(f'({t1}, {t2}) {dtype.__name__}: {off.sum()} of {off.size} '
          f'descents part from JAX')
    if dtype == np.float64:
      assert not off.any()
    else:
      assert off.sum() <= F32_SHARE * off.size, off.sum()


def _sphere_scene():
  return f"""
  <mujoco>
    <option sdf_iterations="12" sdf_initpoints="16"/>
    <asset>{OCTA}</asset>
    <worldbody>
      <body pos="0 0 1"><freejoint/>
        <geom name="sdfgeom" type="sdf" mesh="octa" mass="0.5"/></body>
      <body pos="0 0 1.14"><freejoint/>
        <geom name="ball" type="sphere" size="0.06" mass="0.3"/></body>
    </worldbody>
  </mujoco>
  """


def test_sdf_sphere_depth_matches_c_mujoco():
  """tests/test_sdf.py::test_sdf_sphere_contact_geometry on the port."""
  mjm = mujoco.MjModel.from_xml_string(_sphere_scene())
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  m = mt.put_model(mjm, device='cpu')
  sm = smooth.smooth(m, torch.tensor(mjd.qpos[None], dtype=torch.float32),
                     torch.zeros((1, m.nv)))
  con = collision_driver.collision(m, sm['geom_xpos'], sm['geom_xmat'], 24)
  dist = con['dist'][0].numpy()
  keep = dist < 1e9
  assert keep.any()
  best = dist[keep].min()
  ref = mjd.contact.dist.min() if mjd.ncon else -0.02
  assert best < 0, best
  assert abs(best - ref) < 8e-3, (best, ref)


FLOOR_XML = f"""
<mujoco>
  <option timestep="0.002" sdf_iterations="10" sdf_initpoints="20"/>
  <asset>{OCTA}</asset>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 0.1"/>
    <body pos="0 0 0.3">
      <freejoint/>
      <geom name="sdfgeom" type="sdf" mesh="octa" mass="0.5"/>
    </body>
    <body pos="0.05 0.03 0.6">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.06" mass="0.3"/>
    </body>
  </worldbody>
</mujoco>
"""


def test_sdf_on_the_floor_matches_c_mujoco():
  """tests/test_sdf.py::test_sdf_contacts_floor's trajectory check on the
  port: 25 steps from a penetrating start, qpos[2] within 5e-3 of C's."""
  mjm = mujoco.MjModel.from_xml_string(FLOOR_XML)
  mjd = mujoco.MjData(mjm)
  mjd.qpos[2] = 0.095
  m = mt.put_model(mjm, device='cpu')
  q = mjm.qpos0.copy()
  q[2] = 0.095
  d = mt.data_from_numpy(m, dict(qpos=q[None].astype(np.float32)),
                         nconmax=24)
  for _ in range(25):
    mujoco.mj_step(mjm, mjd)
    d = mt.step_batched(m, d)
  assert abs(float(d.qpos[0, 2]) - mjd.qpos[2]) < 5e-3, (
      float(d.qpos[0, 2]), mjd.qpos[2])
  assert torch.isfinite(d.qpos).all()
