"""The height-field narrowphase (`collision_hfield.py`) against the JAX
package's (`mujoco_warp_tpu/collision_hfield.py`) and C MuJoCo, on the
CPU, and the gate that admits it.

* Against JAX, each collider jitted alone and vmapped over N seeded
  poses on tests/test_hfield.py's bumpy 9 x 9 field (`HFIELD`), the
  field's own pose random too (so its frame is not the world's):
  - the Model's normalized heights equal JAX `put_model`'s;
  - the ellipsoid and cylinder supports in float64 at 1e-12, directions
    along a cylinder's axis included;
  - `sphere_hfield` and the capsule (`hfield_collider`) in float32 at
    the reference tolerance 5e-5 (tests/fixtures.py:140) in every
    output: these are closest points on triangles, with no witness
    ambiguity;
  - the prisms (box, cylinder, ellipsoid) in float64: `_cell_prisms`
    bit-equal; each prism's base MPR contact is found in the same
    prisms, its dist and normal within 1e-9 and its point within 1e-9
    along the normal (MPR's witness moves along the contact plane where
    a support runs along a face, test_torch_convex.py); the port's
    selection (`deepest`) on JAX's own candidates bit-equal to JAX
    `prism_mpr_hfield` run on them (`_jax_selection`: MPR compiles once);
    the ellipsoid's whole output within 1e-9. A
    cylinder's MPR against a flat prism is chaotic in float64 itself: a
    change of its position by 1e-15 relative moves about an eighth of
    the base contacts by up to 4e-4 in dist (measured). There the port
    is held by its own spread: the base contacts over 1e-9 from JAX's
    may number CYL_SPREAD times those over 1e-9 after such changes, and
    lie within CYL_SPREAD times their largest move. The float32 colliders
    are held on the card against float64 (chip_smoke phase (w)).
  The margin rule (ROADMAP §C, C5) plays no part here: the colliders
  take no margin.
* Against C MuJoCo, tests/test_hfield.py's checks at its tolerances, the
  port alone (no JAX): the sphere and capsule at rest after 400 steps,
  the sphere's depth just touching, the box at rest on a plateau after
  250 steps, box, cylinder and ellipsoid contact parity on a flat
  plateau, and the box's deepest contact on the bumpy field.
* The gate admits (HFIELD, t) for the sphere, capsule, ellipsoid,
  cylinder and box, as geom pairs and as <pair>s, with JAX `put_model`'s
  groups and 4 slots a pair; it refuses hfield-mesh and plane-hfield by
  name (JAX refuses the geom pairs at `put_model` too, and a <pair>
  with a mesh when its collider runs); `collision_driver.culls`
  never culls a height field group.
"""

import mujoco
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import collision_convex as jcc
from mujoco_warp_tpu import collision_hfield as jh
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import collision_convex as cc
from mujoco_warp_tpu_torch import collision_driver
from mujoco_warp_tpu_torch import collision_hfield as hf
from mujoco_warp_tpu_torch import io, smooth
from mujoco_warp_tpu_torch.types import GeomType

from test_hfield import BOX_HFIELD, HFIELD, PRISM_XML
from test_torch_convex import _rot
import torch_parity  # noqa: F401  (one torch thread an xdist worker)

TOL = 5e-5
TOL64 = 1e-9
N = 256
CYL_SPREAD = 2.0


def _bumpy(mjm):
  """tests/test_hfield.py's bumpy terrain."""
  nr, nc = mjm.hfield_nrow[0], mjm.hfield_ncol[0]
  h = 0.5 + 0.5 * np.sin(np.linspace(0, 3, nr))[:, None] * np.cos(
      np.linspace(0, 4, nc))[None, :]
  mjm.hfield_data[:] = h.reshape(-1)
  return mjm


@pytest.fixture(scope='module')
def field():
  """(JAX Model, port Model) of the bumpy field."""
  mjm = _bumpy(mujoco.MjModel.from_xml_string(HFIELD))
  return mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')


def _poses(seed, t2):
  """N seeded (hpos, hmat, center, m2, s2) float32: the field near the
  origin, turned at random; geom 2 over the field's footprint and past
  its edges, from 0.15 below its base to 0.35 above, turned at random,
  sized for type t2."""
  rng = np.random.default_rng(seed)
  hpos = (0.1 * rng.standard_normal((N, 3))).astype(np.float32)
  hmat = _rot(rng, N)
  local = np.stack([rng.uniform(-1.1, 1.1, N), rng.uniform(-1.1, 1.1, N),
                    rng.uniform(-0.15, 0.35, N)], 1)
  center = (hpos + np.einsum('nij,nj->ni', hmat, local)).astype(np.float32)
  s2 = rng.uniform(0.04, 0.15, (N, 3)).astype(np.float32)
  if t2 in (GeomType.SPHERE, GeomType.CAPSULE, GeomType.CYLINDER):
    s2[:, 2] = 0
  return hpos, hmat, center, _rot(rng, N), s2


def _jax(fn, args, dt, jit=True):
  """jax.vmap(fn) over the poses, jitted or, where op-by-op dispatch
  takes less time than compiling the unrolled function (sphere_hfield's
  50 triangles, the capsule's three spheres), not."""
  fn = jax.vmap(fn)
  with jax.enable_x64(dt == np.float64):
    out = (jax.jit(fn) if jit else fn)(*[jnp.asarray(a.astype(dt))
                                         for a in args])
    return jax.tree.map(np.asarray, out)


def _port(fn, m, t2, args, dt):
  t = lambda a: torch.tensor(a.astype(dt))
  hp, hm, c, m2, s2 = (t(a) for a in args)
  out = fn(m.hfield_data[0], 9, 9, t2, hp, hm, m.hfield_size[0].to(hp.dtype),
           c, m2, s2)
  return [x.numpy() for x in out]


def test_hfield_model_matches_jax(field):
  jm, m = field
  assert (m.nhfield, m.hfield_nrow, m.hfield_ncol) == (1, (9,), (9,))
  np.testing.assert_array_equal(m.hfield_data.numpy(), jm.hfield_data)
  np.testing.assert_array_equal(m.hfield_size.numpy(), jm.hfield_size)
  assert m.collision_pairs == jm.collision_pairs
  assert m.nxn_candidates == jm.nxn_candidates


@pytest.mark.parametrize('gtype', [GeomType.ELLIPSOID, GeomType.CYLINDER])
def test_supports_match_jax(gtype):
  rng = np.random.default_rng(int(gtype))
  p, s = rng.standard_normal((64, 3)), rng.uniform(0.05, 0.2, (64, 3))
  R = _rot(rng, 64).astype(np.float64)
  d = rng.standard_normal((64, 3))
  d[:8] = np.einsum('nij,j->ni', R[:8], [0.0, 0.0, 1.0])   # along the axis
  d[4:8] *= -1
  with jax.enable_x64(True):
    ref = np.asarray(jax.vmap(jcc.SUPPORT[gtype], in_axes=(0, 0, 0, None, 0))(
        p, R, s, None, d))
  out = cc.SUPPORT[gtype](*[torch.tensor(x) for x in (p, R, s)], None,
                          torch.tensor(d))
  np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)


def test_sphere_and_capsule_match_jax(field):
  jm, m = field
  hs = jm.hfield_size[0]
  # the sphere
  hpos, hmat, center, _, s2 = _poses(0, GeomType.SPHERE)
  ref = _jax(lambda p, R, c, r: jh.sphere_hfield(
      jm, 0, 9, 9, p, R, jnp.asarray(hs, p.dtype), c, r),
             (hpos, hmat, center, s2[:, 0]), np.float32, jit=False)
  out = [x.numpy() for x in hf.sphere_hfield(
      m.hfield_data[0], 9, 9, torch.tensor(hpos), torch.tensor(hmat),
      m.hfield_size[0], torch.tensor(center), torch.tensor(s2[:, 0]))]
  assert (ref[0] < 0).sum() > N // 2 and (ref[0] > 1e9).any()  # duplicates
  for name, a, b in zip(('dist', 'pos', 'frame'), out, ref):
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=name)
  # the capsule, as three spheres
  args = _poses(1, GeomType.CAPSULE)
  ref = _jax(lambda p, R, c, M, s: jh.hfield_collider(
      jm, 0, 9, 9, GeomType.CAPSULE)(p, R, jnp.asarray(hs, p.dtype), c, M, s),
             args, np.float32, jit=False)
  out = _port(lambda data, nr, nc, t2, p1, m1, hs, *a: hf.collide(
      t2, data, nr, nc, hs, p1, m1, *a), m, GeomType.CAPSULE, args,
              np.float32)
  assert (ref[0] < 0).sum() > N // 2
  for name, a, b in zip(('dist', 'pos', 'frame'), out, ref):
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=name)


def _moved(x, rel):
  return x * (1 + rel)


def _jax_selection(jm, t2, cand, args):
  """JAX `prism_mpr_hfield`'s output on the candidates `cand` (each
  pose's (dist, pos, frame) of its 50 prisms, as `candidates` below makes
  them): the function itself, run with its prisms replaced by their
  indices and its collider by a lookup of cand, so that its selection
  (top-4 by depth, the near-duplicate drop) runs on these candidates
  without compiling MPR a second time."""
  index = np.zeros((50, 6, 4))
  index[:, 0, 0] = np.arange(50)

  def one(p, R, c, M, s, dist, pos, frame):
    def lookup(*_):
      def collide(*a, v1=None):
        i = v1[0, 0].astype(jnp.int32)
        return dist[i], pos[i], frame[i]
      return collide
    with pytest.MonkeyPatch.context() as mp:
      mp.setattr(jh, '_cell_prisms', lambda *a: jnp.asarray(index))
      mp.setattr(jcc, 'mpr', lookup)
      mp.setattr(jcc, 'mpr_multi', lookup)
      return jh.prism_mpr_hfield(jm, 0, 9, 9, t2, p, R, jnp.asarray(
          jm.hfield_size[0], p.dtype), c, M, s)
  return _jax(one, tuple(args) + tuple(cand), np.float64)


@pytest.mark.parametrize('t2', [GeomType.BOX, GeomType.CYLINDER,
                                GeomType.ELLIPSOID])
def test_prisms_match_jax(field, t2):
  jm, m = field
  dt = np.float64
  args = _poses(int(t2), t2)
  multi = t2 != GeomType.ELLIPSOID

  def candidates(p, R, c, M, s):
    """(prisms, each prism's candidates), as prism_mpr_hfield makes
    them."""
    hs = jnp.asarray(jm.hfield_size[0], p.dtype)
    prisms = jh._cell_prisms(jm, 0, 9, 9, R, p, hs, c)
    mpr = (jcc.mpr_multi if multi else jcc.mpr)(GeomType.MESH, t2)
    return prisms, jax.vmap(lambda v: mpr(p, R, jnp.zeros(3, p.dtype), c, M,
                                          s, v1=v))(prisms)
  prisms, cand = _jax(candidates, args, dt)
  full = _jax_selection(jm, t2, cand, args)
  hp, hm, c, m2, s2 = (torch.tensor(a.astype(dt)) for a in args)
  data, hs = m.hfield_data[0], m.hfield_size[0].double()
  np.testing.assert_array_equal(
      hf._cell_prisms(data, 9, 9, hm, hp, hs, c).numpy(), prisms)
  out = [x.numpy() for x in hf.prism_contacts(data, 9, 9, t2, hp, hm, hs, c,
                                               m2, s2)]
  # the base contact of each prism
  hit = cand[0][..., 0] < 1e9
  np.testing.assert_array_equal(out[0][..., 0] < 1e9, hit)
  assert hit.any(-1).sum() > N // 2

  def off(a):
    """(dist, normal, point along the normal) of a's base contacts from
    JAX's, where both are found."""
    n = cand[2][..., 0, 0, :]
    dpos = a[1][..., 0, :] - cand[1][..., 0, :]
    return [np.where(hit, x, 0.0) for x in (
        np.abs(a[0][..., 0] - cand[0][..., 0]),
        np.abs(a[2][..., 0, 0, :] - n).max(-1), np.abs((dpos * n).sum(-1)))]
  err = off(out)
  print(f'{t2.name}: {int(hit.sum())} base contacts in {N} pairs x 50 '
        f'prisms; over {TOL64}: dist {int((err[0] > TOL64).sum())}, normal '
        f'{int((err[1] > TOL64).sum())}, along the normal '
        f'{int((err[2] > TOL64).sum())}; largest '
        f'{[float(e.max()) for e in err]}')
  if t2 == GeomType.CYLINDER:
    spread = [np.zeros_like(e) for e in err]
    for rel in (1e-15, -1e-15):
      again = [x.numpy() for x in hf.prism_contacts(
          data, 9, 9, t2, hp, hm, hs, _moved(c, rel), m2, s2)]
      spread = [np.maximum(s, e) for s, e in zip(spread, off(again))]
    n_own = int(((spread[0] > TOL64) | (spread[1] > TOL64)).sum())
    n_off = int(((err[0] > TOL64) | (err[1] > TOL64)).sum())
    print(f'  the port after a 1e-15 relative move: {n_own} over {TOL64}, '
          f'largest {[float(s.max()) for s in spread]}')
    assert n_off <= CYL_SPREAD * n_own
    for e, s in zip(err, spread):
      assert e.max() <= CYL_SPREAD * s.max()
  else:
    for e in err:
      assert e.max() <= TOL64
  # the selection, on JAX's own candidates
  sel = hf.deepest(*[torch.tensor(x) for x in cand])
  for a, b in zip(sel, full):
    np.testing.assert_array_equal(a.numpy(), b)
  assert (full[0] < 0).any(-1).sum() > N // 4
  if not multi:
    whole = [x.numpy() for x in hf.prism_mpr_hfield(data, 9, 9, t2, hp, hm,
                                                     hs, c, m2, s2)]
    for name, a, b in zip(('dist', 'pos', 'frame'), whole, full):
      np.testing.assert_allclose(a, b, rtol=0, atol=TOL64, err_msg=name)


# ---- against C MuJoCo, the port alone ----

def _contacts(m, qpos, nconmax=16):
  """The port's active contacts (dist, pos) at qpos (one world)."""
  sm = smooth.smooth(m, torch.tensor(qpos[None], dtype=torch.float32),
                     torch.zeros((1, m.nv)))
  con = collision_driver.collision(m, sm['geom_xpos'], sm['geom_xmat'],
                                   nconmax)
  n = int(con['ncon'][0])
  return con['dist'][0, :n].numpy(), con['pos'][0, :n].numpy()


def _rollout(m, n):
  d = mt.make_data(m, nconmax=16)
  for _ in range(n):
    d = mt.step_batched(m, d)
  assert torch.isfinite(d.qpos).all()
  return d.qpos[0].numpy()


def test_hfield_rest_matches_c_mujoco():
  """test_hfield_resting_depth: the sphere within 0.02 of C's height and
  the capsule within 0.05 after 400 steps, the capsule above 0."""
  mjm = _bumpy(mujoco.MjModel.from_xml_string(HFIELD))
  mjd = mujoco.MjData(mjm)
  for _ in range(400):
    mujoco.mj_step(mjm, mjd)
  q = _rollout(mt.put_model(mjm, device='cpu'), 400)
  np.testing.assert_allclose(q[2], mjd.qpos[2], atol=0.02)
  assert q[9] > 0.0 and abs(q[9] - mjd.qpos[9]) < 0.05
  # test_hfield_contact_exists: the sphere just touching at (0, 0)
  mjd.qpos[:] = mjm.qpos0
  mjd.qpos[2] = 0.15
  mujoco.mj_forward(mjm, mjd)
  assert mjd.ncon > 0
  dist, _ = _contacts(mt.put_model(mjm, device='cpu'), mjd.qpos)
  assert dist.size
  np.testing.assert_allclose(dist.min(), mjd.contact.dist.min(), atol=3e-3)


def test_box_on_hfield_rest_matches_c_mujoco():
  """test_box_on_hfield_rest: within 5e-3 of C's height after 250
  steps on a plateau."""
  mjm = mujoco.MjModel.from_xml_string(BOX_HFIELD)
  mjm.hfield_data[:] = 0.5
  mjd = mujoco.MjData(mjm)
  for _ in range(250):
    mujoco.mj_step(mjm, mjd)
  q = _rollout(mt.put_model(mjm, device='cpu'), 250)
  assert abs(q[2] - mjd.qpos[2]) < 5e-3, (q[2], mjd.qpos[2])


def _lowered(gtype, size, euler, bumpy):
  """tests/test_hfield.py's `_make_prism`: the geom lowered from 0.8 in
  steps of 2 mm until C reports a contact deeper than 2e-4."""
  mjm = mujoco.MjModel.from_xml_string(PRISM_XML.format(
      gtype=gtype, size=size, z=0.8).replace('euler="5 10 0"',
                                             f'euler="{euler}"'))
  if bumpy:
    _bumpy(mjm)
  else:
    mjm.hfield_data[:] = 0.5
  mjd = mujoco.MjData(mjm)
  for zz in np.arange(0.8, -0.1, -0.002):
    mjd.qpos[2] = zz
    mujoco.mj_forward(mjm, mjd)
    if mjd.ncon > 0 and mjd.contact.dist.min() < -2e-4:
      break
  return mjd, _contacts(mt.put_model(mjm, device='cpu'), mjd.qpos)


@pytest.mark.parametrize('gtype,size,euler,pos_tol,dist_tol', [
    ('box', '0.12 0.1 0.08', '5 10 0', 2e-3, 2e-4),
    ('cylinder', '0.1 0.08', '5 0 0', 5e-3, 3e-4),
    ('ellipsoid', '0.12 0.1 0.08', '5 10 0', 5e-3, 2e-4)])
def test_hfield_contact_parity_vs_c(gtype, size, euler, pos_tol, dist_tol):
  """_contact_parity: each penetrating C contact on a flat plateau has a
  port contact within pos_tol, its depth within dist_tol."""
  mjd, (dist, pos) = _lowered(gtype, size, euler, bumpy=False)
  assert mjd.ncon > 0 and dist.size > 0
  for ci in range(mjd.ncon):
    if mjd.contact.dist[ci] > -1e-5:
      continue
    perr = np.linalg.norm(pos - mjd.contact.pos[ci][None], axis=1)
    j = int(np.argmin(perr))
    assert perr[j] < pos_tol, (gtype, ci, perr[j])
    assert abs(dist[j] - mjd.contact.dist[ci]) < dist_tol


def test_box_hfield_bumpy_depth_vs_c():
  """test_box_hfield_bumpy_depth_parity_vs_c: the deepest contact on the
  bumpy field no shallower than C's deepest + 2e-4, and within 2.5e-3."""
  mjd, (dist, _) = _lowered('box', '0.12 0.1 0.08', '5 10 0', bumpy=True)
  c_min = mjd.contact.dist.min()
  assert dist.size > 0
  assert c_min - 2.5e-3 <= dist.min() <= c_min + 2e-4


# ---- the gate ----

_ROBOTS = ''.join(
    f'<body pos="{0.3 * i - 0.6} 0 0.3"><freejoint/><geom type="{t}" '
    f'size="0.05 0.06 0.07" contype="2" conaffinity="1"/></body>'
    for i, t in enumerate(('sphere', 'capsule', 'ellipsoid', 'cylinder',
                           'box')))
_GATE = """<mujoco><asset><hfield name="f" nrow="5" ncol="6"
  size="1 1 0.2 0.1"/>{assets}</asset><worldbody>
  <geom name="field" type="hfield" hfield="f"/>{bodies}</worldbody>
  {pairs}</mujoco>"""
_TET = ('<mesh name="tet" vertex="0 0 0  0.1 0 0  0 0.1 0  0 0 0.1"/>')
_MESH_BODY = ('<body pos="0 0.5 0.3"><freejoint/><geom name="m" type="mesh" '
              'mesh="tet" contype="2" conaffinity="1"/></body>')


def test_gate_admits_the_five_hfield_pairs_as_jax():
  for pairs in ('', '<contact>' + ''.join(
      f'<pair geom1="field" geom2="g{i}"/>' for i in range(5)) +
                '</contact>'):
    bodies = _ROBOTS if not pairs else _ROBOTS.replace(
        'contype="2" conaffinity="1"', 'contype="0" conaffinity="0"')
    for i in range(5):
      bodies = bodies.replace('<geom type', f'<geom name="g{i}" type', 1)
    mjm = mujoco.MjModel.from_xml_string(_GATE.format(
        assets='', bodies=bodies, pairs=pairs))
    m, jm = mt.put_model(mjm, device='cpu'), mjwt.put_model(mjm)
    assert m.collision_pairs == jm.collision_pairs
    assert [(a, b, len(g)) for a, b, g in m.collision_pairs] == [
        (1, t, 1) for t in (2, 3, 4, 5, 6)]
    assert m.nxn_candidates == jm.nxn_candidates == 5 * hf.NCONH
    assert all(p >= 0 for _, _, g in m.collision_pairs
               for _, _, p in g) == bool(pairs)


@pytest.mark.parametrize('case', ['hfield_mesh', 'hfield_mesh_pair',
                                  'plane_hfield_pair'])
def test_gate_refuses_other_hfield_pairs(case):
  assets, bodies, pairs = _TET, _MESH_BODY, ''
  if case == 'hfield_mesh_pair':
    bodies = _MESH_BODY.replace('contype="2" conaffinity="1"',
                                'contype="0" conaffinity="0"')
    pairs = '<contact><pair geom1="field" geom2="m"/></contact>'
  if case == 'plane_hfield_pair':
    assets, bodies = '', '<geom name="floor" type="plane" size="1 1 1"/>'
    pairs = '<contact><pair geom1="floor" geom2="field"/></contact>'
  mjm = mujoco.MjModel.from_xml_string(_GATE.format(
      assets=assets, bodies=bodies, pairs=pairs))
  key = r'\(0, 1\)' if case == 'plane_hfield_pair' else r'\(1, 7\)'
  with pytest.raises(NotImplementedError, match=key):
    mt.put_model(mjm, device='cpu')
  if case != 'hfield_mesh_pair':
    with pytest.raises(NotImplementedError):
      mjwt.put_model(mjm)
  # JAX `put_model` admits any <pair> with a height field (io.py:412)
  # and raises for this one when its collider runs
  # (`hfield_collider`); the port refuses it at `put_model`


def test_culls_never_takes_a_height_field_group():
  """The JAX driver's hfield branch runs before its cull
  (`collision_driver.py:218-238`): no group with a height field is
  culled, however many pairs it holds."""
  for t2 in (GeomType.SPHERE, GeomType.CAPSULE, GeomType.BOX):
    for n in (64, 65, 2048, 2049, 100_000):
      assert not collision_driver.culls(GeomType.HFIELD, t2, n)
  assert collision_driver.culls(GeomType.CAPSULE, GeomType.CAPSULE, 2049)
  assert io.pair_slots(GeomType.HFIELD, GeomType.CYLINDER, None) == 4
