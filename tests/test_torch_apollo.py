"""apptronik_apollo_flat (the benchmark suite's
`apptronik_apollo/scene_flat.xml`: nv 25, a free joint and 19 limited
hinges with dof friction loss, position actuators, Euler with eulerdamp
disabled, four IMU sensors on one site, plane-capsule, plane-box,
capsule-capsule, capsule-box and box-box pairs) through the port's plain
path on the CPU, against the JAX package and C MuJoCo.

* The model, its pair list and efc layout (JAX's at nconmax 16 and 48),
  and the glue list's stages, sensors included.
* capsule_box and box_box (`collision_primitive`, `collision_box`) on
  seeded poses against the JAX colliders (dist 1e-6; capsule-box points
  and frames at the JAX tests' 2e-3, since its refinement picks one of
  two grid points 1.2e-4 apart in the segment where float rounding
  differs; box-box at 1e-5), and two-body scenes against C MuJoCo
  (`tests/test_box_box.py::_match_contacts`; the deepest capsule-box
  contact at 2e-3, as `tests/test_collision.py`).
* The pair margin and gap rule (C MuJoCo's, as mujoco 3.10 applies it:
  the sums, a contact found below margin + gap and included below the
  margin, where the JAX package takes the larger of each; ROADMAP §C,
  C5) against C MuJoCo's contacts, and the standing robot's 8 plane-box
  contacts.
* Kernel B2's plain rows against JAX `collision` + `make_constraint`
  (tests/test_torch_contact.py's tolerances), three glue steps against
  `jax.vmap(mujoco_warp_tpu.step)` (STEP_TOL; sensordata, cacc at 5e-5
  and cfrc_ext, cfrc_int at 5e-4, scale-relative), all on the model with
  geom_margin zeroed in the one MjModel both packages are built from,
  where the two margin rules agree.
* On the real model, mj_forward's sensordata (C_SENSOR_TOL: the
  accelerometer reads the float32 solve's qacc) with the gyro past its
  cutoff in one world, and one step against mj_step (C_TOL).
* One RK4 step (the unfused list) on the zero-margin model against the
  JAX package's batched RK4 step, sensordata included.

The JAX functions are jitted once per module (`jax_apollo`).
"""

import importlib
import types as pytypes

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import collision_box as jbox
from mujoco_warp_tpu import collision_primitive as jprim
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import (collision_box, collision_driver,
                                   collision_primitive, forward, io, models,
                                   smooth)
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch.types import GeomType, IntegratorType

from test_box_box import _match_contacts
from test_collision import _pair_xml
from test_torch_contact import _assert_matches_jax
from test_torch_equality import _port_rows, jax_rows
from test_torch_forward import _jax_batch
from test_torch_implicit import C_TOL
from test_torch_step import STEP_TOL
from torch_parity import assert_close

jforward = importlib.import_module('mujoco_warp_tpu.forward')

NWORLD = 4
# the accelerometer against C MuJoCo's double-precision solve
C_SENSOR_TOL = 2e-3
# a float32 Newton solve's qacc against C MuJoCo's, scale-relative
C_QACC_TOL = 1e-5
PAIRS = [(0, 3, 14), (0, 6, 4), (3, 3, 71), (3, 6, 48), (6, 6, 6)]
CB, BB = (GeomType.CAPSULE, GeomType.BOX), (GeomType.BOX, GeomType.BOX)
# capsule-box points, frames and their rows against the JAX package: the
# JAX tests' 2e-3 (tests/test_collision.py); the refinement of the
# closest segment point settles on one of two neighbouring grid points
# where float rounding differs
CB_TOL = 2e-3


def _mjm(zero_margin=False):
  mjm = mujoco.MjModel.from_xml_path(models.APOLLO)
  if zero_margin:
    mjm.geom_margin[:] = 0
  return mjm


@pytest.fixture(scope='module')
def apollo():
  mjm = _mjm()
  return mjm, mt.put_model(mjm, device='cpu')


@pytest.fixture(scope='module')
def jax_apollo():
  """The zero-margin model in both packages, the JAX rows (jax_rows) and
  batched step, each jitted once for the module."""
  mjm = _mjm(zero_margin=True)
  jm = mjwt.put_model(mjm)
  return dict(mjm=mjm, jm=jm, m=mt.put_model(mjm, device='cpu'),
              rows=jax_rows(jm),
              step=jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd))))


def _pair_types(m, geom):
  """(W, C) the (type1, type2) of each filled pool slot; None if empty."""
  t = np.asarray(m.geom_type)
  g = np.asarray(geom)
  return [[(t[a], t[b]) if a >= 0 else None for a, b in row] for row in g]


def _rich(mjm, m, nworld, seed=0, want=(CB, BB), drop=0.2):
  """nworld (qpos, qvel) of contact-rich states, each with a contact of
  the pair types in `want` (round robin): from 512 seeded candidates,
  the joints drawn across their ranges, the base `drop` m lower, and the
  legs drawn together in every other candidate so that the soles (boxes)
  meet."""
  rng = np.random.default_rng(seed)
  n = 512
  q = np.tile(mjm.qpos0, (n, 1))
  for j in range(1, mjm.njnt):
    q[:, mjm.jnt_qposadr[j]] = rng.uniform(*mjm.jnt_range[j], n)
  q[:, 2] -= drop
  legs = np.arange(n) % 2 == 0
  for adr, lo, hi in ((15, -0.218, -0.05), (21, 0.05, 0.218), (17, 0, .3),
                      (23, 0, 0.3), (16, -0.3, 0.3), (22, -0.3, 0.3)):
    q[legs, adr] = rng.uniform(lo, hi, legs.sum())
  q = q.astype(np.float32)
  v = rng.normal(0, 0.2, (n, mjm.nv)).astype(np.float32)
  sm = smooth.smooth(m, torch.tensor(q), torch.tensor(v))
  con = collision_driver.collision(m, sm['geom_xpos'], sm['geom_xmat'], 48)
  kinds = _pair_types(m, con['geom'])
  picked = []
  for k in range(nworld):
    kind = want[k % len(want)]
    picked.append(next(w for w in range(n) if w not in picked and
                       kind in kinds[w]))
  return q[picked], v[picked]


def _standing(mjm, nworld, nstep=40, seed=0):
  """(qpos, qvel) of C MuJoCo rollouts from qpos0 with N(0, 0.01^2)
  noise on the hinges: the robot standing, its soles on the floor."""
  rng = np.random.default_rng(seed)
  qs, vs = [], []
  for _ in range(nworld):
    d = mujoco.MjData(mjm)
    d.qpos[7:] += rng.normal(0, 0.01, mjm.nq - 7)
    for _ in range(nstep):
      mujoco.mj_step(mjm, d)
    qs.append(d.qpos.copy())
    vs.append(d.qvel.copy())
  return np.asarray(qs, np.float32), np.asarray(vs, np.float32)


def _six(mjm, m, drop):
  """(qpos, qvel, ctrl holding qpos0's pose) of two standing and four
  contact-rich states (two with capsule-box, two with box-box contacts;
  the base `drop` m lower): the rows' and the glue steps' worlds, six so
  that the JAX step compiles once."""
  qs, vs = _standing(mjm, 2)
  qr, vr = _rich(mjm, m, 4, drop=drop)
  q, v = np.concatenate([qs, qr]), np.concatenate([vs, vr])
  return q, v, np.tile(mjm.qpos0[7:], (6, 1)).astype(np.float32)


def test_apollo_model_and_layout(apollo, jax_apollo):
  mjm, m = apollo
  assert (m.nq, m.nv, m.nu, m.nbody, m.ngeom, m.nsite) == (26, 25, 19, 37,
                                                           19, 9)
  assert (m.ncam, m.nlight, m.nsensor, m.nsensordata) == (3, 3, 4, 13)
  assert [(t1, t2, len(gl)) for t1, t2, gl in m.collision_pairs] == PAIRS
  assert m.nxn_candidates == 14 * 2 + 4 * 4 + 71 + 48 * 2 + 6 * 8
  jm = jax_apollo['jm']
  for nconmax in (16, 48):
    assert mt.efc_layout(m, nconmax) == mjwt.io.efc_layout(jm, nconmax)
  assert mt.efc_layout(m, 16) == (0, 19, 19, 4, 102)
  assert kc.entry(m) == 'box_'
  loaded = io.load_model(models.APOLLO_NPZ, device='cpu')
  assert forward.glue_mode(loaded) == 0
  d = mt.make_data(loaded, nconmax=16, nworld=3)
  assert d.sensordata.shape == (3, 13) and d.cfrc_int.shape == (3, 37, 6)
  assert [n for n, _ in forward.batched_stages(loaded, d)] == [
      'smooth_mega[cuda]', 'camlight', 'contact_efc_mega[cuda]',
      'act_len_vel', 'sensor_pos', 'sensor_vel', 'solve_glue[cuda]',
      'sensor_acc', 'advance']
  assert forward.replays(loaded, d)
  names = [n for n, _ in forward.forward_stages(loaded, d)]
  assert names.index('sensor_pos') == names.index('transmission') + 1
  assert names.index('sensor_vel') == names.index('passive') + 1
  assert names[-1] == 'sensor_acc'


def _poses(n, seed):
  """n seeded pose pairs (pos, mat, size of both geoms): random frames
  with a gap drawn around contact, the first eighth face-aligned, the
  second eighth in one frame rotated 45 degrees about two axes (edge
  against edge), and the third eighth apart by less than 0.005."""
  from scipy.spatial.transform import Rotation
  rng = np.random.default_rng(seed)
  p1 = rng.normal(0, 0.1, (n, 3))
  m1 = Rotation.random(n, random_state=seed).as_matrix()
  m2 = Rotation.random(n, random_state=seed + 1).as_matrix()
  s1 = rng.uniform(0.03, 0.15, (n, 3))
  s2 = rng.uniform(0.05, 0.2, (n, 3))
  p2 = p1 + rng.normal(0, 0.15, (n, 3))
  e = n // 8
  m1[:e] = m2[:e] = np.eye(3)
  m1[e:2 * e] = np.eye(3)
  m2[e:2 * e] = Rotation.from_euler('xz', [45, 45], degrees=True
                                    ).as_matrix()
  # boxes apart along z by a gap in (0, 0.005)
  gap = rng.uniform(0.0, 0.005, e)
  sep = slice(2 * e, 3 * e)
  m1[sep] = m2[sep] = np.eye(3)
  p2[sep, :2] = p1[sep, :2] + rng.uniform(-0.02, 0.02, (e, 2))
  p2[sep, 2] = p1[sep, 2] + s1[sep, 2] + s2[sep, 2] + gap
  f = lambda x: x.astype(np.float32)
  return tuple(map(f, (p1, m1, s1, p2, m2, s2)))


@pytest.mark.parametrize('pair', ['capsule_box', 'box_box'])
def test_colliders_match_jax(pair):
  """64 seeded poses (`_poses`); box-box with margins in [0, 0.01), so
  that boxes apart by less than the margin collide."""
  args = _poses(64, seed=7)
  margin = np.random.default_rng(8).uniform(0, 0.01, 64).astype(np.float32)
  if pair == 'capsule_box':
    ref = jax.jit(jax.vmap(jprim.capsule_box))(*map(jnp.asarray, args))
    out = collision_primitive.capsule_box(*map(torch.tensor, args))
    tols = (1e-6, 2e-3, 2e-3)
  else:
    ref = jax.jit(jax.vmap(jbox.box_box))(*map(jnp.asarray, args),
                                          jnp.asarray(margin))
    out = collision_box.box_box(*map(torch.tensor, args),
                                torch.tensor(margin))
    tols = (1e-6, 1e-5, 1e-5)
  dist = np.asarray(ref[0])
  hit = dist < 1e9
  assert (hit & (dist < 0)).any() and (hit & (dist > 0)).any()
  np.testing.assert_array_equal(out[0].numpy() < 1e9, hit)
  for a, b, name, tol in zip(out, ref, ('dist', 'pos', 'frame'), tols):
    a, b = a.numpy(), np.asarray(b)
    np.testing.assert_allclose(a[hit], b[hit], rtol=0, atol=tol,
                               err_msg=f'{pair} {name}')
  if pair == 'box_box':
    # some poses separate along an edge-edge axis, and the boxes apart
    # by less than their margin collide
    pos21 = torch.einsum('wji,wj->wi', torch.tensor(args[1]),
                         torch.tensor(args[3] - args[0]))
    pos12 = torch.einsum('wji,wj->wi', torch.tensor(args[4]),
                         torch.tensor(args[0] - args[3]))
    rot21 = torch.einsum('wki,wkj->wij', torch.tensor(args[1]),
                         torch.tensor(args[4]))
    code = collision_box._sat(pos21, pos12, rot21, rot21.abs(),
                              torch.tensor(args[2]), torch.tensor(args[5]),
                              torch.tensor(margin))[1]
    assert (code >= 12).any() and (code < 12).any()
    assert (hit[16:24] & (dist[16:24] > 0)).any()


_C_SCENES = {
    'capsule_box_face': ('type="box" size="0.2 0.2 0.1" pos="0 0 0.1"',
                         'type="capsule" size="0.05 0.12" mass="1"',
                         '0 0 0.24', '0 90 0'),
    'capsule_box_end': ('type="box" size="0.2 0.2 0.1" pos="0 0 0.1"',
                        'type="capsule" size="0.05 0.12" mass="1"',
                        '0.1 0.05 0.3', '20 0 0'),
    'box_box_face': ('type="box" size="0.12 0.1 0.08" pos="0 0 0.1"',
                     'type="box" size="0.1 0.09 0.07" mass="1"',
                     '0.01 0.02 0.249', '0 0 0'),
    'box_box_tilt': ('type="box" size="0.12 0.1 0.08" pos="0 0 0.1"',
                     'type="box" size="0.1 0.09 0.07" mass="1"',
                     '0.02 -0.01 0.24', '8 6 30'),
    'box_box_edge': ('type="box" size="0.12 0.1 0.08" pos="0 0 0.1"',
                     'type="box" size="0.1 0.09 0.07" mass="1"',
                     '0 0 0.31', '45 0 45'),
}


@pytest.mark.parametrize('scene', sorted(_C_SCENES))
def test_two_body_scenes_match_c_mujoco(scene):
  """The port's collision of a fixed geom and a free one against C
  MuJoCo's contacts (box-box: every C contact matched by position and
  depth; capsule-box: the deepest depth)."""
  mjm = mujoco.MjModel.from_xml_string(_pair_xml(*_C_SCENES[scene]))
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  assert mjd.ncon > 0
  m = mt.put_model(mjm, device='cpu')
  sm = smooth.smooth(m, torch.tensor(mjd.qpos[None], dtype=torch.float32),
                     torch.zeros(1, m.nv))
  con = collision_driver.collision(m, sm['geom_xpos'], sm['geom_xmat'], 8)
  dist = con['dist'][0].numpy()
  if scene.startswith('box_box'):
    d = pytypes.SimpleNamespace(contact=pytypes.SimpleNamespace(
        dist=dist, pos=con['pos'][0].numpy()))
    _match_contacts(mjm, mjd, d)
  else:
    np.testing.assert_allclose(dist.min(), mjd.contact.dist.min(),
                               atol=2e-3)


_MARGINS = """<mujoco><worldbody>
  <geom type="plane" size="2 2 .1" margin="0.02" gap="0.015"/>
  <body pos="0 0 {z}"><freejoint/>
    <geom type="box" size=".1 .1 .1" margin="0.01" gap="0.004"/></body>
  <body pos="1 0 0.07" euler="0 90 0"><freejoint/>
    <geom type="capsule" size=".05 .1" margin="0.005" gap="0.0"/></body>
  </worldbody></mujoco>"""


@pytest.mark.parametrize('z', [0.125, 0.135, 0.145])
def test_pair_margin_and_gap_follow_c_mujoco(z):
  """C5, as mujoco 3.10 does it: a pair's margin and gap are the sums of
  the geoms' (C mj_contactParam), a contact is found below margin + gap
  and included (active rows) below the margin, its includemargin. A box
  over a plane at dist 0.025 (included: margin 0.03), 0.035 and 0.045
  (in the gap, 0.019), and a capsule at dist 0.02 (margin 0.025): C
  MuJoCo's contacts, dist, includemargin and count of efc rows."""
  mjm = mujoco.MjModel.from_xml_string(_MARGINS.format(z=z))
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  m = mt.put_model(mjm, device='cpu')
  q = torch.tensor(mjd.qpos[None], dtype=torch.float32)
  out = _port_rows(m, q.numpy(), np.zeros((1, m.nv), np.float32),
                   np.zeros((1, 0), bool), 16)
  n = int(out['ncon'][0])
  assert n == mjd.ncon == 6
  ours = sorted(zip(out['geom'][0, :n].tolist(),
                    out['dist'][0, :n].tolist(),
                    out['includemargin'][0, :n].tolist()))
  ref = sorted(zip(mjd.contact.geom.tolist(), mjd.contact.dist.tolist(),
                   mjd.contact.includemargin.tolist()))
  for (g, dist, inc), (g_r, dist_r, inc_r) in zip(ours, ref):
    assert g == g_r
    assert abs(dist - dist_r) < 1e-6 and abs(inc - inc_r) < 1e-7
  assert int(out['efc_active'].sum()) == mjd.nefc == (24 if z < 0.13
                                                      else 8)


def test_standing_apollo_has_c_mujocos_contacts(apollo):
  """The robot standing on the floor (a C MuJoCo rollout of 200 steps
  from qpos0): 8 plane-box contacts at the soles, within margin 0.001
  (the sum of 0.0005 and 0.0005), as C MuJoCo finds them."""
  mjm, m = apollo
  mjd = mujoco.MjData(mjm)
  for _ in range(200):
    mujoco.mj_step(mjm, mjd)
  mujoco.mj_forward(mjm, mjd)
  assert mjd.ncon == 8
  sm = smooth.smooth(m, torch.tensor(mjd.qpos[None], dtype=torch.float32),
                     torch.tensor(mjd.qvel[None], dtype=torch.float32))
  con = collision_driver.collision(m, sm['geom_xpos'], sm['geom_xmat'], 16)
  assert int(con['ncon'][0]) == 8
  np.testing.assert_allclose(con['includemargin'][0, :8].numpy(), 0.001,
                             rtol=1e-6)
  np.testing.assert_allclose(np.sort(con['dist'][0, :8].numpy()),
                             np.sort(mjd.contact.dist), atol=2e-5)


def _assert_rows_match(m, out, ref):
  """out (kc.plain) against the JAX rows: the capsule-box contacts' point
  and frame, and their rows' Jacobian, velocity and aref, at CB_TOL; then
  everything at test_torch_contact's tolerances, those entries set to
  the reference's."""
  S = mt.efc_layout(m, 0)[3]
  cb = np.asarray([[k == CB for k in row]
                   for row in _pair_types(m, out['geom'])])
  rows = np.zeros(out['efc_type'].shape, bool)
  for w, c in zip(*np.nonzero(cb)):
    adr = int(out['efc_address'][w, c])
    rows[w, adr:adr + S] = True
  out = dict(out)
  for field, mask, src in (('pos', cb, ref.contact),
                           ('frame', cb, ref.contact),
                           ('efc_J', rows, ref), ('efc_vel', rows, ref),
                           ('efc_aref', rows, ref)):
    a = out[field].numpy().copy()
    b = np.asarray(getattr(src, field))
    if field == 'efc_J':
      b = b * np.asarray(ref.efc_active)[..., None]
    assert_close(a[mask], b[mask], f'capsule-box {field}', CB_TOL)
    a[mask] = b[mask]
    out[field] = torch.tensor(a)
  _assert_matches_jax(out, ref)


@pytest.mark.parametrize('nconmax', [16, 48])
def test_apollo_rows_match_jax(jax_apollo, nconmax):
  """Two standing states and four contact-rich ones (two with
  capsule-box, two with box-box contacts) of the zero-margin model; the
  capsule-box contacts as `_assert_rows_match` says."""
  mjm, jm, m = jax_apollo['mjm'], jax_apollo['jm'], jax_apollo['m']
  q, v, c = _six(mjm, m, drop=0.2)
  eq = np.zeros((6, 0), bool)
  if nconmax == 16:       # the JAX step's rows, of the state it starts from
    ref = jax_apollo['step'](_jax_batch(jm, q, v, c, nconmax=16))
  else:
    ref = jax_apollo['rows'](q, v, eq, nconmax)
  out = _port_rows(m, q, v, eq, nconmax)
  _assert_rows_match(m, out, ref)
  kinds = _pair_types(m, out['geom'])
  assert any(CB in k for k in kinds) and any(BB in k for k in kinds)
  assert (out['nf'].numpy() == 19).all()


def _off(a, b, tol):
  """(W,) whether world w of a misses b by more than tol * max(1, max |b|)
  (assert_close's scale, over the whole batch)."""
  a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
  scale = max(1.0, float(np.abs(b).max()))
  return (np.abs(a - b) > tol * scale).reshape(a.shape[0], -1).any(1)


def test_apollo_glue_steps_match_jax(jax_apollo):
  """Three glue steps (B1, camlight, B2, the sensors, B3 in mode 0: the
  plain versions; the advance after sensor_acc) against
  jax.vmap(mujoco_warp_tpu.step) at the suite's nconmax 16, each from
  the JAX package's state (qpos, qvel, qacc_warmstart, time), on the
  states of `_six` with the base not lowered: the state, sensordata and
  rne_postconstraint's cacc, cfrc_ext and cfrc_int at STEP_TOL and the
  tolerances above. A world that misses them must be one where the JAX
  solve stopped in fewer iterations (its linesearch polish, ROADMAP §C)
  and the port's qacc lies nearer C MuJoCo's mj_forward, within
  C_QACC_TOL of it; at most one such world a step."""
  mjm, jm, m = jax_apollo['mjm'], jax_apollo['jm'], jax_apollo['m']
  q, v, c = _six(mjm, m, drop=0.0)
  br = _jax_batch(jm, q, v, c, nconmax=16)
  tols = STEP_TOL + (('sensordata', 5e-5), ('cacc', 5e-5),
                     ('cfrc_ext', 5e-4), ('cfrc_int', 5e-4))
  ncon = 0
  for _ in range(3):
    d = mt.data_from_numpy(m, dict(
        qpos=np.array(br.qpos), qvel=np.array(br.qvel), ctrl=c,
        qacc_warmstart=np.array(br.qacc_warmstart),
        time=np.array(br.time)), nconmax=16)
    new = jax_apollo['step'](br)
    out = mt.step_batched(m, d)
    off = np.zeros(6, bool)
    for name, tol in tols:
      off |= _off(getattr(out, name).numpy(), getattr(new, name), tol)
    assert off.sum() <= 1, off
    for w in np.nonzero(off)[0]:
      assert int(new.solver_niter[w]) < int(out.solver_niter[w])
      cd = mujoco.MjData(mjm)
      cd.qpos[:], cd.qvel[:], cd.ctrl[:] = (np.asarray(br.qpos[w]),
                                            np.asarray(br.qvel[w]), c[w])
      mujoco.mj_forward(mjm, cd)
      err = np.abs(out.qacc[w].numpy() - cd.qacc).max()
      assert err < np.abs(np.asarray(new.qacc[w]) - cd.qacc).max()
      assert err < C_QACC_TOL * max(1.0, np.abs(cd.qacc).max())
    keep = ~off
    for name, tol in tols:
      assert_close(getattr(out, name).numpy()[keep],
                   np.asarray(getattr(new, name))[keep], name, tol)
    ncon += int(out.ncon.sum())
    br = new
  assert ncon >= 24


def _c_forward(mjm, q, v, c):
  out = [[], [], []]
  for w in range(q.shape[0]):
    cd = mujoco.MjData(mjm)
    cd.qpos[:], cd.qvel[:], cd.ctrl[:] = q[w], v[w], c[w]
    mujoco.mj_forward(mjm, cd)
    out[0].append(cd.sensordata.copy())
    mujoco.mj_step(mjm, cd)
    out[1].append(cd.qpos.copy())
    out[2].append(cd.qvel.copy())
  return [np.asarray(x) for x in out]


def test_apollo_sensors_and_step_match_c_mujoco(apollo):
  """mj_forward's sensordata (all four sensors) and one mj_step from
  four standing states of the real model (margin 0.0005 on every geom),
  the base spun past the gyro's cutoff (54.9 rad/s) in world 1: the
  port's forward_batched and glue step."""
  mjm, m = apollo
  q, v = _standing(mjm, NWORLD, nstep=100, seed=2)
  v[1, 3:6] = (80.0, -60.0, 5.0)
  c = np.tile(mjm.qpos0[7:], (NWORLD, 1)).astype(np.float32)
  sd, cq, cv = _c_forward(mjm, q, v, c)
  assert np.abs(sd[1, 4:7]).max() == pytest.approx(54.9)
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=16)
  f = mt.forward_batched(m, d)
  assert_close(f.sensordata.numpy(), sd, 'sensordata', C_SENSOR_TOL)
  for k, name in ((slice(0, 4), 'framequat'), (slice(4, 7), 'gyro'),
                  (slice(10, 13), 'magnetometer')):
    assert_close(f.sensordata.numpy()[:, k], sd[:, k], name, 1e-5)
  out = mt.step_batched(m, d)
  # the glue step's sensors read the state before its advance; only the
  # accelerometer reads its solve (B3's plain version, not B4's)
  assert_close(out.sensordata.numpy(), sd, 'sensordata, step',
               C_SENSOR_TOL)
  np.testing.assert_array_equal(out.sensordata.numpy()[:, :7],
                                f.sensordata.numpy()[:, :7])
  assert_close(out.qpos.numpy(), cq, 'qpos', C_TOL['qpos'])
  assert_close(out.qvel.numpy(), cv, 'qvel', C_TOL['qvel'])


def test_apollo_rk4_step_fills_sensordata(jax_apollo, monkeypatch):
  """An RK4 override runs the unfused list (sensor stages after
  transmission, passive and the solve). One step against the JAX
  package's batched RK4 step (`forward_batched`, then `_rk4_batched`,
  as `mujoco_warp_tpu.step_batched` runs it) on the zero-margin model
  with RK4, from the states of `_six` with the base not lowered:
  sensordata (the last evaluation's, as the JAX step leaves it) at 5e-5
  and the state at STEP_TOL, scale-relative; a unit framequat and
  opt.magnetic (norm 0.5) in the site's frame. Each of the JAX step's
  four forward() evaluations is the module's compiled
  jax.vmap(mujoco_warp_tpu.step) on the Euler model with its advance
  undone: that step is forward() and then `_advance`, which sets only
  qpos, qvel, act, time and qacc_warmstart (with eulerdamp disabled its
  qacc is forward's, and forward() reads no integrator option), so
  nothing more compiles."""
  mjm, jm, m = jax_apollo['mjm'], jax_apollo['jm'], jax_apollo['m']
  rk4 = int(IntegratorType.RK4)
  m4 = m.replace(opt=m.opt.replace(integrator=rk4))
  q, v, c = _six(mjm, m, drop=0.0)
  d = mt.data_from_numpy(m4, dict(qpos=q, qvel=v, ctrl=c), nconmax=16)
  names = [n for n, _ in forward.batched_stages(m4, d)]
  assert names[-1] == 'rk4' and 'sensor_acc' in names
  out = mt.step_batched(m4, d)
  fwd = lambda dd: jax_apollo['step'](dd).replace(
      qpos=dd.qpos, qvel=dd.qvel, act=dd.act, time=dd.time,
      qacc_warmstart=dd.qacc_warmstart)
  monkeypatch.setattr(jforward, 'forward_batched', lambda m_, dd: fwd(dd))
  new = jforward._rk4_batched(
      jm.replace(opt=jm.opt.replace(integrator=rk4)),
      fwd(_jax_batch(jm, q, v, c, nconmax=16)))
  monkeypatch.undo()
  for name, tol in STEP_TOL + (('sensordata', 5e-5),):
    assert_close(getattr(out, name).numpy(), np.asarray(getattr(new, name)),
                 name, tol)
  sd = out.sensordata.numpy()
  assert np.isfinite(sd).all() and (np.abs(sd) > 0).any(1).all()
  np.testing.assert_allclose(np.linalg.norm(sd[:, :4], axis=1), 1, atol=1e-5)
  np.testing.assert_allclose(np.linalg.norm(sd[:, 10:13], axis=1), 0.5,
                             atol=1e-5)
  assert not np.array_equal(sd, d.sensordata.numpy())
