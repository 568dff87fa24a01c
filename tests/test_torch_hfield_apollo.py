"""apptronik_apollo_hfield (`benchmarks/scenes/apptronik_apollo/
scene_hfield.xml`, the suite's `config.txt:17` row: apollo's robot on a
588 x 1,121 height field) against the JAX package, on the CPU.

* The Model: the committed `.npz` equals `put_model`; the groups
  (hfield-capsule 14, hfield-box 4, capsule-capsule 71, capsule-box 48,
  box-box 6), 287 candidate slots, the normalized heights and the size
  equal JAX `put_model`'s.
* The stage list: `kernels.contact.supports` refuses the model (height
  field pairs), so the glue list runs the static driver's `collision`
  and `make_constraint` between B1 and B3 (mode 0), replayed; no group
  is culled, the height field groups have 4 slots a pair.
* One JAX step of jax.vmap(step) at 2 worlds (compiled once in the run,
  `torch_parity.shared`), on the model with geom_margin zeroed in the
  one MjModel both packages are built from (the port's pair margin is
  the sum of the geoms', JAX's the larger: they agree at 0, ROADMAP §C,
  C5): world 0 is keyframe 0 after one C MuJoCo step (the soles on the
  terrain), world 1 a contact-rich state (`_rich`: the joints drawn
  across their ranges, the base 0.2 m lower: shins and knees in the
  terrain). The port's `collision` on the JAX step's geom frames gives
  the JAX pool: ncon, ncollision, geom ids and order exactly; dist,
  frame and the other fields at 5e-5; pos at 5e-5 along the normal (MPR's
  witness moves along a face, tests/test_torch_convex.py). One port step
  against the JAX step by tests/test_torch_aloha.py's rules (rows at
  ROW_TOL, the solve by its objective, qacc and the accelerometer, which
  reads it, at QACC_TOL, qvel and qpos at h times qacc's and qvel's, the
  other sensors at 5e-5). The step's own pool, on its own
  kinematics, may place a sole's contact elsewhere on its flat face than
  JAX's (measured: one contact of world 1, 7.9 mm along the face, its
  dist and frame within 5e-5): such contacts must be hfield-box, at
  most 2, with dist, frame and the point along the normal at 5e-5; their
  worlds' rows and solve are then held on a second step whose pool takes
  the JAX pool's points (every world at the tolerances above).
"""

import mujoco
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import collision_driver, forward, io, models, smooth
from mujoco_warp_tpu_torch import solver
from mujoco_warp_tpu_torch.io import efc_layout
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch.types import GeomType, SensorType

from test_torch_aloha import OBJ_UNITS, QACC_TOL, ROW_TOL, TOL
from test_torch_step import STEP_TOL
from torch_parity import assert_close, shared

NCONMAX = 32
GROUPS = [(1, 3, 14), (1, 6, 4), (3, 3, 71), (3, 6, 48), (6, 6, 6)]
STAGES = ['smooth_mega[cuda]', 'camlight', 'collision', 'make_constraint',
          'act_len_vel', 'sensor_pos', 'sensor_vel', 'solve_glue[cuda]',
          'sensor_acc', 'advance']


def _mjm(zero_margin=False):
  mjm = mujoco.MjModel.from_xml_path(models.APOLLO_HFIELD)
  if zero_margin:
    mjm.geom_margin[:] = 0
  return mjm


@pytest.fixture(scope='module')
def apollo_hfield():
  mjm = _mjm()
  return mjm, mt.put_model(mjm, device='cpu')


def _rich(mjm, m, seed=0):
  """qpos (nq,) float32 of a contact-rich state with hfield-capsule and
  hfield-box contacts: of 64 seeded candidates from qpos0 (the joints
  drawn across their ranges, the base 0.2 m lower), the first with both,
  by the port's collision on its kinematics."""
  rng = np.random.default_rng(seed)
  n = 64
  q = np.tile(mjm.qpos0, (n, 1))
  for j in range(1, mjm.njnt):
    q[:, mjm.jnt_qposadr[j]] = rng.uniform(*mjm.jnt_range[j], n)
  q[:, 2] -= 0.2
  q = q.astype(np.float32)
  sm = smooth.smooth(m, torch.tensor(q), torch.zeros(n, mjm.nv))
  con = collision_driver.collision(m, sm['geom_xpos'], sm['geom_xmat'],
                                   NCONMAX)
  t = np.asarray(m.geom_type)
  g = con['geom'].numpy()
  live = g[..., 0] >= 0
  kinds = [{(t[a], t[b]) for a, b in g[w][live[w]]} for w in range(n)]
  w = next(w for w in range(n) if {(1, 3), (1, 6)} <= kinds[w])
  return q[w]


def _states(mjm, m):
  """(qpos, qvel, ctrl, qacc_warmstart) float32 of the two worlds."""
  d = mujoco.MjData(mjm)
  mujoco.mj_resetDataKeyframe(mjm, d, 0)
  mujoco.mj_step(mjm, d)
  q = np.stack([d.qpos, _rich(mjm, m)]).astype(np.float32)
  v = np.stack([d.qvel, 0.2 * np.random.default_rng(1).standard_normal(
      mjm.nv)]).astype(np.float32)
  c = np.tile(d.ctrl, (2, 1)).astype(np.float32)
  w = np.stack([d.qacc_warmstart, np.zeros(mjm.nv)]).astype(np.float32)
  return dict(qpos=q, qvel=v, ctrl=c, qacc_warmstart=w)


_REFERENCE = {}


def _jax_reference():
  """The JAX Model's fields the tests read and one JAX step of the
  zero-margin model from `_states` at 2 worlds, as numpy (computed once
  a run, `torch_parity.shared`, and kept by the process)."""
  if _REFERENCE:
    return _REFERENCE['value']

  def make():
    mjm = _mjm(zero_margin=True)
    jm = mjwt.put_model(mjm)
    fields = _states(mjm, mt.put_model(mjm, device='cpu'))
    jd = mjwt.make_data(jm, nconmax=NCONMAX)
    names = sorted(fields)
    batch = jax.vmap(lambda *a: jd.replace(**dict(zip(names, a))))(
        *[jnp.asarray(fields[k]) for k in names])
    out = jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd)))(batch)
    model = dict(collision_pairs=jm.collision_pairs,
                 nxn_candidates=jm.nxn_candidates,
                 hfield_data=np.asarray(jm.hfield_data),
                 hfield_size=np.asarray(jm.hfield_size),
                 nrow=jm.hfield_nrow, ncol=jm.hfield_ncol,
                 layout=mjwt.io.efc_layout(jm, NCONMAX))
    return dict(model=model, fields=fields,
                out=jax.tree.map(np.asarray, out))
  _REFERENCE['value'] = shared('apollo_hfield', make)
  return _REFERENCE['value']


def test_apollo_hfield_npz_matches_put_model(apollo_hfield):
  _, m = apollo_hfield
  loaded = io.load_model(models.APOLLO_HFIELD_NPZ, device='cpu')
  a, sa = io.model_to_numpy(m)
  b, sb = io.model_to_numpy(loaded)
  assert sa == sb
  assert sorted(a) == sorted(b)
  for k in a:
    np.testing.assert_array_equal(a[k], b[k], k)
  assert (m.nhfield, m.hfield_nrow, m.hfield_ncol) == (1, (588,), (1121,))
  assert tuple(m.hfield_data.shape) == (1, 588, 1121)


def test_apollo_hfield_takes_the_collision_stage(apollo_hfield):
  _, m = apollo_hfield
  d = mt.make_data(m, nconmax=NCONMAX, nworld=2)
  assert [(a, b, len(g)) for a, b, g in m.collision_pairs] == GROUPS
  assert m.nxn_candidates == 14 * 4 + 4 * 4 + 71 + 48 * 2 + 6 * 8 == 287
  assert not m.sap_families and not kc.supports(m, NCONMAX)
  assert [n for n, _ in forward.batched_stages(m, d)] == STAGES
  assert forward.replays(m, d) and forward.glue_mode(m) == 0
  assert not any(collision_driver.culls(a, b, len(g))
                 for a, b, g in m.collision_pairs)
  slots = [grp['slots'] for grp in collision_driver._group_tables(m)]
  assert slots == [4, 4, 1, 2, 8]
  assert efc_layout(m, NCONMAX) == (0, 19, 19, 4, 166)


def test_apollo_hfield_collision_and_step_match_jax():
  ref = _jax_reference()
  m = mt.put_model(_mjm(zero_margin=True), device='cpu')
  jmodel, new, fields = ref['model'], ref['out'], ref['fields']
  assert m.collision_pairs == jmodel['collision_pairs']
  assert m.nxn_candidates == jmodel['nxn_candidates']
  np.testing.assert_array_equal(m.hfield_data.numpy(), jmodel['hfield_data'])
  np.testing.assert_array_equal(m.hfield_size.numpy(), jmodel['hfield_size'])
  assert (m.hfield_nrow, m.hfield_ncol) == (jmodel['nrow'], jmodel['ncol'])
  assert efc_layout(m, NCONMAX) == tuple(jmodel['layout'])
  gx, gm = torch.tensor(new.geom_xpos), torch.tensor(new.geom_xmat)

  # the pool
  con = collision_driver.collision(m, gx, gm, NCONMAX)
  for k in ('ncon', 'ncollision'):
    np.testing.assert_array_equal(con[k].numpy(), getattr(new, k), k)
  np.testing.assert_array_equal(con['geom'].numpy(), new.contact.geom)
  np.testing.assert_array_equal(con['dim'].numpy(), new.contact.dim)
  t = np.asarray(m.geom_type)
  live = new.contact.geom[..., 0] >= 0
  kinds = [{(t[a], t[b]) for a, b in new.contact.geom[w][live[w]]}
           for w in range(2)]
  assert (GeomType.HFIELD, GeomType.BOX) in kinds[0]
  assert {(GeomType.HFIELD, GeomType.CAPSULE),
          (GeomType.HFIELD, GeomType.BOX)} <= kinds[1]
  for k in ('dist', 'frame', 'includemargin', 'friction', 'solref',
            'solreffriction', 'solimp'):
    assert_close(con[k].numpy(), getattr(new.contact, k), k, TOL)
  dpos = con['pos'].numpy() - new.contact.pos
  assert_close((dpos * new.contact.frame[..., 0, :]).sum(-1),
               np.zeros(dpos.shape[:-1]), 'pos', TOL)

  # one step. MPR's witness on a flat face (a sole on the terrain's
  # prism) moves along the face with rounding: the step's own pool, on
  # its own kinematics (B1's plain version, rounding off JAX's), may put
  # such a contact elsewhere on the face, its dist and frame unchanged,
  # and the rows and the solve follow it (test_torch_convex.py). Those
  # worlds are held below on the JAX pool's points.
  d = mt.step_batched(m, mt.data_from_numpy(m, fields, nconmax=NCONMAX))
  np.testing.assert_array_equal(d.contact.geom.numpy(), new.contact.geom)
  scale = max(1.0, float(np.abs(new.contact.pos).max()))
  moved = np.abs(d.contact.pos.numpy() - new.contact.pos).max(-1) > (
      TOL * scale)
  kind = t[np.maximum(new.contact.geom, 0)]
  assert (kind[moved] == (GeomType.HFIELD, GeomType.BOX)).all()
  assert moved.sum() <= 2, moved.sum()
  dpos = d.contact.pos.numpy() - new.contact.pos
  assert_close((dpos * new.contact.frame[..., 0, :]).sum(-1),
               np.zeros(dpos.shape[:-1]), 'pos', TOL)
  for k in ('dist', 'frame'):
    assert_close(getattr(d.contact, k).numpy(), getattr(new.contact, k), k,
                 TOL)
  print(f'contacts whose witness moved along the face: {int(moved.sum())}')
  _hold_step(m, d, new, ~moved.any(1))

  # the same step with the pool's points set to the JAX pool's: every
  # world
  jpos = torch.tensor(new.contact.pos)
  collide = collision_driver.collision

  def with_jax_points(*args):
    con = collide(*args)
    return dict(con, pos=torch.where(
        torch.tensor(moved)[..., None], jpos, con['pos']))
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(collision_driver, 'collision', with_jax_points)
    d = mt.step_batched(m, mt.data_from_numpy(m, fields, nconmax=NCONMAX))
  _hold_step(m, d, new, np.ones(2, bool))


def _hold_step(m, d, new, worlds):
  """One port step d against the JAX step new: the counts, everything
  before the solve and the rows in every world; efc_J, the solve, qacc,
  qvel, qpos and sensordata in `worlds`."""
  for k in ('ncon', 'ncollision', 'ne', 'nf', 'nl', 'nefc'):
    np.testing.assert_array_equal(getattr(d, k).numpy(), getattr(new, k), k)
  for name, tol in STEP_TOL:
    if name not in ('qpos', 'qvel', 'qacc', 'qfrc_constraint'):
      assert_close(getattr(d, name).numpy(), getattr(new, name), name, tol)
  np.testing.assert_array_equal(d.efc_active.numpy(), new.efc_active)
  w = np.nonzero(worlds)[0]
  assert_close(d.efc_J.numpy()[w], (new.efc_J * new.efc_active[..., None])[w],
               'efc_J', TOL)
  ne, nf, nl, _, _ = efc_layout(m, NCONMAX)
  base = ne + nf + nl
  for k in ('efc_D', 'efc_aref', 'efc_pos', 'efc_frictionloss'):
    a, b = getattr(d, k).numpy()[w], getattr(new, k)[w]
    assert_close(a[:, :base], b[:, :base], k, TOL)
    assert_close(a[:, base:], b[:, base:], k, ROW_TOL)
  x = [getattr(d, k).double()[w] for k in ('qM', 'efc_J', 'efc_D',
                                            'efc_aref', 'efc_frictionloss',
                                            'qfrc_smooth')]
  qsm = torch.linalg.solve(x[0], x[5])
  cost = [solver.objective(*x, qsm, qa.double()[w], ne, nf)
          for qa in (d.qacc, torch.tensor(new.qacc))]
  unit = float(m.opt.tolerance * m.stat.meaninertia * m.nv)
  assert (cost[0] <= cost[1] + OBJ_UNITS * unit).all(), (cost, unit)
  assert_close(d.qacc.numpy()[w], new.qacc[w], 'qacc', QACC_TOL)
  # qvel advances by h qacc and qpos by h qvel: h times qacc's and qvel's
  # tolerances (at qacc's scale, which the soles' stiff contacts raise)
  h = float(m.opt.timestep)
  dv = QACC_TOL * h * max(1.0, float(np.abs(new.qacc[w]).max()))
  np.testing.assert_allclose(d.qvel.numpy()[w], new.qvel[w], rtol=0, atol=dv)
  np.testing.assert_allclose(d.qpos.numpy()[w], new.qpos[w], rtol=0,
                             atol=max(5e-6 * float(np.abs(new.qpos).max()),
                                      h * dv))
  # the accelerometer reads qacc: at qacc's tolerance; the other sensors
  # at 5e-5
  for t, adr, dim in zip(m.sensor_type, m.sensor_adr, m.sensor_dim):
    tol = QACC_TOL if t == SensorType.ACCELEROMETER else 5e-5
    assert_close(d.sensordata.numpy()[w, adr:adr + dim],
                 new.sensordata[w, adr:adr + dim], f'sensor type {t}', tol)
