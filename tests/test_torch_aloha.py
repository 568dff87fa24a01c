"""aloha_pot (`benchmarks/scenes/aloha_pot/scene.xml`, the suite's
`config.txt:14` row) and the static driver's cull against the JAX
package, on the CPU.

* The Model: hulls (full and decimated), `geom_rbound`, `geom_dataid`
  and the pair groups equal the JAX package's `put_model` (exact); the
  keyframe names are the MJCF's, and the committed `.npz` holds them all.
* The stage list: B1, camlight, `collision`, `make_constraint`,
  act_len_vel and the glue solve (B3e: the elliptic cone), replayed.
* From the state 200 C MuJoCo steps after keyframe `lift_pot0` (and 250
  steps in the second world), one JAX step of jax.vmap(step) at 2
  worlds (compiled once, in that one test): the port's `collision` on the
  JAX step's geom frames gives the JAX pool (ncon, ncollision with the
  overlaps the cull dropped, geom ids and order exactly; dist, frame and
  the other fields at 5e-5; pos at 5e-5 along the normal), each culled
  group's kept pairs equal `jax.lax.top_k`'s; one port step against the
  JAX step: everything before the solve at the step tolerances
  (tests/test_torch_step.py), the contact rows' D, aref and pos at
  ROW_TOL (a contact's depth differs by float32 rounding between the two
  collision paths, and its impedance scales that by its stiffness past
  5e-5 of aref), the other rows at 5e-5, and the solve by its objective:
  the port's qacc costs at most OBJ_UNITS units of the stopping rule more
  than the JAX qacc on the port's rows (float64), and lies within
  QACC_TOL of scale of it (the two solves stop at their own tolerance:
  the JAX step on the CPU runs `_solve_xla` with its iterative
  linesearch, the port the glue kernel's; they part by more than 5e-5
  of scale here).
* `make_constraint` on this row mix (2 joint equalities, 5 friction-loss
  rows, 17 limits, elliptic contacts of condim 3 and 4 at impratio 10)
  against JAX `make_constraint` on the same kinematics and pool.
* A synthetic scene of 12 cube meshes on free bodies, their centers on a
  grid of 0.125 (every bounding sphere overlaps: 66 mesh-mesh pairs, past
  the cull's 64, K = 64 at nconmax 8, so 2 overlaps drop; the grid ties
  in distance): the kept pairs, valid flags and overlap counts equal
  `jax.lax.top_k`'s on the JAX driver's key; the port's narrowphase on
  them holds to the MPR rules of tests/test_torch_convex.py (the base
  contacts' hits and dist in every world, their normals and points where
  the cubes are turned at random); the port's
  pool of the JAX candidates equals the JAX pool exactly (ncollision with
  the drops, geom ids, order, values).
"""

import dataclasses

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import torch

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import collision_convex as jcc
from mujoco_warp_tpu import collision_driver as jcd
from mujoco_warp_tpu import collision_primitive as jcp
from mujoco_warp_tpu import constraint as jcon
from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu import math as jmath
from mujoco_warp_tpu import smooth as js
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import (collision_driver, constraint, forward, io,
                                   models, solver, types)
from mujoco_warp_tpu_torch.io import efc_layout

from test_convex import CUBE_MESH
from test_torch_step import STEP_TOL
from torch_parity import assert_close

TOL = 5e-5
NCONMAX = 24
# the solve: the port's objective at most OBJ_UNITS units of tolerance *
# meaninertia * nv above the JAX qacc's, qacc within QACC_TOL of scale
OBJ_UNITS = 1.0
QACC_TOL = 1e-3
ROW_TOL = 1e-3
GROUPS = [(0, 2, 12), (0, 7, 131), (2, 2, 54), (2, 6, 12), (2, 7, 1908),
          (6, 7, 131), (7, 7, 6906)]
STAGES = ['smooth_mega[cuda]', 'camlight', 'collision', 'make_constraint',
          'act_len_vel', 'solve_glue[cuda]']


def _mjm():
  return mujoco.MjModel.from_xml_path(models.ALOHA_POT)


def _states(mjm, nsteps=(200, 250)):
  """(qpos, qvel, ctrl, qacc_warmstart) float32 of C MuJoCo runs from
  keyframe lift_pot0, its ctrl held, one world per step count."""
  key = [k for k in range(mjm.nkey)
         if mjm.key(k).name.startswith('lift_pot')][0]
  rows = []
  for n in nsteps:
    d = mujoco.MjData(mjm)
    mujoco.mj_resetDataKeyframe(mjm, d, key)
    for _ in range(n):
      mujoco.mj_step(mjm, d)
    rows.append((d.qpos.copy(), d.qvel.copy(), d.ctrl.copy(),
                 d.qacc_warmstart.copy()))
  return [np.asarray(x, np.float32) for x in zip(*rows)]


def test_aloha_model_matches_jax():
  mjm = _mjm()
  jm, m = mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')
  for k in ('mesh_hullvert', 'mesh_hullvert_small', 'geom_rbound'):
    np.testing.assert_array_equal(getattr(m, k).numpy(),
                                  np.asarray(getattr(jm, k)), k)
  assert m.mesh_hullvert.shape == (134, 1159, 4)
  assert m.mesh_hullvert_small.shape == (134, io.HULL_SMALL, 4)
  np.testing.assert_array_equal(
      io._decimate_hulls(io._mesh_hulls(mjm)),
      jio._decimate_hulls(jio._mesh_hulls(mjm), 64))
  assert m.geom_dataid == jm.geom_dataid
  assert m.collision_pairs == jm.collision_pairs
  assert [(a, b, len(g)) for a, b, g in m.collision_pairs] == GROUPS
  assert m.nxn_candidates == 37695
  assert m.key_names == tuple(mjm.key(k).name for k in range(mjm.nkey))
  assert io.find_keys(m, 'lift_pot') == jio.find_keys(mjm, 'lift_pot') == \
      list(range(3, 11))
  np.testing.assert_array_equal(io.make_trajectory(m, range(3, 11)),
                                jio.make_trajectory(mjm, list(range(3, 11)))
                                .astype(np.float32))
  assert efc_layout(m, NCONMAX) == (2, 5, 17, 4, 120)
  # each group the JAX driver culls, and the pairs it keeps
  assert [collision_driver.culls(a, b, len(g))
          for a, b, g in m.collision_pairs] == [False] * 4 + [True] * 3
  assert collision_driver.cull_slots(NCONMAX, 6906) == 96
  loaded = io.load_model(models.ALOHA_POT_NPZ, device='cpu')
  for k in types.MODEL_STATICS:
    assert getattr(loaded, k) == getattr(m, k), k
  for k in types.MODEL_TENSORS:
    assert torch.equal(getattr(loaded, k), getattr(m, k)), k


def test_aloha_takes_the_static_collision_stage():
  m = io.load_model(models.ALOHA_POT_NPZ, device='cpu')
  d = mt.make_data(m, nconmax=NCONMAX, nworld=2)
  assert [n for n, _ in forward.batched_stages(m, d)] == STAGES
  # the dofs' damping with eulerdamp on: B3e in mode 1
  assert forward.replays(m, d) and forward.glue_mode(m) == 1
  assert solver.cone_inputs(m, d.contact) is not None       # B3e


def _jax_step(jm, fields):
  jd = mjwt.make_data(jm, nconmax=NCONMAX)
  names = sorted(fields)
  batch = jax.vmap(lambda *a: jd.replace(**dict(zip(names, a))))(
      *[jnp.asarray(fields[k]) for k in names])
  out = jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd)))(batch)
  return jax.tree.map(np.asarray, out)


def test_aloha_collision_and_step_match_jax():
  mjm = _mjm()
  m = mt.put_model(mjm, device='cpu')
  q, v, c, w = _states(mjm)
  fields = dict(qpos=q, qvel=v, ctrl=c, qacc_warmstart=w)
  new = _jax_step(mjwt.put_model(mjm), fields)
  gx, gm = torch.tensor(new.geom_xpos), torch.tensor(new.geom_xmat)

  # the pool
  con = collision_driver.collision(m, gx, gm, NCONMAX)
  for k in ('ncon', 'ncollision'):
    np.testing.assert_array_equal(con[k].numpy(), getattr(new, k), k)
  assert (new.ncollision > new.ncon + 400).all()   # the cull's drops
  np.testing.assert_array_equal(con['geom'].numpy(), new.contact.geom)
  np.testing.assert_array_equal(con['dim'].numpy(), new.contact.dim)
  for k in ('dist', 'frame', 'includemargin', 'friction', 'solref',
            'solreffriction', 'solimp'):
    assert_close(con[k].numpy(), getattr(new.contact, k), k, TOL)
  dpos = con['pos'].numpy() - new.contact.pos
  assert_close((dpos * new.contact.frame[..., 0, :]).sum(-1), np.zeros(dpos.shape[:-1]), 'pos', TOL)
  # each culled group's kept pairs: jax.lax.top_k of the JAX driver's key
  params = collision_driver.candidate_params(m)
  for grp in collision_driver._group_tables(m):
    if not grp['cull']:
      continue
    margin = params['margin'][grp['start']:grp['start'] + grp['n']]
    sel, valid, nover = collision_driver.cull(m, gx, grp, margin, 96)
    g1, g2 = grp['g1'].numpy(), grp['g2'].numpy()
    dvec = new.geom_xpos[:, g1] - new.geom_xpos[:, g2]
    d2 = jnp.sum(dvec * dvec, -1)
    rb = m.geom_rbound.numpy()       # equal to the JAX Model's (above)
    rsum = jnp.asarray(rb[g1] + rb[g2])                # margins 0 here
    overlap = d2 <= rsum * rsum
    jsel = np.asarray(jax.lax.top_k(jnp.where(overlap, -d2, -jnp.inf),
                                    96)[1])
    np.testing.assert_array_equal(sel.numpy(), jsel)
    np.testing.assert_array_equal(valid.numpy(),
                                  np.take_along_axis(np.asarray(overlap),
                                                     jsel, 1))
    np.testing.assert_array_equal(nover.numpy(), np.asarray(overlap).sum(1))

  # one step
  d = mt.step_batched(m, mt.data_from_numpy(m, fields, nconmax=NCONMAX))
  for k in ('ncon', 'ncollision', 'ne', 'nf', 'nl', 'nefc'):
    np.testing.assert_array_equal(getattr(d, k).numpy(), getattr(new, k), k)
  assert (d.ne.numpy() == 2).all() and (d.nf.numpy() == 5).all()
  for name, tol in STEP_TOL:
    if name not in ('qpos', 'qvel', 'qacc', 'qfrc_constraint'):
      assert_close(getattr(d, name).numpy(), getattr(new, name), name, tol)
  # rows that do not exist this step have zero J in the port
  np.testing.assert_array_equal(d.efc_active.numpy(), new.efc_active)
  assert_close(d.efc_J.numpy(), new.efc_J * new.efc_active[..., None],
               'efc_J', TOL)
  # a contact row's D and aref scale its depth's float32 difference
  # between the two collision paths by the impedance's stiffness (as the
  # humanoid's, tests/test_torch_elliptic_rows.py): those at ROW_TOL, the
  # rest at TOL; the rows on one pool are held in test_aloha_rows_match_jax
  base = sum(efc_layout(m, 0)[:3])
  for k in ('efc_D', 'efc_aref', 'efc_pos', 'efc_frictionloss'):
    a, b = getattr(d, k).numpy(), getattr(new, k)
    assert_close(a[:, :base], b[:, :base], k, TOL)
    assert_close(a[:, base:], b[:, base:], k, ROW_TOL)
  x = [getattr(d, k).double() for k in ('qM', 'efc_J', 'efc_D', 'efc_aref',
                                         'efc_frictionloss', 'qfrc_smooth')]
  cone = solver.cone_inputs(m, d.contact)
  K = solver.Cone(m, x[2], (cone[0].double(), cone[1], cone[2].double()))
  ne, nf, _, _, _ = efc_layout(m, 0)
  qsm = torch.linalg.solve(x[0], x[5])
  cost = [solver.objective(*x, qsm, qa.double(), ne, nf, cone=K)
          for qa in (d.qacc, torch.tensor(new.qacc))]
  unit = float(m.opt.tolerance * m.stat.meaninertia * m.nv)
  assert (cost[0] <= cost[1] + OBJ_UNITS * unit).all(), (cost, unit)
  assert_close(d.qacc.numpy(), new.qacc, 'qacc', QACC_TOL)
  assert_close(d.qvel.numpy(), new.qvel, 'qvel', QACC_TOL * 2e-3)
  assert_close(d.qpos.numpy(), new.qpos, 'qpos', 5e-6)


def test_aloha_rows_match_jax():
  """`make_constraint` against JAX `make_constraint` on JAX kinematics,
  with a pool of box-mesh contacts at condim 3 and gripper-pad contacts
  at condim 4 (geoms 56, 61, 86, 91), so that every row class stands in
  one batch: equalities, friction loss, limits, elliptic contacts."""
  mjm = _mjm()
  jm, m = mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')
  q, v, _, _ = _states(mjm)
  rng = np.random.default_rng(0)
  C = 8
  jd = mjwt.make_data(jm, nconmax=C)
  pads = [56, 61, 86, 91]
  geom = np.full((2, C, 2), -1, np.int32)
  dim = np.ones((2, C), np.int32)
  for w in range(2):
    for i in range(5):
      g1, cond = ((34, 3) if i < 3 else (pads[(i + w) % 4], 4))
      geom[w, i] = (g1, 177)
      dim[w, i] = cond
  ncon = np.full(2, 5, np.int32)
  dist = np.where(np.arange(C) < 5, -1e-3 * rng.random((2, C)), 1e10)
  frame = np.stack([np.asarray(jmath.make_frame(jnp.asarray(
      rng.standard_normal(3)))) for _ in range(2 * C)]).reshape(2, C, 3, 3)
  pos = 0.1 * rng.standard_normal((2, C, 3))
  friction = np.tile([1.0, 1.0, 0.005, 0.0001, 0.0001], (2, C, 1))
  pool = dict(dist=dist, pos=pos, frame=frame, friction=friction,
              includemargin=np.zeros((2, C)), dim=dim, geom=geom,
              solref=np.tile([0.02, 1.0], (2, C, 1)),
              solreffriction=np.zeros((2, C, 2)),
              solimp=np.tile([0.9, 0.95, 0.001, 0.5, 2.0], (2, C, 1)))
  pool = {k: np.asarray(x, np.int32 if x.dtype.kind == 'i' else np.float32)
          for k, x in pool.items()}

  def rows(qq, vv, p):
    dd = js.com_pos(jm, js.kinematics(jm, jd.replace(qpos=qq, qvel=vv)))
    dd = dd.replace(ncon=p.pop('ncon'),
                    contact=dd.contact.replace(**p))
    return jcon.make_constraint(jm, dd)
  ref = jax.jit(jax.vmap(rows))(jnp.asarray(q), jnp.asarray(v),
                                dict(pool, ncon=jnp.asarray(ncon)))
  ref = jax.tree.map(np.asarray, ref)
  con = {k: torch.tensor(pool[k]) for k in pool}
  con['efc_address'] = torch.full((2, C), -1, dtype=torch.int32)
  out = constraint.make_constraint(
      m, torch.tensor(q), torch.tensor(v), torch.tensor(ref.cdof),
      torch.tensor(ref.subtree_com), con)
  active = ref.efc_active
  np.testing.assert_array_equal(out['active'].numpy(), active)
  for k in ('type', 'id'):
    np.testing.assert_array_equal(out[k].numpy(), getattr(ref, 'efc_' + k))
  types_ = out['type'].numpy()
  for t in (types.ConstraintType.EQUALITY, types.ConstraintType.FRICTION_DOF,
            types.ConstraintType.LIMIT_JOINT,
            types.ConstraintType.CONTACT_ELLIPTIC):
    assert (active & (types_ == t)).any(), t
  assert (out['J'].numpy()[:, 24 + 3::4] != 0).any()   # torsional rows
  assert_close(out['J'].numpy(), ref.efc_J * active[..., None], 'efc_J', TOL)
  for k in ('D', 'aref', 'vel', 'pos', 'margin', 'frictionloss'):
    assert_close(out[k].numpy(), getattr(ref, 'efc_' + k), 'efc_' + k, TOL)
  for k in ('ne', 'nf', 'nl', 'nefc'):
    np.testing.assert_array_equal(out[k].numpy(), getattr(ref, k), k)


def _cubes():
  """12 cube meshes on free bodies, their centers on a 3 x 2 x 2 grid of
  0.125 at height 1, over a plane."""
  bodies = ''.join(
      f'<body pos="{0.125 * (i % 3)} {0.125 * (i // 3 % 2)} '
      f'{1 + 0.125 * (i // 6)}"><freejoint/><geom type="mesh" mesh="cube"/>'
      '</body>' for i in range(12))
  return (f'<mujoco>{CUBE_MESH}<worldbody><geom type="plane" size="2 2 .1"/>'
          f'{bodies}</worldbody></mujoco>')


def test_mesh_cull_and_pool_match_jax():
  mjm = mujoco.MjModel.from_xml_string(_cubes())
  jm, m = mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')
  assert [(a, b, len(g)) for a, b, g in m.collision_pairs] == [(0, 7, 12),
                                                               (7, 7, 66)]
  C, K = 8, 64
  assert collision_driver.cull_slots(C, 66) == K
  # world 0 turned at random, world 1 upright (the grid's faces aligned),
  # world 2 upright on the plane (plane-mesh ties)
  rng = np.random.default_rng(0)
  q = np.tile(mjm.qpos0, (3, 1))
  for i in range(12):
    quat = rng.standard_normal(4)
    q[0, 7 * i + 3:7 * i + 7] = quat / np.linalg.norm(quat)
  q[2, 2::7] -= 0.9
  q = q.astype(np.float32)
  jd = mjwt.make_data(jm, nconmax=C)
  gl = [g for _, _, glist in jm.collision_pairs for g in glist]
  g1 = np.array([a for a, _, _ in gl])
  g2 = np.array([b for _, b, _ in gl])
  hull = jm.mesh_hullvert[np.asarray(jm.geom_dataid)[12]]
  small = jm.mesh_hullvert_small[np.asarray(jm.geom_dataid)[12]]

  def ref(qq):
    """The JAX driver's collision, and its candidates: plane-mesh on the
    full hull, the cull's top-K and mpr_multi on the small hulls."""
    dd = js.kinematics(jm, jd.replace(qpos=qq))
    x, r = dd.geom_xpos, dd.geom_xmat
    pm = jax.vmap(jcp.plane_mesh, in_axes=(0,) * 6 + (None, None))(
        x[g1[:12]], r[g1[:12]], jm.geom_size[g1[:12]], x[g2[:12]],
        r[g2[:12]], jm.geom_size[g2[:12]], jnp.zeros((1, 4)), hull)
    a, b = g1[12:], g2[12:]
    dvec = x[a] - x[b]
    d2 = jnp.sum(dvec * dvec, -1)
    rsum = jm.geom_rbound[a] + jm.geom_rbound[b]
    overlap = d2 <= rsum * rsum
    _, sel = jax.lax.top_k(jnp.where(overlap, -d2, -jnp.inf), K)
    ka, kb = jnp.asarray(a)[sel], jnp.asarray(b)[sel]
    mm = jax.vmap(jcc.mpr_multi(7, 7), in_axes=(0,) * 6 + (None,) * 3)(
        x[ka], r[ka], jm.geom_size[ka], x[kb], r[kb], jm.geom_size[kb],
        small, small, 0.0)
    return (jcd.collision(jm, dd), x, r, pm, sel, overlap[sel],
            overlap.sum(), mm)
  (new, x, r, pm, jsel, jvalid, jnover, mm) = jax.tree.map(
      np.asarray, jax.jit(jax.vmap(ref))(jnp.asarray(q)))
  gx, gm = torch.tensor(x), torch.tensor(r)
  assert (jnover == 66).all() and (new.ncollision >= 2).all()

  # the cull, ties included
  params = collision_driver.candidate_params(m)
  grp = collision_driver._group_tables(m)[1]
  sel, valid, nover = collision_driver.cull(
      m, gx, grp, params['margin'][12:], K)
  np.testing.assert_array_equal(sel.numpy(), jsel)
  np.testing.assert_array_equal(valid.numpy(), jvalid)
  np.testing.assert_array_equal(nover.numpy(), jnover)
  d2 = ((x[:, g1[12:]] - x[:, g2[12:]]) ** 2).sum(-1)
  picked = np.take_along_axis(d2, jsel, 1)
  assert (picked[:, 1:] == picked[:, :-1]).sum() > 20          # ties

  # the narrowphase: plane-mesh at TOL, mpr_multi by the MPR rules
  grp0 = collision_driver._group_tables(m)[0]
  out = collision_driver.narrowphase(m, grp0, gx, gm, params['margin'][:12])
  for a, b, k in zip(out, pm, ('dist', 'pos', 'frame')):
    assert_close(a.numpy(), b, 'plane-mesh ' + k, TOL)
  assert (pm[0][2] == pm[0][2][:, :1]).all()                   # ties
  dist, pos, frame = (t.numpy() for t in collision_driver.narrowphase(
      m, grp, gx, gm, params['margin'][12:][sel], sel))
  hit = mm[0][..., 0] < 1e9
  np.testing.assert_array_equal(dist[..., 0] < 1e9, hit)
  np.testing.assert_allclose(dist[..., 0][hit], mm[0][..., 0][hit], rtol=0,
                             atol=TOL)
  # the normal and the point where the cubes are turned at random (in the
  # upright grid two faces can be equally deep, and rounding picks one)
  hit[1:] = False
  normal = mm[2][..., 0, 0, :][hit]
  np.testing.assert_allclose(frame[..., 0, 0, :][hit], normal, rtol=0,
                             atol=TOL)
  np.testing.assert_allclose(((pos[..., 0, :][hit] - mm[1][..., 0, :][hit]) *
                              normal).sum(-1), 0, rtol=0, atol=TOL)

  # the pool of the JAX candidates, exactly the JAX pool
  W = q.shape[0]
  dists = np.concatenate([pm[0].reshape(W, 48), np.where(
      jvalid[..., None], mm[0], 1e10).reshape(W, K * 5)], 1)
  poss = np.concatenate([pm[1].reshape(W, 48, 3),
                         mm[1].reshape(W, K * 5, 3)], 1)
  frames = np.concatenate([pm[2].reshape(W, 48, 3, 3),
                           mm[2].reshape(W, K * 5, 3, 3)], 1)
  rows = torch.cat([torch.arange(12).repeat_interleave(4).expand(W, -1),
                    (12 + torch.tensor(jsel)).repeat_interleave(5, 1)], 1)
  dropped = torch.tensor(jnover - K, dtype=torch.int32)
  pool = collision_driver.pool(
      torch.tensor(dists.astype(np.float32)), torch.tensor(poss),
      torch.tensor(frames), params, rows, C, dropped)
  for k in ('ncon', 'ncollision'):
    np.testing.assert_array_equal(pool[k].numpy(), getattr(new, k), k)
  for f in dataclasses.fields(new.contact):
    if f.name in pool and f.name != 'efc_address':
      np.testing.assert_array_equal(pool[f.name].numpy(),
                                    getattr(new.contact, f.name), f.name)
  assert (new.ncon == C).any()
