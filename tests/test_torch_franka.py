"""franka_emika_panda (the benchmark suite's `franka_emika_panda/scene.xml`:
nv 9, one joint equality, a plane-capsule and two plane-box pairs,
implicitfast with eulerdamp disabled) through the port's plain path on
the CPU, against the JAX package and C MuJoCo: the model and its efc
layout, kernel B2's plain rows (`kernels.contact.plain`) against
`collision_driver.collision` + `constraint.make_constraint` at the
suite's nconmax 1 and at 12, three glue steps against
`jax.vmap(mujoco_warp_tpu.step)`, and one step against C MuJoCo's
`mj_step`.

States: qpos0 (the fingers 0.82 m above the floor: no contact, joint 4
outside its range) and the reach pose REACH, where the pads' corners
reach the floor, with seeded noise on joints 2, 4 and 6. Tolerances as
tests/test_torch_equality.py (rows), tests/test_torch_step.py (steps)
and tests/test_torch_implicit.py (C MuJoCo); the JAX functions are
jitted once per module (the `jax_franka` fixture).
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import forward, io, models, solver

from test_torch_equality import _port_rows, jax_rows
from test_torch_contact import _assert_matches_jax
from test_torch_forward import _jax_batch
from test_torch_implicit import C_INTEGRATOR_TOL, C_TOL
from test_torch_step import STEP_TOL
from torch_parity import assert_close, build

REACH = np.array([0, 0.9, 0, -1.6, 0, 2.4, 0.785, 0.04, 0.04])
NWORLD = 6


@pytest.fixture(scope='module')
def franka():
  return build('franka_emika_panda')


@pytest.fixture(scope='module')
def jax_franka(franka):
  """The JAX package's B2 rows (jax_rows) and batched step on franka,
  each jitted once for the module."""
  jm = franka[1]
  return dict(rows=jax_rows(jm),
              step=jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd))))


def _reach(mjm, nworld, seed=0):
  """(qpos, qvel, ctrl holding the pose) of nworld reach states: noise of
  +-0.05 rad on joints 2, 4 and 6, qvel N(0, 0.1^2)."""
  rng = np.random.default_rng(seed)
  q = np.tile(REACH, (nworld, 1))
  q[:, [1, 3, 5]] += rng.uniform(-0.05, 0.05, (nworld, 3))
  v = rng.normal(0, 0.1, (nworld, mjm.nv))
  c = np.clip(q[:, :mjm.nu], *mjm.actuator_ctrlrange.T)
  return q.astype(np.float32), v.astype(np.float32), c.astype(np.float32)


def test_franka_model_and_layout(franka):
  mjm, jm, m = franka
  assert (m.nq, m.nv, m.nu, m.neq, m.ncam, m.nlight) == (9, 9, 8, 1, 1, 2)
  assert m.eq_type == (2,) and m.eq_obj2id == (8,)
  assert [(t1, t2, len(gl)) for t1, t2, gl in m.collision_pairs] == [
      (0, 3, 1), (0, 6, 2)]
  assert m.nxn_candidates == 10
  for nconmax in (1, 12):
    assert mt.efc_layout(m, nconmax) == mjwt.io.efc_layout(jm, nconmax)
  assert mt.efc_layout(m, 1) == (1, 0, 9, 4, 14)
  loaded = io.load_model(models.FRANKA_NPZ, device='cpu')
  assert loaded.eq_active0.dtype == torch.bool
  assert forward.glue_mode(loaded) == 2
  d = mt.make_data(loaded, nconmax=1, nworld=3)
  assert [n for n, _ in forward.batched_stages(loaded, d)] == [
      'smooth_mega[cuda]', 'camlight', 'contact_efc_mega[cuda]',
      'act_len_vel', 'solve_glue[cuda]']
  assert d.eq_active.shape == (3, 1) and bool(d.eq_active.all())


@pytest.mark.parametrize('nconmax', [1, 12])
def test_franka_rows_match_jax(franka, jax_franka, nconmax):
  """Two worlds at qpos0 (one with noise) and four reach states, the
  equality off in one of them."""
  mjm, _, m = franka
  q, v, _ = _reach(mjm, NWORLD)
  q[:2] = mjm.qpos0
  q[1] += np.random.default_rng(1).normal(0, 0.01, mjm.nq)
  eq = np.ones((NWORLD, 1), bool)
  eq[3] = False
  ref = jax_franka['rows'](q, v, eq, nconmax)
  out = _port_rows(m, q, v, eq, nconmax)
  _assert_matches_jax(out, ref)
  ncol = out['ncollision'].numpy()
  assert (ncol[:2] == 0).all() and (ncol[2:] >= 8).sum() >= 2, ncol
  np.testing.assert_array_equal(out['ncon'].numpy()[2:],
                                np.minimum(ncol[2:], nconmax))
  np.testing.assert_array_equal(out['ne'].numpy(), eq[:, 0])


def test_franka_glue_steps_match_jax(franka, jax_franka):
  """Three glue steps (B1, camlight, B2, B3 in mode 2: the plain
  versions) from reach states, against three steps of
  jax.vmap(mujoco_warp_tpu.step) at the suite's nconmax 1."""
  mjm, jm, m = franka
  q, v, c = _reach(mjm, 4, seed=2)
  br = _jax_batch(jm, q, v, c, nconmax=1)
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=1)
  for _ in range(3):
    br = jax_franka['step'](br)
    d = mt.step_batched(m, d)
  assert d.ncon.numpy().sum() >= 2 and (d.ne.numpy() == 1).all()
  for name, tol in STEP_TOL:
    assert_close(getattr(d, name).numpy(), np.asarray(getattr(br, name)),
                 name, tol)
  dn = np.abs(d.solver_niter.numpy().astype(np.int64) -
              np.asarray(br.solver_niter, np.int64))
  assert dn.max() <= 4


def _c_step(mjm, q, v, c):
  """C MuJoCo's mj_step from each state: (qpos, qvel), and mj_forward's
  qfrc_constraint, actuator_force and ncon."""
  out = [[], [], [], [], []]
  for w in range(q.shape[0]):
    cd = mujoco.MjData(mjm)
    cd.qpos[:], cd.qvel[:], cd.ctrl[:] = q[w], v[w], c[w]
    mujoco.mj_forward(mjm, cd)
    out[2].append(cd.qfrc_constraint.astype(np.float32))
    out[3].append(cd.actuator_force.copy())
    out[4].append(cd.ncon)
    mujoco.mj_step(mjm, cd)
    out[0].append(cd.qpos.copy())
    out[1].append(cd.qvel.copy())
  return [np.asarray(x) for x in out]


def _integrate(m, f, kept):
  """qvel after the implicitfast re-solve (qM + diag) qacc = qfrc_smooth +
  qfrc_constraint of the forward pass f, the diagonal h damping - h sum
  gear0^2 (biasprm[2] + gainprm[2] ctrl) over the actuators `kept`
  (W, nu) bool."""
  h = float(m.opt.timestep)
  gear0 = m.actuator_gear[:, 0]
  coeff = forward.actuator_vel_coeff(m, f.ctrl) * kept
  per_dof = torch.zeros_like(f.qvel).index_add_(
      1, forward.actuation_tables(m)['dadr'], gear0 * gear0 * coeff)
  diag = forward.damping_diag(m) - h * per_dof
  qacc = solver.cho_solve(solver.cholesky(f.qM + torch.diag_embed(diag)),
                          f.qfrc_smooth + f.qfrc_constraint)
  return f.qvel + h * qacc


def test_franka_step_matches_c_mujoco(franka):
  """One step from reach states (up to 8 plane-box contacts, as many as
  C MuJoCo finds, and the equality row) against mj_step: with ctrl
  holding the pose no actuator force is clamped, and both lists match C
  MuJoCo, whole steps
  at C_TOL and their integrators, given C MuJoCo's constraint forces, at
  C_INTEGRATOR_TOL. With ctrl drawn across its range most forces clamp:
  C MuJoCo then drops a clamped actuator's velocity term from qDeriv,
  where the port, as the JAX package's glue kernel, keeps every
  actuator's (ROADMAP §C): the port's qvel lands more than 100 times
  C_INTEGRATOR_TOL off C MuJoCo's, and within it once the clamped
  actuators' terms are dropped."""
  mjm, _, m = franka
  q, v, c = _reach(mjm, 4, seed=3)
  cq, cv, qfc, frc, ncon = _c_step(mjm, q, v, c)
  limit = mjm.actuator_forcerange[:, 1]
  assert (np.abs(frc) < limit).all() and (ncon == 8).sum() >= 2
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=12)
  for out in (mt.step_batched(m, d),
              forward._run(forward.unfused_stages(m, d), d)):
    np.testing.assert_array_equal(out.ncon.numpy(), ncon)
    assert (out.ne.numpy() == 1).all()
    assert_close(out.qpos.numpy(), cq, 'qpos', C_TOL['qpos'])
    assert_close(out.qvel.numpy(), cv, 'qvel', C_TOL['qvel'])
  f = mt.forward_batched(m, d).replace(qfrc_constraint=torch.tensor(qfc))
  every = torch.ones(4, m.nu)
  for qvel in (forward.implicit(m, f).qvel, _integrate(m, f, every)):
    assert_close(qvel.numpy(), cv, 'qvel, C forces', C_INTEGRATOR_TOL)
  # ctrl across its range: clamped forces
  c = np.random.default_rng(4).uniform(*mjm.actuator_ctrlrange.T,
                                       (4, mjm.nu)).astype(np.float32)
  _, cv, qfc, frc, _ = _c_step(mjm, q, v, c)
  clamped = np.abs(frc) >= limit
  assert clamped.any(1).all()
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=12)
  f = mt.forward_batched(m, d).replace(qfrc_constraint=torch.tensor(qfc))
  scale = max(1.0, float(np.abs(cv).max()))
  for qvel in (forward.implicit(m, f).qvel, _integrate(m, f, every)):
    assert np.abs(qvel.numpy() - cv).max() > 100 * C_INTEGRATOR_TOL * scale
  assert_close(_integrate(m, f, torch.tensor(~clamped)).numpy(), cv,
               'qvel, C forces, clamped terms dropped', C_INTEGRATOR_TOL)
