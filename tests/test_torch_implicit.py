"""The implicitfast integrator of the port (plain path on the CPU) against
the JAX package and C MuJoCo: `derivative.deriv_smooth_vel`, the glue
list's mode-2 diagonal (kernel B3's plain version, `forward.glue`), the
unfused step (`forward.implicit`, B5 on qM - h qDeriv) and
`step1`/`step2`.

The servo fixture is a capsule chain over a plane (sphere, capsule and
plane pairs only) with a position servo with kv, velocity servos (two on
one dof, one with gear 2) and an affine `<general>` whose gain moves with
velocity; its ctrl is drawn partly outside its range [-1, 1], so that
the diagonal (raw ctrl) and the forces (clamped ctrl) read different
values.

Tolerances: steps at STEP_TOL of tests/test_torch_step.py (scale-
relative), solver_niter within 4; what the CG solver moves at
CG_STEP_TOL of tests/test_torch_forward.py; qDeriv and the diagonal at
float32 rounding (DERIV_TOL of scale). Against C MuJoCo's float64 step:
the integrator, given C MuJoCo's own constraint forces, at C_INTEGRATOR_TOL
(qvel 2.1e-6 of scale off on these states), and the whole step at C_TOL,
the float32 envelope of the solve (one world's float32 Newton solve, the
JAX package's too, stops 0.49 in qacc, 1.2e-3 of qvel's scale, away from
C MuJoCo's; the others within 2e-6). Each JAX function is compiled once
for the test that uses it.
"""

import importlib

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu import derivative as jderivative
from mujoco_warp_tpu.pallas import solver_kernels
from mujoco_warp_tpu_torch import forward, solver, support
from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
from mujoco_warp_tpu_torch.kernels import glue as kg
from mujoco_warp_tpu_torch.types import DisableBit, IntegratorType, SolverType

from test_torch_forward import CG_STEP_TOL, _compare, _jax_batch
from test_torch_step import STEP_TOL
from torch_parity import assert_close, build, states

jforward = importlib.import_module('mujoco_warp_tpu.forward')

SERVO = """
<mujoco>
  <option timestep="0.005" integrator="implicitfast"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body pos="0 0 0.06">
      <freejoint/>
      <geom type="capsule" size="0.05" fromto="0 0 0 0.3 0 0" mass="1"/>
      <body pos="0.3 0 0">
        <joint name="bend" type="hinge" axis="0 1 0" damping="0.5"/>
        <geom type="capsule" size="0.04" fromto="0 0 0 0.3 0 0" mass="0.5"/>
        <body pos="0.3 0 0">
          <joint name="turn" type="hinge" axis="0 0 1" damping="0.2"/>
          <geom type="capsule" size="0.04" fromto="0 0 0 0.25 0 0"
                mass="0.4"/>
          <body pos="0.25 0 0">
            <joint name="reach" type="slide" axis="1 0 0" damping="1"/>
            <geom type="sphere" size="0.05" mass="0.3"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <position joint="bend" kp="20" kv="2" ctrlrange="-1 1"/>
    <velocity joint="turn" kv="3" ctrlrange="-1 1"/>
    <general joint="reach" gaintype="affine" gainprm="5 0 -2"
             biastype="affine" biasprm="0 -10 -1" ctrlrange="-1 1"/>
    <velocity joint="bend" kv="1" gear="2"/>
  </actuator>
</mujoco>
"""
NWORLD = 4
NCONMAX = 8
DERIV_TOL = 1e-6
C_TOL = dict(qpos=2e-5, qvel=3e-3)
C_INTEGRATOR_TOL = 1e-5
DAMPER_OFF = int(DisableBit.DAMPER)


def _servo(disable=0):
  mjm = mujoco.MjModel.from_xml_string(SERVO)
  mjm.opt.disableflags |= disable
  return mjm, mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')


def _servo_states(mjm, nworld=NWORLD):
  """C MuJoCo states of the servo fixture in contact, and ctrl uniform in
  [-2, 2] (half of it outside the range)."""
  q, v = states(mjm, nworld, nstep=100)
  c = np.random.default_rng(1).uniform(-2, 2, (nworld, mjm.nu))
  return q, v, c.astype(np.float32)


def _niter_close(d, br):
  dn = np.abs(d.solver_niter.numpy().astype(np.int64) -
              np.asarray(br.solver_niter, np.int64))
  assert dn.max() <= 4


@pytest.fixture(scope='module')
def servo_stepped():
  """Three glue steps of the servo fixture, the port's and the JAX
  package's (jax.vmap(step))."""
  mjm, jm, m = _servo()
  q, v, c = _servo_states(mjm)
  # the affine <general>'s diagonal term moves with ctrl: some worlds'
  # ctrl lies outside its range, some inside
  outside = np.abs(c[:, 2]) > 1
  assert outside.any() and not outside.all()
  br = _jax_batch(jm, q, v, c, nconmax=NCONMAX)
  step = jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd)))
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=NCONMAX)
  assert [n for n, _ in forward.batched_stages(m, d)][-1] == \
      'solve_glue[cuda]'
  for _ in range(3):
    br = step(br)
    d = mt.step_batched(m, d)
  return jm, m, d, br


def test_deriv_smooth_vel_matches_jax(servo_stepped):
  """qDeriv of the same ctrl and actuator moments as jax.vmap of the JAX
  function; with the damper disabled the port drops the damping, as C
  MuJoCo does and the JAX function does not (ROADMAP §C)."""
  jm, m, d, br = servo_stepped
  ref = np.asarray(jax.jit(jax.vmap(
      lambda dd: jderivative.deriv_smooth_vel(jm, dd)))(br))
  out = mt.derivative.deriv_smooth_vel(m, d)
  assert out.shape == (NWORLD, m.nv, m.nv)
  assert_close(out.numpy(), ref, 'qDeriv', DERIV_TOL)
  # the actuator terms move with the raw ctrl: worlds differ
  assert float((out[0] - out[1]).abs().max()) > 0.1
  off = m.replace(opt=m.opt.replace(disableflags=DAMPER_OFF))
  out_off = mt.derivative.deriv_smooth_vel(off, d)
  assert_close(out_off.numpy(), ref + np.diag(m.dof_damping.numpy()),
               'qDeriv, damper off', DERIV_TOL)


def test_mode2_diagonal_is_minus_h_diag_of_jax_qderiv(servo_stepped):
  """The glue list's mode-2 diagonal (`forward.integration_diag`, which
  the plain glue solve adds to qM) against -h diag(qDeriv) of the JAX
  function, per world; kernel B3's table holds its damping part."""
  jm, m, d, br = servo_stepped
  assert forward.glue_mode(m) == 2
  qderiv = np.asarray(jax.jit(jax.vmap(
      lambda dd: jderivative.deriv_smooth_vel(jm, dd)))(br))
  h = float(m.opt.timestep)
  ref = -h * np.diagonal(qderiv, axis1=1, axis2=2)
  out = forward.integration_diag(m, d.ctrl)
  assert out.shape == (NWORLD, m.nv)
  assert_close(out.numpy(), ref, 'mode-2 diagonal', DERIV_TOL)
  table = kg._tables(m)['dof_float'][:, 5]
  torch.testing.assert_close(table, forward.damping_diag(m), rtol=0, atol=0)
  # the humanoid's motors have no velocity terms: h * damping alone
  _, _, hm = build('humanoid')
  hm = hm.replace(opt=hm.opt.replace(
      integrator=int(IntegratorType.IMPLICITFAST)))
  ctrl = torch.rand((3, hm.nu), generator=torch.Generator().manual_seed(0))
  hd = forward.integration_diag(hm, ctrl)
  torch.testing.assert_close(hd, (hm.opt.timestep * hm.dof_damping).expand(
      3, hm.nv), rtol=0, atol=0)


def test_servo_glue_steps_match_jax(servo_stepped):
  _, m, d, br = servo_stepped
  _compare(d, br, STEP_TOL)
  _niter_close(d, br)
  assert int(np.asarray(br.ncon).sum()) > 0


def test_humanoid_glue_steps_match_jax():
  mjm, _, _ = build('humanoid')
  mjm.opt.integrator = IntegratorType.IMPLICITFAST
  jm, m = mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')
  q, v = states(mjm, NWORLD, nstep=150, qpos_noise=0.02)
  c = (0.3 * np.random.default_rng(1).standard_normal(
      (NWORLD, mjm.nu))).astype(np.float32)
  br = _jax_batch(jm, q, v, c, nconmax=24)
  step = jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd)))
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=24)
  assert forward.uses_glue_kernel(m, d) and forward.glue_mode(m) == 2
  for _ in range(3):
    br = step(br)
    d = mt.step_batched(m, d)
  assert int(np.asarray(br.ncon).sum()) > 0
  _compare(d, br, STEP_TOL)
  _niter_close(d, br)


@pytest.mark.parametrize('scene,solver_type', [
    ('three_humanoids', SolverType.NEWTON), ('humanoid', SolverType.CG)],
                         ids=['three_humanoids_newton', 'humanoid_cg'])
def test_unfused_step_matches_jax(scene, solver_type):
  """Two unfused implicitfast steps against the JAX package's
  `forward_batched` + `_implicit_batched`: B7 (three_humanoids) or B5
  (humanoid CG) in fwd_acceleration, and B5 on qM - h qDeriv, whose
  launches the CPU counts as none (the plain versions run)."""
  mjm, _, _ = build(scene)
  mjm.opt.integrator = IntegratorType.IMPLICITFAST
  mjm.opt.solver = solver_type
  jm, m = mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')
  nconmax = 100 if scene == 'three_humanoids' else 24
  q, v = states(mjm, 2, nstep=150, qpos_noise=0.02)
  c = (0.3 * np.random.default_rng(1).standard_normal(
      (2, mjm.nu))).astype(np.float32)
  br = _jax_batch(jm, q, v, c, nconmax=nconmax)
  step = jax.jit(lambda dd: jforward._implicit_batched(
      jm, jforward.forward_batched(jm, dd)))
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=nconmax)
  names = [n for n, _ in forward.batched_stages(m, d)]
  assert names[-2:] == ['solve', 'implicitfast']
  assert not forward.uses_glue_kernel(m, d) and not forward.replays(m, d)
  kb.launches.update(dict.fromkeys(kb.launches, 0))
  solver.counts.update(dict.fromkeys(solver.counts, 0))
  for _ in range(2):
    br = step(br)
    d = mt.step_batched(m, d)
  assert solver.counts['solve'] == 2
  assert kb.launches == dict.fromkeys(kb.launches, 0)
  assert int(np.asarray(br.ncon).sum()) > 0
  if solver_type == SolverType.CG:
    _compare(d, br, tuple((k, CG_STEP_TOL.get(k, t)) for k, t in STEP_TOL))
    assert 0 < int(d.solver_niter.max()) < m.opt.iterations
  else:
    _compare(d, br, STEP_TOL)
    _niter_close(d, br)


@pytest.mark.parametrize('disable', [0, DAMPER_OFF],
                         ids=['damper_on', 'damper_off'])
def test_one_step_matches_c_mujoco(disable):
  """One step of the servo fixture, through the glue list and through the
  unfused list, against C MuJoCo's mj_step from the same state; and the
  two lists' integrators (the unfused `implicit`, the glue solve's
  re-solve with `integration_diag`) given C MuJoCo's own constraint
  forces. With the damper disabled both lists drop the damping from qM -
  h qDeriv, as C MuJoCo does; the JAX package's `implicit` keeps it and
  lands off C MuJoCo (ROADMAP §C)."""
  mjm, jm, m = _servo(disable)
  q, v, c = _servo_states(mjm)
  cq, cv, qfc = [], [], []
  for w in range(NWORLD):
    cd = mujoco.MjData(mjm)
    cd.qpos[:], cd.qvel[:], cd.ctrl[:] = q[w], v[w], c[w]
    mujoco.mj_forward(mjm, cd)
    assert cd.ncon > 0
    qfc.append(cd.qfrc_constraint.astype(np.float32))
    cd = mujoco.MjData(mjm)
    cd.qpos[:], cd.qvel[:], cd.ctrl[:] = q[w], v[w], c[w]
    mujoco.mj_step(mjm, cd)
    cq.append(cd.qpos.copy())
    cv.append(cd.qvel.copy())
  cq, cv, qfc = np.asarray(cq), np.asarray(cv), np.asarray(qfc)
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=NCONMAX)
  glue = mt.step_batched(m, d)
  unfused = forward._run(forward.unfused_stages(m, d), d)
  for out in (glue, unfused):
    assert_close(out.qpos.numpy(), cq, 'qpos', C_TOL['qpos'])
    assert_close(out.qvel.numpy(), cv, 'qvel', C_TOL['qvel'])
  f = mt.forward_batched(m, d).replace(qfrc_constraint=torch.tensor(qfc))
  h = float(m.opt.timestep)
  diag = torch.diag_embed(forward.integration_diag(m, f.ctrl))
  resolve = solver.cho_solve(solver.cholesky(f.qM + diag),
                             f.qfrc_smooth + f.qfrc_constraint)
  for qvel in (forward.implicit(m, f).qvel, f.qvel + h * resolve):
    assert_close(qvel.numpy(), cv, 'qvel, C forces', C_INTEGRATOR_TOL)
  if disable:
    jf = jax.jit(jax.vmap(lambda dd: mjwt.forward(jm, dd)))(
        _jax_batch(jm, q, v, c, nconmax=NCONMAX))
    jf = jf.replace(qfrc_constraint=jnp.asarray(qfc))
    ji = jax.jit(jax.vmap(lambda dd: mjwt.implicit(jm, dd)))(jf)
    off = np.abs(np.asarray(ji.qvel) - cv).max()
    assert off > 100 * C_INTEGRATOR_TOL * max(1.0, np.abs(cv).max())


def test_step1_step2_match_the_unfused_step_and_jax():
  """step2(step1(d)) is the unfused step bit for bit (implicitfast and
  Euler); step1 and step2 against jax.vmap of the JAX functions; RK4 has
  no split."""
  mjm, jm, m = _servo()
  q, v, c = _servo_states(mjm)
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=NCONMAX)
  br = _jax_batch(jm, q, v, c, nconmax=NCONMAX)
  for mm in (m, m.replace(opt=m.opt.replace(
      integrator=int(IntegratorType.EULER)))):
    a = mt.step2(mm, mt.step1(mm, d))
    b = forward._run(forward.unfused_stages(mm, d), d)
    for k in ('qpos', 'qvel', 'qacc', 'qfrc_constraint', 'qacc_warmstart',
              'time', 'actuator_force', 'qfrc_passive'):
      torch.testing.assert_close(getattr(a, k), getattr(b, k), rtol=0,
                                 atol=0)
  s1 = mt.step1(m, d)
  j1 = jax.jit(jax.vmap(lambda dd: mjwt.step1(jm, dd)))(br)
  assert s1.qfrc_actuator is d.qfrc_actuator     # step2's to compute
  _compare(s1, j1, (('actuator_length', 5e-6), ('actuator_velocity', 5e-5),
                    ('qfrc_passive', 5e-5), ('qfrc_bias', 5e-5)))
  np.testing.assert_array_equal(s1.ncon.numpy(), np.asarray(j1.ncon))
  s2 = mt.step2(m, s1)
  j2 = jax.jit(jax.vmap(lambda dd: mjwt.step2(jm, dd)))(j1)
  _compare(s2, j2, STEP_TOL)
  _niter_close(s2, j2)
  rk4 = m.replace(opt=m.opt.replace(integrator=int(IntegratorType.RK4)))
  with pytest.raises(NotImplementedError):
    mt.step2(rk4, s1)


@pytest.mark.parametrize('disable', [0, DAMPER_OFF],
                         ids=['damper_on', 'damper_off'])
def test_plain_mode2_glue_matches_the_jax_glue_kernel(disable, monkeypatch):
  """The port's plain mode-2 glue (`forward.glue`) against the JAX
  package's glue kernel in mode 2 (`make_glue_kernel` -> `run`, Pallas
  interpret mode as MJWT_FORCE_MEGA=1 runs it on the CPU) on the same
  inputs, at 2 worlds, at B3's tolerances (tests/test_glue_kernel.py).
  Both drop the damping with the damper disabled."""
  monkeypatch.setenv('MJWT_FORCE_MEGA', '1')
  mjm, jm, m = _servo(disable)
  q, v, c = _servo_states(mjm, 2)
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=NCONMAX)
  for _, fn in forward.glue_stages(m, d)[:-1]:
    d = fn(d)
  qfx = d.qfrc_applied + support.xfrc_accumulate(
      m, d.xfrc_applied, d.xipos, d.subtree_com, d.cdof) - d.qfrc_bias
  g_in = (d.qM, d.efc_J, d.efc_D, d.efc_aref, d.efc_frictionloss, d.qpos,
          d.qvel, d.ctrl, qfx, d.qacc_warmstart)
  out = forward.glue(m, *g_in)
  ne, nf, _, _, nj = mt.efc_layout(m, NCONMAX)
  assert jforward._glue_mode(jm) == forward.glue_mode(m) == 2
  run = solver_kernels.make_glue_kernel(jm, nj, ne, nf, True, 2)
  ref = run(*[jnp.asarray(x.numpy()) for x in g_in], jm.opt.tolerance,
            jm.stat.meaninertia, jm.opt.timestep)
  assert int(d.ncon.sum()) > 0
  for k in kg.OUTPUTS:
    if k == 'solver_niter':
      dn = np.abs(out[k].numpy() - np.asarray(ref[k]))
      assert dn.max() <= 4
    else:
      tol = {'qpos': 5e-6, 'qfrc_constraint': 5e-4,
             'efc_force': 5e-4}.get(k, 5e-5)
      assert_close(out[k].numpy(), np.asarray(ref[k]), k, tol)
