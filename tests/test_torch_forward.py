"""`forward_batched`, an RK4 step and a CG step of the port (plain path on
the CPU) against the JAX package's entry points on the humanoid, from C
MuJoCo states with contacts; the stage lists and CPU dispatch counts of
the port's paths; and the gates that choose them.

Tolerances are scale-relative, STEP_TOL of tests/test_torch_step.py.
solver_niter: Newton within 4 per world (the port's Newton kernel path
follows the glue kernel's linesearch). CG is held at its converged
answer, not per iteration (float32 reordering changes beta and the path;
tests/test_torch_cg.py holds single passes tightly and measures the
spread): after three steps the JAX package's CG step is 3.1e-3 of scale
in qacc from the Newton step of the same state, and the port's CG 3.0e-3
from the JAX package's. So what the solver moves is held at CG_STEP_TOL
(about three times that), against the JAX package's CG step and against
the port's own Newton step, the rest at STEP_TOL; CG's solver_niter only
has to stay inside the iteration budget.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import forward, solver
from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch.kernels import glue as kg
from mujoco_warp_tpu_torch.kernels import newton as kn
from mujoco_warp_tpu_torch.kernels import smooth as ks
from mujoco_warp_tpu_torch.types import IntegratorType, SolverType

from test_torch_step import STEP_TOL
from torch_parity import SCENES, assert_close, states

NWORLD = 4
NCONMAX = 24
# (actuator_length is linear in qpos; qfrc_passive and actuator_velocity
# are linear in qvel)
CG_STEP_TOL = dict(qpos=1e-4, actuator_length=1e-4, qvel=5e-3,
                   qfrc_passive=5e-3, actuator_velocity=5e-3, qacc=1e-2,
                   qfrc_constraint=5e-3)
# forward() leaves qpos, qvel and time alone; the rest as a step
FORWARD_TOL = tuple((k, t) for k, t in STEP_TOL
                    if k not in ('qpos', 'qvel', 'time')) + (
                        ('qacc_smooth', 5e-5),)


def _reset_counts():
  for mod in (ks, kc, kg, kn):
    mod.launches = 0
  kb.launches.update(dict.fromkeys(kb.launches, 0))
  solver.counts.update(solve=0, passes=0)


def _models(scene='humanoid', **opt):
  """(mjm, JAX Model, port Model on the CPU) with mjOption fields set."""
  mjm = mujoco.MjModel.from_xml_string(SCENES[scene])
  for k, v in opt.items():
    setattr(mjm.opt, k, v)
  return mjm, mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')


def _start(mjm, nworld=NWORLD):
  q, v = states(mjm, nworld, nstep=150, qpos_noise=0.02)
  c = (0.3 * np.random.default_rng(1).standard_normal(
      (nworld, mjm.nu))).astype(np.float32)
  return q, v, c


def _jax_batch(jm, q, v, c, nconmax=NCONMAX):
  jd = mjwt.make_data(jm, nconmax=nconmax)
  return jax.vmap(lambda qq, vv, cc: jd.replace(qpos=qq, qvel=vv, ctrl=cc))(
      jnp.asarray(q), jnp.asarray(v), jnp.asarray(c))


def _with(m, **opt):
  return m.replace(opt=m.opt.replace(**opt))


def _compare(d, br, tols):
  for name, tol in tols:
    assert_close(getattr(d, name).numpy(), np.asarray(getattr(br, name)),
                 name, tol)


def test_forward_batched_matches_jax():
  mjm, jm, m = _models()
  q, v, c = _start(mjm)
  br = _jax_batch(jm, q, v, c)
  br = jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd)))(br)   # a warm start
  d = mt.data_from_numpy(m, dict(
      qpos=np.array(br.qpos), qvel=np.array(br.qvel), ctrl=c,
      qacc_warmstart=np.array(br.qacc_warmstart), time=np.array(br.time)),
                         nconmax=NCONMAX)
  ref = jax.jit(jax.vmap(lambda dd: mjwt.forward(jm, dd)))(br)
  _reset_counts()
  out = mt.forward_batched(m, d)
  assert int(np.asarray(ref.ncon).sum()) > 0
  _compare(out, ref, FORWARD_TOL)
  # no integration (B1 only normalizes qpos's quaternions again)
  torch.testing.assert_close(out.qpos, d.qpos, rtol=0, atol=1e-6)
  for name in ('qvel', 'time', 'qacc_warmstart'):
    torch.testing.assert_close(getattr(out, name), getattr(d, name),
                               rtol=0, atol=0)
  dn = np.abs(out.solver_niter.numpy().astype(np.int64) -
              np.asarray(ref.solver_niter, np.int64))
  assert dn.max() <= 4
  # the solve stage is kernel B4's: it wrote the factor of qM and, with
  # eulerdamp disabled on the humanoid, qacc_euler = qacc
  L = out.qLD.double().numpy()
  assert not np.triu(L, 1).any()
  assert_close(L @ L.transpose(0, 2, 1), out.qM.numpy(), 'L Lᵀ', 2e-6)
  torch.testing.assert_close(out.qacc_euler, out.qacc, rtol=0, atol=0)
  # on the CPU every wrapper ran its plain version
  assert (ks.launches, kc.launches, kg.launches, kn.launches) == (0,) * 4
  assert solver.counts['solve'] == 0      # not the unfused solve


@pytest.mark.parametrize('case', ['rk4', 'cg'])
def test_step_matches_jax(case):
  opt = {'rk4': dict(integrator=int(IntegratorType.RK4)),
         'cg': dict(solver=int(SolverType.CG))}[case]
  mjm, jm, m = _models(**opt)
  q, v, c = _start(mjm)
  br = _jax_batch(jm, q, v, c)
  step = jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd)))
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=NCONMAX)
  assert not forward.uses_glue_kernel(m, d)
  newton = _with(m, solver=int(SolverType.NEWTON))
  d_newton = d
  _reset_counts()
  nstep = 3
  for _ in range(nstep):
    br = step(br)
    d = mt.step_batched(m, d)
    if case == 'cg':
      d_newton = mt.step_batched(newton, d_newton)
  assert int(np.asarray(br.ncon).sum()) > 0
  tols = STEP_TOL + (('qacc_warmstart', 5e-5),)
  if case == 'cg':
    tols = tuple((k, CG_STEP_TOL.get(k, t)) for k, t in tols
                 if k != 'qacc_warmstart') + (('qacc_warmstart', 1e-2),)
    _compare(d, d_newton, tols)
  _compare(d, br, tols)
  niter, ref_niter = d.solver_niter.numpy(), np.asarray(br.solver_niter)
  if case == 'rk4':
    assert np.abs(niter.astype(np.int64) - ref_niter).max() <= 4
    assert solver.counts == {'solve': 0, 'passes': 0}
  else:
    assert 0 < niter.max() < m.opt.iterations
    assert ref_niter.max() < m.opt.iterations
    assert solver.counts['solve'] == nstep
    assert solver.counts['passes'] >= int(niter.max())
  assert kb.launches == dict.fromkeys(kb.launches, 0)
  assert (ks.launches, kc.launches, kg.launches, kn.launches) == (0,) * 4


@pytest.fixture(scope='module')
def humanoid():
  mjm, _, m = _models()
  q, v, c = _start(mjm, 2)
  return m, mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c),
                               nconmax=NCONMAX)


_FRONT = ['smooth_mega[cuda]', 'contact_efc_mega[cuda]', 'transmission',
          'velocity_glue', 'passive', 'fwd_actuation', 'fwd_acceleration']


def test_stage_lists(humanoid):
  m, d = humanoid
  names = lambda stages: [n for n, _ in stages]
  assert names(forward.forward_stages(m, d)) == _FRONT + ['solve[cuda]']
  assert names(forward.batched_stages(m, d)) == [
      'smooth_mega[cuda]', 'contact_efc_mega[cuda]', 'act_len_vel',
      'solve_glue[cuda]']
  rk4 = _with(m, integrator=int(IntegratorType.RK4))
  assert names(forward.batched_stages(rk4, d)) == _FRONT + ['solve[cuda]',
                                                           'rk4']
  cg = _with(m, solver=int(SolverType.CG))
  assert names(forward.forward_stages(cg, d)) == _FRONT + ['solve']
  assert names(forward.batched_stages(cg, d)) == _FRONT + ['solve', 'euler']
  both = _with(m, solver=int(SolverType.CG),
               integrator=int(IntegratorType.RK4))
  assert names(forward.batched_stages(both, d)) == _FRONT + ['solve', 'rk4']


def test_cg_and_rk4_never_take_the_glue_list(humanoid):
  """The glue kernel solves with Newton and advances with Euler: a model
  with another solver or integrator must not reach it."""
  m, d = humanoid
  assert forward.uses_glue_kernel(m, d) and forward.uses_newton_kernel(m, d)
  rk4 = _with(m, integrator=int(IntegratorType.RK4))
  assert forward.uses_newton_kernel(rk4, d)
  assert not forward.uses_glue_kernel(rk4, d)
  cg = _with(m, solver=int(SolverType.CG))
  assert not forward.uses_newton_kernel(cg, d)
  assert not forward.uses_glue_kernel(cg, d)
  for mm in (rk4, cg):
    assert 'solve_glue[cuda]' not in [
        n for n, _ in forward.batched_stages(mm, d)]
  none = _with(m, iterations=0)
  assert not forward.uses_glue_kernel(none, d)


def test_options_set_on_a_loaded_model_match_put_model(humanoid):
  """Replacing Model.opt selects the same path and gives the same step as
  compiling the option into the model."""
  m, d = humanoid
  for opt in (dict(integrator=int(IntegratorType.RK4)),
              dict(solver=int(SolverType.CG))):
    compiled = _models(**opt)[2]
    replaced = _with(m, **opt)
    assert replaced.opt.integrator == compiled.opt.integrator
    assert replaced.opt.solver == compiled.opt.solver
    a = mt.step_batched(compiled, d)
    b = mt.step_batched(replaced, d)
    for name in ('qpos', 'qvel', 'qacc', 'solver_niter'):
      torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                 rtol=0, atol=0)


@pytest.mark.parametrize('opt', [
    dict(integrator=int(IntegratorType.IMPLICITFAST)),
    dict(integrator=int(IntegratorType.IMPLICIT)),
    dict(cone=1), dict(solver=int(SolverType.PGS)), dict(enableflags=2)],
    ids=['implicitfast', 'implicit', 'elliptic', 'pgs', 'energy'])
def test_options_outside_the_gate_raise(humanoid, opt):
  m, d = humanoid
  mm = _with(m, **opt)
  for entry in (mt.step_batched, mt.forward_batched, forward.batched_stages,
                forward.forward_stages):
    with pytest.raises(NotImplementedError):
      entry(mm, d)


def test_iterative_linesearch_still_raises(humanoid):
  m, d = humanoid
  mm = _with(m, solver=int(SolverType.CG), ls_parallel=0)
  with pytest.raises(NotImplementedError):
    mt.step_batched(mm, d)


def test_rk4_dispatch_counts_and_warmstart(humanoid):
  """An RK4 step is four forward_batched: the first three evaluations
  leave qacc_warmstart alone and the step sets it to the first
  evaluation's qacc; time advances once."""
  m, d = humanoid
  rk4 = _with(m, integrator=int(IntegratorType.RK4))
  calls = []
  orig = kn.newton_solve

  def counting(*args, **kw):
    calls.append(args[7].clone())           # qacc_warmstart
    return orig(*args, **kw)
  kn.newton_solve = counting
  try:
    first = mt.forward_batched(rk4, d)
    calls.clear()
    out = mt.step_batched(rk4, d)
  finally:
    kn.newton_solve = orig
  assert len(calls) == 4
  for ws in calls:
    torch.testing.assert_close(ws, d.qacc_warmstart, rtol=0, atol=0)
  torch.testing.assert_close(out.qacc_warmstart, first.qacc, rtol=0, atol=0)
  np.testing.assert_allclose(out.time.numpy(),
                             d.time.numpy() + float(m.opt.timestep),
                             rtol=1e-6)
  assert bool(torch.isfinite(out.qpos).all())


def test_unfused_euler_with_the_newton_kernel_equals_the_glue_step(humanoid):
  """forward_batched + euler (B4's path) and the glue list (B3's) are the
  same step: their plain versions share `solver.newton`."""
  m, d = humanoid
  a = mt.step_batched(m, d)
  b = d
  for _, fn in forward.unfused_stages(m, d):
    b = fn(b)
  for name, tol in STEP_TOL:
    assert_close(getattr(b, name).numpy(), getattr(a, name).numpy(), name,
                 tol)
  torch.testing.assert_close(a.solver_niter, b.solver_niter, rtol=0, atol=0)
