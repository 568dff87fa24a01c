"""`forward_batched`, an RK4 step and a CG step of the port (plain path on
the CPU) against the JAX package's entry points on the humanoid, from C
MuJoCo states with contacts (and their warm starts); the stage lists and
CPU dispatch counts of the port's paths; and the gates that choose them.
The JAX package's `forward` is compiled once for the module: it is
`forward_batched`'s reference and the four evaluations of the JAX RK4
step (`forward`, then `_rk4_batched`, the combination of `rungekutta4`
over a leading world axis, whose three evaluations run the same
compiled function).

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

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu import solver as jsolver
from mujoco_warp_tpu_torch import forward, solver
from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch.kernels import glue as kg
from mujoco_warp_tpu_torch.kernels import newton as kn
from mujoco_warp_tpu_torch.kernels import smooth as ks
from mujoco_warp_tpu_torch.types import ConeType, IntegratorType, SolverType

from test_torch_cg import CG_TOL
from test_torch_step import STEP_TOL
from torch_parity import SCENES, assert_close, states

jforward = importlib.import_module('mujoco_warp_tpu.forward')

NWORLD = 4
NCONMAX = 24
ELLIPTIC = ['opt.cone=elliptic', 'opt.impratio=10']
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
  solver.counts.update(dict.fromkeys(solver.counts, 0))


def _models(scene='humanoid', **opt):
  """(mjm, JAX Model, port Model on the CPU) with mjOption fields set."""
  mjm = mujoco.MjModel.from_xml_string(SCENES[scene])
  for k, v in opt.items():
    setattr(mjm.opt, k, v)
  return mjm, mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')


def _start(mjm, nworld=NWORLD):
  q, v, ws = states(mjm, nworld, nstep=150, qpos_noise=0.02,
                    warmstart=True)
  c = (0.3 * np.random.default_rng(1).standard_normal(
      (nworld, mjm.nu))).astype(np.float32)
  return q, v, c, ws


def _jax_batch(jm, q, v, c, ws=None, nconmax=NCONMAX):
  jd = mjwt.make_data(jm, nconmax=nconmax)
  ws = np.zeros_like(v) if ws is None else ws
  return jax.vmap(lambda qq, vv, cc, ww: jd.replace(
      qpos=qq, qvel=vv, ctrl=cc, qacc_warmstart=ww))(
          jnp.asarray(q), jnp.asarray(v), jnp.asarray(c), jnp.asarray(ws))


@pytest.fixture(scope='module')
def jax_forward():
  """(mjm, JAX Model, the JAX package's forward jitted for one world):
  vmapped, it compiles once for every batch of NWORLD worlds."""
  mjm, jm, _ = _models()
  return mjm, jm, jax.jit(lambda dd: mjwt.forward(jm, dd))


def _jax_rk4_step(jm, forward, batch, monkeypatch):
  """The JAX package's RK4 step over a batch, `forward` and then
  `_rk4_batched` (the combination of `rungekutta4`, over a leading world
  axis), every forward() evaluation run by the same compiled vmap of
  `forward` (forward() reads no integrator option, so the Euler model's
  compiled forward serves)."""
  fwd = jax.vmap(forward)
  monkeypatch.setattr(jforward, 'forward_batched', lambda m_, dd: fwd(dd))
  try:
    return jforward._rk4_batched(jm, fwd(batch))
  finally:
    monkeypatch.undo()


def _with(m, **opt):
  return m.replace(opt=m.opt.replace(**opt))


def _compare(d, br, tols):
  for name, tol in tols:
    assert_close(getattr(d, name).numpy(), np.asarray(getattr(br, name)),
                 name, tol)


def test_forward_batched_matches_jax(jax_forward):
  mjm, jm, jf = jax_forward
  m = mt.put_model(mjm, device='cpu')
  q, v, c, ws = _start(mjm)
  br = _jax_batch(jm, q, v, c, ws)
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c, qacc_warmstart=ws),
                         nconmax=NCONMAX)
  assert bool((d.qacc_warmstart != 0).any())
  ref = jax.vmap(jf)(br)
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
def test_step_matches_jax(case, jax_forward, monkeypatch):
  opt = {'rk4': dict(integrator=int(IntegratorType.RK4)),
         'cg': dict(solver=int(SolverType.CG))}[case]
  _, _, jf = jax_forward
  mjm, jm, m = _models(**opt)
  q, v, c, _ = _start(mjm)
  br = _jax_batch(jm, q, v, c)
  if case == 'rk4':
    step = lambda b: _jax_rk4_step(jm, jf, b, monkeypatch)
  else:
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
    assert solver.counts == {'solve': 0, 'passes': 0, 'linesearch': 0}
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
  q, v, c, _ = _start(mjm, 2)
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
  """Replacing Model.opt, or overriding it as the JAX package's
  `override_model` does, selects the same path and gives the same step as
  compiling the option into the model; the elliptic cone also turns the
  parallel linesearch off, as put_model does."""
  m, d = humanoid
  for opt in (dict(integrator=int(IntegratorType.RK4)),
              dict(solver=int(SolverType.CG)),
              dict(cone=int(ConeType.ELLIPTIC), impratio=10.0)):
    compiled = _models(**opt)[2]
    if 'cone' in opt:
      replaced = mt.override_model(m, ELLIPTIC)
      assert replaced.opt.ls_parallel == compiled.opt.ls_parallel == 0
      torch.testing.assert_close(replaced.opt.impratio,
                                 compiled.opt.impratio, rtol=0, atol=0)
    else:
      replaced = _with(m, **opt)
    for f in dataclasses.fields(compiled.opt):
      if not torch.is_tensor(getattr(compiled.opt, f.name)):
        assert getattr(replaced.opt, f.name) == getattr(compiled.opt,
                                                         f.name), f.name
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
  """Options outside the gate raise at every entry point. The elliptic
  cone and implicitfast have been opened since: with the cone (set as
  `override_model` sets it) the entry points run and take the kernel
  lists, whose solve stages are B3e and B4-elliptic; with implicitfast
  the glue list, whose solve stage is B3 in mode 2, and B4 in
  forward_batched."""
  m, d = humanoid
  names = lambda stages: [n for n, _ in stages]
  if opt.get('integrator') == IntegratorType.IMPLICITFAST:
    mm = _with(m, **opt)
    assert names(forward.batched_stages(mm, d)) == [
        'smooth_mega[cuda]', 'contact_efc_mega[cuda]', 'act_len_vel',
        'solve_glue[cuda]']
    assert forward.glue_mode(mm) == 2 and forward.replays(mm, d)
    assert names(forward.forward_stages(mm, d))[-1] == 'solve[cuda]'
    assert names(forward.unfused_stages(mm, d))[-2:] == [
        'solve[cuda]', 'implicitfast']
    _reset_counts()
    for entry in (mt.step_batched, mt.forward_batched, mt.step1):
      out = entry(mm, d)
      assert bool(torch.isfinite(out.qpos).all())
    assert bool(torch.isfinite(mt.step2(mm, out).qacc).all())
    assert solver.counts['solve'] == 0
    return
  if opt.get('cone') == ConeType.ELLIPTIC:
    mm = mt.override_model(m, ELLIPTIC)
    assert names(forward.batched_stages(mm, d)) == [
        'smooth_mega[cuda]', 'contact_efc_mega[cuda]', 'act_len_vel',
        'solve_glue[cuda]']
    assert names(forward.forward_stages(mm, d))[-1] == 'solve[cuda]'
    _reset_counts()
    for entry in (mt.step_batched, mt.forward_batched):
      out = entry(mm, d)
      assert bool(torch.isfinite(out.qacc).all())
      assert bool((out.efc_type == 7).any())         # elliptic rows
    assert solver.counts['solve'] == 0
    assert solver.cone_inputs(mm, d.contact) is not None
    return
  mm = _with(m, **opt)
  for entry in (mt.step_batched, mt.forward_batched, forward.batched_stages,
                forward.forward_stages):
    with pytest.raises(NotImplementedError):
      entry(mm, d)


def test_iterative_linesearch_still_raises(humanoid):
  """Named when the iterative linesearch (ls_parallel off) raised: a CG
  step with it now runs it, and the step's solve matches the JAX
  package's `_solve_xla` on the same inputs, both in float64: after 1
  and 3 passes qacc, qfrc_constraint and efc_force at 1e-9 of scale and
  solver_niter equal; converged (about 30 passes) CG's rounding has
  moved the two paths apart, 3e-4 of scale in qacc, so there at CG_TOL
  of tests/test_torch_cg.py."""
  m, d = humanoid
  over = ['opt.solver=cg', 'opt.ls_parallel=0']
  mm = mt.override_model(m, over)
  assert not mm.opt.ls_parallel and mm.opt.solver == SolverType.CG
  _reset_counts()
  out = mt.step_batched(mm, d)
  assert solver.counts['solve'] == 1 and bool(torch.isfinite(out.qpos).all())
  stages = forward.batched_stages(mm, d)
  pre = d
  for _, fn in stages[:[n for n, _ in stages].index('solve')]:
    pre = fn(pre)
  f64 = lambda x: x.double() if x.is_floating_point() else x
  inputs = ('qM', 'efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss',
            'efc_type', 'qfrc_smooth', 'qacc_smooth', 'qacc_warmstart')
  _, qld = kb.m_solve_factor(f64(pre.qM), f64(pre.qfrc_smooth),
                             m.dof_parentid)
  x64 = lambda t: jax.tree.map(lambda x: x.astype(jnp.float64) if hasattr(
      x, 'dtype') and x.dtype == jnp.float32 else x, t)
  with jax.enable_x64(True):
    jm = x64(jio.override_model(_models()[1], over))
    jd = x64(mjwt.make_data(jm, nconmax=NCONMAX))
    batch = jax.vmap(lambda *xs: jd.replace(**dict(zip(inputs, xs))))(
        *[jnp.asarray(f64(getattr(pre, k)).numpy()) for k in inputs])
    _, jqld = jsolver.m_solve_factor(jm, batch.qM, batch.qfrc_smooth)
    batch = batch.replace(qLD=jqld)
    # the iteration budget is an argument: one compile for all three
    run = jax.jit(lambda b, it: jsolver._solve_xla(dataclasses.replace(
        jm, opt=dataclasses.replace(jm.opt, iterations=it)), b))
    for budget in (1, 3, m.opt.iterations):
      ref = run(batch, jnp.int32(budget))
      ours = solver.solve(_with(mm, iterations=budget),
                          *[f64(getattr(pre, k)) for k in inputs], qLD=qld)
      np.testing.assert_array_equal(ours['solver_niter'].numpy(),
                                    np.asarray(ref.solver_niter))
      for name in ('qacc', 'qfrc_constraint', 'efc_force'):
        tol = 1e-9 if budget < 10 else CG_TOL[name]
        assert_close(ours[name].numpy(), np.asarray(getattr(ref, name)),
                     name, tol)
  assert 3 < int(ours['solver_niter'].max()) < m.opt.iterations


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
