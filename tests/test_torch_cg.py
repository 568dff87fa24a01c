"""The port's CG solve (`solver.solve` with `opt.solver == CG`, kernel
B6's or B8's plain version as the preconditioner) against the JAX
package's `solver._solve_xla` on the same inputs: qM, the efc rows,
qfrc_smooth, qacc_smooth, a warm start and the factor of qM, from
humanoid (nv 27: lower Cholesky factor, B6) and three_humanoids (nv 81:
packed tree LD, B8) states with contacts. The JAX package on the CPU
preconditions with a dense Cholesky factor at both sizes, so it gets its
own `m_solve_factor` of the same qM.

Two kinds of check:

* with the iteration budget cut to 1 and 3, both stop after the same
  passes and the two paths have not parted yet: qacc at 5e-5,
  qfrc_constraint and efc_force at 5e-4 of scale (the step tolerances of
  tests/test_torch_step.py). This holds the preconditioned gradient, the
  Polak-Ribière direction and the masked commit operation for operation;
* converged, CG is compared at its answer, not per iteration: float32
  reordering changes beta and the path, and the stopping rule (cost
  improvement below tolerance) leaves qacc further from the optimum than
  Newton does. On these inputs, when qfrc_smooth changes by one ulp the
  port's own CG answer moves by 1.9e-4 (qacc), 7.0e-4 (qfrc_constraint)
  and 4.1e-3 (efc_force: the rows of a pyramid share a contact's force,
  so single rows move most) of scale, and both packages' CG end up to
  8.4e-4, 9.8e-4 and 3.1e-3 from the float64 Newton optimum. So the
  converged answers are held at CG_TOL (qacc 2e-3, qfrc_constraint 5e-3,
  efc_force 2e-2 of scale, about five times that spread) against the JAX
  package and against the port's own Newton solve in float64, and
  solver_niter loosely (within the budget, and within a third of the JAX
  count plus 4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu import solver as jsolver
from mujoco_warp_tpu_torch import forward, models, solver
from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
from mujoco_warp_tpu_torch.types import SolverType

from torch_parity import SCENES, assert_close, states

NWORLD = 4
INPUTS = ('qM', 'efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss', 'efc_type',
          'qfrc_smooth', 'qacc_smooth', 'qacc_warmstart')
CG_TOL = dict(qacc=2e-3, qfrc_constraint=5e-3, efc_force=2e-2)
NCONMAX = {'humanoid': 24, 'three_humanoids': 100}


def _cg_inputs(scene):
  """(JAX Model, port Model, port Data before the solve stage) with the
  CG solver, one step in (which sets the warm start)."""
  if scene == 'three_humanoids':
    mjm = mujoco.MjModel.from_xml_path(models.THREE_HUMANOIDS)
  else:
    mjm = mujoco.MjModel.from_xml_string(SCENES[scene])
  mjm.opt.solver = int(SolverType.CG)
  jm, m = mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')
  q, v = states(mjm, NWORLD, nstep=150, qpos_noise=0.05)
  c = (0.3 * np.random.default_rng(2).standard_normal(
      (NWORLD, mjm.nu))).astype(np.float32)
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c),
                         nconmax=NCONMAX[scene])
  d = mt.step_batched(m, d)
  stages = forward.batched_stages(m, d)
  for name, fn in stages[:[n for n, _ in stages].index('solve')]:
    d = fn(d)
  return jm, m, d


@pytest.fixture(scope='module', params=['humanoid', 'three_humanoids'])
def problem(request):
  scene = request.param
  jm, m, d = _cg_inputs(scene)
  jd = mjwt.make_data(jm, nconmax=NCONMAX[scene])
  batch = jax.vmap(lambda *xs: jd.replace(**dict(zip(INPUTS, xs))))(
      *[jnp.asarray(getattr(d, k).numpy()) for k in INPUTS])
  _, jqld = jsolver.m_solve_factor(jm, batch.qM, batch.qfrc_smooth)
  batch = batch.replace(qpos=jnp.asarray(d.qpos.numpy()), qLD=jqld)
  return scene, jm, m, d, batch


def _port_solve(m, d):
  return solver.solve(m, *[getattr(d, k) for k in INPUTS], qLD=d.qLD)


_COMPILED = {}


def _jax_solve(jm, batch, iterations=None):
  """`_solve_xla`, compiled once per model: the iteration budget is an
  argument of the compiled function."""
  if id(jm) not in _COMPILED:
    _COMPILED[id(jm)] = (jm, jax.jit(lambda dd, it: jsolver._solve_xla(
        dataclasses.replace(jm, opt=dataclasses.replace(jm.opt,
                                                        iterations=it)),
        dd)))
  it = jm.opt.iterations if iterations is None else iterations
  return _COMPILED[id(jm)][1](batch, jnp.int32(it))


def test_qld_layout_follows_nv(problem):
  scene, _, m, d, _ = problem
  nv = m.nv
  ld = d.qLD.double().numpy()
  qM = d.qM.double().numpy()
  if scene == 'humanoid':
    assert not kb.uses_tree_factor(nv)
    assert not np.triu(ld, 1).any()
    assert_close(ld @ ld.transpose(0, 2, 1), qM, 'L Lᵀ', 2e-6)
  else:
    assert kb.uses_tree_factor(nv)
    L = np.tril(ld, -1) + np.eye(nv)
    dd = np.diagonal(ld, axis1=1, axis2=2)
    assert_close(L.transpose(0, 2, 1) @ (dd[:, :, None] * L), qM, 'LᵀDL',
                 2e-6)


@pytest.mark.parametrize('iterations', [1, 3])
def test_cg_passes_match_jax(problem, iterations):
  _, jm, m, d, batch = problem
  mm = m.replace(opt=m.opt.replace(iterations=iterations))
  solver.counts.update(dict.fromkeys(solver.counts, 0))
  out = _port_solve(mm, d)
  ref = _jax_solve(jm, batch, iterations)
  assert solver.counts == {'solve': 1, 'passes': iterations,
                            'linesearch': 0}
  np.testing.assert_array_equal(out['solver_niter'].numpy(),
                                np.asarray(ref.solver_niter))
  assert int(out['solver_niter'].max()) == iterations
  assert_close(out['qacc'].numpy(), np.asarray(ref.qacc), 'qacc', 5e-5)
  for name in ('qfrc_constraint', 'efc_force'):
    assert_close(out[name].numpy(), np.asarray(getattr(ref, name)), name,
                 5e-4)


def test_cg_converged_matches_jax_and_newton(problem):
  _, jm, m, d, batch = problem
  assert int(d.ncon.min()) > 0 and bool((d.qacc_warmstart != 0).any())
  solver.counts.update(dict.fromkeys(solver.counts, 0))
  kb.launches.update(dict.fromkeys(kb.launches, 0))
  out = _port_solve(m, d)
  assert solver.counts['solve'] == 1
  assert solver.counts['passes'] == int(out['solver_niter'].max()) > 0
  assert kb.launches == dict.fromkeys(kb.launches, 0)   # CPU: plain
  ref = _jax_solve(jm, batch)
  niter = out['solver_niter'].numpy().astype(np.int64)
  ref_niter = np.asarray(ref.solver_niter, np.int64)
  assert niter.max() < m.opt.iterations and ref_niter.max() < m.opt.iterations
  assert (np.abs(niter - ref_niter) <= ref_niter // 3 + 4).all(), (
      niter, ref_niter)
  for name in ('qacc', 'qfrc_constraint', 'efc_force'):
    assert_close(out[name].numpy(), np.asarray(getattr(ref, name)), name,
                 CG_TOL[name])
  # the optimum itself: the port's Newton solve of the same problem in
  # float64
  newton = m.replace(opt=m.opt.replace(solver=int(SolverType.NEWTON)))
  f64 = lambda x: x.double() if x.is_floating_point() else x
  opt = solver.solve(newton, *[f64(getattr(d, k)) for k in INPUTS])
  for name in ('qacc', 'qfrc_constraint'):
    assert_close(out[name].numpy(), opt[name].numpy(), name + ' vs Newton',
                 CG_TOL[name])
    assert_close(np.asarray(getattr(ref, name)), opt[name].numpy(),
                 name + ' (JAX) vs Newton', CG_TOL[name])


def test_cg_needs_the_factor(problem):
  _, _, m, d, _ = problem
  with pytest.raises(ValueError, match='qLD'):
    solver.solve(m, *[getattr(d, k) for k in INPUTS])


def test_a_factor_in_the_other_layout_gives_another_answer(problem):
  """B6 fed an LD, or B8 an L, returns finite wrong numbers: this is why
  `m_solve_factor` and `m_cho_solve` share `uses_tree_factor`."""
  scene, _, m, d, _ = problem
  grad = d.qfrc_smooth
  right = kb.m_cho_solve(d.qLD, grad, m.dof_parentid)
  if scene == 'humanoid':
    wrong = kb.tree_solve(d.qLD, grad, m.dof_parentid)
  else:
    wrong = kb.cho_solve(d.qLD, grad)
  assert_close(right.numpy(), d.qacc_smooth.numpy(), 'M⁻¹ qfrc_smooth', 2e-5)
  scale = float(right.abs().max())
  assert bool(torch.isfinite(wrong).all())
  assert float((wrong - right).abs().max()) > 1e-2 * scale
