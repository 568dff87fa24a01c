"""three_humanoids (nv 81) with the CG solver through the port's unfused
step against the JAX package: 2 batched port steps (plain path on the
CPU) against 2 steps of jax.vmap(mujoco_warp_tpu.step) from C MuJoCo
states with contacts. The solver is selected on the loaded Model
(`m.replace(opt=m.opt.replace(solver=CG))`), as on the card.

CG is held at its converged answer (see tests/test_torch_forward.py):
what the solver moves at CG_STEP_TOL against the JAX package's CG step
and against the port's own Newton step of the same states, the rest at
STEP_TOL. The JAX step is compiled once for the module (about a minute
and a half on the CPU), by the one test that compares with it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import forward, solver
from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
from mujoco_warp_tpu_torch.types import SolverType

from test_torch_forward import CG_STEP_TOL, _compare
from test_torch_step import STEP_TOL
from torch_parity import build, states

NWORLD = 2
NCONMAX = 100
NSTEP = 2
TOLS = tuple((k, CG_STEP_TOL.get(k, t)) for k, t in STEP_TOL)


def _start():
  mjm, jm, m = build('three_humanoids')
  q, v = states(mjm, NWORLD, nstep=150, qpos_noise=0.02)
  c = (0.3 * np.random.default_rng(1).standard_normal(
      (NWORLD, mjm.nu))).astype(np.float32)
  return jm, m, q, v, c


@pytest.fixture(scope='module')
def stepped():
  """The port's NSTEP CG steps from solve counts at 0, and its Newton
  steps from the same state; the JAX reference is a fixture of its own,
  so that only the test that compares with it compiles the JAX step."""
  _, newton, q, v, c = _start()
  m = newton.replace(opt=newton.opt.replace(solver=int(SolverType.CG)))
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=NCONMAX)
  d_newton = d
  kb.launches.update(dict.fromkeys(kb.launches, 0))
  solver.counts.update(dict.fromkeys(solver.counts, 0))
  for _ in range(NSTEP):
    d = mt.step_batched(m, d)
  counts = dict(solver.counts)
  for _ in range(NSTEP):
    d_newton = mt.step_batched(newton, d_newton)
  return m, d, d_newton, counts


@pytest.fixture(scope='module')
def jax_stepped():
  """NSTEP CG steps of jax.vmap(mujoco_warp_tpu.step) from the same
  state."""
  jm, _, q, v, c = _start()
  jm = jm.replace(opt=jm.opt.replace(solver=int(SolverType.CG)))
  jd = mjwt.make_data(jm, nconmax=NCONMAX)
  br = jax.vmap(lambda qq, vv, cc: jd.replace(qpos=qq, qvel=vv, ctrl=cc))(
      jnp.asarray(q), jnp.asarray(v), jnp.asarray(c))
  step = jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd)))
  for _ in range(NSTEP):
    br = step(br)
  return br


def test_three_humanoids_cg_step_matches_jax(stepped, jax_stepped):
  (m, d, _, _), br = stepped, jax_stepped
  assert int(np.asarray(br.ncon).sum()) > 0
  _compare(d, br, TOLS)
  np.testing.assert_array_equal(d.ncon.numpy(), np.asarray(br.ncon))
  assert 0 < int(d.solver_niter.max()) < m.opt.iterations
  assert int(np.asarray(br.solver_niter).max()) < m.opt.iterations


def test_three_humanoids_cg_step_matches_the_newton_step(stepped):
  _, d, d_newton, _ = stepped
  _compare(d, d_newton, TOLS)


def test_three_humanoids_cg_stages_and_counts(stepped):
  m, d, _, counts = stepped
  names = [n for n, _ in forward.batched_stages(m, d)]
  assert names == ['smooth_mega[cuda]', 'camlight', 'contact_efc_mega[cuda]',
                   'transmission', 'velocity_glue', 'passive',
                   'fwd_actuation', 'fwd_acceleration', 'solve', 'euler']
  assert not forward.uses_glue_kernel(m, d)
  assert not forward.uses_newton_kernel(m, d)
  # the CPU ran the plain versions and launched nothing; the solve ran
  # once per step and its passes are the slowest worlds'
  assert kb.launches == dict.fromkeys(kb.launches, 0)
  assert counts['solve'] == NSTEP
  assert counts['passes'] >= int(d.solver_niter.max())
  # qLD is B7's packed LD of qM: the preconditioner B8 reads
  assert kb.uses_tree_factor(m.nv)
  x = kb.m_cho_solve(d.qLD, d.qfrc_smooth, m.dof_parentid)
  ref = torch.linalg.solve(d.qM.double(), d.qfrc_smooth.double())
  scale = float(ref.abs().max())
  assert float((x.double() - ref).abs().max()) <= 2e-5 * scale
