"""Kernel B4's plain version (`solver.newton_solve`, which is
`solver.newton`) against the TPU kernel `newton_solve_batched` in
interpret mode on the same inputs:

* the random SPD problem of tests/test_solver_kernel.py:15-37 (8 worlds,
  nv 5, 9 one-sided rows, tolerance 1e-8, 30 iterations);
* a humanoid state before the solve at 8 worlds (nv 27, 117 rows), with
  a warm start, once without and once with the integration diagonal hb
  (`euler_damp`); one run of the TPU kernel with hb serves both, since
  hb enters only its final re-solve.

qacc, qacc_smooth and qacc_euler at 5e-5, qfrc_constraint and efc_force
at 5e-4 of scale (the step tolerances of tests/test_torch_step.py),
solver_niter within 4 per world, the factor of qM at 2e-5 (the TPU
kernel writes it by columns and leaves its upper triangle undefined, so
the lower triangles are compared). The wrapper `kernels.newton` runs the
plain version on CPU tensors and refuses them on its launch path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu.pallas import solver_kernels
from mujoco_warp_tpu_torch import forward, solver
from mujoco_warp_tpu_torch.kernels import newton as kn

from torch_parity import assert_close, build, shared, states

NAMES = ('qacc', 'qfrc_constraint', 'efc_force', 'solver_niter',
         'qacc_smooth', 'qLD', 'qacc_euler')
TOL = dict(qacc=5e-5, qacc_smooth=5e-5, qacc_euler=5e-5,
           qfrc_constraint=5e-4, efc_force=5e-4)


def _check(out, ref):
  ref = dict(zip(NAMES, ref))
  for name, tol in TOL.items():
    assert_close(out[name].numpy(), np.asarray(ref[name]), name, tol)
  dn = np.abs(out['solver_niter'].numpy().astype(np.int64) -
              np.asarray(ref['solver_niter'], np.int64))
  assert dn.max() <= 4, (out['solver_niter'], ref['solver_niter'])
  assert_close(np.tril(out['qLD'].numpy()), np.tril(np.asarray(ref['qLD'])),
               'qLD', 2e-5)
  assert not np.triu(out['qLD'].numpy(), 1).any()


def test_newton_solve_random_spd_problem():
  W, nv, nj = 8, 5, 9
  rng = np.random.default_rng(0)
  q = rng.normal(size=(W, nv, nv)).astype(np.float32)
  qm = q @ np.swapaxes(q, 1, 2) + 4 * np.eye(nv, dtype=np.float32)
  J = rng.normal(size=(W, nj, nv)).astype(np.float32)
  D = np.abs(rng.normal(size=(W, nj)).astype(np.float32))
  aref = rng.normal(size=(W, nj)).astype(np.float32)
  fl = np.zeros((W, nj), np.float32)
  qfs = rng.normal(size=(W, nv)).astype(np.float32)
  ws = np.zeros((W, nv), np.float32)
  ref = solver_kernels.newton_solve_batched(
      *[jnp.asarray(x) for x in (qm, J, D, aref, fl, qfs, ws)],
      jnp.float32(1e-8), jnp.float32(1.0), ne=0, nf=0, iterations=30,
      interpret=True)
  # any model serves: the solve reads its tolerance, iteration budget and
  # meaninertia, and the hopper has no equality or friction rows
  m = build('hopper')[2]
  m = m.replace(
      opt=m.opt.replace(tolerance=torch.tensor(1e-8), iterations=30),
      stat=m.stat.replace(meaninertia=torch.tensor(1.0)))
  assert mt.efc_layout(m, 0)[:2] == (0, 0)
  out = solver.newton_solve(m, *[torch.tensor(x) for x in (
      qm, J, D, aref, fl, qfs, ws)])
  _check(out, ref)
  x = np.linalg.solve(qm.astype(np.float64), qfs[..., None])[..., 0]
  np.testing.assert_allclose(out['qacc_smooth'].numpy(), x, atol=2e-5)
  assert int(out['solver_niter'].max()) <= 30
  torch.testing.assert_close(out['qacc_euler'], out['qacc'], rtol=0, atol=0)


@pytest.fixture(scope='module')
def presolve():
  """The humanoid before the solve stage, 8 worlds, one step in."""
  mjm, _, m = build('humanoid')
  q, v = states(mjm, 8, nstep=150, qpos_noise=0.02)
  c = (0.3 * np.random.default_rng(1).standard_normal(
      (8, mjm.nu))).astype(np.float32)
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=24)
  d = mt.step_batched(m, d)
  stages = forward.forward_stages(m, d)
  assert stages[-1][0] == 'solve[cuda]'
  for _, fn in stages[:-1]:
    d = fn(d)
  return m, d


def _inputs(d):
  return (d.qM, d.efc_J, d.efc_D, d.efc_aref, d.efc_frictionloss,
          d.qfrc_smooth, d.qacc_warmstart)


@pytest.fixture(scope='module')
def reference(presolve):
  """The TPU kernel's outputs at the humanoid state, with euler_damp and
  hb: the re-solve writes qacc_euler alone, so the other outputs are
  also those of the kernel without it (one interpret-mode compile for
  both cases, and for the run: `shared`)."""
  m, d = presolve
  hb = m.opt.timestep * m.dof_damping
  ne, nf, _, _, _ = mt.efc_layout(m, 24)
  return hb, shared('newton_reference', lambda: tuple(
      np.asarray(x) for x in solver_kernels.newton_solve_batched(
          *[jnp.asarray(x.numpy()) for x in _inputs(d)],
          jnp.asarray(m.opt.tolerance.numpy()),
          jnp.asarray(m.stat.meaninertia.numpy()), jnp.asarray(hb.numpy()),
          ne=ne, nf=nf, iterations=m.opt.iterations, euler_damp=True,
          interpret=True)))


@pytest.mark.parametrize('euler_damp', [False, True])
def test_newton_solve_humanoid_state(presolve, reference, euler_damp):
  m, d = presolve
  assert int(d.ncon.min()) > 0 and bool((d.qacc_warmstart != 0).any())
  hb, ref = reference
  hb = hb if euler_damp else None
  if not euler_damp:        # without euler_damp qacc_euler is qacc
    ref = ref[:6] + (ref[0],)
  kn.launches = 0
  out = kn.newton_solve(m, *_inputs(d), hb=hb)
  assert kn.launches == 0                  # CPU tensors: the plain version
  _check(out, ref)
  assert int(out['solver_niter'].max()) > 0
  if euler_damp:
    assert float((out['qacc_euler'] - out['qacc']).abs().max()) > 0
    a = d.qM.double() + torch.diag(hb.double())
    rhs = d.qfrc_smooth.double() + out['qfrc_constraint'].double()
    x = torch.linalg.solve(a, rhs)
    assert_close(out['qacc_euler'].numpy(), x.numpy(), 'qacc_euler', 5e-5)
  else:
    torch.testing.assert_close(out['qacc_euler'], out['qacc'], rtol=0,
                               atol=0)


def test_newton_wrapper_refuses_cpu_tensors_and_models_past_its_caps(
    presolve):
  m, d = presolve
  kn.launches = 0
  with pytest.raises(ValueError, match='expected a tensor on'):
    kn._launch(m, *_inputs(d))
  big = torch.zeros(2, kn.MAXNJ + 1, m.nv)
  with pytest.raises(ValueError, match='cap'):
    kn._launch(m, d.qM[:2], big, big[..., 0], big[..., 0], big[..., 0],
               d.qfrc_smooth[:2], d.qacc_warmstart[:2])
  assert kn.launches == 0


def test_forward_with_the_newton_kernel_stage(presolve):
  """The solve[cuda] stage fills what fwd_acceleration left out:
  qacc_smooth and the factor of qM."""
  m, d = presolve
  stages = forward.forward_stages(m, d)
  stale = d.replace(qacc_smooth=torch.full_like(d.qacc_smooth, 7.0),
                    qLD=torch.full_like(d.qLD, 7.0))
  kept = stages[-2][1](stale)               # fwd_acceleration skips both
  assert stages[-2][0] == 'fwd_acceleration'
  assert bool((kept.qacc_smooth == 7.0).all() and (kept.qLD == 7.0).all())
  out = stages[-1][1](kept)
  x = torch.linalg.solve(d.qM.double(), d.qfrc_smooth.double())
  assert_close(out.qacc_smooth.numpy(), x.numpy(), 'qacc_smooth', 5e-5)
  L = out.qLD.double()
  assert_close((L @ L.transpose(1, 2)).numpy(), d.qM.numpy(), 'L Lᵀ', 2e-6)
