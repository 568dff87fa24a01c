"""three_humanoids (nv 81) through the port's unfused step against the JAX
package: 3 batched port steps (plain path on the CPU) against 3 steps of
jax.vmap(mujoco_warp_tpu.step) from C MuJoCo states with contacts.

Tolerances are scale-relative: STEP_TOL of tests/test_torch_step.py,
cam_xpos and light_xpos at 5e-6 (positions, as qpos), solver_niter within
4 per world. qLD is not compared elementwise: the JAX package on the CPU
stores a dense Cholesky factor there, the port the packed tree LD, so
the test holds the port's factor to qM and to qacc_smooth instead. The
JAX step is compiled once for the module (about a minute on the CPU), by
the one test that compares with it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import forward, solver
from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
from mujoco_warp_tpu_torch.utils import benchmark as tbench

from test_torch_step import STEP_TOL
from torch_parity import assert_close, build, states

NWORLD = 2
NCONMAX = 100
NSTEP = 3


def _start():
  mjm, jm, m = build('three_humanoids')
  q, v = states(mjm, NWORLD, nstep=150, qpos_noise=0.02)
  c = (0.3 * np.random.default_rng(1).standard_normal(
      (NWORLD, mjm.nu))).astype(np.float32)
  return jm, m, q, v, c


@pytest.fixture(scope='module')
def stepped():
  """The port's NSTEP steps, from launch and solve counts at 0; the JAX
  reference is a fixture of its own, so that only the test that compares
  with it compiles the JAX step (each xdist worker that runs a test of
  this module builds the module's fixtures)."""
  _, m, q, v, c = _start()
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=NCONMAX)
  kb.launches.update(dict.fromkeys(kb.launches, 0))
  solver.counts.update(dict.fromkeys(solver.counts, 0))
  for _ in range(NSTEP):
    d = mt.step_batched(m, d)
  return m, d


@pytest.fixture(scope='module')
def jax_stepped():
  """NSTEP steps of jax.vmap(mujoco_warp_tpu.step) from the same state."""
  jm, _, q, v, c = _start()
  jd = mjwt.make_data(jm, nconmax=NCONMAX)
  br = jax.vmap(lambda qq, vv, cc: jd.replace(qpos=qq, qvel=vv, ctrl=cc))(
      jnp.asarray(q), jnp.asarray(v), jnp.asarray(c))
  step = jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd)))
  for _ in range(NSTEP):
    br = step(br)
  return br


def test_three_humanoids_step_matches_jax(stepped, jax_stepped):
  (m, d), br = stepped, jax_stepped
  assert int(np.asarray(br.ncon).sum()) > 0
  for name, tol in STEP_TOL + (('cam_xpos', 5e-6), ('light_xpos', 5e-6),
                               ('cam_xmat', 5e-6), ('light_xdir', 5e-6)):
    assert_close(getattr(d, name).numpy(), np.asarray(getattr(br, name)),
                 name, tol)
  dn = np.abs(d.solver_niter.numpy().astype(np.int64) -
              np.asarray(br.solver_niter, np.int64))
  assert dn.max() <= 4
  np.testing.assert_array_equal(d.ncon.numpy(), np.asarray(br.ncon))


def test_three_humanoids_packed_factor(stepped):
  """The port's qLD is the packed tree LD of qM: Lᵀ D L rebuilds qM and
  solving with it gives qacc_smooth."""
  m, d = stepped
  ld = d.qLD.double().numpy()
  nv = m.nv
  for w in range(d.nworld):
    L = np.tril(ld[w], -1) + np.eye(nv)
    dd = np.diag(ld[w])
    A = L.T @ (dd[:, None] * L)
    qM = d.qM[w].double().numpy()
    assert_close(A, qM, 'LᵀDL', 2e-6)
    x = np.linalg.solve(A, d.qfrc_smooth[w].double().numpy())
    assert_close(d.qacc_smooth[w].numpy(), x, 'qacc_smooth', 2e-5)


def test_three_humanoids_stages_and_counts(stepped):
  m, d = stepped
  names = [n for n, _ in forward.batched_stages(m, d)]
  assert names == ['smooth_mega[cuda]', 'camlight', 'contact_efc_mega[cuda]',
                   'transmission', 'velocity_glue', 'passive',
                   'fwd_actuation', 'fwd_acceleration', 'solve', 'euler']
  assert not forward.uses_glue_kernel(m, d)
  # the CPU runs the plain versions and launches nothing; the solve
  # counted one call per step and its passes are the slowest worlds'
  assert kb.launches == dict.fromkeys(kb.launches, 0)
  assert solver.counts['solve'] == NSTEP
  assert solver.counts['passes'] >= int(d.solver_niter.max())
  hm = build('humanoid')[2]
  hd = mt.make_data(hm, nconmax=24)
  assert forward.uses_glue_kernel(hm, hd)
  assert [n for n, _ in forward.batched_stages(hm, hd)] == [
      'smooth_mega[cuda]', 'contact_efc_mega[cuda]', 'act_len_vel',
      'solve_glue[cuda]']
  assert bool(torch.isfinite(d.qpos).all())
  # the harness's control noise and loop run the unfused list
  solver.counts.update(dict.fromkeys(solver.counts, 0))
  d2, res = tbench.benchmark(m, d, nstep=0)   # a first and a timed step
  assert solver.counts['solve'] == 2 and res['nstep'] == 1
  assert res['solver_niter_max'] == int(d2.solver_niter.max())
  assert bool(torch.isfinite(d2.qpos).all())
