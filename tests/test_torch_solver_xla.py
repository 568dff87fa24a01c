"""The port's solve of the unfused step (`solver.solve`, Newton with the
parallel linesearch and kernel B5's plain version for each direction)
against the JAX package's `solver.solve`, which runs its XLA branch on
the CPU, on the same inputs: qM, the efc rows, qfrc_smooth, qacc_smooth
and a warm start from three_humanoids states with contacts.

Same algorithm, so qacc is held at 5e-5 and qfrc_constraint and efc_force
at 5e-4 (scale-relative, the step tolerances of tests/test_torch_step.py)
and solver_niter within 2 per world."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu import solver as jsolver
from mujoco_warp_tpu_torch import forward, solver

from torch_parity import assert_close, build, states

NWORLD = 4
NCONMAX = 100
INPUTS = ('qM', 'efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss', 'efc_type',
          'qfrc_smooth', 'qacc_smooth', 'qacc_warmstart')


@pytest.fixture(scope='module')
def inputs():
  """The solve's inputs after one port step (which sets the warm start)
  and the stages before the solve of the next."""
  mjm, jm, m = build('three_humanoids')
  q, v = states(mjm, NWORLD, nstep=150, qpos_noise=0.05)
  c = (0.3 * np.random.default_rng(2).standard_normal(
      (NWORLD, mjm.nu))).astype(np.float32)
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=NCONMAX)
  d = mt.step_batched(m, d)
  stages = forward.batched_stages(m, d)
  for name, fn in stages[:[n for n, _ in stages].index('solve')]:
    d = fn(d)
  return jm, m, d


def test_solve_matches_jax_xla_solver(inputs):
  jm, m, d = inputs
  assert int(d.ncon.min()) > 0 and bool((d.qacc_warmstart != 0).any())
  solver.counts.update(dict.fromkeys(solver.counts, 0))
  out = solver.solve(m, *[getattr(d, k) for k in INPUTS])
  assert solver.counts['solve'] == 1
  assert solver.counts['passes'] == int(out['solver_niter'].max()) > 0

  jd = mjwt.make_data(jm, nconmax=NCONMAX)
  batch = jax.vmap(lambda *xs: jd.replace(**dict(zip(INPUTS, xs))))(
      *[jnp.asarray(getattr(d, k).numpy()) for k in INPUTS])
  batch = batch.replace(qpos=jnp.asarray(d.qpos.numpy()))
  ref = jax.jit(lambda dd: jsolver.solve(jm, dd))(batch)
  assert_close(out['qacc'].numpy(), np.asarray(ref.qacc), 'qacc', 5e-5)
  for name in ('qfrc_constraint', 'efc_force'):
    assert_close(out[name].numpy(), np.asarray(getattr(ref, name)), name,
                 5e-4)
  dn = np.abs(out['solver_niter'].numpy().astype(np.int64) -
              np.asarray(ref.solver_niter, np.int64))
  assert dn.max() <= 2, (out['solver_niter'], ref.solver_niter)


def test_solve_refuses_the_iterative_linesearch(inputs):
  """Named when the iterative linesearch (ls_parallel off) raised: the
  same Newton solve with it now runs it and reaches the optimum the
  parallel linesearch reaches, its objective within one unit of
  tolerance · meaninertia · nv (float64). The iterative linesearch is
  held against the JAX package's `_solve_xla` in
  tests/test_torch_forward.py (CG) and tests/test_torch_elliptic_solve.py
  (the elliptic cone)."""
  _, m, d = inputs
  f64 = lambda x: x.double() if x.is_floating_point() else x
  args = [f64(getattr(d, k)) for k in INPUTS]
  solver.counts.update(dict.fromkeys(solver.counts, 0))
  it = solver.solve(m.replace(opt=m.opt.replace(ls_parallel=0)), *args)
  assert solver.counts['passes'] == int(it['solver_niter'].max()) > 0
  par = solver.solve(m, *args)
  ne, nf, _, _, _ = mt.efc_layout(m, 0)
  rf = args[4] / torch.clamp(args[2], min=solver.MINVAL)
  masks = solver._row_masks(d.efc_type)

  def objective(qacc):
    jaref = torch.einsum('wrn,wn->wr', args[1], qacc) - args[3]
    _, cost, _ = solver._update_constraint(jaref, args[2], args[4], rf,
                                           *masks)
    ma = torch.einsum('wij,wj->wi', args[0], qacc)
    return 0.5 * ((ma - args[6]) * (qacc - args[7])).sum(1) + cost[:, 0]
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * m.nv
  gap = (objective(it['qacc']) - objective(par['qacc'])) / unit
  assert float(gap.abs().max()) <= 1.0, gap
