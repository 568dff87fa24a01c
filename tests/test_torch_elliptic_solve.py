"""The port's solves with the elliptic cone against the JAX package's
`solver._solve_xla`, which runs the iterative linesearch on the CPU, on
the same inputs: qM, the efc rows, qfrc_smooth, qacc_smooth, a warm start
and the contacts' friction and dim, from humanoid states with contacts
(elliptic cone, impratio 10, one step in).

* `solver.solve` (the unfused solve: the cone's constraint update, its
  Hessian blocks with the Tikhonov floor, the cone terms of the
  iterative linesearch) is the same algorithm as `_solve_xla`. Run both
  in float64, they agree to rounding: qacc, qfrc_constraint and efc_force
  at 1e-9 of scale and solver_niter exactly, after 1 and 3 iterations and
  converged, for Newton and for CG (CG converged at CG_TOL of
  tests/test_torch_cg.py: over tens of passes its rounding moves the two
  paths apart even in float64). In float32 the elliptic problem
  amplifies rounding: one iteration in, the port's and the JAX package's
  float32 qacc each lie about 5e-5 of scale from the float64 answer, and
  after three about 1e-3 (the Hessian's condition number is about 6e4 at
  impratio 10). So the float32 solve is held at its converged answer, at
  2e-3 of scale (qacc, qfrc_constraint) and 1e-2 (efc_force) from the
  float64 one.
* `solver.newton_solve` with the cone (the plain version of kernels B3e
  and B4-elliptic) follows the TPU kernel's linesearch (a bracket, a
  secant and 4 polish steps), not the iterative one, so it is held to the
  same problem's optimum: its objective no higher than that of
  `_solve_xla`'s converged answer plus one unit of tolerance ·
  meaninertia · nv (float64, and float32 for the port's side). One-sided:
  on these inputs `_solve_xla` stops in 2 of the 4 worlds on its
  gradient rule while its next Newton step would still gain 4.3e3 and
  1.3e4 units (the cone makes H nearly singular along a sliding
  direction), where the kernel's solve goes on to the lower cost. After
  one iteration, where both linesearches find the minimum along the same
  first direction, qacc is held at 1e-5 of scale (float64).

The JAX solve is compiled once per solver for the module: the iteration
budget is an argument of the compiled function, not a constant of it.
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
from mujoco_warp_tpu_torch import forward, solver
from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
from mujoco_warp_tpu_torch.types import ConeType, SolverType

from test_torch_cg import CG_TOL
from torch_parity import SCENES, assert_close, states

NWORLD = 4
INPUTS = ('qM', 'efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss', 'efc_type',
          'qfrc_smooth', 'qacc_smooth', 'qacc_warmstart')
CONTACT = ('friction', 'dim', 'geom')
TOL64 = 1e-9
TOL32 = dict(qacc=2e-3, qfrc_constraint=2e-3, efc_force=1e-2)


def _f64(x):
  return x.double() if x.is_floating_point() else x


def _x64(tree):
  return jax.tree.map(
      lambda x: x.astype(jnp.float64)
      if hasattr(x, 'dtype') and x.dtype == jnp.float32 else x, tree)


@pytest.fixture(scope='module')
def problem():
  """(JAX Model, port Model, port Data before the solve stage) of the
  elliptic humanoid, and the JAX batch of the same inputs in float64."""
  mjm = mujoco.MjModel.from_xml_string(SCENES['humanoid'])
  mjm.opt.cone = int(ConeType.ELLIPTIC)
  mjm.opt.impratio = 10
  jm, m = mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')
  assert not m.opt.ls_parallel and not jm.opt.ls_parallel
  q, v = states(mjm, NWORLD, nstep=150, qpos_noise=0.02)
  c = (0.3 * np.random.default_rng(1).standard_normal(
      (NWORLD, mjm.nu))).astype(np.float32)
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=24)
  d = mt.step_batched(m, d)
  stages = forward.forward_stages(m, d)
  for _, fn in stages[:-1]:
    d = fn(d)
  with jax.enable_x64(True):
    jd = _x64(mjwt.make_data(jm, nconmax=24))
    arrays = ([jnp.asarray(_f64(getattr(d, k)).numpy()) for k in INPUTS] +
              [jnp.asarray(getattr(d.contact, k).numpy()) for k in CONTACT])

    def one(*xs):
      dd = jd.replace(**dict(zip(INPUTS, xs)))
      return dd.replace(contact=dd.contact.replace(
          **dict(zip(CONTACT, xs[len(INPUTS):]))))
    batch = jax.vmap(one)(*arrays)
    _, qld = jsolver.m_solve_factor(_x64(jm), batch.qM, batch.qfrc_smooth)
    batch = batch.replace(qLD=qld)
  return jm, m, d, batch


_COMPILED = {}


def _jax_solve(jm, batch, solver_type, iterations):
  """`_solve_xla` in float64, compiled once per solver."""
  with jax.enable_x64(True):
    if solver_type not in _COMPILED:
      jmm = _x64(jm.replace(opt=jm.opt.replace(solver=int(solver_type))))

      def run(dd, it):
        return jsolver._solve_xla(
            dataclasses.replace(jmm, opt=dataclasses.replace(
                jmm.opt, iterations=it)), dd)
      _COMPILED[solver_type] = jax.jit(run)
    return _COMPILED[solver_type](batch, jnp.int32(iterations))


def _port(m, d, solver_type, iterations, dtype=torch.float64):
  mm = m.replace(opt=m.opt.replace(solver=int(solver_type),
                                   iterations=iterations))
  cast = _f64 if dtype == torch.float64 else (lambda x: x)
  cone = solver.cone_inputs(mm, d.contact)
  cone = (cast(cone[0]), cone[1], cast(cone[2]))
  qld = None
  if solver_type == SolverType.CG:
    _, qld = kb.m_solve_factor(cast(d.qM), cast(d.qfrc_smooth),
                               m.dof_parentid)
  return solver.solve(mm, *[cast(getattr(d, k)) for k in INPUTS], qLD=qld,
                      cone=cone)


def _compare(out, ref, tols):
  for name in ('qacc', 'qfrc_constraint', 'efc_force'):
    tol = tols[name] if isinstance(tols, dict) else tols
    assert_close(out[name].numpy(), np.asarray(getattr(ref, name)), name,
                 tol)


@pytest.mark.parametrize('solver_type', [SolverType.NEWTON, SolverType.CG],
                         ids=['newton', 'cg'])
@pytest.mark.parametrize('iterations', [1, 3, 100])
def test_solve_matches_jax_in_float64(problem, solver_type, iterations):
  jm, m, d, batch = problem
  assert int(d.ncon.min()) > 0 and bool((d.qacc_warmstart != 0).any())
  solver.counts.update(dict.fromkeys(solver.counts, 0))
  out = _port(m, d, solver_type, iterations)
  ref = _jax_solve(jm, batch, solver_type, iterations)
  assert solver.counts['solve'] == 1
  np.testing.assert_array_equal(out['solver_niter'].numpy(),
                                np.asarray(ref.solver_niter))
  if iterations < 100:
    assert int(out['solver_niter'].max()) == iterations
  else:
    assert int(out['solver_niter'].max()) < iterations
  cg_converged = solver_type == SolverType.CG and iterations == 100
  _compare(out, ref, CG_TOL if cg_converged else TOL64)


def test_solve_float32_converged(problem):
  jm, m, d, batch = problem
  out = _port(m, d, SolverType.NEWTON, m.opt.iterations, torch.float32)
  ref = _jax_solve(jm, batch, SolverType.NEWTON, m.opt.iterations)
  _compare(out, ref, TOL32)
  dn = np.abs(out['solver_niter'].numpy().astype(np.int64) -
              np.asarray(ref.solver_niter, np.int64))
  assert dn.max() <= 4, (out['solver_niter'], ref.solver_niter)


def _objective(m, d, qacc):
  """The elliptic problem's cost at qacc (W,), in float64."""
  x = [_f64(getattr(d, k)) for k in ('qM', 'efc_J', 'efc_D', 'efc_aref',
                                      'efc_frictionloss', 'qfrc_smooth')]
  friction, dim, impratio = solver.cone_inputs(m, d.contact)
  cone = solver.Cone(m, x[2], (_f64(friction), dim, _f64(impratio)))
  qsm = torch.linalg.solve(x[0], x[5])
  ne, nf, _, _, _ = mt.efc_layout(m, 0)
  qacc = _f64(torch.tensor(np.array(qacc)))
  return solver.objective(*x, qsm, qacc, ne, nf, cone=cone)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['float64', 'float32'])
def test_newton_reaches_the_jax_optimum(problem, dtype):
  jm, m, d, batch = problem
  cast = _f64 if dtype == torch.float64 else (lambda x: x)
  args = [cast(getattr(d, k)) for k in (
      'qM', 'efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss', 'qfrc_smooth',
      'qacc_warmstart')]
  friction, dim, impratio = solver.cone_inputs(m, d.contact)
  cone = (cast(friction), dim, cast(impratio))
  out = solver.newton_solve(m, *args, cone=cone)
  ref = _jax_solve(jm, batch, SolverType.NEWTON, m.opt.iterations)
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * m.nv
  gap = (_objective(m, d, out['qacc']) -
         _objective(m, d, np.asarray(ref.qacc))) / unit
  assert float(gap.max()) <= 1.0, gap
  assert int(out['solver_niter'].max()) < m.opt.iterations
  if dtype == torch.float64:
    one = solver.newton_solve(m.replace(opt=m.opt.replace(iterations=1)),
                              *args, cone=cone)
    ref1 = _jax_solve(jm, batch, SolverType.NEWTON, 1)
    assert_close(one['qacc'].numpy(), np.asarray(ref1.qacc), 'qacc', 1e-5)


def test_cone_forces_lie_in_the_cone(problem):
  """Converged, each elliptic contact's force lies in its friction cone:
  f_n >= 0 and |f_t| <= friction[0] f_n (condim 3, both tangential
  coefficients friction[0]), within float32; frictionless contacts only
  push."""
  _, m, d, _ = problem
  out = _port(m, d, SolverType.NEWTON, m.opt.iterations, torch.float32)
  friction, dim, impratio = solver.cone_inputs(m, d.contact)
  K = solver.Cone(m, d.efc_D, (friction, dim, impratio))
  f = K.blocks(out['efc_force'])                   # (W, C, S)
  ell = K.is_ell & (f[..., 0] != 0)
  assert bool(ell.any())
  fn = f[..., 0][ell]
  assert bool((fn >= 0).all())
  mu = K.mu[ell] * float(impratio) ** 0.5          # friction[0]
  ft = torch.sqrt((f[..., 1:][ell] ** 2).sum(-1))
  assert bool((ft <= mu * fn * (1 + 1e-4) + 1e-6).all()), (ft, mu * fn)
  one = (dim == 1)
  assert bool((f[..., 0][one] >= 0).all())
