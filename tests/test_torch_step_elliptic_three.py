"""A three_humanoids step of the port with the elliptic cone (impratio
10) against the JAX package, from C MuJoCo states with contacts: the
unfused list, 2 worlds, one step. Its stages are those of
tests/test_torch_step_three.py with two that change with the cone: B2's
elliptic rows (3 per contact, 363 in all) and the solve, Newton with the
cone's Hessian blocks (B5's plain version per direction) and the
iterative linesearch. The step's own solve inputs are held against the
JAX package's `_solve_xla` run in float64 on them (qacc, qfrc_constraint,
efc_force at 1e-9 of scale, solver_niter equal), and the step's float32
qacc and forces against that answer at the float32 tolerances of
tests/test_torch_elliptic_solve.py. (The whole JAX step at this size
takes about 100 s to trace and compile on the CPU; the stages the cone
does not change are held against it in tests/test_torch_step_three.py.)
"""

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
from mujoco_warp_tpu_torch.types import ConeType

from test_torch_elliptic_solve import CONTACT, INPUTS, TOL32, TOL64, _x64
from test_torch_step_elliptic import _reset, _start
from torch_parity import assert_close


@pytest.fixture(scope='module')
def three():
  """One port step of three_humanoids with the elliptic cone at 2 worlds,
  and the solve stage's inputs of that step."""
  mjm = mujoco.MjModel.from_xml_path(models.THREE_HUMANOIDS)
  q, v, c = _start(mjm, 2)
  m = mt.put_model(mjm, device='cpu')
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=100)
  stages = forward.batched_stages(m, d)
  names = [n for n, _ in stages]
  _reset()
  pre = d
  for _, fn in stages[:names.index('solve')]:
    pre = fn(pre)
  out = pre
  for _, fn in stages[names.index('solve'):]:
    out = fn(out)
  counts = dict(solver.counts)
  return mjwt.put_model(mjm), m, names, pre, out, counts


def test_three_humanoids_elliptic_stages(three):
  _, m, names, pre, out, counts = three
  assert m.opt.cone == ConeType.ELLIPTIC and not m.opt.ls_parallel
  assert names == ['smooth_mega[cuda]', 'camlight', 'contact_efc_mega[cuda]',
                   'transmission', 'velocity_glue', 'passive',
                   'fwd_actuation', 'fwd_acceleration', 'solve', 'euler']
  assert pre.efc_J.shape == (2, 63 + 100 * 3, m.nv)
  types = pre.efc_type[pre.efc_active]
  assert bool((types == 7).any())              # elliptic contact rows
  assert counts['solve'] == 1
  assert counts['passes'] >= int(out.solver_niter.max()) > 0
  assert kb.launches == dict.fromkeys(kb.launches, 0)
  for name in ('qpos', 'qvel', 'qacc', 'efc_force'):
    assert bool(torch.isfinite(getattr(out, name)).all())


def test_three_humanoids_elliptic_solve_matches_jax(three):
  jm, m, _, pre, out, _ = three
  f64 = lambda x: x.double() if x.is_floating_point() else x
  cone = solver.cone_inputs(m, pre.contact)
  ours = solver.solve(m, *[f64(getattr(pre, k)) for k in INPUTS],
                      cone=(f64(cone[0]), cone[1], f64(cone[2])))
  with jax.enable_x64(True):
    jd = _x64(mjwt.make_data(jm, nconmax=100))
    arrays = ([jnp.asarray(f64(getattr(pre, k)).numpy()) for k in INPUTS] +
              [jnp.asarray(getattr(pre.contact, k).numpy()) for k in CONTACT])

    def one(*xs):
      dd = jd.replace(**dict(zip(INPUTS, xs)))
      return dd.replace(contact=dd.contact.replace(
          **dict(zip(CONTACT, xs[len(INPUTS):]))))
    ref = jax.jit(lambda b: jsolver._solve_xla(_x64(jm), b))(
        jax.vmap(one)(*arrays))
  np.testing.assert_array_equal(ours['solver_niter'].numpy(),
                                np.asarray(ref.solver_niter))
  for name in ('qacc', 'qfrc_constraint', 'efc_force'):
    expect = np.asarray(getattr(ref, name))
    assert_close(ours[name].numpy(), expect, name, TOL64)
    assert_close(getattr(out, name).numpy(), expect, name + ' (step)',
                 TOL32[name])
