"""The elliptic friction cone in the port, apart from its solve: options,
gates, the efc rows (the plain version of kernel B2's elliptic rows)
against the JAX package, and whole forward and step calls against C
MuJoCo.

* `override_model` gives the JAX package's Option (cone, impratio and the
  `ls_parallel` that a change of cone sets), bit for bit.
* The gates: an elliptic model takes the kernel lists where the JAX
  package's gate admits the cone (Newton, nv <= 32; the glue list with
  Euler), and the elliptic kernels only where the JAX package builds its
  cone (a contact of more than one row).
* Rows: the port's `constraint.make_constraint` against JAX
  `make_constraint`, fed the same kinematics and the same contact pool
  (the JAX package's), for the humanoid (elliptic, impratio 10, noisy
  qpos; condim 1 and 3 contacts); and the whole plain B2 chain
  (collision + rows) against JAX `collision` + `make_constraint` for the
  sliding sphere of tests/test_elliptic.py at condim 3, 4 and 6, which
  reach the torsional and rolling rows. efc_J, D, aref, vel and pos at
  the reference tolerance 5e-5 (tests/fixtures.py:140), scale-relative;
  type and active exactly. (Through the two collision paths the
  humanoid's D moves by 1e-4 of scale: the impedance of a contact 1 mm
  deep turns a float32 difference of its depth into that; the pyramidal
  rows do the same, so the humanoid's rows are held on the JAX pool.)
* C MuJoCo: the sliding sphere's qacc from one-world `forward_batched`
  at the five (impratio, condim) cases of tests/test_elliptic.py:47-61
  within 2e-2 of scale, and the elliptic hopper of
  tests/test_elliptic.py:25 (glue list, mode 1) over 100 steps within
  the 5e-3 of qpos of its :88.
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
from mujoco_warp_tpu import collision_driver as jcd
from mujoco_warp_tpu import constraint as jcon
from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu import smooth as jsmooth
from mujoco_warp_tpu_torch import constraint, forward, smooth, solver, types
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch.kernels import glue as kg
from mujoco_warp_tpu_torch.kernels import newton as kn
from mujoco_warp_tpu_torch.types import (ConeType, ConstraintType,
                                         IntegratorType, SolverType)

from test_elliptic import HOPPER_ELLIPTIC, SLIDE_SPHERE
from torch_parity import SCENES, assert_close, states

TOL = 5e-5
ELLIPTIC = ['opt.cone=elliptic', 'opt.impratio=10']
ROWS = ('efc_D', 'efc_aref', 'efc_vel', 'efc_pos', 'efc_margin',
        'efc_frictionloss')


def _elliptic_humanoid():
  """(mjm, JAX Model, port Model) of the humanoid with the elliptic cone
  at impratio 10, compiled so."""
  mjm = mujoco.MjModel.from_xml_string(SCENES['humanoid'])
  mjm.opt.cone = int(ConeType.ELLIPTIC)
  mjm.opt.impratio = 10
  return mjm, mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')


@pytest.mark.parametrize('overrides', [
    ELLIPTIC, ['opt.cone=elliptic', 'opt.cone=pyramidal'],
    ['opt.solver=cg', 'opt.iterations=7', 'opt.ls_parallel=0',
     'opt.ls_iterations=12', 'opt.tolerance=1e-7'],
    ['opt.integrator=rk4', 'opt.disableflags=warmstart|eulerdamp',
     'opt.gravity=0 0 -1']], ids=['elliptic', 'back', 'cg', 'misc'])
def test_override_model_matches_jax(overrides):
  mjm = mujoco.MjModel.from_xml_string(SCENES['humanoid'])
  m = mt.override_model(mt.put_model(mjm, device='cpu'), overrides)
  jm = jio.override_model(mjwt.put_model(mjm), overrides)
  for name in types.OPTION_STATICS:
    assert getattr(m.opt, name) == getattr(jm.opt, name), name
  for name in types.OPTION_TENSORS:
    np.testing.assert_array_equal(getattr(m.opt, name).numpy(),
                                  np.asarray(getattr(jm.opt, name)), name)


def test_override_model_equals_the_compiled_option():
  """Overriding the cone of a loaded model gives the model compiled with
  it, ls_parallel included: `opt.replace(cone=...)` would keep the
  parallel linesearch."""
  _, _, compiled = _elliptic_humanoid()
  mjm = mujoco.MjModel.from_xml_string(SCENES['humanoid'])
  m = mt.put_model(mjm, device='cpu')
  over = mt.override_model(m, ELLIPTIC)
  assert over.opt.ls_parallel == compiled.opt.ls_parallel == 0
  assert m.opt.replace(cone=int(ConeType.ELLIPTIC)).ls_parallel == 1
  for f in dataclasses.fields(compiled.opt):
    a, b = getattr(over.opt, f.name), getattr(compiled.opt, f.name)
    if torch.is_tensor(b):
      torch.testing.assert_close(a, b, rtol=0, atol=0)
    else:
      assert a == b, f.name
  with pytest.raises(ValueError, match='unknown option'):
    mt.override_model(m, 'opt.noslip_iterations=3')


@pytest.fixture(scope='module')
def humanoid():
  mjm, jm, m = _elliptic_humanoid()
  q, v = states(mjm, 6, nstep=200, qpos_noise=0.02)
  return mjm, jm, m, q, v


def test_elliptic_gates_and_stage_lists(humanoid):
  _, _, m, q, v = humanoid
  d = mt.data_from_numpy(m, dict(qpos=q[:2], qvel=v[:2]), nconmax=24)
  names = lambda stages: [n for n, _ in stages]
  assert forward.uses_glue_kernel(m, d) and forward.uses_newton_kernel(m, d)
  assert names(forward.batched_stages(m, d)) == [
      'smooth_mega[cuda]', 'contact_efc_mega[cuda]', 'act_len_vel',
      'solve_glue[cuda]']
  front = ['smooth_mega[cuda]', 'contact_efc_mega[cuda]', 'transmission',
           'velocity_glue', 'passive', 'fwd_actuation', 'fwd_acceleration']
  assert names(forward.forward_stages(m, d)) == front + ['solve[cuda]']
  for opt, last in ((dict(integrator=int(IntegratorType.RK4)),
                     ['solve[cuda]', 'rk4']),
                    (dict(solver=int(SolverType.CG)), ['solve', 'euler'])):
    mm = m.replace(opt=m.opt.replace(**opt))
    assert not forward.uses_glue_kernel(mm, d)
    assert names(forward.batched_stages(mm, d)) == front + last
  # the cone reaches the kernels: 3 rows per contact, empty slots dim 0
  friction, dim, impratio = solver.cone_inputs(m, d.contact)
  assert mt.efc_layout(m, 24)[3:] == (3, 21 + 24 * 3)
  assert friction.shape == (2, 24, 5) and dim.dtype == torch.int32
  assert float(impratio) == 10.0
  # a model whose contacts have one row each builds no cone
  mjm1 = mujoco.MjModel.from_xml_string(
      SCENES['humanoid'].replace('condim="3"', 'condim="1"'))
  mjm1.opt.cone = int(ConeType.ELLIPTIC)
  m1 = mt.put_model(mjm1, device='cpu')
  d1 = mt.make_data(m1, nconmax=24)
  assert mt.efc_layout(m1, 24)[3] == 1
  assert solver.cone_inputs(m1, d1.contact) is None
  assert forward.uses_glue_kernel(m1, d1)


def _jax_rows(jm, q, v, nconmax):
  """JAX kinematics, collision and rows of a batch of states."""
  jd = mjwt.make_data(jm, nconmax=nconmax)
  batch = jax.vmap(lambda qq, vv: jd.replace(qpos=qq, qvel=vv))(
      jnp.asarray(q), jnp.asarray(v))
  return jax.jit(jax.vmap(lambda dd: jcon.make_constraint(jm, jcd.collision(
      jm, jsmooth.com_pos(jm, jsmooth.kinematics(jm, dd))))))(batch)


def _check_rows(out, ref):
  active = np.asarray(ref.efc_active)
  np.testing.assert_array_equal(out['active'].numpy(), active)
  for name in ('type', 'id'):
    np.testing.assert_array_equal(out[name].numpy(),
                                  np.asarray(getattr(ref, 'efc_' + name)))
  J = out['J'].numpy()
  assert_close(J, np.asarray(ref.efc_J) * active[..., None], 'efc_J', TOL)
  assert not J[~active].any(), 'rows that do not exist have zero J'
  for name in ROWS:
    assert_close(out[name[4:]].numpy(), np.asarray(getattr(ref, name)),
                 name, TOL)


def test_elliptic_rows_match_jax_humanoid(humanoid):
  """The row builder on the JAX package's own kinematics and contacts."""
  _, jm, m, q, v = humanoid
  ref = _jax_rows(jm, q, v, 24)
  con = {f.name: torch.tensor(np.asarray(getattr(ref.contact, f.name)))
         for f in dataclasses.fields(ref.contact)
         if f.name in types.CONTACT_TENSORS}
  out = constraint.make_constraint(
      m, torch.tensor(np.asarray(ref.qpos)), torch.tensor(v),
      torch.tensor(np.asarray(ref.cdof)),
      torch.tensor(np.asarray(ref.subtree_com)), con)
  types_ = out['type'].numpy()
  active = np.asarray(ref.efc_active)
  # condim 1 (capsule pairs) and condim 3 (the floor, the feet) contacts
  assert (active & (types_ == ConstraintType.CONTACT_ELLIPTIC)).any()
  assert (active & (types_ == ConstraintType.CONTACT_FRICTIONLESS)).any()
  assert not (types_ == ConstraintType.CONTACT_PYRAMIDAL).any()
  _check_rows(out, ref)
  # the friction rows: D_r = D_0 impratio (mu_r / mu_1)^2, here mu_r = mu_1
  D = out['D'].numpy()[:, 21:].reshape(6, 24, 3)
  ell = active[:, 21::3] & (types_[:, 21::3] ==
                            ConstraintType.CONTACT_ELLIPTIC)
  np.testing.assert_allclose(D[ell][:, 1:], np.repeat(10 * D[ell][:, :1], 2, 1),
                             rtol=1e-6)


@pytest.mark.parametrize('condim', [3, 4, 6])
def test_elliptic_rows_match_jax_sliding_sphere(condim):
  """The whole plain B2 chain, torsional (condim 4) and rolling (6)
  rows included."""
  mjm = mujoco.MjModel.from_xml_string(SLIDE_SPHERE.format(impratio=3,
                                                           condim=condim))
  jm, m = mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')
  q = np.tile(mjm.qpos0, (2, 1)).astype(np.float32)
  q[1, 2] -= 0.004                            # deeper into the plane
  v = np.array([[0.3, -0.2, 0.0, 0.1, 0.2, 0.3],
                [-0.1, 0.4, -0.05, 0.5, -0.3, 0.2]], np.float32)
  ref = _jax_rows(jm, q, v, 1)
  sm = smooth.smooth(m, torch.tensor(q), torch.tensor(v))
  out = kc.plain(m, sm['qpos'], torch.tensor(v), sm['geom_xpos'],
                 sm['geom_xmat'], sm['subtree_com'], sm['cdof'], 1)
  assert out['efc_J'].shape[1] == condim
  assert bool(out['efc_active'].all())
  np.testing.assert_array_equal(out['dim'].numpy(), [[condim]] * 2)
  _check_rows({k[4:]: out[k] for k in kc.EFC_FIELDS}, ref)


@pytest.mark.parametrize('impratio,condim', [(1, 3), (3, 3), (3, 6), (1, 4),
                                             (5, 6)])
def test_sliding_sphere_qacc_matches_mujoco(impratio, condim):
  """One-world forward_batched (B4-elliptic's plain version) against
  mj_forward across the cone's zones (tests/test_elliptic.py:47-61)."""
  mjm = mujoco.MjModel.from_xml_string(
      SLIDE_SPHERE.format(impratio=impratio, condim=condim))
  mjd = mujoco.MjData(mjm)
  mjd.qvel[:3] = [0.3, -0.2, 0.0]
  mjd.qvel[3:] = [0.1, 0.2, 0.3]
  mujoco.mj_forward(mjm, mjd)
  m = mt.put_model(mjm, device='cpu')
  d = mt.data_from_numpy(m, dict(qpos=mjd.qpos[None], qvel=mjd.qvel[None]))
  for mod in (kg, kn):
    mod.launches = mod.launches_ell = 0
  out = mt.forward_batched(m, d)
  assert (kn.launches, kn.launches_ell) == (0, 0)     # CPU: plain
  scale = max(1.0, float(np.abs(mjd.qacc).max()))
  err = float(np.abs(out.qacc[0].numpy() - mjd.qacc).max()) / scale
  assert err < 2e-2, (err, out.qacc[0].numpy(), mjd.qacc)


def test_hopper_elliptic_trajectory_matches_mujoco():
  """100 steps of the glue list (B3e's plain version, mode 1) against
  mj_step (tests/test_elliptic.py:77-89)."""
  mjm = mujoco.MjModel.from_xml_string(HOPPER_ELLIPTIC)
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  m = mt.put_model(mjm, device='cpu')
  d = mt.data_from_numpy(m, dict(qpos=mjd.qpos[None], qvel=mjd.qvel[None]))
  assert forward.glue_mode(m) == 1
  assert [n for n, _ in forward.batched_stages(m, d)][-1] == \
      'solve_glue[cuda]'
  stages = forward.batched_stages(m, d)
  for _ in range(100):
    mujoco.mj_step(mjm, mjd)
    for _, fn in stages:
      d = fn(d)
  q = d.qpos[0].numpy()
  assert np.isfinite(q).all()
  err = float(np.abs(q - mjd.qpos).max())
  assert err < 5e-3, (err, q, mjd.qpos)
