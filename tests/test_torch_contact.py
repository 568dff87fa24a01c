"""Collision and constraint rows of the port (plain version of kernel B2)
against the JAX package's collision_driver.collision +
constraint.make_constraint, at the reference tolerance 5e-5
(tests/fixtures.py:140), scale-relative. The port writes zero Jacobian
rows where a row does not exist; the JAX rows are compared where the
row is active."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import collision_driver as jcd
from mujoco_warp_tpu import constraint as jcon
from mujoco_warp_tpu import smooth as jsmooth
from mujoco_warp_tpu_torch import smooth
from mujoco_warp_tpu_torch.kernels import contact as kc

from torch_parity import assert_close, build, states

TOL = 5e-5
NCONMAX = {'humanoid': 24, 'hopper': 8, 'hopper_friction': 8, 'spheres': 8,
           'ball_chain': 8}
POOL = ('dist', 'pos', 'frame', 'includemargin', 'friction', 'solref',
        'solreffriction', 'solimp')
EXACT = ('dim', 'geom', 'efc_address')
ROWS = ('efc_D', 'efc_aref', 'efc_frictionloss', 'efc_pos', 'efc_margin',
        'efc_vel')


def _case(scene, nworld=6):
  mjm, jm, m = build(scene)
  q, v = states(mjm, nworld, nstep={'humanoid': 200, 'hopper': 300,
                                     'hopper_friction': 300}.get(scene, 60),
                qpos_noise=0.02)
  return mjm, jm, m, q, v


def _port(m, q, v, nconmax):
  sm = smooth.smooth(m, torch.tensor(q), torch.tensor(v))
  return sm, kc.plain(m, sm['qpos'], torch.tensor(v), sm['geom_xpos'],
                      sm['geom_xmat'], sm['subtree_com'], sm['cdof'],
                      nconmax)


@pytest.mark.parametrize('scene', ['humanoid', 'hopper', 'hopper_friction',
                                   'spheres', 'ball_chain'])
def test_contact_matches_jax(scene):
  _, jm, m, q, v = _case(scene)
  jd = mjwt.make_data(jm, nconmax=NCONMAX[scene])
  nconmax = jd.contact.dist.shape[0]      # 0 without collision candidates
  batch = jax.vmap(lambda qq, vv: jd.replace(qpos=qq, qvel=vv))(
      jnp.asarray(q), jnp.asarray(v))
  ref = jax.jit(jax.vmap(lambda dd: jcon.make_constraint(jm, jcd.collision(
      jm, jsmooth.com_pos(jm, jsmooth.kinematics(jm, dd))))))(batch)
  _, out = _port(m, q, v, nconmax)
  assert (np.asarray(ref.ncon).sum() > 0) == (scene != 'ball_chain')
  for name in ('ncon', 'ncollision', 'nl', 'nf', 'nefc'):
    np.testing.assert_array_equal(out[name].numpy(),
                                  np.asarray(getattr(ref, name)), name)
  for name in POOL:
    assert_close(out[name].numpy(), np.asarray(getattr(ref.contact, name)),
                 name, TOL)
  for name in EXACT:
    np.testing.assert_array_equal(out[name].numpy(),
                                  np.asarray(getattr(ref.contact, name)),
                                  name)
  active = np.asarray(ref.efc_active)
  np.testing.assert_array_equal(out['efc_active'].numpy(), active)
  for name in ('efc_type', 'efc_id'):
    np.testing.assert_array_equal(out[name].numpy(),
                                  np.asarray(getattr(ref, name)), name)
  J = out['efc_J'].numpy()
  assert_close(J, np.asarray(ref.efc_J) * active[..., None], 'efc_J', TOL)
  assert not J[~active].any(), 'rows that do not exist have zero J'
  for name in ROWS:
    assert_close(out[name].numpy(), np.asarray(getattr(ref, name)), name,
                 TOL)


def test_contact_overflow_counts_ncollision():
  _, _, m, q, v = _case('humanoid', nworld=4)
  _, full = _port(m, q, v, 24)
  _, small = _port(m, q, v, 2)
  np.testing.assert_array_equal(small['ncollision'].numpy(),
                                full['ncollision'].numpy())
  np.testing.assert_array_equal(
      small['ncon'].numpy(), np.minimum(full['ncon'].numpy(), 2))
  # the kept contacts are the first two in candidate order
  np.testing.assert_array_equal(small['geom'].numpy(),
                                full['geom'][:, :2].numpy())
