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
from mujoco_warp_tpu_torch import collision_driver, smooth
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


def _jax_rows(jm, q, v, nconmax):
  """The JAX package's collision + make_constraint rows of the worlds
  (q, v), and the pool's size (0 without collision candidates)."""
  jd = mjwt.make_data(jm, nconmax=nconmax)
  batch = jax.vmap(lambda qq, vv: jd.replace(qpos=qq, qvel=vv))(
      jnp.asarray(q), jnp.asarray(v))
  ref = jax.jit(jax.vmap(lambda dd: jcon.make_constraint(jm, jcd.collision(
      jm, jsmooth.com_pos(jm, jsmooth.kinematics(jm, dd))))))(batch)
  return ref, jd.contact.dist.shape[0]


def _assert_matches_jax(out, ref):
  for name in ('ncon', 'ncollision', 'ne', 'nl', 'nf', 'nefc'):
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


@pytest.mark.parametrize('scene', ['humanoid', 'hopper', 'hopper_friction',
                                   'spheres', 'ball_chain'])
def test_contact_matches_jax(scene):
  _, jm, m, q, v = _case(scene)
  ref, nconmax = _jax_rows(jm, q, v, NCONMAX[scene])
  _, out = _port(m, q, v, nconmax)
  assert (np.asarray(ref.ncon).sum() > 0) == (scene != 'ball_chain')
  _assert_matches_jax(out, ref)


def test_contact_nconmax_between_end_caps_matches_jax():
  """An nconmax that ends the pool between the two end caps of one
  plane-capsule pair (kernel B2's warp scan gives each cap its own slot):
  the first cap is kept, the second dropped and counted in ncollision."""
  _, jm, m, q, v = _case('humanoid')
  _, full = _port(m, q, v, NCONMAX['humanoid'])
  geom, ncon = full['geom'].numpy(), full['ncon'].numpy()
  cuts = [(w, k + 1) for w in range(len(ncon)) for k in range(ncon[w] - 1)
          if (geom[w, k] == geom[w, k + 1]).all()]
  assert cuts, 'no plane-capsule pair with both caps in contact'
  w, cut = max(cuts, key=lambda c: c[1])
  ref, _ = _jax_rows(jm, q, v, cut)
  _, out = _port(m, q, v, cut)
  assert int(out['ncon'][w]) == cut < int(out['ncollision'][w])
  assert (out['geom'][w, cut - 1].numpy() == geom[w, cut]).all()
  _assert_matches_jax(out, ref)


def test_contact_three_humanoids_matches_jax():
  """three_humanoids' 1614 candidates at nconmax 100: contacts from
  candidates past the first 32 (the later rounds of kernel B2's
  narrowphase, the slots carried across rounds)."""
  mjm, jm, m = build('three_humanoids')
  q, v = states(mjm, 3, 100, qpos_noise=0.02)
  ref, _ = _jax_rows(jm, q, v, 100)
  _, out = _port(m, q, v, 100)
  pairs = collision_driver.candidate_params(m)
  index = {}
  for i, g in enumerate(zip(pairs['g1'].tolist(), pairs['g2'].tolist())):
    index.setdefault(g, i)
  first = [index[tuple(out['geom'][w, k].tolist())]
           for w in range(q.shape[0]) for k in range(int(out['ncon'][w]))]
  assert m.nxn_candidates == 1614 and max(first) >= 32, first
  _assert_matches_jax(out, ref)


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
