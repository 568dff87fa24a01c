"""Joint-equality rows and plane-box contacts of the port (the plain
version of kernel B2) against the JAX package, on the CPU:
`collision_primitive.plane_box` slot for slot on boxes whose corners tie
in depth, and the B2 rows (`kernels.contact.plain`) against
`collision_driver.collision` + `constraint.make_constraint` on a small
scene (a free box over a plane; two hinges tied by a two-joint polycoef
equality and a slide held by a one-joint equality), with equalities off
in some worlds and with the equality flag disabled; at the reference
tolerance 5e-5 (tests/fixtures.py:140), scale-relative."""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import collision_driver as jcd
from mujoco_warp_tpu import collision_primitive as jcp
from mujoco_warp_tpu import constraint as jcon
from mujoco_warp_tpu import smooth as jsmooth
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import collision_primitive, smooth
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch.types import DisableBit

from test_torch_contact import _assert_matches_jax
from torch_parity import assert_close

TOL = 5e-5
NCONMAX = 6

SCENE = """
<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body pos="0 0 0.3">
      <freejoint/>
      <geom type="box" size="0.1 0.08 0.05"/>
    </body>
    <body pos="1 0 1">
      <joint name="a" type="hinge" axis="0 1 0"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"
            contype="0" conaffinity="0"/>
      <body pos="0.3 0 0">
        <joint name="b" type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"
              contype="0" conaffinity="0"/>
        <body pos="0.3 0 0">
          <joint name="c" type="slide" axis="1 0 0"/>
          <geom type="sphere" size="0.04" contype="0" conaffinity="0"/>
        </body>
      </body>
    </body>
  </worldbody>
  <equality>
    <joint joint1="b" joint2="a" polycoef="0.1 -0.5 0.3 0.2 -0.1"
           solref="0.02 1"/>
    <joint joint1="c" polycoef="0.05 0 0 0 0"/>
  </equality>
</mujoco>
"""
NWORLD = 6


def _quat(axis, angle):
  axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
  return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def _states():
  """(qpos, qvel, eq_active) of NWORLD worlds: the box resting flat (its
  four lower corners tied in depth) and turned about the vertical, tilted
  about one axis (corners tied in pairs) and about a generic one, and
  clear of the plane; the hinges and the slide away from their
  equalities; each equality off in one world."""
  rng = np.random.default_rng(0)
  box = [((0, 0, 0.049), _quat((0, 0, 1), 0.0)),
         ((0.2, -0.1, 0.0495), _quat((0, 0, 1), np.pi / 2)),
         ((0, 0, 0.06), _quat((1, 0, 0), 0.3)),
         ((0.1, 0.3, 0.07), _quat((1, 2, 0.5), 0.4)),
         ((0, 0, 0.5), _quat((0, 1, 0), 0.2)),
         ((-0.2, 0, 0.08), _quat((0, 1, 0), 0.5))]
  q = np.zeros((NWORLD, 10))
  for w, (pos, quat) in enumerate(box):
    q[w, :3], q[w, 3:7] = pos, quat
  q[:, 7:9] = rng.uniform(-0.8, 0.8, (NWORLD, 2))
  q[:, 9] = rng.uniform(-0.1, 0.2, NWORLD)
  v = rng.normal(0, 0.5, (NWORLD, 9))
  eq = np.ones((NWORLD, 2), bool)
  eq[2, 0] = eq[4, 1] = False
  return q.astype(np.float32), v.astype(np.float32), eq


def jax_rows(jm):
  """rows(q, v, eq, nconmax): the JAX package's kinematics, com_pos,
  collision and make_constraint of the worlds (qpos q, qvel v, eq_active
  eq) on jm, jitted once per nconmax; a test module builds it once."""
  fns = {}

  def rows(q, v, eq, nconmax):
    if nconmax not in fns:
      fns[nconmax] = jax.jit(jax.vmap(lambda dd: jcon.make_constraint(
          jm, jcd.collision(jm, jsmooth.com_pos(jm, jsmooth.kinematics(
              jm, dd))))))
    jd = mjwt.make_data(jm, nconmax=nconmax)
    batch = jax.vmap(lambda qq, vv, ee: jd.replace(qpos=qq, qvel=vv,
                                                   eq_active=ee))(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(eq))
    return fns[nconmax](batch)
  return rows


def _port_rows(m, q, v, eq, nconmax):
  sm = smooth.smooth(m, torch.tensor(q), torch.tensor(v))
  return kc.plain(m, sm['qpos'], torch.tensor(v), sm['geom_xpos'],
                  sm['geom_xmat'], sm['subtree_com'], sm['cdof'], nconmax,
                  torch.tensor(eq))


@pytest.fixture(scope='module', params=[0, int(DisableBit.EQUALITY)],
                ids=['equality_on', 'equality_off'])
def scene(request):
  """(disable flag, port Model, JAX rows) of SCENE with the flag set."""
  mjm = mujoco.MjModel.from_xml_string(SCENE)
  mjm.opt.disableflags |= request.param
  return (request.param, mt.put_model(mjm, device='cpu'),
          jax_rows(mjwt.put_model(mjm)))


def test_equality_and_box_rows_match_jax(scene):
  flag, m, rows = scene
  q, v, eq = _states()
  ref = rows(q, v, eq, NCONMAX)
  out = _port_rows(m, q, v, eq, NCONMAX)
  _assert_matches_jax(out, ref)
  # the branches fire: box contacts (4 of the resting box), equality rows
  # active where eq_active and the flag allow
  ncon = out['ncon'].numpy()
  assert ncon[0] == 4 and ncon[4] == 0, ncon
  expect = np.zeros_like(eq) if flag else eq
  np.testing.assert_array_equal(out['efc_active'][:, :2].numpy(), expect)
  np.testing.assert_array_equal(out['ne'].numpy(), expect.sum(1))
  assert (out['efc_type'][:, :2] == 0).all()


def test_plane_box_ties_match_jax():
  """Boxes whose corners tie in depth (resting flat: the four lower
  corners; turned about the vertical; tilted about one axis: ties in
  pairs) and a generic box: the same 4 deepest corners in the same
  slots as the JAX collider, the lower corner index first among ties."""
  def mat(quat):
    out = np.zeros(9)
    mujoco.mju_quat2Mat(out, np.asarray(quat, np.float64))
    return out.reshape(3, 3)
  cases = [((0, 0, 0.05), (1, 0, 0, 0)),
           ((0.3, 0.1, 0.02), tuple(_quat((0, 0, 1), np.pi / 2))),
           ((0, 0, 0.04), tuple(_quat((1, 0, 0), 0.25))),
           ((0, 0, 0.04), tuple(_quat((0, 1, 0), -0.25))),
           ((0, 0, 0.08), tuple(_quat((1, 2, 3), 0.7)))]
  n = len(cases)
  p1 = np.zeros((n, 3), np.float32)
  m1 = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
  s1 = np.ones((n, 3), np.float32)
  p2 = np.asarray([c[0] for c in cases], np.float32)
  m2 = np.asarray([mat(c[1]) for c in cases], np.float32)
  s2 = np.tile(np.asarray([0.1, 0.08, 0.05], np.float32), (n, 1))
  args = (p1, m1, s1, p2, m2, s2)
  ref = jax.vmap(jcp.plane_box)(*map(jnp.asarray, args))
  out = collision_primitive.plane_box(*map(torch.tensor, args))
  for name, a, b in zip(('dist', 'pos', 'frame'), out, ref):
    assert_close(a.numpy(), np.asarray(b), name, TOL)
  # the resting box: its four lower corners, all at depth 0, in corner
  # order
  np.testing.assert_array_equal(out[0][0].numpy(), np.zeros(4, np.float32))
  lower = np.asarray([[sx * 0.1, sy * 0.08, 0.0] for sx in (-1, 1)
                      for sy in (-1, 1)], np.float32)
  np.testing.assert_allclose(out[1][0].numpy(), lower, atol=1e-7)
