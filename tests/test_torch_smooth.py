"""Smooth stage of the port (plain version of kernel B1) against the JAX
package's smooth.kinematics -> com_pos -> crb -> com_vel -> rne, at the
bound of tests/test_kernels_interpret_fast.py:50 (2e-5), scale-relative:
|port - jax| <= 2e-5 * max(1, max |jax|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import smooth as jsmooth
from mujoco_warp_tpu_torch import smooth

from torch_parity import assert_close, build, states

TOL = 2e-5


def _inputs(scene, nworld=6):
  mjm, jm, m = build(scene)
  q, v = states(mjm, nworld, nstep=150 if scene == 'humanoid' else 40)
  return jm, m, q, v


@pytest.mark.parametrize('scene', ['humanoid', 'ball_chain', 'pendulum'])
def test_smooth_matches_jax(scene):
  jm, m, q, v = _inputs(scene)
  jd = mjwt.make_data(jm)
  batch = jax.vmap(lambda qq, vv: jd.replace(qpos=qq, qvel=vv))(
      jnp.asarray(q), jnp.asarray(v))
  ref = jax.jit(jax.vmap(lambda dd: jsmooth.rne(jm, jsmooth.com_vel(
      jm, jsmooth.crb(jm, jsmooth.com_pos(jm, jsmooth.kinematics(
          jm, dd)))))))(batch)
  out = smooth.smooth(m, torch.tensor(q), torch.tensor(v))
  for name in smooth.OUTPUTS:
    assert_close(out[name].numpy(), np.asarray(getattr(ref, name)), name,
                 TOL)
