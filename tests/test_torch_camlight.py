"""The port's camlight (camera and light frames, `smooth.camlight`)
against jax.vmap(mujoco_warp_tpu.smooth.camlight) on the same body
poses: three_humanoids (9 cameras in modes FIXED and TRACKCOM, 10 lights
in FIXED, TRACKCOM and TARGETBODYCOM) and a small scene with every mode
for both. Positions and frames at 2e-6, scale-relative (the same float32
operations in another order)."""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu import smooth as jsmooth
from mujoco_warp_tpu_torch import smooth

from torch_parity import assert_close, build, states

ALL_MODES = """<mujoco><worldbody>
  <geom type="plane" size="2 2 .1"/>
  <body name="a" pos="0 0 1"><freejoint/><geom size=".1" mass="1"/>
    <camera name="fixed" pos=".1 .2 .3" euler="10 20 30"/>
    <camera name="track" mode="track" pos="0 -1 .5"/>
    <camera name="trackcom" mode="trackcom" pos="0 -1 .5" xyaxes="1 0 0 0 0 1"/>
    <light name="lfixed" pos="0 0 1" dir="0 1 -1"/>
    <light name="ltrack" mode="track" pos="0 0 1"/>
    <light name="ltrackcom" mode="trackcom" pos="0 0 1"/>
    <body name="b" pos=".3 0 0"><joint type="hinge" axis="0 1 0"/>
      <geom type="capsule" size=".05 .2" mass=".5"/>
      <camera name="target" mode="targetbody" target="a" pos=".5 .5 .5"/>
      <camera name="targetcom" mode="targetbodycom" target="a" pos="0 0 0"/>
      <light name="ltarget" mode="targetbody" target="a" pos=".2 0 .3"/>
      <light name="ltargetcom" mode="targetbodycom" target="a" pos="0 .2 .3"/>
    </body>
  </body>
</worldbody></mujoco>"""

FIELDS = ('cam_xpos', 'cam_xmat', 'light_xpos', 'light_xdir')


def _models(scene):
  if scene == 'all_modes':
    mjm = mujoco.MjModel.from_xml_string(ALL_MODES)
    return mjm, mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')
  return build(scene)


@pytest.mark.parametrize('scene', ['three_humanoids', 'all_modes'])
def test_camlight_matches_jax(scene):
  mjm, jm, m = _models(scene)
  assert m.ncam and m.nlight
  q, v = states(mjm, 3, nstep=40, qpos_noise=0.1)
  sm = smooth.smooth(m, torch.tensor(q), torch.tensor(v))
  out = smooth.camlight(m, sm['xpos'], sm['xquat'], sm['subtree_com'])
  jd = mjwt.make_data(jm)
  batch = jax.vmap(lambda xp, xq, sc: jd.replace(
      xpos=xp, xquat=xq, subtree_com=sc))(
          *[jnp.asarray(sm[k].numpy()) for k in
            ('xpos', 'xquat', 'subtree_com')])
  ref = jax.vmap(lambda dd: jsmooth.camlight(jm, dd))(batch)
  for name in FIELDS:
    assert out[name].shape == (3,) + np.asarray(getattr(ref, name)).shape[1:]
    assert_close(out[name].numpy(), np.asarray(getattr(ref, name)), name,
                 2e-6)
