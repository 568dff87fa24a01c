"""Helpers for the PyTorch port's parity tests (tests/test_torch_*.py):
one MJCF builds C MuJoCo, the JAX package and the port; states with
contacts come from C MuJoCo stepping, and reach both packages as numpy.
"""

from __future__ import annotations

import mujoco
import numpy as np

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import models

import fixtures


def _read(path: str) -> str:
  with open(path) as f:
    return f.read()


SCENES = {
    'humanoid': _read(models.HUMANOID),
    'pendulum': fixtures.PENDULUM,
    'ball_chain': fixtures.BALL_CHAIN,
    'hopper': fixtures.HOPPER,
    'spheres': fixtures.SPHERES,
    # the hopper with dof friction: friction efc rows and their solver zone
    'hopper_friction': fixtures.HOPPER.replace(
        'damping="0.5"', 'damping="0.5" frictionloss="0.3"').replace(
            'damping="0.3"', 'damping="0.3" frictionloss="0.2"'),
}


# a slide and a hinge over a plane, in contact at every keyframe, with a
# ctrl-limited motor and keyframes, three of them named lift_*
KEYED = """
<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body pos="0 0 0.04">
      <joint name="lift" type="slide" axis="0 0 1" damping="0.1"/>
      <geom type="capsule" size="0.05" fromto="0 0 0 0.3 0 0" mass="1"/>
      <body pos="0.3 0 0">
        <joint name="tilt" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="sphere" size="0.06" mass="0.4"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="lift" gear="10" ctrlrange="-1 1" ctrllimited="true"/>
    <motor joint="tilt" gear="2"/>
  </actuator>
  <keyframe>
    <key name="lift_0" time="0.5" qpos="0 0.2" qvel="0.1 -0.1"
         ctrl="0.5 0.1"/>
    <key name="lift_1" qpos="-0.005 -0.1" ctrl="-0.2 0.4"/>
    <key name="rest"/>
    <key name="lift_2" qpos="0.002 0.3" ctrl="1.0 -0.5"/>
  </keyframe>
</mujoco>
"""

# scenes read from their files (they include other files)
FILES = {'three_humanoids': models.THREE_HUMANOIDS,
         'franka_emika_panda': models.FRANKA,
         'apptronik_apollo_flat': models.APOLLO}
ALL_SCENES = sorted(SCENES) + sorted(FILES)


def build(scene: str):
  """(mjm, JAX Model, port Model on the CPU)."""
  if scene in FILES:
    mjm = mujoco.MjModel.from_xml_path(FILES[scene])
  else:
    mjm = mujoco.MjModel.from_xml_string(SCENES[scene])
  return mjm, mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')


def states(mjm, nworld: int, nstep: int, seed: int = 0,
           qpos_noise: float = 0.05, warmstart: bool = False):
  """(qpos, qvel) float32 arrays of nworld C MuJoCo rollouts of nstep
  (+ 7 per world) steps from qpos0 with Gaussian qpos noise; with
  warmstart, also the rollouts' qacc_warmstart (the last step's qacc)."""
  rng = np.random.default_rng(seed)
  qs, vs, ws = [], [], []
  for w in range(nworld):
    d = mujoco.MjData(mjm)
    d.qpos[:] += qpos_noise * rng.standard_normal(mjm.nq)
    for _ in range(nstep + 7 * w):
      mujoco.mj_step(mjm, d)
    qs.append(d.qpos.copy())
    vs.append(d.qvel.copy())
    ws.append(d.qacc_warmstart.copy())
  out = np.asarray(qs, np.float32), np.asarray(vs, np.float32)
  return out + (np.asarray(ws, np.float32),) if warmstart else out


def assert_close(a, b, name: str, tol: float):
  """|a - b| <= tol * max(1, max |b|) (scale-relative)."""
  a = np.asarray(a, np.float64)
  b = np.asarray(b, np.float64).reshape(a.shape)
  scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
  np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=name)
