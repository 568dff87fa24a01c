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


def build(scene: str):
  """(mjm, JAX Model, port Model on the CPU)."""
  mjm = mujoco.MjModel.from_xml_string(SCENES[scene])
  return mjm, mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')


def states(mjm, nworld: int, nstep: int, seed: int = 0,
           qpos_noise: float = 0.05):
  """(qpos, qvel) float32 arrays of nworld C MuJoCo rollouts of nstep
  (+ 7 per world) steps from qpos0 with Gaussian qpos noise."""
  rng = np.random.default_rng(seed)
  qs, vs = [], []
  for w in range(nworld):
    d = mujoco.MjData(mjm)
    d.qpos[:] += qpos_noise * rng.standard_normal(mjm.nq)
    for _ in range(nstep + 7 * w):
      mujoco.mj_step(mjm, d)
    qs.append(d.qpos.copy())
    vs.append(d.qvel.copy())
  return np.asarray(qs, np.float32), np.asarray(vs, np.float32)


def assert_close(a, b, name: str, tol: float):
  """|a - b| <= tol * max(1, max |b|) (scale-relative)."""
  a = np.asarray(a, np.float64)
  b = np.asarray(b, np.float64).reshape(a.shape)
  scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
  np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=name)
