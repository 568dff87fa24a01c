"""Helpers for the PyTorch port's parity tests (tests/test_torch_*.py):
one MJCF builds C MuJoCo, the JAX package and the port; states with
contacts come from C MuJoCo stepping, and reach both packages as numpy.
"""

from __future__ import annotations

import fcntl
import os
import pickle
import tempfile

import mujoco
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import models

import fixtures

# Under pytest-xdist each worker's torch would start one intra-op thread
# per core, and the workers share the cores: with six workers on an
# eight-core CPU the threads waited on each other more than they
# computed (the torch tests took 798 s and 94 min of CPU, against 598 s
# and 60 min with one thread a worker). The tests' tensors are small.
if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)


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
         'apptronik_apollo_flat': models.APOLLO,
         'aloha_pot': models.ALOHA_POT}
ALL_SCENES = sorted(SCENES) + sorted(FILES)


def _sap_grid() -> str:
  """A 12 x 12 grid of boxes on the world body under two capsules and two
  boxes on free joints, all margins 0 (where the port's pair margin rule
  and the JAX package's agree, ROADMAP §C, C5): capsule-capsule 1,
  capsule-box 292 and box-box 289 admissible pairs. The large box's AABB
  covers about 80 grid boxes, past the 64 pairs a family keeps at
  nconmax 8; every grid box under an AABB's footprint overlaps it by the
  same z slack, so slacks tie."""
  grid = ''.join(
      f'<geom type="box" size="0.05 0.05 0.05" pos="{0.1 * i - 0.55:.2f} '
      f'{0.1 * j - 0.55:.2f} 0"/>' for i in range(12) for j in range(12))
  return f"""<mujoco><option timestep="0.005"/><worldbody>{grid}
  <body pos="0.3 0.3 0.088"><freejoint/>
    <geom type="capsule" size="0.04 0.3" euler="0 90 45"/></body>
  <body pos="0.35 -0.35 0.079"><freejoint/>
    <geom type="capsule" size="0.03 0.12" euler="90 0 0"/></body>
  <body pos="-0.2 -0.2 0.118"><freejoint/>
    <geom type="box" size="0.3 0.3 0.05" euler="3 2 40"/></body>
  <body pos="-0.35 0.4 0.1015"><freejoint/>
    <geom type="box" size="0.08 0.06 0.05" euler="1 2 10"/></body>
  </worldbody></mujoco>"""


SAP_GRID = _sap_grid()
# the large-scene threshold both packages take the SAP grid's model at
SAP_GRID_THRESHOLD = 100


def build_sap(xml: str = SAP_GRID, threshold: int = SAP_GRID_THRESHOLD):
  """(mjm, JAX Model, port Model on the CPU) of xml compiled with both
  packages' large-scene threshold at `threshold` (the JAX package's
  MJWT_SAP_THRESHOLD, the port's io.SAP_THRESHOLD), both put back
  after."""
  mjm = mujoco.MjModel.from_xml_string(xml)
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv('MJWT_SAP_THRESHOLD', str(threshold))
    mp.setattr(mt.io, 'SAP_THRESHOLD', threshold)
    return mjm, mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')


def sap_grid_states(mjm, nworld: int, seed: int = 0) -> np.ndarray:
  """(nworld, nq) float32 qpos of the SAP grid: world 0 at qpos0, the
  others with each free body moved up to 3 cm in x and y and -6..4 mm in
  z."""
  rng = np.random.default_rng(seed)
  q = np.tile(mjm.qpos0, (nworld, 1)).astype(np.float32)
  for w in range(1, nworld):
    for b in range(mjm.nbody - 1):
      q[w, 7 * b:7 * b + 2] += rng.uniform(-0.03, 0.03, 2)
      q[w, 7 * b + 2] += rng.uniform(-0.006, 0.004)
  return q


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


def compile_fresh(path: str) -> mujoco.MjModel:
  """The MJCF at path compiled as a new process compiles it: MuJoCo's
  asset cache is cleared first. The cache hands a mesh compiled for one
  model to the next model that reads its file: aloha_sdf reads
  aloha_pot's meshes (its meshdir) and compiles the fingers' octrees
  from them, which come out otherwise after aloha_pot in one process."""
  mujoco.mj_clearCache(mujoco.mj_getCache())
  return mujoco.MjModel.from_xml_path(path)


def shared(name: str, make):
  """make()'s value, computed once a test run: under pytest-xdist the
  first worker to ask computes it under a lock and writes it to the
  run's temporary directory, and the others wait for the lock and read
  it, so that a JAX reference that takes minutes to compile is built by
  one worker, not by each worker that runs a test of it. Outside xdist,
  make(). The value pickles: numpy arrays, not JAX arrays."""
  run = os.environ.get('PYTEST_XDIST_TESTRUNUID')
  if run is None:
    return make()
  path = os.path.join(tempfile.gettempdir(), f'mjwt-shared-{run}-{name}')
  with open(path + '.lock', 'w') as lock:
    fcntl.flock(lock, fcntl.LOCK_EX)
    if os.path.exists(path):
      with open(path, 'rb') as f:
        return pickle.load(f)
    value = make()
    with open(path + '.tmp', 'wb') as f:
      pickle.dump(value, f)
    os.replace(path + '.tmp', path)
    return value
