"""Benchmark scene assets: MJCF sources and their compiled `.npz` form.

`humanoid.npz` is `io.save_model(io.put_model(MjModel(humanoid.xml)))`,
committed so that a machine without the `mujoco` bindings can load the
model (`io.load_model`). Regenerate it after a change to the compiler:

    python -m mujoco_warp_tpu_torch.models.regenerate
"""

import os

_DIR = os.path.dirname(__file__)


def path(name: str) -> str:
  return os.path.join(_DIR, name if name.endswith('.xml') else name + '.xml')


HUMANOID = path('humanoid')
HUMANOID_NPZ = os.path.join(_DIR, 'humanoid.npz')
