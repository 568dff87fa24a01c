"""Rewrite the committed `.npz` models from their MJCF sources.

    python -m mujoco_warp_tpu_torch.models.regenerate
"""

import mujoco

from mujoco_warp_tpu_torch import io
from mujoco_warp_tpu_torch import models

# (MJCF source, committed .npz)
SOURCES = ((models.HUMANOID, models.HUMANOID_NPZ),
           (models.THREE_HUMANOIDS, models.THREE_HUMANOIDS_NPZ),
           (models.FRANKA, models.FRANKA_NPZ),
           (models.APOLLO, models.APOLLO_NPZ),
           (models.APOLLO_TERRAIN, models.APOLLO_TERRAIN_NPZ))


def main():
  for xml, npz in SOURCES:
    mjm = mujoco.MjModel.from_xml_path(xml)
    io.save_model(io.put_model(mjm, device='cpu'), npz)
    print('wrote', npz)


if __name__ == '__main__':
  main()
