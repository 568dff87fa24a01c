"""Rewrite the committed `.npz` models from their MJCF sources.

    python -m mujoco_warp_tpu_torch.models.regenerate

aloha_sdf's voxel grids are built at the resolution MJWT_SDF_RES names
(default `io.SDF_RES`, 48): leave it unset.
"""

import mujoco

from mujoco_warp_tpu_torch import io
from mujoco_warp_tpu_torch import models

# (MJCF source, committed .npz)
SOURCES = ((models.HUMANOID, models.HUMANOID_NPZ),
           (models.THREE_HUMANOIDS, models.THREE_HUMANOIDS_NPZ),
           (models.FRANKA, models.FRANKA_NPZ),
           (models.APOLLO, models.APOLLO_NPZ),
           (models.APOLLO_TERRAIN, models.APOLLO_TERRAIN_NPZ),
           (models.APOLLO_HFIELD, models.APOLLO_HFIELD_NPZ),
           (models.ALOHA_POT, models.ALOHA_POT_NPZ),
           (models.ALOHA_SDF, models.ALOHA_SDF_NPZ),
           (models.KITCHEN, models.KITCHEN_NPZ))


def main():
  for xml, npz in SOURCES:
    # as a new process compiles it: MuJoCo's asset cache would hand
    # aloha_pot's meshes to aloha_sdf (its meshdir), whose finger octrees
    # then come out otherwise
    mujoco.mj_clearCache(mujoco.mj_getCache())
    mjm = mujoco.MjModel.from_xml_path(xml)
    io.save_model(io.put_model(mjm, device='cpu'), npz)
    print('wrote', npz)


if __name__ == '__main__':
  main()
