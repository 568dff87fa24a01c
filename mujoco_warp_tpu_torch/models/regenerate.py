"""Rewrite the committed `.npz` models from their MJCF sources.

    python -m mujoco_warp_tpu_torch.models.regenerate
"""

import mujoco

from mujoco_warp_tpu_torch import io
from mujoco_warp_tpu_torch import models


def main():
  mjm = mujoco.MjModel.from_xml_path(models.HUMANOID)
  io.save_model(io.put_model(mjm, device='cpu'), models.HUMANOID_NPZ)
  print('wrote', models.HUMANOID_NPZ)


if __name__ == '__main__':
  main()
