"""Support functions (mirrors `mujoco_warp_tpu/support.py`)."""

from __future__ import annotations

import torch

from . import math
from .types import Model


def xfrc_accumulate(m: Model, xfrc_applied, xipos, subtree_com, cdof):
  """Generalized forces of the Cartesian wrenches xfrc_applied (W, nb, 6)
  applied at the body coms (support.py:84)."""
  force, torque = xfrc_applied[..., :3], xfrc_applied[..., 3:]
  offset = xipos - subtree_com[:, list(m.body_rootid)]
  cfrc = torch.cat([torque + math.cross(offset, force), force], -1)
  csub = torch.einsum('bc,wci->wbi', m.body_subtree_mask, cfrc)
  return torch.sum(cdof * csub[:, list(m.dof_bodyid)], -1)
