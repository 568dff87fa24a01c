"""Support functions (mirrors `mujoco_warp_tpu/support.py`)."""

from __future__ import annotations

import torch

from . import math
from .kernels import _build
from .types import Model


def _index(m: Model) -> dict:
  """body_rootid and dof_bodyid as index tensors, built once per model."""
  idx = lambda x: torch.as_tensor(x, dtype=torch.long, device=m.device)
  return dict(rootid=idx(m.body_rootid), dof_bodyid=idx(m.dof_bodyid))


def xfrc_accumulate(m: Model, xfrc_applied, xipos, subtree_com, cdof):
  """Generalized forces of the Cartesian wrenches xfrc_applied (W, nb, 6)
  applied at the body coms (support.py:84)."""
  t = _build.model_tables(m, 'support', _index)
  force, torque = xfrc_applied[..., :3], xfrc_applied[..., 3:]
  offset = xipos - subtree_com[:, t['rootid']]
  cfrc = torch.cat([torque + math.cross(offset, force), force], -1)
  csub = torch.einsum('bc,wci->wbi', m.body_subtree_mask, cfrc)
  return torch.sum(cdof * csub[:, t['dof_bodyid']], -1)
