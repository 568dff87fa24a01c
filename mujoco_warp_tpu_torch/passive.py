"""Passive forces: joint springs and dof dampers (mirrors
`mujoco_warp_tpu/passive.py:17` for the ported subset: springs only on
slide/hinge joints, no tendons, gravity compensation or fluid)."""

from __future__ import annotations

import torch

from .types import DisableBit, JointType, Model


def passive(m: Model, qpos: torch.Tensor, qvel: torch.Tensor):
  """-> (qfrc_spring, qfrc_damper, qfrc_passive), each (W, nv)."""
  spring = torch.zeros_like(qvel)
  if not m.opt.disableflags & DisableBit.SPRING:
    for j in range(m.njnt):
      if m.jnt_type[j] in (JointType.SLIDE, JointType.HINGE):
        q, v = m.jnt_qposadr[j], m.jnt_dofadr[j]
        spring[:, v] = -m.jnt_stiffness[j] * (qpos[:, q] - m.qpos_spring[q])
  damper = torch.zeros_like(qvel)
  if not m.opt.disableflags & DisableBit.DAMPER:
    damper = -m.dof_damping * qvel
  return spring, damper, spring + damper
