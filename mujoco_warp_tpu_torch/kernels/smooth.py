"""Kernel B1: the smooth stage (kinematics, frames, com_pos, crb/qM,
com_vel, rne) in one CUDA kernel, `csrc/smooth.cu`.

Replaces the TPU kernel `smooth_mega_batched`
(`mujoco_warp_tpu/pallas/smooth_kernels.py:557`). Its plain version is
`mujoco_warp_tpu_torch.smooth.smooth`, which runs for CPU tensors; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import smooth as plain
from ..types import DisableBit, Model
from . import _build

MAXBODY = 64     # compile-time cap of csrc/smooth.cu

launches = 0     # kernel launches since the count was last reset

_PTRS = (
    'qpos', 'qvel',
    'body_parentid', 'body_rootid', 'body_jntadr', 'body_jntnum',
    'jnt_type', 'jnt_qposadr', 'jnt_dofadr', 'jnt_bodyid', 'dof_bodyid',
    'dof_parentid', 'geom_bodyid', 'site_bodyid',
    'body_pos', 'body_quat', 'body_ipos', 'body_iquat', 'body_mass',
    'body_subtreemass', 'body_inertia', 'jnt_pos', 'jnt_axis', 'qpos0',
    'dof_armature', 'geom_pos', 'geom_quat', 'site_pos', 'site_quat',
    'gravity') + tuple('qpos_out' if k == 'qpos' else k
                       for k in plain.OUTPUTS)
_INTS = ('nworld', 'nq', 'nv', 'nbody', 'njnt', 'ngeom', 'nsite')
Params = _build.struct('SmoothParams', _PTRS, (), _INTS)

_INT_TABLES = ('body_parentid', 'body_rootid', 'body_jntadr', 'body_jntnum',
               'jnt_type', 'jnt_qposadr', 'jnt_dofadr', 'jnt_bodyid',
               'dof_bodyid', 'dof_parentid', 'geom_bodyid', 'site_bodyid')
_FLOAT_TABLES = ('body_pos', 'body_quat', 'body_ipos', 'body_iquat',
                 'body_mass', 'body_subtreemass', 'body_inertia', 'jnt_pos',
                 'jnt_axis', 'qpos0', 'dof_armature', 'geom_pos',
                 'geom_quat', 'site_pos', 'site_quat')


def _tables(m: Model) -> dict:
  dev = m.device
  t = {k: torch.tensor(getattr(m, k), dtype=torch.int32, device=dev)
       for k in _INT_TABLES}
  t.update({k: getattr(m, k).contiguous() for k in _FLOAT_TABLES})
  gravity = m.opt.gravity
  if m.opt.disableflags & DisableBit.GRAVITY:
    gravity = torch.zeros_like(gravity)
  t['gravity'] = gravity.contiguous()
  return t


def output_shapes(m: Model, nworld: int) -> dict:
  W, nb, nv = nworld, m.nbody, m.nv
  return dict(
      qpos=(W, m.nq), xpos=(W, nb, 3), xquat=(W, nb, 4), xmat=(W, nb, 3, 3),
      xipos=(W, nb, 3), ximat=(W, nb, 3, 3), xanchor=(W, m.njnt, 3),
      xaxis=(W, m.njnt, 3), geom_xpos=(W, m.ngeom, 3),
      geom_xmat=(W, m.ngeom, 3, 3), site_xpos=(W, m.nsite, 3),
      site_xmat=(W, m.nsite, 3, 3), subtree_com=(W, nb, 3),
      cinert=(W, nb, 10), cdof=(W, nv, 6), crb=(W, nb, 10), qM=(W, nv, nv),
      cvel=(W, nb, 6), cdof_dot=(W, nv, 6), cacc=(W, nb, 6),
      qfrc_bias=(W, nv))


def smooth(m: Model, qpos: torch.Tensor, qvel: torch.Tensor) -> dict:
  """(W, nq) qpos and (W, nv) qvel -> dict of plain.OUTPUTS tensors."""
  if qpos.device.type == 'cpu':
    return plain.smooth(m, qpos, qvel)
  return _launch(m, qpos, qvel)


def _launch(m: Model, qpos: torch.Tensor, qvel: torch.Tensor) -> dict:
  global launches
  if m.nbody > MAXBODY:
    raise ValueError(f'smooth kernel: nbody={m.nbody} (cap {MAXBODY})')
  W = qpos.shape[0]
  dev = m.device
  _build.check('qpos', qpos, (W, m.nq), device=dev)
  _build.check('qvel', qvel, (W, m.nv), device=dev)
  outs = {k: torch.empty(s, dtype=torch.float32, device=dev)
          for k, s in output_shapes(m, W).items()}
  values = dict(_build.model_tables(m, 'smooth', _tables), **outs)
  values.update(qpos=qpos, qvel=qvel, qpos_out=outs['qpos'], nworld=W,
                nq=m.nq, nv=m.nv, nbody=m.nbody, njnt=m.njnt, ngeom=m.ngeom,
                nsite=m.nsite)
  _build.launch('smooth', Params, values, dev)
  launches += 1
  return outs
