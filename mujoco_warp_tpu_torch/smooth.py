"""Smooth dynamics: kinematics, frames, com_pos, crb/qM, com_vel, rne.

This is the plain PyTorch version of kernel B1 (`kernels/smooth.py`,
`csrc/smooth.cu`) and follows the same algorithm: bodies are in
topological order, so one forward walk over bodies gives the poses and
velocities and one backward walk the subtree sums. Every tensor leads
with the world axis. Mirrors `mujoco_warp_tpu/smooth.py` (`_normalize_qpos`
:39, `kinematics` :53, `com_pos` :183, `crb` :310, `com_vel` :414, `rne`
:439) and the Pallas megakernel it feeds
(`pallas/smooth_kernels.py:531`).
"""

from __future__ import annotations

import torch

from . import math
from .kernels import _build
from .types import DisableBit, JointType, Model

# outputs of the smooth stage, in the order kernels/smooth.py returns them
OUTPUTS = ('qpos', 'xpos', 'xquat', 'xmat', 'xipos', 'ximat', 'xanchor',
           'xaxis', 'geom_xpos', 'geom_xmat', 'site_xpos', 'site_xmat',
           'subtree_com', 'cinert', 'cdof', 'crb', 'qM', 'cvel', 'cdof_dot',
           'cacc', 'qfrc_bias')


def normalize_qpos(m: Model, qpos: torch.Tensor) -> torch.Tensor:
  """Normalize the quaternions of free and ball joints."""
  qpos = qpos.clone()
  for j in range(m.njnt):
    if m.jnt_type[j] in (JointType.FREE, JointType.BALL):
      a = m.jnt_qposadr[j] + (3 if m.jnt_type[j] == JointType.FREE else 0)
      qpos[:, a:a + 4] = math.quat_normalize(qpos[:, a:a + 4])
  return qpos


def kinematics(m: Model, qpos: torch.Tensor):
  """Forward kinematics of normalized qpos (W, nq) -> xpos (W, nb, 3),
  xquat (W, nb, 4), xanchor, xaxis (W, njnt, 3)."""
  W = qpos.shape[0]
  z3 = qpos.new_zeros((W, 3))
  unit = qpos.new_zeros((W, 4))
  unit[:, 0] = 1.0
  xpos, xquat = [z3], [unit]
  xanchor, xaxis = [z3] * m.njnt, [z3] * m.njnt
  for b in range(1, m.nbody):
    p = m.body_parentid[b]
    pq = xquat[p]
    xq = math.mul_quat(pq, m.body_quat[b])
    xp = xpos[p] + math.rot_vec_quat(m.body_pos[b], pq)
    for j in range(m.body_jntadr[b], m.body_jntadr[b] + m.body_jntnum[b]):
      jt, qadr = m.jnt_type[j], m.jnt_qposadr[j]
      if jt == JointType.FREE:
        xp = qpos[:, qadr:qadr + 3]
        xq = qpos[:, qadr + 3:qadr + 7]
        xanchor[j] = xp
        xaxis[j] = m.jnt_axis[j].expand(W, 3)
        continue
      jpos, jaxis = m.jnt_pos[j], m.jnt_axis[j]
      anchor = xp + math.rot_vec_quat(jpos, xq)
      axis = math.rot_vec_quat(jaxis, xq)
      if jt == JointType.SLIDE:
        xp = xp + axis * (qpos[:, qadr:qadr + 1] - m.qpos0[qadr])
      else:
        if jt == JointType.HINGE:
          half = 0.5 * (qpos[:, qadr:qadr + 1] - m.qpos0[qadr])
          qloc = torch.cat([torch.cos(half), torch.sin(half) * jaxis], -1)
        else:
          qloc = math.quat_normalize_rsqrt(qpos[:, qadr:qadr + 4])
        xq = math.mul_quat(xq, qloc)
        xp = anchor - math.rot_vec_quat(jpos, xq)
      xanchor[j], xaxis[j] = anchor, axis
    xpos.append(xp)
    xquat.append(math.quat_normalize_rsqrt(xq))
  stack = lambda xs, k: (torch.stack(xs, 1) if xs else
                         qpos.new_zeros((W, 0, k)))
  return (stack(xpos, 3), stack(xquat, 4), stack(xanchor, 3),
          stack(xaxis, 3))


def frames(m: Model, xpos, xquat):
  """Body rotation and inertial frames, geom and site frames."""
  def attach(bodyid, pos, quat):
    if not bodyid:
      W = xpos.shape[0]
      return xpos.new_zeros((W, 0, 3)), xpos.new_zeros((W, 0, 3, 3))
    idx = list(bodyid)
    bq = xquat[:, idx]
    return (xpos[:, idx] + math.rot_vec_quat(pos, bq),
            math.quat_to_mat(math.mul_quat(bq, quat)))
  xmat = math.quat_to_mat(xquat)
  xipos, ximat = attach(range(m.nbody), m.body_ipos, m.body_iquat)
  geom_xpos, geom_xmat = attach(m.geom_bodyid, m.geom_pos, m.geom_quat)
  site_xpos, site_xmat = attach(m.site_bodyid, m.site_pos, m.site_quat)
  return xmat, xipos, ximat, geom_xpos, geom_xmat, site_xpos, site_xmat


def com_pos(m: Model, xquat, xipos, ximat, xanchor, xaxis):
  """Subtree com, com-frame inertia cinert (W, nb, 10), dof motion axes
  cdof (W, nv, 6)."""
  acc = list((xipos * m.body_mass[:, None]).unbind(1))
  for b in range(m.nbody - 1, 0, -1):
    p = m.body_parentid[b]
    acc[p] = acc[p] + acc[b]
  subtree_com = torch.stack(acc, 1) / torch.clamp(
      m.body_subtreemass, min=1e-12)[:, None]

  # I = R diag(i) R^T + m (|o|^2 E - o o^T) about the root's subtree com
  off = xipos - subtree_com[:, list(m.body_rootid)]
  mass = m.body_mass[:, None, None]
  imat = (ximat * m.body_inertia[:, None, :]) @ ximat.transpose(-1, -2)
  eye = torch.eye(3, dtype=xipos.dtype, device=xipos.device)
  imat = imat + mass * (math.dot(off, off)[..., None, None] * eye -
                        off[..., :, None] * off[..., None, :])
  cinert = torch.cat([
      torch.stack([imat[..., 0, 0], imat[..., 1, 1], imat[..., 2, 2],
                   imat[..., 0, 1], imat[..., 0, 2], imat[..., 1, 2]], -1),
      m.body_mass[:, None] * off,
      m.body_mass[None, :, None].expand(off.shape[:-1] + (1,))], -1)
  cinert[:, 0] = 0.0

  W = xipos.shape[0]
  cdof = [None] * m.nv
  for j in range(m.njnt):
    b, jt, dadr = m.jnt_bodyid[j], m.jnt_type[j], m.jnt_dofadr[j]
    off_j = xanchor[:, j] - subtree_com[:, m.body_rootid[b]]
    rot_cols = lambda: math.quat_to_mat(xquat[:, b]).unbind(-1)
    if jt == JointType.FREE:
      for i in range(3):
        e = xipos.new_zeros((W, 6))
        e[:, 3 + i] = 1.0
        cdof[dadr + i] = e
      for i, ax in enumerate(rot_cols()):
        cdof[dadr + 3 + i] = torch.cat([ax, math.cross(ax, -off_j)], -1)
    elif jt == JointType.BALL:
      for i, ax in enumerate(rot_cols()):
        cdof[dadr + i] = torch.cat([ax, math.cross(ax, -off_j)], -1)
    elif jt == JointType.SLIDE:
      cdof[dadr] = torch.cat([xipos.new_zeros((W, 3)), xaxis[:, j]], -1)
    else:
      ax = xaxis[:, j]
      cdof[dadr] = torch.cat([ax, math.cross(ax, -off_j)], -1)
  cdof = torch.stack(cdof, 1) if cdof else xipos.new_zeros((W, 0, 6))
  return subtree_com, cinert, cdof


def crb(m: Model, cinert, cdof):
  """Composite rigid-body inertia and the dense mass matrix qM with
  armature (W, nv, nv)."""
  acc = list(cinert.unbind(1))
  for b in range(m.nbody - 1, 0, -1):
    p = m.body_parentid[b]
    if p != 0:
      acc[p] = acc[p] + acc[b]
  crb_ = torch.stack(acc, 1)
  buf = math.inert_mul(crb_[:, list(m.dof_bodyid)], cdof)       # (W, nv, 6)
  full = torch.sum(buf[:, :, None, :] * cdof[:, None, :, :], -1)
  low = full * m.dof_ancestor_mask          # j ancestor-or-self of i
  qM = low + torch.tril(low, -1).transpose(-1, -2) + torch.diag(
      m.dof_armature)
  return crb_, qM


def com_vel(m: Model, qvel, cdof):
  """Body spatial velocities cvel (W, nb, 6) and cdof_dot (W, nv, 6),
  accumulated in C mj_comVel order."""
  W = qvel.shape[0]
  zero6 = qvel.new_zeros((W, 6))
  cvel = [zero6]
  cdof_dot = [zero6] * m.nv
  for b in range(1, m.nbody):
    v = cvel[m.body_parentid[b]]
    for j in range(m.body_jntadr[b], m.body_jntadr[b] + m.body_jntnum[b]):
      jt, dadr = m.jnt_type[j], m.jnt_dofadr[j]
      lin = 3 if jt == JointType.FREE else 0
      ndof = {JointType.FREE: 6, JointType.BALL: 3}.get(jt, 1)
      for i in range(dadr, dadr + lin):
        v = v + cdof[:, i] * qvel[:, i:i + 1]
      for i in range(dadr + lin, dadr + ndof):
        cdof_dot[i] = math.motion_cross(v, cdof[:, i])
      for i in range(dadr + lin, dadr + ndof):
        v = v + cdof[:, i] * qvel[:, i:i + 1]
    cvel.append(v)
  cdof_dot = (torch.stack(cdof_dot, 1) if m.nv else
              qvel.new_zeros((W, 0, 6)))
  return torch.stack(cvel, 1), cdof_dot


def rne(m: Model, qvel, cdof, cinert, cvel, cdof_dot):
  """Bias forces with qacc = 0: cacc (W, nb, 6), qfrc_bias (W, nv)."""
  W = qvel.shape[0]
  grav = qvel.new_zeros((W, 6))
  if not m.opt.disableflags & DisableBit.GRAVITY:
    grav = grav + torch.cat([m.opt.gravity.new_zeros(3), -m.opt.gravity])
  cacc = [grav]
  for b in range(1, m.nbody):
    a = cacc[m.body_parentid[b]]
    for j in range(m.body_jntadr[b], m.body_jntadr[b] + m.body_jntnum[b]):
      dadr = m.jnt_dofadr[j]
      ndof = {JointType.FREE: 6, JointType.BALL: 3}.get(m.jnt_type[j], 1)
      for i in range(dadr, dadr + ndof):
        a = a + cdof_dot[:, i] * qvel[:, i:i + 1]
    cacc.append(a)
  cacc = torch.stack(cacc, 1)
  cfrc = (math.inert_mul(cinert, cacc) +
          math.motion_cross_force(cvel, math.inert_mul(cinert, cvel)))
  acc = list(cfrc.unbind(1))
  for b in range(m.nbody - 1, 0, -1):
    p = m.body_parentid[b]
    acc[p] = acc[p] + acc[b]
  cfrc = torch.stack(acc, 1)
  qfrc_bias = torch.sum(cdof * cfrc[:, list(m.dof_bodyid)], -1)
  return cacc, qfrc_bias


def _lookat(pos, target):
  """Camera matrix (W, 3, 3) whose -z axis points from pos to target."""
  z = math.normalize(pos - target)
  up = torch.zeros_like(z)
  up[:, 2] = 1.0
  x = math.cross(up, z)
  xn = math.norm(x)[:, None]
  small = xn < 1e-8
  unit_x = torch.zeros_like(x)
  unit_x[:, 0] = 1.0
  x = torch.where(small, unit_x, x / torch.where(small, 1.0, xn))
  return torch.stack([x, math.cross(z, x), z], -1)


def _camlight_index(m: Model) -> dict:
  """cam_bodyid and light_bodyid as index tensors, built once per model."""
  idx = lambda x: torch.as_tensor(x, dtype=torch.long, device=m.device)
  return dict(cam=idx(m.cam_bodyid), light=idx(m.light_bodyid))


def camlight(m: Model, xpos, xquat, subtree_com) -> dict:
  """Camera and light frames (W, ...) with the FIXED, TRACK, TRACKCOM,
  TARGETBODY and TARGETBODYCOM modes (mirrors `smooth.camlight` :253)."""
  out = {}
  body = _build.model_tables(m, 'camlight', _camlight_index)
  if m.ncam:
    bq = xquat[:, body['cam']]
    pos = xpos[:, body['cam']] + math.rot_vec_quat(m.cam_pos, bq)
    mat = math.quat_to_mat(math.mul_quat(bq, m.cam_quat))
    poss, mats = [], []
    for c in range(m.ncam):
      mode, b, tb = m.cam_mode[c], m.cam_bodyid[c], m.cam_targetbodyid[c]
      p, R = pos[:, c], mat[:, c]
      if mode == 1:      # TRACK: world-fixed orientation
        p = xpos[:, b] + m.cam_pos0[c]
        R = m.cam_mat0[c].expand_as(R)
      elif mode == 2:    # TRACKCOM
        p = subtree_com[:, b] + m.cam_poscom0[c]
        R = m.cam_mat0[c].expand_as(R)
      if mode in (3, 4) and tb >= 0:
        R = _lookat(p, subtree_com[:, tb] if mode == 4 else xpos[:, tb])
      poss.append(p)
      mats.append(R)
    out.update(cam_xpos=torch.stack(poss, 1), cam_xmat=torch.stack(mats, 1))
  if m.nlight:
    bq = xquat[:, body['light']]
    lpos = xpos[:, body['light']] + math.rot_vec_quat(m.light_pos, bq)
    ldir = math.rot_vec_quat(m.light_dir, bq)
    poss, dirs = [], []
    for c in range(m.nlight):
      mode, b = m.light_mode[c], m.light_bodyid[c]
      tb = m.light_targetbodyid[c]
      p, dr = lpos[:, c], ldir[:, c]
      if mode == 1:
        p = xpos[:, b] + m.light_pos0[c]
        dr = m.light_dir0[c].expand_as(dr)
      elif mode == 2:
        p = subtree_com[:, b] + m.light_poscom0[c]
        dr = m.light_dir0[c].expand_as(dr)
      if mode in (3, 4) and tb >= 0:
        dr = (subtree_com[:, tb] if mode == 4 else xpos[:, tb]) - p
      poss.append(p)
      dirs.append(math.normalize(dr))
    out.update(light_xpos=torch.stack(poss, 1),
               light_xdir=torch.stack(dirs, 1))
  return out


def smooth(m: Model, qpos: torch.Tensor, qvel: torch.Tensor) -> dict:
  """The whole smooth stage for (W, nq) qpos and (W, nv) qvel; returns
  the tensors named in OUTPUTS (qpos comes back normalized)."""
  qpos = normalize_qpos(m, qpos)
  xpos, xquat, xanchor, xaxis = kinematics(m, qpos)
  (xmat, xipos, ximat, geom_xpos, geom_xmat, site_xpos,
   site_xmat) = frames(m, xpos, xquat)
  subtree_com, cinert, cdof = com_pos(m, xquat, xipos, ximat, xanchor, xaxis)
  crb_, qM = crb(m, cinert, cdof)
  cvel, cdof_dot = com_vel(m, qvel, cdof)
  cacc, qfrc_bias = rne(m, qvel, cdof, cinert, cvel, cdof_dot)
  return dict(qpos=qpos, xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
              ximat=ximat, xanchor=xanchor, xaxis=xaxis, geom_xpos=geom_xpos,
              geom_xmat=geom_xmat, site_xpos=site_xpos, site_xmat=site_xmat,
              subtree_com=subtree_com, cinert=cinert, cdof=cdof, crb=crb_,
              qM=qM, cvel=cvel, cdof_dot=cdof_dot, cacc=cacc,
              qfrc_bias=qfrc_bias)
