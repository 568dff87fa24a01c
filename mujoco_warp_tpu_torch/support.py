"""Support functions (mirrors `mujoco_warp_tpu/support.py`): the
applied wrenches' generalized forces, the contact forces and
rne_postconstraint (cacc, cfrc_ext, cfrc_int), and an object's
acceleration."""

from __future__ import annotations

import torch

from . import math
from .kernels import _build
from .types import ConeType, DisableBit, Model


def _index(m: Model) -> dict:
  """body_rootid, dof_bodyid and geom_bodyid as index tensors, built once
  per model."""
  idx = lambda x: torch.as_tensor(x, dtype=torch.long, device=m.device)
  return dict(rootid=idx(m.body_rootid), dof_bodyid=idx(m.dof_bodyid),
              geom_bodyid=idx(m.geom_bodyid))


def xfrc_accumulate(m: Model, xfrc_applied, xipos, subtree_com, cdof):
  """Generalized forces of the Cartesian wrenches xfrc_applied (W, nb, 6)
  applied at the body coms (support.py:84)."""
  t = _build.model_tables(m, 'support', _index)
  force, torque = xfrc_applied[..., :3], xfrc_applied[..., 3:]
  offset = xipos - subtree_com[:, t['rootid']]
  cfrc = torch.cat([torque + math.cross(offset, force), force], -1)
  csub = torch.einsum('bc,wci->wbi', m.body_subtree_mask, cfrc)
  return torch.sum(cdof * csub[:, t['dof_bodyid']], -1)


def contact_force(m: Model, contact, efc_force):
  """(W, C, 6) force of each pool slot in its contact frame (normal,
  tangents, torsion), decoded from efc_force (W, njmax) (support.py:121,
  C mj_contactForce): the elliptic rows are the force itself; a
  pyramidal contact's normal is the sum of its rows and its k-th
  friction component (row 2k - row 2k+1) mu_k. Empty slots give 0."""
  adr, dim = contact.efc_address.long(), contact.dim.long()
  nj = efc_force.shape[1]
  W, C = adr.shape
  on = (adr >= 0)[..., None]
  if m.opt.cone == ConeType.ELLIPTIC:
    rows = torch.arange(6, device=adr.device)
    idx = torch.clamp(adr[..., None] + rows, 0, nj - 1)
    vals = torch.gather(efc_force, 1, idx.reshape(W, -1)).reshape(W, C, 6)
    return torch.where(on & (rows < dim[..., None]), vals, 0.0)
  rows = torch.arange(10, device=adr.device)
  idx = torch.clamp(adr[..., None] + rows, 0, nj - 1)
  vals = torch.gather(efc_force, 1, idx.reshape(W, -1)).reshape(W, C, 10)
  pyr = torch.where(on & (rows < 2 * (dim[..., None] - 1)), vals, 0.0)
  frictionless = torch.where(on[..., 0] & (dim == 1), vals[..., 0], 0.0)
  comps = [torch.sum(pyr, -1) + frictionless]
  for k in range(4):
    comps.append(torch.where(dim > k + 1, (pyr[..., 2 * k] -
                                           pyr[..., 2 * k + 1]) *
                             contact.friction[..., k], 0.0))
  comps.append(torch.zeros_like(comps[0]))
  return torch.stack(comps, -1)


def transform_motion(vec, offset):
  """A motion vector (..., 6) moved to a frame offset by `offset`
  (C mju_transformSpatial, motion)."""
  ang = vec[..., :3]
  return torch.cat([ang, vec[..., 3:] - math.cross(offset, ang)], -1)


def rne_postconstraint(m: Model, d) -> dict:
  """cacc with the step's qacc, cfrc_ext (the applied wrenches and the
  contact forces on both bodies of each contact, in com frames) and
  cfrc_int (subtree sums of the net wrenches), (W, nbody, 6) each
  (support.py:158, C mj_rnePostConstraint). cacc replaces Data.cacc."""
  t = _build.model_tables(m, 'support', _index)
  W = d.qpos.shape[0]
  frc, trq = d.xfrc_applied[..., :3], d.xfrc_applied[..., 3:]
  offset = d.xipos - d.subtree_com[:, t['rootid']]
  cfrc_ext = torch.cat([trq + math.cross(offset, frc), frc], -1)
  con = d.contact
  if con.dist.shape[1] and m.ngeom:
    force = contact_force(m, con, d.efc_force)
    f_w = torch.einsum('wcji,wcj->wci', con.frame, force[..., :3])
    t_w = torch.einsum('wcji,wcj->wci', con.frame, force[..., 3:])
    g1, g2 = con.geom[..., 0].long(), con.geom[..., 1].long()
    valid = (g1 >= 0) & (con.dist < con.includemargin)
    bodies = torch.arange(m.nbody, device=g1.device)
    for g, sign in ((g2, 1.0), (g1, -1.0)):
      body = t['geom_bodyid'][torch.clamp(g, min=0)]
      com = torch.gather(d.subtree_com, 1, t['rootid'][body][..., None]
                         .expand(body.shape + (3,)))
      torque = t_w + math.cross(con.pos - com, f_w)
      wrench = torch.cat([torque, f_w], -1) * sign
      # each body's sum over the slots as a product with the slots' one-hot
      # bodies (W, C, nbody): the same order every run, where a scatter-add
      # on the card adds in whatever order its atomics land
      onehot = ((body[..., None] == bodies) & valid[..., None]).to(
          wrench.dtype)
      cfrc_ext = cfrc_ext + torch.einsum('wcb,wci->wbi', onehot, wrench)
  contrib = d.cdof_dot * d.qvel[..., None] + d.cdof * d.qacc[..., None]
  cacc = torch.einsum('bj,wji->wbi', m.body_dof_ancestor_mask, contrib)
  if not m.opt.disableflags & DisableBit.GRAVITY:
    grav = torch.cat([torch.zeros_like(m.opt.gravity), -m.opt.gravity])
    cacc = torch.cat([grav.expand(W, 1, 6), cacc[:, 1:] + grav], 1)
  cfrc_com = math.inert_mul(d.cinert, cacc) + math.motion_cross_force(
      d.cvel, math.inert_mul(d.cinert, d.cvel))
  cfrc_int = torch.einsum('bc,wci->wbi', m.body_subtree_mask,
                          cfrc_com - cfrc_ext)
  cfrc_int = torch.cat([torch.zeros_like(cfrc_int[:, :1]), cfrc_int[:, 1:]],
                       1)
  return dict(cacc=cacc, cfrc_ext=cfrc_ext, cfrc_int=cfrc_int)


def object_acceleration(m: Model, d, pos, body: int):
  """(acc, vel) (W, 6) each, angular then linear, of a point pos (W, 3)
  fixed to `body`, world-aligned (support.py:221, C
  mj_objectAcceleration): the linear part corrected by w x v."""
  offset = pos - d.subtree_com[:, m.body_rootid[body]]
  acc = transform_motion(d.cacc[:, body], offset)
  vel = transform_motion(d.cvel[:, body], offset)
  corr = math.cross(vel[:, :3], vel[:, 3:])
  return torch.cat([acc[:, :3], acc[:, 3:] + corr], -1), vel
