"""Constraint (efc) rows: dof friction, joint limits and pyramidal
contacts at fixed row addresses (io.efc_layout).

Mirrors `mujoco_warp_tpu/constraint.py` (`_kbi` :32, `_row` :63, the
friction and limit rows of `make_constraint` :102, the pyramidal branch
of `_contact_rows_all` :388) with one difference: the Jacobian of a row
that does not exist this step (an inactive limit, an empty contact slot,
the unused rows of a frictionless contact) is zero, as in the CUDA
kernel. Such rows also have D = aref = frictionloss = 0, so the solver
sees the same problem either way.
"""

from __future__ import annotations

import torch

from . import math
from .io import efc_layout
from .types import ConstraintType, DisableBit, JointType, Model

MINVAL = 1e-15
_MINIMP = 0.0001
_MAXIMP = 0.9999


def kbi(m: Model, solref, solimp, pos_imp):
  """Stiffness, damping and impedance (mj_assignRef / mj_getImpedance);
  solref (..., 2), solimp (..., 5), pos_imp (...)."""
  timeconst, dampratio = solref[..., 0], solref[..., 1]
  dmin = torch.clamp(solimp[..., 0], _MINIMP, _MAXIMP)
  dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
  width = torch.clamp(solimp[..., 2], min=MINVAL)
  mid = torch.clamp(solimp[..., 3], _MINIMP, _MAXIMP)
  power = torch.clamp(solimp[..., 4], min=1.0)
  if not m.opt.disableflags & DisableBit.REFSAFE:
    timeconst = torch.maximum(timeconst, 2.0 * m.opt.timestep)
  dmax_sq = dmax * dmax
  k = 1.0 / torch.clamp(dmax_sq * timeconst * timeconst * dampratio *
                        dampratio, min=MINVAL)
  b = 2.0 / torch.clamp(dmax * timeconst, min=MINVAL)
  k = torch.where(solref[..., 0] <= 0, -solref[..., 0] / dmax_sq, k)
  b = torch.where(solref[..., 1] <= 0, -solref[..., 1] / dmax, b)
  imp_x = torch.abs(pos_imp) / width
  imp_a = (1.0 / mid ** (power - 1)) * imp_x ** power
  imp_b = 1.0 - (1.0 / (1.0 - mid) ** (power - 1)) * (1.0 - imp_x) ** power
  imp_y = torch.where(imp_x < mid, imp_a, imp_b)
  imp = torch.clamp(dmin + imp_y * (dmax - dmin), dmin, dmax)
  imp = torch.where(imp_x > 1.0, dmax, imp)
  return k, b, imp


def _rows(m: Model, J, pos, invweight, solref, solimp, margin, vel,
          frictionloss, ctype, cid, exists):
  """Finish a batch of efc rows (all args broadcast to J.shape[:-1])."""
  k, b, imp = kbi(m, solref, solimp, pos)
  act = exists.to(J.dtype)
  shape = J.shape[:-1]
  full = lambda x: torch.as_tensor(x, device=J.device).expand(shape)
  return dict(
      J=J * act[..., None],
      pos=full(pos + margin).to(J.dtype),
      margin=full(margin).to(J.dtype),
      D=full(1.0 / torch.clamp(invweight * (1.0 - imp) / imp, min=MINVAL) *
             act),
      vel=full(vel),
      aref=full((-k * imp * pos - b * vel) * act),
      frictionloss=full(frictionloss * act).to(J.dtype),
      type=full(torch.as_tensor(ctype, dtype=torch.int32, device=J.device)),
      id=full(torch.as_tensor(cid, dtype=torch.int32, device=J.device)),
      active=full(exists))


def make_constraint(m: Model, qpos, qvel, cdof, subtree_com,
                    contact: dict) -> dict:
  """All efc rows (W, njmax, ...) plus the row counts ne, nf, nl, nefc and
  the contacts' efc_address."""
  W, nv = qpos.shape[0], m.nv
  dev, dt = qpos.device, qpos.dtype
  nconmax = contact['dist'].shape[1]
  ne, nf, nl, stride, njmax = efc_layout(m, nconmax)
  onehot = lambda ids: torch.eye(nv, dtype=dt, device=dev)[ids]
  ivec = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
  groups = []

  # dof friction
  fr_ids = [i for i in range(nv) if m.dof_hasfrictionloss[i]]
  if fr_ids:
    n = len(fr_ids)
    on = not m.opt.disableflags & DisableBit.FRICTIONLOSS
    groups.append(_rows(
        m, onehot(fr_ids).expand(W, n, nv), qvel.new_zeros((W, n)),
        m.dof_invweight0[fr_ids], m.dof_solref[fr_ids],
        m.dof_solimp[fr_ids], 0.0, qvel[:, fr_ids],
        m.dof_frictionloss[fr_ids], ConstraintType.FRICTION_DOF,
        ivec(fr_ids), torch.full((W, n), on, dtype=torch.bool, device=dev)))

  # joint limits (slide / hinge; other limited joints are outside the gate)
  lim = [j for j in range(m.njnt) if m.jnt_limited[j]]
  if lim:
    assert all(m.jnt_type[j] in (JointType.SLIDE, JointType.HINGE)
               for j in lim)
    qadr = [m.jnt_qposadr[j] for j in lim]
    dadr = [m.jnt_dofadr[j] for j in lim]
    q = qpos[:, qadr]
    dist_min = q - m.jnt_range[lim, 0]
    dist_max = m.jnt_range[lim, 1] - q
    pos = torch.minimum(dist_min, dist_max) - m.jnt_margin[lim]
    exists = pos < 0
    if m.opt.disableflags & DisableBit.LIMIT:
      exists = torch.zeros_like(exists)
    sign = torch.where(dist_min < dist_max, 1.0, -1.0).to(dt)
    groups.append(_rows(
        m, onehot(dadr) * sign[..., None], pos, m.dof_invweight0[dadr],
        m.jnt_solref[lim], m.jnt_solimp[lim], m.jnt_margin[lim],
        sign * qvel[:, dadr], 0.0, ConstraintType.LIMIT_JOINT, ivec(lim),
        exists))

  if nconmax and stride:
    groups.append(_contact_rows(m, qvel, cdof, subtree_com, contact, stride))
  if not groups:   # no rows at all: empty (W, 0, ...) arrays
    groups.append(_rows(
        m, qvel.new_zeros((W, 0, nv)), qvel.new_zeros((W, 0)),
        qvel.new_zeros((W, 0)), qvel.new_zeros((W, 0, 2)),
        qvel.new_zeros((W, 0, 5)), 0.0, qvel.new_zeros((W, 0)), 0.0, 0, 0,
        torch.zeros((W, 0), dtype=torch.bool, device=dev)))
  out = {k: torch.cat([g[k] for g in groups], 1)
         for k in ('J', 'pos', 'margin', 'D', 'vel', 'aref', 'frictionloss',
                   'type', 'id', 'active')}
  active = out['active']
  count = lambda a, b: active[:, a:b].sum(1, dtype=torch.int32)
  efc_address = ne + nf + nl + stride * torch.arange(
      nconmax, dtype=torch.int32, device=dev)
  out.update(
      ne=count(0, ne), nf=count(ne, ne + nf), nl=count(ne + nf, ne + nf + nl),
      nefc=active.sum(1, dtype=torch.int32),
      efc_address=torch.where(contact['geom'][..., 0] >= 0, efc_address, -1))
  return out


def _contact_rows(m: Model, qvel, cdof, subtree_com, con: dict,
                  stride: int) -> dict:
  """Pyramidal contact rows, `stride` per pool slot."""
  W, C = con['dist'].shape
  dev = qvel.device
  geom_bodyid = torch.tensor(m.geom_bodyid, device=dev)
  rootid = torch.tensor(m.body_rootid, device=dev)
  g1, g2 = con['geom'][..., 0].long(), con['geom'][..., 1].long()
  valid = g1 >= 0
  b1 = torch.where(valid, geom_bodyid[g1.clamp(min=0)], 0)
  b2 = torch.where(valid, geom_bodyid[g2.clamp(min=0)], 0)
  dim = con['dim']
  pos = con['dist'] - con['includemargin']
  active_con = (pos < 0) & valid

  # frame row f of the contact Jacobians, from cdof = (A | L) per dof:
  #   f . jacp_b[:, n] = mask_b[n] (f . L[n] - (f x off_b) . A[n])
  frame = con['frame']                                   # (W, C, 3, 3)
  A, L = cdof[..., :3], cdof[..., 3:]                    # (W, nv, 3)
  bidx = lambda b: torch.gather(
      subtree_com, 1, rootid[b][..., None].expand(W, C, 3))
  off1 = con['pos'] - bidx(b1)
  off2 = con['pos'] - bidx(b2)
  mask1 = m.body_dof_ancestor_mask[b1]                   # (W, C, nv)
  mask2 = m.body_dof_ancestor_mask[b2]
  FL = torch.einsum('wcri,wni->wcrn', frame, L)
  FA = torch.einsum('wcri,wni->wcrn', frame, A)
  QA1 = torch.einsum('wcri,wni->wcrn', math.cross(frame, off1[:, :, None]),
                     A)
  QA2 = torch.einsum('wcri,wni->wcrn', math.cross(frame, off2[:, :, None]),
                     A)
  jp = mask2[:, :, None] * (FL - QA2) - mask1[:, :, None] * (FL - QA1)
  jr = (mask2 - mask1)[:, :, None] * FA
  jn = jp[:, :, 0]                                       # (W, C, nv)
  jdirs = torch.cat([jp[:, :, 1:3], jr], 2)              # (W, C, 5, nv)

  invw = m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0]
  friction = con['friction']
  fri0 = friction[..., 0]
  impratio = torch.clamp(m.opt.impratio, min=MINVAL)
  invw_pyr = (invw + fri0 * fri0 * invw) * 2.0 * fri0 * fri0 / impratio

  r = torch.arange(stride, device=dev)
  kidx = r // 2                                          # friction dim - 1
  sign = torch.where(r % 2 == 0, 1.0, -1.0).to(qvel.dtype)
  is_fl_row = (dim[..., None] == 1) & (r == 0)
  pyr_exists = (dim[..., None] > 1) & (r < 2 * (dim[..., None] - 1))
  exists = active_con[..., None] & (is_fl_row | pyr_exists)
  frii = friction[..., kidx]                             # (W, C, S)
  j_pyr = jn[:, :, None] + (sign[:, None] * frii[..., None] *
                            jdirs[:, :, kidx])
  J = torch.where(is_fl_row[..., None], jn[:, :, None], j_pyr)
  iw = torch.where(dim[..., None] == 1, invw[..., None],
                   invw_pyr[..., None]).expand(W, C, stride)
  vel = torch.sum(J * qvel[:, None, None, :], -1)
  ctype = torch.where(dim == 1, int(ConstraintType.CONTACT_FRICTIONLESS),
                      int(ConstraintType.CONTACT_PYRAMIDAL))
  rep = lambda x: x[:, :, None].expand((W, C, stride) + x.shape[2:])
  rows = _rows(m, J, rep(pos), iw, rep(con['solref']), rep(con['solimp']),
               rep(con['includemargin']), vel, 0.0, 0, 0, exists)
  rows['type'] = rep(ctype.to(torch.int32))
  rows['id'] = rep(torch.arange(C, dtype=torch.int32, device=dev).expand(
      W, C))
  return {k: v.reshape((W, C * stride) + v.shape[3:])
          for k, v in rows.items()}
