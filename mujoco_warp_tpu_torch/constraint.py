"""Constraint (efc) rows: joint equalities, dof friction, joint limits
and contacts (pyramidal or elliptic cone) at fixed row addresses
(io.efc_layout).

Mirrors `mujoco_warp_tpu/constraint.py` (`_kbi` :32, `_row` :63, the
joint equality, friction and limit rows of `make_constraint` :102,
`_contact_rows_all` :388 with its elliptic branch :479-517) with one
difference: the Jacobian of a row that does not exist this step (an
inactive equality, limit or contact, an empty contact slot, the unused
rows of a contact of lower dim) is zero, as in the CUDA kernel. Such
rows also have D = aref = frictionloss = 0, so the solver sees the same
problem either way.
"""

from __future__ import annotations

import torch

from . import math
from .io import efc_layout
from .kernels import _build
from .types import ConeType, ConstraintType, DisableBit, JointType, Model

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

  def full(x, dtype=J.dtype):   # a python number is filled on the device
    if not torch.is_tensor(x):
      x = J.new_full((), x, dtype=dtype)
    return x.to(dtype).expand(shape)
  return dict(
      J=J * act[..., None],
      pos=full(pos + margin),
      margin=full(margin),
      D=full(1.0 / torch.clamp(invweight * (1.0 - imp) / imp, min=MINVAL) *
             act),
      vel=full(vel),
      aref=full((-k * imp * pos - b * vel) * act),
      frictionloss=full(frictionloss * act),
      type=full(ctype, torch.int32), id=full(cid, torch.int32),
      active=full(exists, torch.bool))


def eq_active_or_start(m: Model, qpos, eq_active):
  """eq_active (W, neq) bool, or where None each equality as the model
  starts it (eq_active0) in every world."""
  if eq_active is None:
    return m.eq_active0[None].repeat(qpos.shape[0], 1)
  return eq_active


def _equality_rows(m: Model, qpos, qvel, eq_active) -> dict:
  """One row per joint equality (constraint.py:193-213): pos = q1 -
  qpos0[q1] - poly(dif), dif = q2 - qpos0[q2] (poly(0) = data[0] with one
  joint), J = 1 at dof 1 and -poly'(dif) at dof 2, vel = J qvel; active
  where eq_active and the equality flag is clear."""
  W = qpos.shape[0]
  on = not m.opt.disableflags & DisableBit.EQUALITY
  J = qpos.new_zeros((W, m.neq, m.nv))
  pos = qpos.new_zeros((W, m.neq))
  vel = qpos.new_zeros((W, m.neq))
  invweight = []
  for i in range(m.neq):
    j1, j2 = m.eq_obj1id[i], m.eq_obj2id[i]
    d1, q1 = m.jnt_dofadr[j1], m.jnt_qposadr[j1]
    c = m.eq_data[i]
    J[:, i, d1] = 1.0
    if j2 > -1:
      d2, q2 = m.jnt_dofadr[j2], m.jnt_qposadr[j2]
      dif = qpos[:, q2] - m.qpos0[q2]
      rhs = c[0] + dif * (c[1] + dif * (c[2] + dif * (c[3] + dif * c[4])))
      deriv = c[1] + dif * (2 * c[2] + dif * (3 * c[3] + dif * 4 * c[4]))
      pos[:, i] = qpos[:, q1] - m.qpos0[q1] - rhs
      J[:, i, d2] = -deriv
      vel[:, i] = qvel[:, d1] - deriv * qvel[:, d2]
      invweight.append(m.dof_invweight0[d1] + m.dof_invweight0[d2])
    else:
      pos[:, i] = qpos[:, q1] - m.qpos0[q1] - c[0]
      vel[:, i] = qvel[:, d1]
      invweight.append(m.dof_invweight0[d1])
  ids = torch.arange(m.neq, dtype=torch.int32, device=qpos.device)
  return _rows(m, J, pos, torch.stack(invweight), m.eq_solref, m.eq_solimp,
               0.0, vel, 0.0, ConstraintType.EQUALITY, ids, eq_active & on)


def constraint_tables(m: Model) -> dict:
  """Index tensors of the friction and limit rows and of the contacts'
  bodies, built once per model, so that a step builds no tensor from
  host data (a CUDA graph captures the torch rows of a model past the
  large-scene threshold, `collision_sap.py`)."""
  def make(m):
    dev = m.device
    idx = lambda x: torch.as_tensor(x, dtype=torch.long, device=dev)
    fr = [i for i in range(m.nv) if m.dof_hasfrictionloss[i]]
    lim = [j for j in range(m.njnt) if m.jnt_limited[j]]
    assert all(m.jnt_type[j] in (JointType.SLIDE, JointType.HINGE)
               for j in lim)
    dadr = [m.jnt_dofadr[j] for j in lim]
    eye = torch.eye(m.nv, device=dev)
    return dict(fr=idx(fr), fr_J=eye[fr], lim=idx(lim),
                lim_qadr=idx([m.jnt_qposadr[j] for j in lim]),
                lim_dadr=idx(dadr), lim_J=eye[dadr],
                geom_bodyid=idx(m.geom_bodyid), rootid=idx(m.body_rootid))
  return _build.model_tables(m, 'constraint', make)


def make_constraint(m: Model, qpos, qvel, cdof, subtree_com,
                    contact: dict, eq_active=None) -> dict:
  """All efc rows (W, njmax, ...) plus the row counts ne, nf, nl, nefc and
  the contacts' efc_address; eq_active (W, neq) bool as
  `eq_active_or_start`."""
  W, nv = qpos.shape[0], m.nv
  dev, dt = qpos.device, qpos.dtype
  nconmax = contact['dist'].shape[1]
  ne, nf, nl, stride, njmax = efc_layout(m, nconmax)
  t = constraint_tables(m)
  groups = []

  if ne:
    groups.append(_equality_rows(m, qpos, qvel,
                                 eq_active_or_start(m, qpos, eq_active)))

  # dof friction
  fr = t['fr']
  if nf:
    on = not m.opt.disableflags & DisableBit.FRICTIONLOSS
    groups.append(_rows(
        m, t['fr_J'].to(dt).expand(W, nf, nv), qvel.new_zeros((W, nf)),
        m.dof_invweight0[fr], m.dof_solref[fr], m.dof_solimp[fr], 0.0,
        qvel[:, fr], m.dof_frictionloss[fr], ConstraintType.FRICTION_DOF,
        fr.to(torch.int32), torch.full((W, nf), on, dtype=torch.bool,
                                       device=dev)))

  # joint limits (slide / hinge; other limited joints are outside the gate)
  lim, dadr = t['lim'], t['lim_dadr']
  if nl:
    q = qpos[:, t['lim_qadr']]
    dist_min = q - m.jnt_range[lim, 0]
    dist_max = m.jnt_range[lim, 1] - q
    pos = torch.minimum(dist_min, dist_max) - m.jnt_margin[lim]
    exists = pos < 0
    if m.opt.disableflags & DisableBit.LIMIT:
      exists = torch.zeros_like(exists)
    sign = torch.where(dist_min < dist_max, 1.0, -1.0).to(dt)
    groups.append(_rows(
        m, t['lim_J'].to(dt) * sign[..., None], pos, m.dof_invweight0[dadr],
        m.jnt_solref[lim], m.jnt_solimp[lim], m.jnt_margin[lim],
        sign * qvel[:, dadr], 0.0, ConstraintType.LIMIT_JOINT,
        lim.to(torch.int32), exists))

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
  """Contact rows of the model's cone, `stride` per pool slot."""
  W, C = con['dist'].shape
  dev = qvel.device
  t = constraint_tables(m)
  geom_bodyid, rootid = t['geom_bodyid'], t['rootid']
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
  if m.opt.cone == ConeType.ELLIPTIC:
    return _elliptic_rows(m, qvel, con, stride, pos, active_con, jn, jdirs,
                          invw)
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


def _elliptic_rows(m: Model, qvel, con: dict, S: int, pos, active_con, jn,
                   jdirs, invw) -> dict:
  """Elliptic contact rows (constraint.py:479-517): row 0 the normal with
  the standard impedance; row r >= 1 along the frame's tangent, then its
  rotations (torsion, rolling), with D_r = D_0 impratio (mu_r / mu_1)^2
  and aref_r = -b_f vel_r, where b_f comes from solreffriction when that
  is set and is the normal row's b otherwise."""
  W, C = con['dist'].shape
  dev = qvel.device
  dim = con['dim']
  friction = con['friction']
  k, b, imp = kbi(m, con['solref'], con['solimp'], pos)       # (W, C)
  d0 = 1.0 / torch.clamp(invw * (1.0 - imp) / imp, min=MINVAL)
  r = torch.arange(S, device=dev)
  fr_row = friction[..., torch.clamp(r - 1, 0, 4)]            # (W, C, S)
  d_fr = d0[..., None] * m.opt.impratio * (
      fr_row / torch.clamp(friction[..., :1], min=MINVAL)) ** 2
  srf = con['solreffriction']
  use_srf = torch.any(torch.abs(srf) > 1e-12, -1)
  b_f = torch.where(use_srf, 2.0 / torch.clamp(
      torch.clamp(con['solimp'][..., 1], _MINIMP, _MAXIMP) * srf[..., 0],
      min=MINVAL), b)
  J = torch.cat([jn[:, :, None], jdirs], 2)[:, :, :S]         # (W, C, S, nv)
  vel = torch.sum(J * qvel[:, None, None, :], -1)
  is_normal = r == 0
  exists = active_con[..., None] & (r < torch.clamp(dim, min=1)[..., None])
  act = exists.to(qvel.dtype)
  D = torch.where(is_normal, d0[..., None], d_fr) * act
  aref = torch.where(is_normal,
                     (-k * imp * pos)[..., None] - b[..., None] * vel,
                     -b_f[..., None] * vel) * act
  ctype = torch.where(dim == 1, int(ConstraintType.CONTACT_FRICTIONLESS),
                      int(ConstraintType.CONTACT_ELLIPTIC)).to(torch.int32)
  rep = lambda x: x[:, :, None].expand(W, C, S)
  rows = dict(
      J=J * act[..., None], pos=rep(pos + con['includemargin']),
      margin=rep(con['includemargin']), D=D, vel=vel, aref=aref,
      frictionloss=torch.zeros_like(D), type=rep(ctype),
      id=rep(torch.arange(C, dtype=torch.int32, device=dev).expand(W, C)),
      active=exists)
  return {k: v.reshape((W, C * S) + v.shape[3:]) for k, v in rows.items()}
