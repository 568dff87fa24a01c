"""Step orchestration: the glue-folded batched step.

`step_batched` runs the stage list of the JAX package's glue-folded step
(`mujoco_warp_tpu/forward.py:577-676`, `_glue_stages`) under the same
stage names, with the Pallas kernels replaced by the CUDA kernels of
`kernels/`:

  smooth_mega[cuda]       kernel B1: kinematics .. rne
  contact_efc_mega[cuda]  kernel B2: narrowphase, compaction, efc rows
  act_len_vel             actuator lengths and velocities (tensor ops)
  solve_glue[cuda]        kernel B3: actuation, passive, Newton, advance

This module also holds the plain version of B3 (`glue`): actuation
(:83), passive forces, qfrc_smooth, the Newton solve and the Euler
advance (`_advance` :331, `_integrate_pos` :274), in the glue kernel's
formulation.
"""

from __future__ import annotations

import torch

from . import math
from . import passive as passive_mod
from . import solver
from . import support
from .io import efc_layout
from .types import (CONTACT_TENSORS, BiasType, Contact, Data, DisableBit,
                    GainType, JointType, Model)

_BIG = 1e30


def actuator_addrs(m: Model):
  """qpos and dof addresses of each actuator's joint."""
  jids = [m.actuator_trnid[u][0] for u in range(m.nu)]
  return [m.jnt_qposadr[j] for j in jids], [m.jnt_dofadr[j] for j in jids]


def act_len_vel(m: Model, qpos, qvel):
  """actuator_length and actuator_velocity (W, nu) of joint actuators."""
  qadr, dadr = actuator_addrs(m)
  gear0 = m.actuator_gear[:, 0]
  return qpos[:, qadr] * gear0, qvel[:, dadr] * gear0


def actuation_tables(m: Model) -> dict:
  """Per-actuator and per-dof tables of the affine actuation model,
  shared by the plain `fwd_actuation` and kernel B3."""
  dev = m.device
  nu = m.nu
  dis = m.opt.disableflags
  f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
  clamp_ctrl = not dis & DisableBit.CLAMPCTRL
  climit = f([bool(m.actuator_ctrllimited[u]) and clamp_ctrl
              for u in range(nu)]).bool()
  flimit = f(m.actuator_forcelimited).bool() if nu else climit
  gp, bp = m.actuator_gainprm, m.actuator_biasprm
  affine_g = f([t == GainType.AFFINE for t in m.actuator_gaintype])[:, None]
  affine_b = f([t == BiasType.AFFINE for t in m.actuator_biastype])[:, None]
  gain3 = torch.cat([gp[:, :1], gp[:, 1:3] * affine_g], 1)
  bias3 = bp[:, :3] * affine_b
  big = torch.full((nu,), _BIG, device=dev)
  ctrl_lo = torch.where(climit, m.actuator_ctrlrange[:, 0], -big)
  ctrl_hi = torch.where(climit, m.actuator_ctrlrange[:, 1], big)
  frc_lo = torch.where(flimit, m.actuator_forcerange[:, 0], -big)
  frc_hi = torch.where(flimit, m.actuator_forcerange[:, 1], big)
  lim = f([bool(m.jnt_actfrclimited[m.dof_jntid[v]])
           for v in range(m.nv)]).bool()
  bigv = torch.full((m.nv,), _BIG, device=dev)
  dof_jnt = list(m.dof_jntid)
  af_lo = torch.where(lim, m.jnt_actfrcrange[dof_jnt, 0], -bigv)
  af_hi = torch.where(lim, m.jnt_actfrcrange[dof_jnt, 1], bigv)
  return dict(gain3=gain3, bias3=bias3, ctrl_lo=ctrl_lo, ctrl_hi=ctrl_hi,
              frc_lo=frc_lo, frc_hi=frc_hi, af_lo=af_lo, af_hi=af_hi)


def fwd_actuation(m: Model, qpos, qvel, ctrl):
  """Affine actuators on slide/hinge joints -> actuator_force (W, nu),
  qfrc_actuator (W, nv)."""
  W = qpos.shape[0]
  if m.nu == 0 or m.opt.disableflags & DisableBit.ACTUATION:
    return qpos.new_zeros((W, m.nu)), qpos.new_zeros((W, m.nv))
  t = actuation_tables(m)
  length, velocity = act_len_vel(m, qpos, qvel)
  c = torch.minimum(torch.maximum(ctrl, t['ctrl_lo']), t['ctrl_hi'])
  g, b = t['gain3'], t['bias3']
  gain = g[:, 0] + g[:, 1] * length + g[:, 2] * velocity
  bias = b[:, 0] + b[:, 1] * length + b[:, 2] * velocity
  force = torch.minimum(torch.maximum(gain * c + bias, t['frc_lo']),
                        t['frc_hi'])
  _, dadr = actuator_addrs(m)
  qfa = qpos.new_zeros((W, m.nv))
  qfa.index_add_(1, torch.tensor(dadr, device=qpos.device),
                 force * m.actuator_gear[:, 0])
  qfa = torch.minimum(torch.maximum(qfa, t['af_lo']), t['af_hi'])
  return force, qfa


def glue_mode(m: Model) -> int:
  """Integration diagonal of the glue solve: 0 plain Euler, 1 Euler with
  implicit joint damping (mirrors forward._glue_mode :469)."""
  if m.has_damping and not m.opt.disableflags & DisableBit.EULERDAMP:
    return 1
  return 0


def integration_diag(m: Model):
  """h * dof damping, the diagonal of the mode-1 re-solve
  (qM + diag) qacc_euler = qfrc_smooth + qfrc_constraint; None in mode 0."""
  if glue_mode(m) != 1:
    return None
  if m.opt.disableflags & DisableBit.DAMPER:
    return torch.zeros_like(m.dof_damping)
  return m.opt.timestep * m.dof_damping


def integrate_pos(m: Model, qpos, qvel, h):
  """mj_integratePos in the glue kernel's form: scalar and free-joint
  linear coordinates step by h*qvel; quaternions rotate exactly."""
  out = qpos.clone()
  for j in range(m.njnt):
    jt, q, v = m.jnt_type[j], m.jnt_qposadr[j], m.jnt_dofadr[j]
    if jt == JointType.FREE:
      out[:, q:q + 3] = qpos[:, q:q + 3] + h * qvel[:, v:v + 3]
      q, v = q + 3, v + 3
    elif jt != JointType.BALL:
      out[:, q] = qpos[:, q] + h * qvel[:, v]
      continue
    w = qvel[:, v:v + 3]
    norm = torch.sqrt(torch.clamp(torch.sum(w * w, 1, keepdim=True),
                                  min=1e-30))
    half = 0.5 * norm * h
    dq = torch.cat([torch.cos(half), w / norm * torch.sin(half)], 1)
    out[:, q:q + 4] = math.quat_normalize_rsqrt(
        math.mul_quat(qpos[:, q:q + 4], dq))
  return out


def glue(m: Model, qM, efc_J, efc_D, efc_aref, efc_frictionloss, qpos,
         qvel, ctrl, qfx, qacc_warmstart) -> dict:
  """Plain version of kernel B3: actuation + passive + qfrc_smooth +
  Newton solve + Euler advance. qfx = qfrc_applied + xfrc - qfrc_bias."""
  ne, nf, _, _, _ = efc_layout(m, 0)
  h = m.opt.timestep
  afrc, qfa = fwd_actuation(m, qpos, qvel, ctrl)
  qfsp, qfdp, qfp = passive_mod.passive(m, qpos, qvel)
  qfs = qfp + qfa + qfx
  out = solver.newton(
      m, qM, efc_J, efc_D, efc_aref, efc_frictionloss, qfs, qacc_warmstart,
      ne, nf, use_warmstart=not m.opt.disableflags & DisableBit.WARMSTART,
      hdiag=integration_diag(m))
  qvel_new = qvel + h * out['qacc_euler']
  out.update(actuator_force=afrc, qfrc_actuator=qfa, qfrc_spring=qfsp,
             qfrc_damper=qfdp, qfrc_passive=qfp, qfrc_smooth=qfs,
             qvel=qvel_new, qpos=integrate_pos(m, qpos, qvel_new, h))
  return out


def glue_stages(m: Model, d: Data) -> list:
  """[(name, fn)] of the batched step, fn: Data -> Data."""
  from .kernels import contact as contact_k
  from .kernels import glue as glue_k
  from .kernels import smooth as smooth_k
  nconmax = d.contact.dist.shape[1]

  def smooth_stage(dd):
    return dd.replace(**smooth_k.smooth(m, dd.qpos, dd.qvel))

  def contact_stage(dd):
    out = contact_k.contact(m, dd.qpos, dd.qvel, dd.geom_xpos, dd.geom_xmat,
                            dd.subtree_com, dd.cdof, nconmax)
    return dd.replace(
        contact=Contact(**{k: out[k] for k in CONTACT_TENSORS}),
        ncon=out['ncon'],
        ncollision=out['ncollision'], ne=out['ne'], nf=out['nf'],
        nl=out['nl'], nefc=out['nefc'],
        **{k: out[k] for k in contact_k.EFC_FIELDS})

  def act_stage(dd):
    length, velocity = act_len_vel(m, dd.qpos, dd.qvel)
    return dd.replace(actuator_length=length, actuator_velocity=velocity)

  def solve_stage(dd):
    qfx = dd.qfrc_applied + support.xfrc_accumulate(
        m, dd.xfrc_applied, dd.xipos, dd.subtree_com, dd.cdof) - dd.qfrc_bias
    out = glue_k.glue(m, dd.qM, dd.efc_J, dd.efc_D, dd.efc_aref,
                      dd.efc_frictionloss, dd.qpos, dd.qvel, dd.ctrl, qfx,
                      dd.qacc_warmstart)
    return dd.replace(time=dd.time + m.opt.timestep,
                      qacc_warmstart=out['qacc'], **out)

  return [('smooth_mega[cuda]', smooth_stage),
          ('contact_efc_mega[cuda]', contact_stage),
          ('act_len_vel', act_stage),
          ('solve_glue[cuda]', solve_stage)]


def step_batched(m: Model, d: Data) -> Data:
  """One physics step of every world in d (nworld leading)."""
  for _, fn in glue_stages(m, d):
    d = fn(d)
  return d
