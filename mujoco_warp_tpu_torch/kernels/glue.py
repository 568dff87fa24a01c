"""Kernels B3 and B3e: the back half of the step in one CUDA kernel,
`csrc/glue.cu`: affine actuation, joint springs and dampers,
qfrc_smooth, the qM factor and qacc_smooth, the whole Newton solve, the
integration-diagonal re-solve (mode 1: Euler with implicit joint damping;
mode 2: implicitfast, each world's diagonal built in the kernel from its
ctrl) and the semi-implicit advance, one warp per world (4 worlds a
block, each world's state in shared memory). B3 solves with the
pyramidal cone; B3e, launched when `glue` is given the contacts'
`solver.cone_inputs`, with the elliptic cone (a table of the contacts in
shared memory, one lane per contact).

They replace the TPU kernel `make_glue_kernel` / `run`
(`mujoco_warp_tpu/pallas/solver_kernels.py:1207`, `_glue_core` :966;
`_glue_kernel` :939 and `_glue_ell_kernel` :954). The plain version is
`mujoco_warp_tpu_torch.forward.glue`, which runs for CPU tensors; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import forward
from .. import solver
from ..io import efc_layout
from ..types import DisableBit, JointType, Model
from . import _build

MAXNV = 32       # compile-time caps of csrc/newton.cuh
MAXNJ = 256
MAXS = 6

launches = 0     # B3 launches since the count was last reset
launches_ell = 0   # B3e launches since the count was last reset

OUTPUTS = ('qacc', 'qfrc_constraint', 'efc_force', 'solver_niter',
           'qacc_smooth', 'qLD', 'qacc_euler', 'actuator_force',
           'qfrc_actuator', 'qfrc_spring', 'qfrc_damper', 'qfrc_passive',
           'qfrc_smooth', 'qpos', 'qvel')

_PTRS = ('qM', 'efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss', 'qpos_in',
         'qvel_in', 'ctrl', 'qfx', 'qacc_warmstart', 'act_int', 'act_float',
         'dof_int', 'dof_float', 'jnt_int', 'ls_scales') + OUTPUTS
_FLOATS = ('timestep', 'tolerance', 'meaninertia')
_INTS = ('nworld', 'nq', 'nv', 'nu', 'njnt', 'nj', 'ne', 'nf', 'iterations',
         'ls_k', 'ls_polish', 'use_ws', 'mode', 'actuation_on')
Params = _build.struct('GlueParams', _PTRS, _FLOATS, _INTS)
# B3e: B3's parameters and the contacts of the elliptic cone
# (ConeParams<Params> of csrc/newton.cuh)
CONE_PTRS = ('con_friction', 'con_dim')
CONE_FLOATS = ('impratio',)
CONE_INTS = ('efc_base', 'stride', 'nconmax')
EllParams = _build.struct('GlueEllParams', CONE_PTRS, CONE_FLOATS, CONE_INTS,
                          base=Params)


def _tables(m: Model) -> dict:
  """Actuator (nu, 10), dof (nv, 5) and joint (njnt, 3) tables."""
  dev = m.device
  i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
  t = forward.actuation_tables(m)
  qadr, dadr = forward.actuator_addrs(m)
  act_float = torch.cat([
      m.actuator_gear[:, :1], t['ctrl_lo'][:, None], t['ctrl_hi'][:, None],
      t['gain3'], t['bias3'], t['frc_lo'][:, None], t['frc_hi'][:, None]],
      1)
  dis = m.opt.disableflags
  damping = (m.dof_damping if not dis & DisableBit.DAMPER else
             torch.zeros_like(m.dof_damping))
  stiff = torch.zeros_like(damping)
  spring_ref = torch.zeros_like(damping)
  spring_qadr = [0] * m.nv
  if not dis & DisableBit.SPRING:
    for j in range(m.njnt):
      if m.jnt_type[j] in (JointType.SLIDE, JointType.HINGE):
        v, q = m.jnt_dofadr[j], m.jnt_qposadr[j]
        stiff[v] = m.jnt_stiffness[j]
        spring_ref[v] = m.qpos_spring[q]
        spring_qadr[v] = q
  # the re-solve's diagonal in mode 1; in mode 2 its damping part, to
  # which the kernel adds each world's actuator part
  hdiag = (forward.damping_diag(m) if forward.glue_mode(m) else
           torch.zeros_like(damping))
  dof_float = torch.stack([damping, stiff, spring_ref, t['af_lo'],
                           t['af_hi'], hdiag], 1)
  jnt_int = torch.stack([i32(m.jnt_type), i32(m.jnt_qposadr),
                         i32(m.jnt_dofadr)], 1)
  return dict(
      act_int=torch.stack([i32(qadr), i32(dadr)], 1),
      act_float=act_float.contiguous(),
      dof_int=i32(spring_qadr), dof_float=dof_float.contiguous(),
      jnt_int=jnt_int.contiguous(),
      ls_scales=torch.tensor(solver.LS_SCALES, dtype=torch.float32,
                             device=dev),
      timestep=float(m.opt.timestep), tolerance=float(m.opt.tolerance),
      meaninertia=float(m.stat.meaninertia))


def glue(m: Model, qM, efc_J, efc_D, efc_aref, efc_frictionloss, qpos, qvel,
         ctrl, qfx, qacc_warmstart, cone=None) -> dict:
  """Back half of the step -> dict of OUTPUTS (qpos, qvel advanced);
  with `cone` (`solver.cone_inputs`) kernel B3e."""
  if qM.device.type == 'cpu':
    return forward.glue(m, qM, efc_J, efc_D, efc_aref, efc_frictionloss,
                        qpos, qvel, ctrl, qfx, qacc_warmstart, cone=cone)
  return _launch(m, qM, efc_J, efc_D, efc_aref, efc_frictionloss, qpos,
                 qvel, ctrl, qfx, qacc_warmstart, cone)


def cone_values(m: Model, efc_J, cone, dev) -> dict:
  """The parameters of the elliptic cone (B3e, B4-elliptic), checked.
  impratio is the model's, read on the host once per model: `cone`'s
  (`solver.cone_inputs`) is the same value on the device, and reading it
  would make every call wait for the card."""
  friction, dim, _ = cone
  W, nj = efc_J.shape[0], efc_J.shape[1]
  C = friction.shape[1]
  ne, nf, nl, stride, njmax = efc_layout(m, C)
  if njmax != nj or not 2 <= stride <= MAXS:
    raise ValueError(f'elliptic cone: {nj} rows, stride {stride} (layout '
                     f'{njmax} rows, stride cap {MAXS})')
  _build.check('con_friction', friction, (W, C, 5), device=dev)
  _build.check('con_dim', dim, (W, C), dtype=torch.int32, device=dev)
  impratio = _build.model_tables(
      m, 'cone', lambda mm: dict(impratio=float(mm.opt.impratio)))
  return dict(con_friction=friction, con_dim=dim, **impratio,
              efc_base=ne + nf + nl, stride=stride, nconmax=C)


def _launch(m: Model, qM, efc_J, efc_D, efc_aref, efc_frictionloss, qpos,
            qvel, ctrl, qfx, qacc_warmstart, cone=None) -> dict:
  global launches, launches_ell
  W, nj = efc_J.shape[0], efc_J.shape[1]
  if m.nv > MAXNV or nj > MAXNJ:
    raise ValueError(f'glue kernel: nv={m.nv} (cap {MAXNV}), nj={nj} '
                     f'(cap {MAXNJ})')
  dev, nv = m.device, m.nv
  for name, t, shape in (
      ('qM', qM, (W, nv, nv)), ('efc_J', efc_J, (W, nj, nv)),
      ('efc_D', efc_D, (W, nj)), ('efc_aref', efc_aref, (W, nj)),
      ('efc_frictionloss', efc_frictionloss, (W, nj)),
      ('qpos', qpos, (W, m.nq)), ('qvel', qvel, (W, nv)),
      ('ctrl', ctrl, (W, m.nu)), ('qfx', qfx, (W, nv)),
      ('qacc_warmstart', qacc_warmstart, (W, nv))):
    _build.check(name, t, shape, device=dev)
  f = torch.float32
  shapes = dict(
      qacc=(W, nv), qfrc_constraint=(W, nv), efc_force=(W, nj),
      solver_niter=(W,), qacc_smooth=(W, nv), qLD=(W, nv, nv),
      qacc_euler=(W, nv), actuator_force=(W, m.nu), qfrc_actuator=(W, nv),
      qfrc_spring=(W, nv), qfrc_damper=(W, nv), qfrc_passive=(W, nv),
      qfrc_smooth=(W, nv), qpos=(W, m.nq), qvel=(W, nv))
  outs = {k: torch.empty(s, device=dev, dtype=torch.int32 if
                         k == 'solver_niter' else f)
          for k, s in shapes.items()}
  ne, nf, _, _, _ = efc_layout(m, 0)
  dis = m.opt.disableflags
  values = dict(_build.model_tables(m, 'glue', _tables), **outs)
  values.update(
      qM=qM, efc_J=efc_J, efc_D=efc_D, efc_aref=efc_aref,
      efc_frictionloss=efc_frictionloss, qpos_in=qpos, qvel_in=qvel,
      ctrl=ctrl, qfx=qfx, qacc_warmstart=qacc_warmstart, nworld=W,
      nq=m.nq, nv=nv, nu=m.nu, njnt=m.njnt, nj=nj, ne=ne, nf=nf,
      iterations=m.opt.iterations, ls_k=solver.LS_K,
      ls_polish=solver.LS_POLISH,
      use_ws=int(not dis & DisableBit.WARMSTART), mode=forward.glue_mode(m),
      actuation_on=int(m.nu > 0 and not dis & DisableBit.ACTUATION))
  if cone is None:
    _build.launch('glue', Params, values, dev)
    launches += 1
  else:
    values.update(cone_values(m, efc_J, cone, dev))
    _build.launch('glue', EllParams, values, dev, entry='ell_')
    launches_ell += 1
  return outs
