"""Step orchestration: `forward_batched` and the glue-folded and the
unfused batched step.

`step_batched` picks a stage list as the JAX package's `_step_batched`
(`mujoco_warp_tpu/forward.py:867`) does and runs it under the same stage
names, with the Pallas kernels replaced by the CUDA kernels of
`kernels/`. With the Newton solver, the Euler or implicitfast integrator
and 0 < nv <= 32 it runs the glue-folded list (`_glue_stages` :577), for
either cone:

  smooth_mega[cuda]       kernel B1: kinematics .. rne
  camlight                camera and light frames (tensor ops)
  contact_efc_mega[cuda]  kernel B2: narrowphase, compaction, efc rows
                          (joint equalities by the Data's eq_active)
  act_len_vel             actuator lengths and velocities (tensor ops)
  sensor_pos, sensor_vel  position and velocity sensors (tensor ops;
                          models with sensors)
  solve_glue[cuda]        kernel B3 (pyramidal) or B3e (elliptic):
                          actuation, passive, Newton, the re-solve with
                          the integration diagonal (`glue_mode`), advance
  sensor_acc              rne_postconstraint and acceleration sensors
                          (models with sensors)
  advance                 where an acceleration sensor reads the
                          pre-advance velocity (`sensor.needs_rne_post`,
                          JAX `_needs_preadv` :462): the kernel's qpos
                          and qvel are dropped and the advance runs here,
                          on its qacc_euler, after sensor_acc

A model past the large-scene threshold (`m.sap_families`, set by
`io._sap_precompute`: apptronik_apollo_terrain) runs two stages in
place of contact_efc_mega[cuda], on every list (glue, forward_batched,
RK4, CG, implicitfast), under the JAX package's names:

  collision               the large-scene broadphase (`collision_sap`):
                          world AABBs, the top-K pairs a family, the
                          narrowphase and the pool (torch ops)
  make_constraint         the efc rows (`constraint.make_constraint`,
                          torch ops)

The JAX package runs XLA `collision` and `make_constraint` there: its
contact kernel refuses a model with `sap_meta`
(`pallas/contact_kernels.py:66`), so no TPU kernel stands on that path,
and B2's table would hold every admissible pair. Every other model the
port runs keeps B2.

Otherwise `forward_batched`'s list (`forward_stages`: the `use_mega`
branch of `batched_stages` :698-758, which never folds the back half)
and then the integrator, `_euler_batched` (:787-800), `_rk4_batched`
(:815-839) or `_implicit_batched` (:803-812):

  smooth_mega[cuda], camlight, contact_efc_mega[cuda]   as above
  transmission            actuator lengths
  sensor_pos              (models with sensors)
  velocity_glue           actuator velocities
  passive                 joint springs and dampers
  sensor_vel              (models with sensors)
  fwd_actuation           actuator forces
  fwd_acceleration        qfrc_smooth; qacc_smooth and qLD by kernel B7
                          (nv > 32) or B5 (nv <= 32), unless B4 follows
  solve[cuda]             Newton and 0 < nv <= 32: kernel B4 (pyramidal)
                          or B4-elliptic (qacc_smooth and qLD too), or
  solve                   Newton: kernel B5 per direction; CG: kernel B8
                          (nv > 32) or B6 (nv <= 32) on qLD per direction;
                          the parallel or, for the elliptic cone, the
                          iterative linesearch
  sensor_acc              (models with sensors)
  euler                   eulerdamp: kernel B7 or B5 with diag h·damping;
                          advance, or
  rk4                     three more `forward_batched` and the Runge-Kutta
                          combination, or
  implicitfast            qDeriv (`derivative`); kernel B5 on qM - h·qDeriv;
                          advance

`step1` runs that list up to passive, `step2` the rest.

The elliptic kernels B3e and B4-elliptic run where the JAX package builds
its cone for its kernels (`solver.cone_inputs`: the elliptic cone, a
contact pool, contacts of more than one row); an elliptic model whose
contacts all have condim 1 runs B3 and B4.

Two deliberate differences from the JAX lists. The JAX package runs the
smooth and contact stages of models past nv 64 (three_humanoids) as XLA,
for the TPU compiler's sake (`MJWT_MEGA_NV_CAP`, :453; the contact
kernel's unroll budget). B1 and B2 loop over the model's tables at run
time and have no such limit, so the port runs them for every model;
their results equal the XLA stages'. And the JAX contact kernel refuses
the elliptic cone (`pallas/contact_kernels.py:57`), so for that cone the
JAX list runs XLA `collision` and `make_constraint` where the port runs
B2, which builds the elliptic rows too, under B2's stage name.

camlight is skipped for models without cameras and lights, as in the
JAX lists. qLD holds a lower Cholesky factor of qM up to nv 32 (from B3,
B4 or B5) and B7's packed tree factor LD above
(`kernels.batch_linalg.uses_tree_factor`). This module also holds the
plain version of B3 and B3e (`glue`):
actuation (:83), passive forces, qfrc_smooth, the Newton solve and the
Euler advance (`_advance` :331, `_integrate_pos` :274), in the glue
kernel's formulation.
"""

from __future__ import annotations

import torch

from . import collision_sap
from . import constraint
from . import math
from . import passive as passive_mod
from . import sensor as sensor_mod
from . import smooth as smooth_mod
from . import solver
from . import support
from .io import check_options, efc_layout
from .kernels import _build
from .types import (CONTACT_TENSORS, BiasType, ConeType, Contact, Data,
                    DisableBit, GainType, IntegratorType, JointType, Model,
                    SolverType)

_BIG = 1e30


def actuator_addrs(m: Model):
  """qpos and dof addresses of each actuator's joint."""
  jids = [m.actuator_trnid[u][0] for u in range(m.nu)]
  return [m.jnt_qposadr[j] for j in jids], [m.jnt_dofadr[j] for j in jids]


def act_len_vel(m: Model, qpos, qvel):
  """actuator_length and actuator_velocity (W, nu) of joint actuators."""
  t = actuation_tables(m)
  gear0 = m.actuator_gear[:, 0]
  return qpos[:, t['qadr']] * gear0, qvel[:, t['dadr']] * gear0


def actuation_tables(m: Model) -> dict:
  """Per-actuator and per-dof tables of the affine actuation model, and
  each actuator's qpos and dof address as index tensors, shared by the
  plain `fwd_actuation` and kernel B3. Built once per model, so that a
  step builds no tensor from host data (a CUDA graph captures it)."""
  return _build.model_tables(m, 'actuation', _actuation_tables)


def _actuation_tables(m: Model) -> dict:
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
  qadr, dadr = actuator_addrs(m)
  idx = lambda x: torch.as_tensor(x, dtype=torch.long, device=dev)
  return dict(gain3=gain3, bias3=bias3, ctrl_lo=ctrl_lo, ctrl_hi=ctrl_hi,
              frc_lo=frc_lo, frc_hi=frc_hi, af_lo=af_lo, af_hi=af_hi,
              qadr=idx(qadr), dadr=idx(dadr))


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
  qfa = qpos.new_zeros((W, m.nv))
  qfa.index_add_(1, t['dadr'], force * m.actuator_gear[:, 0])
  qfa = torch.minimum(torch.maximum(qfa, t['af_lo']), t['af_hi'])
  return force, qfa


def actuator_vel_coeff(m: Model, ctrl):
  """(W, nu) d force / d velocity of each affine actuator: biasprm[2] for
  AFFINE bias plus gainprm[2] * ctrl for AFFINE gain, from the raw ctrl
  (the actuator term of qDeriv, JAX `derivative.py:31-44`)."""
  t = actuation_tables(m)
  return t['bias3'][:, 2] + t['gain3'][:, 2] * ctrl


def glue_mode(m: Model) -> int:
  """Integration diagonal of the glue solve: 0 plain Euler, 1 Euler with
  implicit joint damping, 2 implicitfast (mirrors forward._glue_mode
  :469, which asks for implicitfast first)."""
  if m.opt.integrator == IntegratorType.IMPLICITFAST:
    return 2
  if m.has_damping and not m.opt.disableflags & DisableBit.EULERDAMP:
    return 1
  return 0


def damping_diag(m: Model):
  """h * dof damping (nv,), zero with the damper disabled, as in C
  MuJoCo and the glue kernel (`solver_kernels.py:848`)."""
  if m.opt.disableflags & DisableBit.DAMPER:
    return torch.zeros_like(m.dof_damping)
  return m.opt.timestep * m.dof_damping


def integration_diag(m: Model, ctrl=None):
  """The diagonal of the glue solve's re-solve (qM + diag) qacc_euler =
  qfrc_smooth + qfrc_constraint: None in mode 0; in mode 1 h * damping
  (nv,); in mode 2 −h diag(qDeriv) per world (nworld, nv), h * damping −
  h Σᵤ gear0² (bias3[2] + gain3[2] ctrl) over each dof's actuators in
  actuator order, from the raw ctrl (`_glue_core` :1146-1156)."""
  mode = glue_mode(m)
  if mode == 0:
    return None
  hdamp = damping_diag(m)
  if mode == 1:
    return hdamp
  h = m.opt.timestep
  W = ctrl.shape[0]
  if m.nu == 0 or m.opt.disableflags & DisableBit.ACTUATION:
    return hdamp.expand(W, m.nv)
  gear0 = m.actuator_gear[:, 0]
  act = (gear0 * gear0) * actuator_vel_coeff(m, ctrl)
  per_dof = ctrl.new_zeros((W, m.nv)).index_add_(
      1, actuation_tables(m)['dadr'], act)
  return hdamp - h * per_dof


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
         qvel, ctrl, qfx, qacc_warmstart, cone=None) -> dict:
  """Plain version of kernel B3 (B3e with `cone`, the contacts'
  `solver.cone_inputs`): actuation + passive + qfrc_smooth + Newton
  solve + Euler advance. qfx = qfrc_applied + xfrc - qfrc_bias."""
  ne, nf, _, _, _ = efc_layout(m, 0)
  h = m.opt.timestep
  afrc, qfa = fwd_actuation(m, qpos, qvel, ctrl)
  qfsp, qfdp, qfp = passive_mod.passive(m, qpos, qvel)
  qfs = qfp + qfa + qfx
  out = solver.newton(
      m, qM, efc_J, efc_D, efc_aref, efc_frictionloss, qfs, qacc_warmstart,
      ne, nf, use_warmstart=not m.opt.disableflags & DisableBit.WARMSTART,
      hdiag=integration_diag(m, ctrl), cone=cone)
  qvel_new = qvel + h * out['qacc_euler']
  out.update(actuator_force=afrc, qfrc_actuator=qfa, qfrc_spring=qfsp,
             qfrc_damper=qfdp, qfrc_passive=qfp, qfrc_smooth=qfs,
             qvel=qvel_new, qpos=integrate_pos(m, qpos, qvel_new, h))
  return out


def _common_stages(m: Model, d: Data) -> list:
  """The stages both lists share: B1, camlight and B2, or for a model
  past the large-scene threshold (`m.sap_families`) `collision` and
  `make_constraint` in B2's place."""
  from .kernels import contact as contact_k
  from .kernels import smooth as smooth_k
  nconmax = d.contact.dist.shape[1]

  def smooth_stage(dd):
    return dd.replace(**smooth_k.smooth(m, dd.qpos, dd.qvel))

  def camlight_stage(dd):
    return dd.replace(**smooth_mod.camlight(m, dd.xpos, dd.xquat,
                                            dd.subtree_com))

  def contact_stage(dd):
    out = contact_k.contact(m, dd.qpos, dd.qvel, dd.geom_xpos, dd.geom_xmat,
                            dd.subtree_com, dd.cdof, nconmax, dd.eq_active)
    return dd.replace(
        contact=Contact(**{k: out[k] for k in CONTACT_TENSORS}),
        ncon=out['ncon'],
        ncollision=out['ncollision'], ne=out['ne'], nf=out['nf'],
        nl=out['nl'], nefc=out['nefc'],
        **{k: out[k] for k in contact_k.EFC_FIELDS})

  def collision_stage(dd):
    con = collision_sap.collision(m, dd.geom_xpos, dd.geom_xmat, nconmax)
    return dd.replace(
        contact=dd.contact.replace(**{k: con[k] for k in CONTACT_TENSORS
                                      if k != 'efc_address'}),
        ncon=con['ncon'], ncollision=con['ncollision'])

  def constraint_stage(dd):
    efc = constraint.make_constraint(
        m, dd.qpos, dd.qvel, dd.cdof, dd.subtree_com,
        {k: getattr(dd.contact, k) for k in CONTACT_TENSORS}, dd.eq_active)
    return dd.replace(
        contact=dd.contact.replace(efc_address=efc['efc_address']),
        ne=efc['ne'], nf=efc['nf'], nl=efc['nl'], nefc=efc['nefc'],
        **{k: efc[k[4:]] for k in contact_k.EFC_FIELDS})

  stages = [('smooth_mega[cuda]', smooth_stage)]
  if m.ncam or m.nlight:
    stages.append(('camlight', camlight_stage))
  if m.sap_families:
    stages += [('collision', collision_stage),
               ('make_constraint', constraint_stage)]
  else:
    stages.append(('contact_efc_mega[cuda]', contact_stage))
  return stages


def _sensor_stage(m: Model, name: str) -> list:
  """[(name, fn)] of the stage `name` of `sensor.py`, or [] for a model
  without sensors (whose lists keep their stages as they were)."""
  fn = getattr(sensor_mod, name)
  return [(name, lambda dd: fn(m, dd))] if m.nsensor else []


def glue_stages(m: Model, d: Data) -> list:
  """[(name, fn)] of the glue-folded step, fn: Data -> Data."""
  from .kernels import glue as glue_k

  def act_stage(dd):
    length, velocity = act_len_vel(m, dd.qpos, dd.qvel)
    return dd.replace(actuator_length=length, actuator_velocity=velocity)

  preadv = sensor_mod.needs_rne_post(m)

  def solve_stage(dd):
    qfx = dd.qfrc_applied + support.xfrc_accumulate(
        m, dd.xfrc_applied, dd.xipos, dd.subtree_com, dd.cdof) - dd.qfrc_bias
    out = glue_k.glue(m, dd.qM, dd.efc_J, dd.efc_D, dd.efc_aref,
                      dd.efc_frictionloss, dd.qpos, dd.qvel, dd.ctrl, qfx,
                      dd.qacc_warmstart,
                      cone=solver.cone_inputs(m, dd.contact))
    if preadv:                # the advance runs after sensor_acc
      del out['qpos'], out['qvel']
      return dd.replace(**out)
    return dd.replace(time=dd.time + m.opt.timestep,
                      qacc_warmstart=out['qacc'], **out)

  stages = _common_stages(m, d) + [('act_len_vel', act_stage)]
  stages += _sensor_stage(m, 'sensor_pos') + _sensor_stage(m, 'sensor_vel')
  stages += [('solve_glue[cuda]', solve_stage)]
  stages += _sensor_stage(m, 'sensor_acc')
  if preadv:
    stages.append(('advance', lambda dd: _advance(m, dd, dd.qacc_euler)))
  return stages


def uses_newton_kernel(m: Model, d: Data) -> bool:
  """True when the solve stage is kernel B4 (B4-elliptic where
  `solver.cone_inputs` gives a cone), which also computes qacc_smooth and
  the qM factor, as the JAX package's gate (`solver.uses_fused_kernel`
  :678-682): the Newton solver, either cone, 0 < nv <= 32, efc rows and
  iterations to run. Besides, the rows must fit the kernels' cap (nj <=
  256, `csrc/newton.cuh`), which the JAX gate need not ask: it falls back
  to XLA where its kernel does not compile."""
  from .kernels.newton import MAXNJ, MAXNV
  return (m.opt.solver == SolverType.NEWTON and
          m.opt.cone in (ConeType.PYRAMIDAL, ConeType.ELLIPTIC) and
          0 < m.nv <= MAXNV and
          0 < d.efc_J.shape[1] <= MAXNJ and m.opt.iterations > 0 and
          not m.opt.disableflags & DisableBit.CONSTRAINT)


def uses_glue_kernel(m: Model, d: Data) -> bool:
  """True when the step folds its back half into kernel B3, as the JAX
  package's gate (`forward._glue_gates` :473): the solve would be the
  Newton kernel's (`uses_newton_kernel`) and the integrator is one the
  fold advances with (`solver_kernels.glue_supported` :723-729: Euler,
  or implicitfast in mode 2)."""
  return (uses_newton_kernel(m, d) and
          m.opt.integrator in (IntegratorType.EULER,
                               IntegratorType.IMPLICITFAST))


def replays(m: Model, d: Data) -> bool:
  """Whether the harness (`utils.benchmark`) replays a step of (m, d) on
  the card as one CUDA graph, decided from the stage list before the
  run: True when the list's solve is a kernel, B3 or B3e in the glue
  list or B4 or B4-elliptic in the unfused list (`uses_newton_kernel`;
  with the Euler or implicitfast integrator such a model takes the glue
  list, whose mode-2 diagonal is built from ctrl on the device, with RK4
  the unfused list and four B4 launches). Those lists make no host sync
  and build no tensor from host data, so one step can be captured. The
  unfused solve (`solver.solve`) reads `done.all()` on the host once per
  pass, and with the iterative linesearch once per linesearch step, so
  every other list steps eagerly: three_humanoids' Newton and CG steps
  (implicitfast too) and the humanoid's CG step."""
  return uses_newton_kernel(m, d)


def forward_stages(m: Model, d: Data) -> list:
  """[(name, fn)] of `forward_batched`, fn: Data -> Data: everything up
  to qacc, the back half never folded."""
  from .kernels import batch_linalg as linalg_k
  from .kernels import newton as newton_k
  check_options(m.opt)
  fused = uses_newton_kernel(m, d)

  def transmission(dd):
    qadr = actuation_tables(m)['qadr']
    return dd.replace(actuator_length=dd.qpos[:, qadr] *
                      m.actuator_gear[:, 0])

  def velocity_glue(dd):
    dadr = actuation_tables(m)['dadr']
    return dd.replace(actuator_velocity=dd.qvel[:, dadr] *
                      m.actuator_gear[:, 0])

  def passive(dd):
    spring, damper, total = passive_mod.passive(m, dd.qpos, dd.qvel)
    return dd.replace(qfrc_spring=spring, qfrc_damper=damper,
                      qfrc_passive=total)

  def actuation(dd):
    force, qfrc = fwd_actuation(m, dd.qpos, dd.qvel, dd.ctrl)
    return dd.replace(actuator_force=force, qfrc_actuator=qfrc)

  def acceleration(dd):
    qfrc_smooth = (dd.qfrc_passive - dd.qfrc_bias + dd.qfrc_applied +
                   dd.qfrc_actuator + support.xfrc_accumulate(
                       m, dd.xfrc_applied, dd.xipos, dd.subtree_com,
                       dd.cdof))
    if fused:    # B4 computes qacc_smooth and the factor
      return dd.replace(qfrc_smooth=qfrc_smooth)
    qacc_smooth, qld = linalg_k.m_solve_factor(dd.qM, qfrc_smooth,
                                               m.dof_parentid)
    return dd.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth,
                      qLD=qld)

  def solve_newton_kernel(dd):
    # no hb: a Newton + Euler model that reaches B4 steps through the
    # glue list, and step2 re-solves in its integrator, so nothing would
    # read the damped re-solve
    return dd.replace(**newton_k.newton_solve(
        m, dd.qM, dd.efc_J, dd.efc_D, dd.efc_aref, dd.efc_frictionloss,
        dd.qfrc_smooth, dd.qacc_warmstart,
        cone=solver.cone_inputs(m, dd.contact)))

  def solve(dd):
    return dd.replace(**solver.solve(
        m, dd.qM, dd.efc_J, dd.efc_D, dd.efc_aref, dd.efc_frictionloss,
        dd.efc_type, dd.qfrc_smooth, dd.qacc_smooth, dd.qacc_warmstart,
        qLD=dd.qLD, cone=solver.cone_inputs(m, dd.contact)))

  stages = _common_stages(m, d) + [('transmission', transmission)]
  stages += _sensor_stage(m, 'sensor_pos')
  stages += [('velocity_glue', velocity_glue), ('passive', passive)]
  stages += _sensor_stage(m, 'sensor_vel')
  stages += [('fwd_actuation', actuation), ('fwd_acceleration', acceleration),
             ('solve[cuda]', solve_newton_kernel) if fused else
             ('solve', solve)]
  return stages + _sensor_stage(m, 'sensor_acc')


def _run(stages: list, d: Data) -> Data:
  for _, fn in stages:
    d = fn(d)
  return d


def forward_batched(m: Model, d: Data) -> Data:
  """Forward dynamics of every world in d (nworld leading): positions
  through qacc, no integration (`forward_batched` :779)."""
  return _run(forward_stages(m, d), d)


def _advance(m: Model, d: Data, qacc) -> Data:
  """The semi-implicit advance with qacc (`_advance` :331)."""
  h = m.opt.timestep
  qvel = d.qvel + qacc * h
  return d.replace(qvel=qvel, qpos=integrate_pos(m, d.qpos, qvel, h),
                   time=d.time + h, qacc_warmstart=d.qacc)


def _euler(m: Model, d: Data) -> Data:
  """Semi-implicit Euler with implicit joint damping
  (`_euler_batched` :787). With the damper disabled there is no damping
  to integrate implicitly, so qacc is used as it is, as in C MuJoCo's
  mj_Euler; the JAX package's unfused Euler re-solves with h·dof_damping
  all the same (ROADMAP §C). The re-solve asks for x alone: the JAX
  package's also computes a factor, which it drops."""
  from .kernels import batch_linalg as linalg_k
  h = m.opt.timestep
  qacc = d.qacc
  dis = m.opt.disableflags
  if (m.has_damping and not dis & DisableBit.EULERDAMP and
      not dis & DisableBit.DAMPER):
    qacc = linalg_k.m_solve_factor(d.qM, d.qfrc_smooth + d.qfrc_constraint,
                                   m.dof_parentid, diag=h * m.dof_damping,
                                   return_factor=False)
  return _advance(m, d, qacc)


def implicit(m: Model, d: Data) -> Data:
  """The implicitfast integrator (`_implicit_batched` :803-812): qDeriv
  (`derivative.deriv_smooth_vel`), mh = qM − h·qDeriv made symmetric (the
  JAX package factors the symmetric part, ROADMAP §C), qacc from mh qacc
  = qfrc_smooth + qfrc_constraint by kernel B5, then the advance."""
  from . import derivative
  from .kernels import batch_linalg as linalg_k
  mh = d.qM - m.opt.timestep * derivative.deriv_smooth_vel(m, d)
  mh = 0.5 * (mh + mh.transpose(1, 2))
  return _advance(m, d, linalg_k.spd_solve(
      mh, d.qfrc_smooth + d.qfrc_constraint))


def _rk4(m: Model, d: Data, forward: list) -> Data:
  """Runge-Kutta 4 from d = forward_batched of the step's state: three
  more evaluations through the same stage list `forward`, each from the
  same qacc_warmstart, then the combination (`_rk4_batched` :815).
  solver_niter is the last evaluation's."""
  h = m.opt.timestep
  a = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
  b = (1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6)
  qpos0, qvel0, time0 = d.qpos, d.qvel, d.time
  fs = [(d.qvel, d.qacc)]
  d_i = d
  for i in range(3):
    dqvel = sum(a[i][j] * fs[j][1] for j in range(i + 1) if a[i][j])
    dqpos_vel = sum(a[i][j] * fs[j][0] for j in range(i + 1) if a[i][j])
    d_i = _run(forward, d_i.replace(
        qpos=integrate_pos(m, qpos0, dqpos_vel, h), qvel=qvel0 + h * dqvel,
        time=time0))
    fs.append((d_i.qvel, d_i.qacc))
  vel_b = sum(b[i] * fs[i][0] for i in range(4))
  acc_b = sum(b[i] * fs[i][1] for i in range(4))
  return d_i.replace(qpos=integrate_pos(m, qpos0, vel_b, h),
                     qvel=qvel0 + h * acc_b, time=time0 + h, qacc=acc_b,
                     qacc_warmstart=d.qacc)


def unfused_stages(m: Model, d: Data) -> list:
  """[(name, fn)] of the unfused step: `forward_batched`'s list and the
  integrator."""
  forward = forward_stages(m, d)
  if m.opt.integrator == IntegratorType.RK4:
    last = ('rk4', lambda dd: _rk4(m, dd, forward))
  elif m.opt.integrator == IntegratorType.IMPLICITFAST:
    last = ('implicitfast', lambda dd: implicit(m, dd))
  else:
    last = ('euler', lambda dd: _euler(m, dd))
  return forward + [last]


def _split(stages: list) -> int:
  """Where step2's stages begin: at fwd_actuation."""
  return [n for n, _ in stages].index('fwd_actuation')


def step1(m: Model, d: Data) -> Data:
  """The position and velocity stages of the unfused list, for ctrl set
  between step1 and step2 (`step1` :881): B1, camlight, B2,
  transmission, sensor_pos, velocity_glue, passive and sensor_vel."""
  stages = forward_stages(m, d)
  return _run(stages[:_split(stages)], d)


def step2(m: Model, d: Data) -> Data:
  """Actuation onward and the integrator (`step2` :891): fwd_actuation,
  fwd_acceleration, the solve (kernel B4 where `uses_newton_kernel`, else
  `solver.solve`), sensor_acc, then Euler or implicitfast.
  step2(step1(d)) is the unfused step. RK4 has no such split, as in the
  JAX package."""
  if m.opt.integrator == IntegratorType.RK4:
    raise NotImplementedError('step1/step2 split with RK4')
  stages = unfused_stages(m, d)
  return _run(stages[_split(stages):], d)


def batched_stages(m: Model, d: Data) -> list:
  """[(name, fn)] of the stage list step_batched runs for (m, d). The
  model's options are checked once, here or in `forward_stages`."""
  if uses_glue_kernel(m, d):
    check_options(m.opt)
    return glue_stages(m, d)
  return unfused_stages(m, d)


def step_batched(m: Model, d: Data) -> Data:
  """One physics step of every world in d (nworld leading)."""
  return _run(batched_stages(m, d), d)
