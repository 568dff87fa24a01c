"""Analytic velocity derivatives for the implicitfast integrator, batched
over worlds: the counterpart of `mujoco_warp_tpu/derivative.py`.

qDeriv = d(qfrc_actuator + qfrc_damper) / d(qvel), without the RNE
Coriolis derivative (what makes implicitfast "fast", as in MuJoCo). The
gate admits neither tendons nor activation states, so the JAX function's
tendon term and its `act` input have no counterpart here.
"""

from __future__ import annotations

import torch

from .forward import actuator_vel_coeff
from .types import Data, DisableBit, Model


def deriv_smooth_vel(m: Model, d: Data) -> torch.Tensor:
  """(nworld, nv, nv) qDeriv: −diag(dof_damping) + momentᵀ diag(c) moment,
  c the actuators' affine velocity coefficients (`actuator_vel_coeff`,
  from the raw ctrl, as C MuJoCo's mjd_actuator_vel). With the damper
  disabled the damping term is dropped, as C MuJoCo drops it (the JAX
  function keeps it, ROADMAP §C)."""
  W = d.qpos.shape[0]
  damping = (m.dof_damping if not m.opt.disableflags & DisableBit.DAMPER
             else torch.zeros_like(m.dof_damping))
  qderiv = -torch.diag(damping).expand(W, m.nv, m.nv)
  if m.nu and not m.opt.disableflags & DisableBit.ACTUATION:
    qderiv = qderiv + torch.einsum('wun,wu,wuk->wnk', d.actuator_moment,
                                   actuator_vel_coeff(m, d.ctrl),
                                   d.actuator_moment)
  return qderiv
