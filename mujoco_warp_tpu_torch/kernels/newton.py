"""Kernels B4 and B4-elliptic: the Newton solve of `forward_batched` in
one CUDA kernel, `csrc/newton.cu`: the qM factor and qacc_smooth, the
whole Newton solve from a given qfrc_smooth, the forces and, with `hb`,
the re-solve (qM + diag(hb)) qacc_euler = qfrc_smooth + qfrc_constraint,
one warp per world. B4 solves with the pyramidal cone; B4-elliptic,
launched when `newton_solve` is given the contacts' `solver.cone_inputs`,
with the elliptic cone.

They replace the TPU kernel `newton_solve_batched`
(`mujoco_warp_tpu/pallas/solver_kernels.py:534`, bodies `_newton_kernel`
:72 and `_newton_ell_kernel` :88). They share their device code
(`csrc/newton.cuh`) with kernels B3 and B3e. The plain version is
`mujoco_warp_tpu_torch.solver.newton_solve`, which runs for CPU tensors;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import solver
from ..io import efc_layout
from ..types import DisableBit, Model
from . import _build
from .glue import CONE_FLOATS, CONE_INTS, CONE_PTRS, cone_values

MAXNV = 32       # compile-time caps of csrc/newton.cuh
MAXNJ = 256

launches = 0     # B4 launches since the count was last reset
launches_ell = 0   # B4-elliptic launches since the count was last reset

OUTPUTS = ('qacc', 'qfrc_constraint', 'efc_force', 'solver_niter',
           'qacc_smooth', 'qLD', 'qacc_euler')

_PTRS = ('qM', 'efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss',
         'qfrc_smooth', 'qacc_warmstart', 'hb', 'ls_scales') + OUTPUTS
_FLOATS = ('tolerance', 'meaninertia')
_INTS = ('nworld', 'nv', 'nj', 'ne', 'nf', 'iterations', 'ls_k', 'ls_polish',
         'use_ws', 'euler_damp')
Params = _build.struct('NewtonParams', _PTRS, _FLOATS, _INTS)
EllParams = _build.struct('NewtonEllParams', CONE_PTRS, CONE_FLOATS,
                          CONE_INTS, base=Params)


def _tables(m: Model) -> dict:
  return dict(
      ls_scales=torch.tensor(solver.LS_SCALES, dtype=torch.float32,
                             device=m.device),
      tolerance=float(m.opt.tolerance),
      meaninertia=float(m.stat.meaninertia))


def newton_solve(m: Model, qM, efc_J, efc_D, efc_aref, efc_frictionloss,
                 qfrc_smooth, qacc_warmstart, hb=None, cone=None) -> dict:
  """The Newton solve from qfrc_smooth -> dict of OUTPUTS; hb (nv,) or
  None and cone (`solver.cone_inputs`) or None as `solver.newton_solve`.
  With a cone, kernel B4-elliptic."""
  if qM.device.type == 'cpu':
    return solver.newton_solve(m, qM, efc_J, efc_D, efc_aref,
                               efc_frictionloss, qfrc_smooth, qacc_warmstart,
                               hb=hb, cone=cone)
  return _launch(m, qM, efc_J, efc_D, efc_aref, efc_frictionloss,
                 qfrc_smooth, qacc_warmstart, hb, cone)


def _launch(m: Model, qM, efc_J, efc_D, efc_aref, efc_frictionloss,
            qfrc_smooth, qacc_warmstart, hb=None, cone=None) -> dict:
  global launches, launches_ell
  W, nj = efc_J.shape[0], efc_J.shape[1]
  if m.nv > MAXNV or nj > MAXNJ:
    raise ValueError(f'newton kernel: nv={m.nv} (cap {MAXNV}), nj={nj} '
                     f'(cap {MAXNJ})')
  dev, nv = m.device, m.nv
  for name, t, shape in (
      ('qM', qM, (W, nv, nv)), ('efc_J', efc_J, (W, nj, nv)),
      ('efc_D', efc_D, (W, nj)), ('efc_aref', efc_aref, (W, nj)),
      ('efc_frictionloss', efc_frictionloss, (W, nj)),
      ('qfrc_smooth', qfrc_smooth, (W, nv)),
      ('qacc_warmstart', qacc_warmstart, (W, nv))):
    _build.check(name, t, shape, device=dev)
  if hb is not None:
    _build.check('hb', hb, (nv,), device=dev)
  shapes = dict(qacc=(W, nv), qfrc_constraint=(W, nv), efc_force=(W, nj),
                solver_niter=(W,), qacc_smooth=(W, nv), qLD=(W, nv, nv),
                qacc_euler=(W, nv))
  outs = {k: torch.empty(s, device=dev, dtype=torch.int32 if
                         k == 'solver_niter' else torch.float32)
          for k, s in shapes.items()}
  ne, nf, _, _, _ = efc_layout(m, 0)
  values = dict(_build.model_tables(m, 'newton', _tables), **outs)
  values.update(
      qM=qM, efc_J=efc_J, efc_D=efc_D, efc_aref=efc_aref,
      efc_frictionloss=efc_frictionloss, qfrc_smooth=qfrc_smooth,
      qacc_warmstart=qacc_warmstart, hb=hb, nworld=W, nv=nv, nj=nj, ne=ne,
      nf=nf, iterations=m.opt.iterations, ls_k=solver.LS_K,
      ls_polish=solver.LS_POLISH,
      use_ws=int(not m.opt.disableflags & DisableBit.WARMSTART),
      euler_damp=int(hb is not None))
  if cone is None:
    _build.launch('newton', Params, values, dev)
    launches += 1
  else:
    values.update(cone_values(m, efc_J, cone, dev))
    _build.launch('newton', EllParams, values, dev, entry='ell_')
    launches_ell += 1
  return outs
