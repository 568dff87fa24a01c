"""Kernel B1: the smooth stage (kinematics, frames, com_pos, crb/qM,
com_vel, rne) in one CUDA kernel, `csrc/smooth.cu`, one group of 8, 16
or 32 lanes per world (`lanes`); and kernels B9-B12, entries of the same
source that run B1's position stages.

Replaces the TPU kernel `smooth_mega_batched`
(`mujoco_warp_tpu/pallas/smooth_kernels.py:557`). Its plain version is
`mujoco_warp_tpu_torch.smooth.smooth`, which runs for CPU tensors; a
CUDA tensor launches the kernel or raises.

B9-B12 are public functions with the JAX kernels' inputs and outputs:

* B10 `kinematics` (`kinematics_batched` :722): xpos, xquat, xanchor,
  xaxis of normalized qpos; plain version `smooth.kinematics`.
* B11 `com_pos` (`com_pos_batched` :243): subtree_com, cinert, cdof of
  xpos, xquat, xanchor, xaxis; plain version `plain_com_pos`.
* B12 `crb` (`crb_batched` :353): crb and the dense qM of any cinert and
  cdof; plain version `smooth.crb`.
* B9 `smooth_front` (`smooth_front_batched` :665): B10, B11 and B12 in
  one launch; plain version `plain_smooth_front`.

No step path calls them. Unlike the JAX kernels, they return njnt rows of
xanchor and xaxis when njnt is 0 (the JAX kernels pad one row), and, as
B1, they take no mocap bodies (the model gate refuses them). `launches`
counts B1's launches; `launches_front`, `launches_kin`, `launches_com`
and `launches_crb` count B9, B10, B11 and B12.
"""

from __future__ import annotations

import ctypes

import torch

from .. import smooth as plain
from ..types import DisableBit, Model
from . import _build

launches = 0     # B1's launches since the count was last reset
launches_front = launches_kin = launches_com = launches_crb = 0   # B9-B12

_PTRS = (
    'qpos', 'qvel',
    'body_parentid', 'body_rootid', 'body_jntadr', 'body_jntnum',
    'jnt_type', 'jnt_qposadr', 'jnt_dofadr', 'jnt_bodyid', 'dof_bodyid',
    'dof_parentid', 'geom_bodyid', 'site_bodyid', 'level_start',
    'level_body', 'child_start', 'child_body', 'qm_rowstart', 'qm_slot',
    'body_pos', 'body_quat', 'body_ipos', 'body_iquat', 'body_mass',
    'body_subtreemass', 'body_inertia', 'jnt_pos', 'jnt_axis', 'qpos0',
    'dof_armature', 'geom_pos', 'geom_quat', 'site_pos', 'site_quat',
    'gravity') + tuple('qpos_out' if k == 'qpos' else k
                       for k in plain.OUTPUTS)
_INTS = ('nworld', 'nq', 'nv', 'nbody', 'njnt', 'ngeom', 'nsite', 'nlevel',
         'nnz', 'lanes')
Params = _build.struct('SmoothParams', _PTRS, (), _INTS)

_INT_TABLES = ('body_parentid', 'body_rootid', 'body_jntadr', 'body_jntnum',
               'jnt_type', 'jnt_qposadr', 'jnt_dofadr', 'jnt_bodyid',
               'dof_bodyid', 'dof_parentid', 'geom_bodyid', 'site_bodyid')
_FLOAT_TABLES = ('body_pos', 'body_quat', 'body_ipos', 'body_iquat',
                 'body_mass', 'body_subtreemass', 'body_inertia', 'jnt_pos',
                 'jnt_axis', 'qpos0', 'dof_armature', 'geom_pos',
                 'geom_quat', 'site_pos', 'site_quat')


QM_NONE = 0xffff   # qm_slot of a dense qM entry outside the packed rows


def tree_tables(body_parentid, dof_parentid) -> dict:
  """The kernel's tree tables (lists): bodies by tree level
  (`level_body`, level l at [level_start[l], level_start[l + 1]), body 0
  alone at level 0, ascending index within a level); each body's
  children in descending index (`child_body` at [child_start[b],
  child_start[b + 1])); qM's packed rows, row i holding dof i, then its
  ancestors from the parent up, from `qm_rowstart[i]`; and `qm_slot`,
  the packed slot of each dense entry (i, j), row-major, or QM_NONE.
  Bodies and dofs are in topological order (parent < child)."""
  nb, nv = len(body_parentid), len(dof_parentid)
  depth = [0] * nb
  for b in range(1, nb):
    depth[b] = depth[body_parentid[b]] + 1
  nlevel = max(depth) + 1
  level_body = sorted(range(nb), key=lambda b: (depth[b], b))
  level_start = [0] * (nlevel + 1)
  for b in range(nb):
    level_start[depth[b] + 1] += 1
  for lv in range(nlevel):
    level_start[lv + 1] += level_start[lv]
  child_start, child_body = [0], []
  for b in range(nb):
    child_body += [c for c in range(nb - 1, 0, -1) if body_parentid[c] == b]
    child_start.append(len(child_body))
  qm_rowstart, qm_slot, nnz = [], [QM_NONE] * (nv * nv), 0
  for i in range(nv):
    qm_rowstart.append(nnz)
    j = i
    while j >= 0:
      qm_slot[i * nv + j] = qm_slot[j * nv + i] = nnz
      nnz += 1
      j = dof_parentid[j]
  if nnz >= QM_NONE:
    raise ValueError(f'smooth kernel: {nnz} packed qM entries')
  return dict(level_start=level_start, level_body=level_body,
              child_start=child_start, child_body=child_body,
              qm_rowstart=qm_rowstart, qm_slot=qm_slot, nlevel=nlevel,
              nnz=nnz)


def block(m: Model) -> tuple:
  """(a world's bytes of shared memory, worlds a block) of csrc/smooth.cu
  on m, from the kernel's own layout (csrc/smooth_layout.cuh,
  `smooth_block`): the most worlds, up to 4, whose layouts fit a block.
  Raises where one world does not fit."""
  return _build.model_tables(m, 'smooth', _tables)['block']


def _block(lib, m: Model, nnz: int) -> tuple:
  """`block` from lib's `smooth_block` (the built kernel, or a host
  build of its header)."""
  words = ctypes.c_int()
  worlds = lib.smooth_block(m.nq, m.nv, m.nbody, m.njnt, nnz,
                            ctypes.byref(words))
  if worlds < 1:
    raise ValueError(f'smooth kernel: a world of this model takes '
                     f'{4 * words.value} bytes of shared memory, more than '
                     f'a block has')
  return 4 * words.value, worlds


# B1's lanes per world: the fewest of LANES that keep MIN_WARPS warps
# resident per SM (by the card's occupancy query for the model's shared
# memory and the entry's registers), of those that make a block of whole
# warps (its worlds, `block`, x lanes a multiple of 32); the most, 32,
# where none does. On the H100 both models ran fastest at 16 resident
# warps of the choices: the humanoid at 16 lanes (32 worlds a SM),
# three_humanoids at 32 (16 worlds a SM, by shared memory).
LANES = (8, 16, 32)
MIN_WARPS = 16


def lanes(m: Model, entry: str = '') -> int:
  """Lanes per world of an entry of csrc/smooth.cu on this model (a warp
  holds 32 / lanes worlds), chosen at its first launch."""
  return _build.model_tables(m, 'smooth', _tables)['lanes'][entry]


def _choose_lanes(values: dict, entry: str) -> int:
  for g in LANES:
    _, threads, _, per_sm = _build.launch_shape('smooth', Params,
                                                dict(values, lanes=g), entry)
    if threads % 32 == 0 and per_sm * threads // 32 >= MIN_WARPS:
      return g
  return LANES[-1]


def _tables(m: Model) -> dict:
  dev = m.device
  t = {k: torch.tensor(getattr(m, k), dtype=torch.int32, device=dev)
       for k in _INT_TABLES}
  tree = tree_tables(m.body_parentid, m.dof_parentid)
  for k, v in tree.items():
    t[k] = v if isinstance(v, int) else torch.tensor(
        v, dtype=torch.int32, device=dev)
  t['lanes'] = {}                   # per entry, at its first launch
  t['block'] = _block(_build.library('smooth'), m, tree['nnz'])
  # 16-bit words, which the kernel reads unsigned
  t['qm_slot'] = torch.tensor(
      [v - 0x10000 if v >= 0x8000 else v for v in tree['qm_slot']],
      dtype=torch.int16, device=dev)
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


def _launch_entry(m: Model, entry: str, inputs: dict, outputs) -> dict:
  """Launch an entry of csrc/smooth.cu on `inputs` (Params fields ->
  tensors) into new tensors for the fields `outputs`; every other pointer
  of Params is null. Raises for a model of which one world does not fit
  a block (`block`)."""
  W = next(iter(inputs.values())).shape[0]
  dev = m.device
  shapes = dict(output_shapes(m, W), qvel=(W, m.nv))
  for k, t in inputs.items():
    _build.check(k, t, shapes[k], device=dev)
  outs = {k: torch.empty(shapes[k], dtype=torch.float32, device=dev)
          for k in outputs}
  values = dict.fromkeys(_PTRS)
  values.update(_build.model_tables(m, 'smooth', _tables), **inputs)
  values.update({'qpos_out' if k == 'qpos' else k: t for k, t in outs.items()})
  values.update(nworld=W, nq=m.nq, nv=m.nv, nbody=m.nbody, njnt=m.njnt,
                ngeom=m.ngeom, nsite=m.nsite)
  chosen = values['lanes']
  if entry not in chosen:
    chosen[entry] = _choose_lanes(values, entry)
  values['lanes'] = chosen[entry]
  _build.launch('smooth', Params, values, dev, entry=entry)
  return outs


def _launch(m: Model, qpos: torch.Tensor, qvel: torch.Tensor) -> dict:
  global launches
  outs = _launch_entry(m, '', dict(qpos=qpos, qvel=qvel), plain.OUTPUTS)
  launches += 1
  return outs


KINEMATICS = ('xpos', 'xquat', 'xanchor', 'xaxis')
COM_POS = ('subtree_com', 'cinert', 'cdof')
CRB = ('crb', 'qM')
FRONT = KINEMATICS + COM_POS + CRB


def plain_com_pos(m: Model, xpos, xquat, xanchor, xaxis):
  """B11's plain version: the body frames, then `smooth.com_pos`."""
  _, xipos, ximat, *_ = plain.frames(m, xpos, xquat)
  return plain.com_pos(m, xquat, xipos, ximat, xanchor, xaxis)


def plain_smooth_front(m: Model, qpos) -> dict:
  """B9's plain version: kinematics, com_pos and crb in order."""
  out = dict(zip(KINEMATICS, plain.kinematics(m, qpos)))
  out.update(zip(COM_POS, plain_com_pos(m, *out.values())))
  out.update(zip(CRB, plain.crb(m, out['cinert'], out['cdof'])))
  return out


def kinematics(m: Model, qpos: torch.Tensor):
  """Normalized (W, nq) qpos -> (xpos (W, nb, 3), xquat (W, nb, 4),
  xanchor, xaxis (W, njnt, 3)), as `smooth_kernels.kinematics_batched`."""
  if qpos.device.type == 'cpu':
    return plain.kinematics(m, qpos)
  return _launch_kinematics(m, qpos)


def _launch_kinematics(m: Model, qpos: torch.Tensor):
  global launches_kin
  outs = _launch_entry(m, 'kin_', dict(qpos=qpos), KINEMATICS)
  launches_kin += 1
  return tuple(outs.values())


def com_pos(m: Model, xpos, xquat, xanchor, xaxis):
  """(W, nb, 3) xpos, (W, nb, 4) xquat, (W, njnt, 3) xanchor and xaxis ->
  (subtree_com (W, nb, 3), cinert (W, nb, 10), cdof (W, nv, 6)), as
  `smooth_kernels.com_pos_batched`."""
  if xpos.device.type == 'cpu':
    return plain_com_pos(m, xpos, xquat, xanchor, xaxis)
  return _launch_com_pos(m, xpos, xquat, xanchor, xaxis)


def _launch_com_pos(m: Model, xpos, xquat, xanchor, xaxis):
  global launches_com
  outs = _launch_entry(m, 'com_', dict(xpos=xpos, xquat=xquat,
                                       xanchor=xanchor, xaxis=xaxis),
                       COM_POS)
  launches_com += 1
  return tuple(outs.values())


def crb(m: Model, cinert, cdof):
  """(W, nb, 10) cinert and (W, nv, 6) cdof -> (crb (W, nb, 10), qM (W,
  nv, nv)), as `smooth_kernels.crb_batched`."""
  if cinert.device.type == 'cpu':
    return plain.crb(m, cinert, cdof)
  return _launch_crb(m, cinert, cdof)


def _launch_crb(m: Model, cinert, cdof):
  global launches_crb
  outs = _launch_entry(m, 'crb_', dict(cinert=cinert, cdof=cdof), CRB)
  launches_crb += 1
  return tuple(outs.values())


def smooth_front(m: Model, qpos: torch.Tensor) -> dict:
  """Normalized (W, nq) qpos -> dict of FRONT tensors (xpos .. qM), as
  `smooth_kernels.smooth_front_batched`."""
  if qpos.device.type == 'cpu':
    return plain_smooth_front(m, qpos)
  return _launch_smooth_front(m, qpos)


def _launch_smooth_front(m: Model, qpos: torch.Tensor) -> dict:
  global launches_front
  outs = _launch_entry(m, 'front_', dict(qpos=qpos), FRONT)
  launches_front += 1
  return outs
