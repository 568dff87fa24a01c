"""Kernel B2: narrowphase over the static candidate pairs, order-keeping
compaction into the contact pool, and the efc rows (dof friction, joint
limits, pyramidal contacts) in one CUDA kernel, `csrc/contact.cu`.

Replaces the TPU kernel `contact_efc` / `make_contact_kernel`
(`mujoco_warp_tpu/pallas/contact_kernels.py:1643`, `:1061`) for plane,
sphere and capsule pairs. Its plain version (`plain`) is
`collision_driver.collision` followed by `constraint.make_constraint`;
it runs for CPU tensors, and a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import collision_driver
from .. import constraint
from ..io import efc_layout
from ..types import DisableBit, Model
from . import _build

MAXCON = 64      # compile-time cap of csrc/contact.cu

launches = 0     # kernel launches since the count was last reset

CONTACT_FIELDS = ('dist', 'pos', 'frame', 'includemargin', 'friction',
                  'solref', 'solreffriction', 'solimp', 'dim', 'geom',
                  'efc_address')
EFC_FIELDS = ('efc_J', 'efc_pos', 'efc_margin', 'efc_D', 'efc_vel',
              'efc_aref', 'efc_frictionloss', 'efc_type', 'efc_id',
              'efc_active')
COUNTS = ('ncon', 'ncollision', 'ne', 'nf', 'nl', 'nefc')

_PTRS = (('qpos', 'qvel', 'geom_xpos', 'geom_xmat', 'subtree_com', 'cdof',
          'pair_int', 'pair_float', 'geom_size', 'body_rootid',
          'body_dof_mask', 'fr_int', 'fr_float', 'lim_int', 'lim_float') +
         tuple('con_' + k for k in CONTACT_FIELDS) + EFC_FIELDS + COUNTS)
_FLOATS = ('timestep',)
_INTS = ('nworld', 'nq', 'nv', 'nbody', 'ngeom', 'npair', 'nconmax',
         'nf_rows', 'nl_rows', 'stride', 'njmax', 'refsafe', 'fr_on',
         'lim_on')
Params = _build.struct('ContactParams', _PTRS, _FLOATS, _INTS)


def plain(m: Model, qpos, qvel, geom_xpos, geom_xmat, subtree_com, cdof,
          nconmax: int) -> dict:
  """Plain version: collision + constraint rows, keys as `contact`."""
  con = collision_driver.collision(m, geom_xpos, geom_xmat, nconmax)
  efc = constraint.make_constraint(m, qpos, qvel, cdof, subtree_com, con)
  out = {k: con[k] for k in CONTACT_FIELDS if k != 'efc_address'}
  out['efc_address'] = efc['efc_address']
  out.update({k: efc[k[4:]] for k in EFC_FIELDS})
  out.update(ncon=con['ncon'], ncollision=con['ncollision'],
             ne=efc['ne'], nf=efc['nf'], nl=efc['nl'], nefc=efc['nefc'])
  return out


def _tables(m: Model) -> dict:
  dev = m.device
  p = collision_driver.candidate_params(m)
  g1, g2 = p['g1'].long(), p['g2'].long()
  types = [(t1, t2) for t1, t2, gl in m.collision_pairs for _ in gl]
  geom_bodyid = torch.tensor(m.geom_bodyid, dtype=torch.long, device=dev)
  b1, b2 = geom_bodyid[g1], geom_bodyid[g2]
  invw = m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0]
  fri0 = p['friction'][:, 0]
  invw_pyr = (invw + fri0 * fri0 * invw) * 2.0 * fri0 * fri0 / torch.clamp(
      m.opt.impratio, min=constraint.MINVAL)
  i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
  pair_int = torch.stack([
      i32([t[0] for t in types]), i32([t[1] for t in types]), i32(g1),
      i32(g2), i32(b1), i32(b2), p['condim'], torch.zeros_like(p['condim'])],
      1)
  pair_float = torch.cat([
      p['friction'], p['solref'], p['solreffriction'], p['solimp'],
      p['margin'][:, None], p['includemargin'][:, None], invw[:, None],
      invw_pyr[:, None]], 1)
  fr = [i for i in range(m.nv) if m.dof_hasfrictionloss[i]]
  fr_float = torch.cat([m.dof_solref[fr], m.dof_solimp[fr],
                        m.dof_invweight0[fr, None],
                        m.dof_frictionloss[fr, None]], 1)
  lim = [j for j in range(m.njnt) if m.jnt_limited[j]]
  dadr = [m.jnt_dofadr[j] for j in lim]
  lim_int = torch.stack([i32([m.jnt_qposadr[j] for j in lim]), i32(dadr),
                         i32(lim)], 1)
  lim_float = torch.cat([m.jnt_range[lim], m.jnt_margin[lim, None],
                         m.jnt_solref[lim], m.jnt_solimp[lim],
                         m.dof_invweight0[dadr, None]], 1)
  return dict(pair_int=pair_int.contiguous(),
              pair_float=pair_float.contiguous(),
              geom_size=m.geom_size.contiguous(),
              body_rootid=i32(m.body_rootid),
              body_dof_mask=m.body_dof_ancestor_mask.contiguous(),
              fr_int=i32(fr), fr_float=fr_float.contiguous(),
              lim_int=lim_int.contiguous(), lim_float=lim_float.contiguous(),
              timestep=float(m.opt.timestep),
              npair=sum(len(gl) for _, _, gl in m.collision_pairs))


def output_shapes(m: Model, nworld: int, nconmax: int) -> dict:
  W, C = nworld, nconmax
  _, _, _, _, nj = efc_layout(m, nconmax)
  f, i, b = torch.float32, torch.int32, torch.bool
  shapes = dict(
      dist=((W, C), f), pos=((W, C, 3), f), frame=((W, C, 3, 3), f),
      includemargin=((W, C), f), friction=((W, C, 5), f),
      solref=((W, C, 2), f), solreffriction=((W, C, 2), f),
      solimp=((W, C, 5), f), dim=((W, C), i), geom=((W, C, 2), i),
      efc_address=((W, C), i), efc_J=((W, nj, m.nv), f),
      efc_pos=((W, nj), f), efc_margin=((W, nj), f), efc_D=((W, nj), f),
      efc_vel=((W, nj), f), efc_aref=((W, nj), f),
      efc_frictionloss=((W, nj), f), efc_type=((W, nj), i),
      efc_id=((W, nj), i), efc_active=((W, nj), b))
  shapes.update({k: ((W,), i) for k in COUNTS})
  return shapes


def contact(m: Model, qpos, qvel, geom_xpos, geom_xmat, subtree_com, cdof,
            nconmax: int) -> dict:
  """Contact pool (CONTACT_FIELDS), efc rows (EFC_FIELDS) and COUNTS for
  a batch of worlds, as the plain version returns them."""
  if qpos.device.type == 'cpu':
    return plain(m, qpos, qvel, geom_xpos, geom_xmat, subtree_com, cdof,
                 nconmax)
  return _launch(m, qpos, qvel, geom_xpos, geom_xmat, subtree_com, cdof,
                 nconmax)


def _launch(m: Model, qpos, qvel, geom_xpos, geom_xmat, subtree_com, cdof,
            nconmax: int) -> dict:
  global launches
  if nconmax > MAXCON:
    raise ValueError(f'contact kernel: nconmax={nconmax} (cap {MAXCON})')
  W, dev = qpos.shape[0], m.device
  for name, t, shape in (
      ('qpos', qpos, (W, m.nq)), ('qvel', qvel, (W, m.nv)),
      ('geom_xpos', geom_xpos, (W, m.ngeom, 3)),
      ('geom_xmat', geom_xmat, (W, m.ngeom, 3, 3)),
      ('subtree_com', subtree_com, (W, m.nbody, 3)),
      ('cdof', cdof, (W, m.nv, 6))):
    _build.check(name, t, shape, device=dev)
  outs = {k: torch.empty(s, dtype=dt, device=dev)
          for k, (s, dt) in output_shapes(m, W, nconmax).items()}
  ne, nf, nl, stride, njmax = efc_layout(m, nconmax)
  dis = m.opt.disableflags
  values = dict(_build.model_tables(m, 'contact', _tables))
  values.update({'con_' + k: outs[k] for k in CONTACT_FIELDS})
  values.update({k: outs[k] for k in EFC_FIELDS + COUNTS})
  values.update(
      qpos=qpos, qvel=qvel, geom_xpos=geom_xpos, geom_xmat=geom_xmat,
      subtree_com=subtree_com, cdof=cdof, nworld=W, nq=m.nq, nv=m.nv,
      nbody=m.nbody, ngeom=m.ngeom,
      nconmax=nconmax, nf_rows=nf, nl_rows=nl, stride=stride, njmax=njmax,
      refsafe=int(not dis & DisableBit.REFSAFE),
      fr_on=int(not dis & DisableBit.FRICTIONLOSS),
      lim_on=int(not dis & DisableBit.LIMIT))
  _build.launch('contact', Params, values, dev)
  launches += 1
  return outs
