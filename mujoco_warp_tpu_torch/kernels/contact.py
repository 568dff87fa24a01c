"""Kernel B2: narrowphase over the static candidate pairs, order-keeping
compaction into the contact pool, and the efc rows (joint equalities,
dof friction, joint limits, contacts of the pyramidal or the elliptic
cone) in one CUDA kernel, `csrc/contact.cu`: one warp per world, 4
worlds a block, the pool's slots in shared memory; its entries (the
pyramidal rows and, `ell_`, the elliptic rows; for a model with joint
equalities or plane-box pairs, `eqbox_` and `eqbox_ell_`, `entry`)
record their launch shapes in `_build.shapes[('contact', entry)]`; a
model with capsule-box or box-box pairs launches `box_` or `box_ell_`,
which also take the `eqbox_` branches.

Replaces the TPU kernel `contact_efc` / `make_contact_kernel`
(`mujoco_warp_tpu/pallas/contact_kernels.py:1643`, `:1061`) for plane,
sphere and capsule pairs, plane-box, capsule-box (`_capsule_box_batch`
:260) and box-box pairs (`_box_box_batch` :410) and joint equalities. A
plane-box pair is four candidate rows of the kernel's table and a
box-box pair eight, one per depth rank of the pair's contacts (as
`_build_static` expands a pair into its candidates, `:992-1006`): the
lane of a box-box row repeats the separating-axis test and the manifold
and keeps the contact of its rank, so that a lane holds at most the two
contacts of a plane-capsule or a capsule-box pair. That kernel refuses
the elliptic cone (`:57`), for which the JAX package runs XLA
`collision` and `make_constraint`; this one builds the elliptic rows
too. Its plain
version (`plain`) is `collision_driver.collision` followed by
`constraint.make_constraint`; it runs for CPU tensors, and a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import collision_driver
from .. import constraint
from ..io import efc_layout
from ..io import MAX_CONTACTS
from ..types import ConeType, DisableBit, GeomType, Model
from . import _build

MAXCON = 128     # cap of nconmax: csrc/contact.cu's pool is <= 10 KB a world

launches = 0     # kernel launches since the count was last reset

CONTACT_FIELDS = ('dist', 'pos', 'frame', 'includemargin', 'friction',
                  'solref', 'solreffriction', 'solimp', 'dim', 'geom',
                  'efc_address')
EFC_FIELDS = ('efc_J', 'efc_pos', 'efc_margin', 'efc_D', 'efc_vel',
              'efc_aref', 'efc_frictionloss', 'efc_type', 'efc_id',
              'efc_active')
COUNTS = ('ncon', 'ncollision', 'ne', 'nf', 'nl', 'nefc')

_PTRS = (('qpos', 'qvel', 'geom_xpos', 'geom_xmat', 'subtree_com', 'cdof',
          'eq_active', 'pair_int', 'pair_float', 'geom_size', 'body_rootid',
          'body_dof_mask', 'eq_int', 'eq_float', 'fr_int', 'fr_float',
          'lim_int', 'lim_float') +
         tuple('con_' + k for k in CONTACT_FIELDS) + EFC_FIELDS + COUNTS)
_FLOATS = ('timestep', 'impratio')
_INTS = ('nworld', 'nq', 'nv', 'nbody', 'ngeom', 'ncand', 'nconmax',
         'ne_rows', 'nf_rows', 'nl_rows', 'stride', 'njmax', 'refsafe',
         'eq_on', 'fr_on', 'lim_on')
Params = _build.struct('ContactParams', _PTRS, _FLOATS, _INTS)

# pair types whose pairs take one candidate row of the kernel's table a
# contact (MAX_CONTACTS rows, by depth rank: a box's corners, a box-box
# manifold's contacts); a pair of another type takes one row (a lane
# finds both contacts of a plane-capsule or a capsule-box pair)
ROW_PER_CONTACT = frozenset({(GeomType.PLANE, GeomType.BOX),
                             (GeomType.BOX, GeomType.BOX)})
# pair types of the BOXES entries (`box_`, `box_ell_`)
BOX_PAIRS = frozenset({(GeomType.CAPSULE, GeomType.BOX),
                       (GeomType.BOX, GeomType.BOX)})
# every pair type the kernel has a branch for
PAIRS = frozenset({(GeomType.PLANE, GeomType.SPHERE),
                   (GeomType.PLANE, GeomType.CAPSULE),
                   (GeomType.PLANE, GeomType.BOX),
                   (GeomType.SPHERE, GeomType.SPHERE),
                   (GeomType.SPHERE, GeomType.CAPSULE),
                   (GeomType.CAPSULE, GeomType.CAPSULE)}) | BOX_PAIRS


def supports(m: Model, nconmax: int) -> bool:
  """Whether the kernel takes m at nconmax: the static pair list (no
  large-scene broadphase), every group of a pair type it has a branch
  for and not one the JAX driver would cull
  (`collision_driver.culls`), and nconmax <= MAXCON. Elsewhere the step
  runs `collision_driver.collision` (or `collision_sap.collision`) and
  `constraint.make_constraint`, as the JAX package runs XLA where its
  contact kernel refuses (`pallas/contact_kernels.py:50-82`)."""
  return (not m.sap_families and nconmax <= MAXCON and
          all((t1, t2) in PAIRS and
              not collision_driver.culls(t1, t2, len(gl))
              for t1, t2, gl in m.collision_pairs))


def entry(m: Model) -> str:
  """The C entry of csrc/contact.cu that m launches: `box_` for
  capsule-box or box-box pairs, else `eqbox_` for joint equalities or
  plane-box pairs; `ell_` for the elliptic cone."""
  types = {(t1, t2) for t1, t2, _ in m.collision_pairs}
  if types & BOX_PAIRS:
    prefix = 'box_'
  elif m.neq > 0 or types & ROW_PER_CONTACT:
    prefix = 'eqbox_'
  else:
    prefix = ''
  return prefix + ('ell_' if m.opt.cone == ConeType.ELLIPTIC else '')


def plain(m: Model, qpos, qvel, geom_xpos, geom_xmat, subtree_com, cdof,
          nconmax: int, eq_active=None) -> dict:
  """Plain version: collision + constraint rows, keys as `contact`."""
  con = collision_driver.collision(m, geom_xpos, geom_xmat, nconmax)
  efc = constraint.make_constraint(m, qpos, qvel, cdof, subtree_com, con,
                                   eq_active)
  out = {k: con[k] for k in CONTACT_FIELDS if k != 'efc_address'}
  out['efc_address'] = efc['efc_address']
  out.update({k: efc[k[4:]] for k in EFC_FIELDS})
  out.update(ncon=con['ncon'], ncollision=con['ncollision'],
             ne=efc['ne'], nf=efc['nf'], nl=efc['nl'], nefc=efc['nefc'])
  return out


def _tables(m: Model) -> dict:
  dev = m.device
  types = [(t1, t2) for t1, t2, gl in m.collision_pairs for _ in gl]
  # each pair's candidate rows, and the rank of each row's contact
  reps = [MAX_CONTACTS[t] if t in ROW_PER_CONTACT else 1 for t in types]
  row_pair = torch.tensor([q for q, r in enumerate(reps) for _ in range(r)],
                          dtype=torch.long, device=dev)
  rank = [k for r in reps for k in range(r)]
  types = [types[q] for q in row_pair.tolist()]
  p = {k: v[row_pair] for k, v in
       collision_driver.candidate_params(m).items()}
  g1, g2 = p['g1'].long(), p['g2'].long()
  geom_bodyid = torch.tensor(m.geom_bodyid, dtype=torch.long, device=dev)
  b1, b2 = geom_bodyid[g1], geom_bodyid[g2]
  invw = m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0]
  fri0 = p['friction'][:, 0]
  invw_pyr = (invw + fri0 * fri0 * invw) * 2.0 * fri0 * fri0 / torch.clamp(
      m.opt.impratio, min=constraint.MINVAL)
  i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
  pair_int = torch.stack([
      i32([t[0] for t in types]), i32([t[1] for t in types]), i32(g1),
      i32(g2), i32(b1), i32(b2), p['condim'], i32(rank)], 1)
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
  # the joint equalities (one row each, the gate): dof and qpos
  # addresses of both joints (-1 for one joint), qpos0 of both, the
  # polycoef, invweight, solref and solimp
  eq_int, eq_float = [], []
  for i in range(m.neq):
    j1, j2 = m.eq_obj1id[i], m.eq_obj2id[i]
    d1, q1 = m.jnt_dofadr[j1], m.jnt_qposadr[j1]
    d2, q2 = (m.jnt_dofadr[j2], m.jnt_qposadr[j2]) if j2 > -1 else (-1, -1)
    invw = m.dof_invweight0[d1] + (m.dof_invweight0[d2] if j2 > -1 else 0)
    eq_int.append(i32([d1, q1, d2, q2]))
    eq_float.append(torch.cat([
        m.qpos0[q1, None], m.qpos0[max(q2, 0), None], m.eq_data[i, :5],
        invw[None], m.eq_solref[i], m.eq_solimp[i]]))
  eq_int = torch.stack(eq_int) if eq_int else i32([]).reshape(0, 4)
  eq_float = (torch.stack(eq_float) if eq_float else
              torch.zeros((0, 15), device=dev))
  return dict(pair_int=pair_int.contiguous(),
              pair_float=pair_float.contiguous(),
              geom_size=m.geom_size.contiguous(),
              body_rootid=i32(m.body_rootid),
              body_dof_mask=m.body_dof_ancestor_mask.contiguous(),
              eq_int=eq_int.contiguous(), eq_float=eq_float.contiguous(),
              fr_int=i32(fr), fr_float=fr_float.contiguous(),
              lim_int=lim_int.contiguous(), lim_float=lim_float.contiguous(),
              timestep=float(m.opt.timestep),
              impratio=float(m.opt.impratio), ncand=len(rank))


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
            nconmax: int, eq_active=None) -> dict:
  """Contact pool (CONTACT_FIELDS), efc rows (EFC_FIELDS) and COUNTS for
  a batch of worlds, as the plain version returns them; eq_active
  (nworld, neq) bool, each world's active equalities (None: the model's
  eq_active0 in every world)."""
  if qpos.device.type == 'cpu':
    return plain(m, qpos, qvel, geom_xpos, geom_xmat, subtree_com, cdof,
                 nconmax, eq_active)
  return _launch(m, qpos, qvel, geom_xpos, geom_xmat, subtree_com, cdof,
                 nconmax, eq_active)


def _launch(m: Model, qpos, qvel, geom_xpos, geom_xmat, subtree_com, cdof,
            nconmax: int, eq_active=None) -> dict:
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
  eq_active = constraint.eq_active_or_start(m, qpos, eq_active)
  _build.check('eq_active', eq_active, (W, m.neq), dtype=torch.bool,
               device=dev)
  outs = {k: torch.empty(s, dtype=dt, device=dev)
          for k, (s, dt) in output_shapes(m, W, nconmax).items()}
  ne, nf, nl, stride, njmax = efc_layout(m, nconmax)
  dis = m.opt.disableflags
  values = dict(_build.model_tables(m, 'contact', _tables))
  values.update({'con_' + k: outs[k] for k in CONTACT_FIELDS})
  values.update({k: outs[k] for k in EFC_FIELDS + COUNTS})
  values.update(
      qpos=qpos, qvel=qvel, geom_xpos=geom_xpos, geom_xmat=geom_xmat,
      subtree_com=subtree_com, cdof=cdof, eq_active=eq_active, nworld=W,
      nq=m.nq, nv=m.nv, nbody=m.nbody, ngeom=m.ngeom, nconmax=nconmax,
      ne_rows=ne, nf_rows=nf, nl_rows=nl, stride=stride, njmax=njmax,
      refsafe=int(not dis & DisableBit.REFSAFE),
      eq_on=int(not dis & DisableBit.EQUALITY),
      fr_on=int(not dis & DisableBit.FRICTIONLOSS),
      lim_on=int(not dis & DisableBit.LIMIT))
  _build.launch('contact', Params, values, dev, entry=entry(m))
  launches += 1
  return outs
