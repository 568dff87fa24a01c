"""Collision over the static pair list: narrowphase per type-pair group,
then order-preserving compaction into the per-world contact pool.

Mirrors `mujoco_warp_tpu/collision_driver.py` (`_candidate_params` :25,
the static-pair path of `collision` :177, `finalize` :121). Together with
`constraint.py` this is the plain PyTorch version of kernel B2
(`kernels/contact.py`), and, where B2 cannot take the model
(`kernels.contact.supports`), the step's `collision` stage on the card:
the JAX package runs it as XLA there.

A group of more pairs than the JAX package's cull threshold (64 for mesh
or MPR pairs, 2,048 for the others) whose first type is not a plane is
culled each step, as the JAX driver culls it (:300-335): the pairs whose
bounding spheres (`geom_rbound` plus the pair's detection margin)
overlap, the `cull_slots` of them with the nearest centers (ties to the
lower pair, as `jax.lax.top_k`), go through the narrowphase, mesh hulls
decimated (`mesh_hullvert_small`); the overlaps dropped count in
ncollision. Mesh groups run the narrowphase in chunks of worlds, so that
no tensor of a whole batch's hull vertices is built. A group with an SDF
side runs the SDF narrowphase (`collision_sdf.collide`, its
sdf_initpoints candidates a pair, each side's voxel grid or primitive
distance) and is never culled, as the JAX driver sends it there before
its cull (:240-289). So is a group with a height field: it runs one
subgroup a height field geom (`collision_hfield.collide` on that field's
grid, in chunks of worlds of HFIELD_ELEMENTS), the subgroups by geom id,
each in list order, which orders the group's rows of the pool, as the
JAX driver's hfield branch does (:218-238).

One deliberate difference, C MuJoCo's rule (mujoco 3.10): a geom pair's
margin and gap are the sums of the two geoms' (explicit <pair>s keep
their own), a contact is found below margin + gap, and its includemargin
is the margin, so that a contact in the gap has no active rows. The JAX
package takes the larger margin and gap, finds contacts below the
margin, and includes them below margin - gap (`collision_driver.py:60`).
The two agree where the geoms have no gap and at most one has a margin
(ROADMAP §C, C5).
"""

from __future__ import annotations

import numpy as np
import torch

from . import collision_convex
from . import collision_hfield
from . import collision_primitive
from . import collision_sdf
from .io import MPR_PAIRS, is_hfield_pair, is_sdf_pair, pair_slots
from .kernels import _build
from .types import GeomType, Model

# contact pool fill values of empty slots
_EMPTY_DIST = 1e10
# the JAX driver's cull thresholds (`_CULL_THRESHOLD`,
# `_CULL_THRESHOLD_CHEAP`, `mujoco_warp_tpu/collision_driver.py:83-84`):
# groups of mesh or MPR pairs, and the others
CULL_THRESHOLD = 64
CULL_THRESHOLD_CHEAP = 2048
# (world, pair) entries of one chunk of a culled group's sphere test
# (each (..., 3) float32 temporary at most 400 MB), and (world, pair, hull
# vertex, tilt) entries of one chunk of worlds of a mesh group's
# narrowphase (each such float32 temporary at most 1 GB)
CHUNK_ELEMENTS = 1 << 25
NARROW_ELEMENTS = 1 << 28
# (world, pair, `collision_hfield.candidates`) entries of one chunk of
# worlds of a height field group's narrowphase (each (..., 3) float32
# temporary at most 100 MB)
HFIELD_ELEMENTS = 1 << 23

_LOW = 1 << 32          # a composite key's pair-index part
_INDEX_TOP = (1 << 31) - 1


def _sortable(x):
  """float32 -> int64 of the same order (-0.0 below +0.0)."""
  bits = x.contiguous().view(torch.int32)
  return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()


def pair_params(m: Model, g1, g2, pid) -> dict:
  """Mixed contact parameters of the geom pairs (g1[i], g2[i]) with
  <pair> ids pid[i] (-1 for none), int sequences of length P
  (C mj_contactParam): friction (P, 5), solref, solreffriction (P, 2),
  solimp (P, 5), margin (the detection margin: the pair's margin plus its
  gap), includemargin (the pair's margin) (P,), condim (P,) int32, plus
  the geom ids g1, g2 (P,) int32. Builds tensors from host data: a step
  reads it through a per-model table (`candidate_params`,
  `collision_sap.sap_tables`)."""
  dev = m.device
  idx = lambda x: torch.as_tensor(np.asarray(x, np.int64).reshape(-1),
                                  device=dev)
  g1s, g2s, pids = idx(g1), idx(g2), idx(pid)
  pr = torch.as_tensor(m.geom_priority, device=dev)
  cd = torch.as_tensor(m.geom_condim, dtype=torch.int32, device=dev)
  use1 = pr[g1s] > pr[g2s]
  eq = pr[g1s] == pr[g2s]

  f1, f2 = m.geom_friction[g1s], m.geom_friction[g2s]
  fr3 = torch.where(eq[:, None], torch.maximum(f1, f2),
                    torch.where(use1[:, None], f1, f2))
  friction = torch.stack([fr3[:, 0], fr3[:, 0], fr3[:, 1], fr3[:, 2],
                          fr3[:, 2]], dim=1)

  sm1, sm2 = m.geom_solmix[g1s], m.geom_solmix[g2s]
  denom = sm1 + sm2
  mix = torch.where(denom > 1e-12, sm1 / torch.where(
      denom > 1e-12, denom, torch.ones_like(denom)),
      torch.full_like(denom, 0.5))
  mix = torch.where((sm1 < 1e-12) & (sm2 < 1e-12), 0.5, mix)
  mix = torch.where((sm1 < 1e-12) & (sm2 >= 1e-12), 0.0, mix)
  mix = torch.where((sm2 < 1e-12) & (sm1 >= 1e-12), 1.0, mix)
  mix = torch.where(eq, mix, torch.where(use1, 1.0, 0.0))

  sr1, sr2 = m.geom_solref[g1s], m.geom_solref[g2s]
  standard = (sr1[:, 0] > 0) & (sr2[:, 0] > 0)
  solref = torch.where(standard[:, None], mix[:, None] * sr1 +
                       (1 - mix)[:, None] * sr2, torch.minimum(sr1, sr2))
  solimp = (mix[:, None] * m.geom_solimp[g1s] +
            (1 - mix)[:, None] * m.geom_solimp[g2s])
  margin = m.geom_margin[g1s] + m.geom_margin[g2s]
  gap = m.geom_gap[g1s] + m.geom_gap[g2s]
  solreffriction = torch.zeros_like(solref)
  condim = torch.where(eq, torch.maximum(cd[g1s], cd[g2s]),
                       torch.where(use1, cd[g1s], cd[g2s]))

  is_pair = pids >= 0
  if bool(is_pair.any()):
    pid = pids.clamp(min=0)
    pair_dim = torch.as_tensor(m.pair_dim, dtype=torch.int32, device=dev)
    friction = torch.where(is_pair[:, None], m.pair_friction[pid], friction)
    solref = torch.where(is_pair[:, None], m.pair_solref[pid], solref)
    solreffriction = torch.where(is_pair[:, None],
                                 m.pair_solreffriction[pid], solreffriction)
    solimp = torch.where(is_pair[:, None], m.pair_solimp[pid], solimp)
    margin = torch.where(is_pair, m.pair_margin[pid], margin)
    gap = torch.where(is_pair, m.pair_gap[pid], gap)
    condim = torch.where(is_pair, pair_dim[pid], condim)
  return dict(friction=friction, solref=solref,
              solreffriction=solreffriction, solimp=solimp,
              margin=margin + gap, includemargin=margin, condim=condim,
              g1=g1s.to(torch.int32), g2=g2s.to(torch.int32))


def candidate_params(m: Model) -> dict:
  """`pair_params` of every pair of the static list, in list order,
  built once per model."""
  def make(m):
    gl = [p for _, _, g in m.collision_pairs for p in g]
    return pair_params(m, [p[0] for p in gl], [p[1] for p in gl],
                       [p[2] for p in gl])
  return _build.model_tables(m, 'candidate_params', make)


def culls(t1: int, t2: int, n: int) -> bool:
  """Whether the JAX driver culls a static group of n (t1, t2) pairs
  (`collision_driver.py:300-304`): never an SDF or a height field group,
  which it sends to their narrowphase before the cull (:218-289)."""
  if GeomType.SDF in (t1, t2) or GeomType.HFIELD in (t1, t2):
    return False
  costly = (t1, t2) in MPR_PAIRS or GeomType.MESH in (t1, t2)
  return (n > (CULL_THRESHOLD if costly else CULL_THRESHOLD_CHEAP) and
          t1 != GeomType.PLANE)


def cull_slots(nconmax: int, n: int) -> int:
  """Pairs a culled group of n keeps a step (`_cull_k` :87)."""
  return min(n, max(4 * nconmax, 64))


def group_collider(m: Model, t1: int, t2: int):
  """(collide, slots, extra) of a pair type: the analytic collider, MPR
  (`collision_convex.collider`) or the SDF narrowphase
  (`collision_sdf.collide`), and what it takes after the six geometry
  arguments: 'margin', 'hulls' or 'hulls+margin'; 'sdf' for the SDF
  narrowphase, which takes each side's `collision_sdf.Side`; 'hfield'
  for the height-field narrowphase, which takes the field's grid."""
  if is_hfield_pair(t1, t2):
    return collision_hfield.collide, pair_slots(t1, t2, m.opt), 'hfield'
  if (t1, t2) in MPR_PAIRS:
    fn, k = collision_convex.collider(t1, t2, m.opt.disableflags)
    return fn, k, 'hulls+margin'
  if is_sdf_pair(t1, t2):
    return collision_sdf.collide, pair_slots(t1, t2, m.opt), 'sdf'
  extra = ('margin' if (t1, t2) in collision_primitive.NEEDS_MARGIN else
           'hulls' if (t1, t2) in collision_primitive.NEEDS_HULLS else '')
  return (collision_primitive.COLLIDERS[(t1, t2)],
          pair_slots(t1, t2, m.opt), extra)


def sdf_side(m: Model, t: int, g, did) -> collision_sdf.Side:
  """The `collision_sdf.Side` of geoms g (P,) of type t with mesh ids did
  (P,): a mesh or SDF geom reads its mesh's voxel grid."""
  grid = None
  if t in (GeomType.MESH, GeomType.SDF):
    gom = torch.as_tensor(m.sdf_grid_of_mesh, device=m.device)
    gi = gom[did]
    if bool((gi < 0).any()):
      raise NotImplementedError(f'no SDF grid for meshes {did[gi < 0]}')
    aabb = m.sdf_grid_aabb[gi]
    grid = collision_sdf.Grid(m.sdf_grids, gi, aabb[:, 0], aabb[:, 1])
  return collision_sdf.Side(t, m.geom_size[g], m.geom_aabb[g], grid)


def _group_tables(m: Model) -> list:
  """Per group of the static list: its geom ids g1, g2 and mesh ids d1,
  d2 (-1 for none) as index tensors, its first row of
  `candidate_params`, its collider, slots and cull, and the full hulls
  of an uncut mesh group's pairs; of a height field group, its pairs in
  the narrowphase's order ('order', by the field's geom id, stable) and
  its subgroups ('fields': the geom, its field id and its pairs), built
  once per model."""
  def make(m):
    out, start = [], 0
    idx = lambda x: torch.as_tensor(x, dtype=torch.long, device=m.device)
    for t1, t2, glist in m.collision_pairs:
      g1, g2 = [g for g, _, _ in glist], [g for _, g, _ in glist]
      fn, k, extra = group_collider(m, t1, t2)
      grp = dict(g1=idx(g1), g2=idx(g2), t2=t2, start=start, n=len(glist),
                 fn=fn, slots=k, extra=extra, cull=culls(t1, t2, len(glist)),
                 mesh=(t1 == GeomType.MESH, t2 == GeomType.MESH))
      for side, gs, t in (('1', g1, t1), ('2', g2, t2)):
        did = idx([m.geom_dataid[g] for g in gs])
        grp['d' + side] = did
        if extra == 'sdf':
          grp['side' + side] = sdf_side(m, t, grp['g' + side], did)
        elif grp['mesh'][int(side) - 1] and not grp['cull']:
          grp['hull' + side] = m.mesh_hullvert[did]
      if extra == 'hfield':
        order = sorted(range(len(glist)), key=lambda i: g1[i])
        grp['order'] = idx(order)
        grp['fields'] = [(h, m.geom_dataid[h], idx(
            [i for i in order if g1[i] == h])) for h in sorted(set(g1))]
      out.append(grp)
      start += len(glist)
    return out
  return _build.model_tables(m, 'collision_groups', make)


def top_k_chunked(score, count: int, W: int, kk: int, chunk_elements: int):
  """The kk pairs of greatest score of `count`, taken in chunks of at
  most chunk_elements (world, pair) entries with a running top-K, ties to
  the lower pair (as `jax.lax.top_k`): (sel (W, kk) long pair indices,
  best first; valid (W, kk) bool, the pair overlaps; noverlap (W,) int32
  the overlapping pairs). score(s, e) gives pairs s..e-1's (W, e - s)
  float32 scores, -inf where a pair does not overlap."""
  chunk = max(kk, chunk_elements // W)
  best, noverlap = None, None
  for s in range(0, count, chunk):
    key = score(s, min(s + chunk, count))
    n = (key > float('-inf')).sum(1, dtype=torch.int32)
    noverlap = n if noverlap is None else noverlap + n
    rows = torch.arange(s, s + key.shape[1], device=key.device)
    # the score's order first, then the lower row: every key distinct
    comp = _sortable(key) * _LOW + (_INDEX_TOP - rows)
    if best is not None:
      comp = torch.cat([best, comp], 1)
    best = torch.topk(comp, kk, dim=1).values
  sel = _INDEX_TOP - (best & (_LOW - 1))
  valid = (best >> 32) > _sortable(key.new_full((), float('-inf')))
  return sel, valid, noverlap


def cull(m: Model, geom_xpos, grp: dict, margin, kk: int):
  """A culled group's kk pairs of nearest centers among those whose
  bounding spheres, widened by the pair's detection margin (P,),
  overlap: `top_k_chunked`'s (sel, valid, noverlap)
  (`collision_driver.py:306-314`)."""
  g1, g2 = grp['g1'], grp['g2']
  rsum = (m.geom_rbound[g1] + m.geom_rbound[g2]) + margin

  def score(s, e):
    dv = geom_xpos[:, g1[s:e]] - geom_xpos[:, g2[s:e]]
    d2 = (dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1]) + \
        dv[..., 2] * dv[..., 2]
    r = rsum[s:e]
    return torch.where(d2 <= r * r, -d2, float('-inf'))
  return top_k_chunked(score, grp['n'], geom_xpos.shape[0], kk,
                       CHUNK_ELEMENTS)


def pick(x, g):
  """x[w, g[w, k]] of per-world x (W, n, ...) at the per-world ids g."""
  return torch.gather(x, 1, g.reshape(g.shape + (1,) * (x.dim() - 2)).expand(
      g.shape + x.shape[2:]))


def narrowphase(m: Model, grp: dict, geom_xpos, geom_xmat, margin,
                sel=None):
  """(dist (W, P, k), pos (W, P, k, 3), frame (W, P, k, 3, 3)) of a
  group's pairs: all of them in every world, or where sel (W, P) picks
  them per world, those, with decimated hulls. A group with hulls runs
  in chunks of worlds of at most NARROW_ELEMENTS (world, pair, vertex,
  tilt) entries, an SDF group in `collision_sdf.collide`'s chunks;
  margin (P,) or (W, P)."""
  W = geom_xpos.shape[0]
  if grp['extra'] == 'hfield':
    return _hfield_narrowphase(m, grp, geom_xpos, geom_xmat)
  if grp['extra'] == 'sdf':
    ga, gb = grp['g1'], grp['g2']
    return grp['fn'](grp['side1'], grp['side2'], grp['slots'],
                     m.opt.sdf_iterations, geom_xpos[:, ga], geom_xmat[:, ga],
                     geom_xpos[:, gb], geom_xmat[:, gb])
  hulls = grp['extra'].startswith('hulls')
  if sel is None:
    ga, gb, npair = grp['g1'], grp['g2'], grp['n']
  else:
    ga, gb, npair = grp['g1'][sel], grp['g2'][sel], sel.shape[1]
  nvert = 1
  if hulls and any(grp['mesh']):
    table = m.mesh_hullvert if sel is None else m.mesh_hullvert_small
    nvert = table.shape[1] * (4 if grp['slots'] > 1 else 1)
  wc = max(1, NARROW_ELEMENTS // (npair * nvert))
  outs = []
  for w in range(0, W, wc):
    ws = slice(w, min(w + wc, W))
    if sel is None:
      geo = (geom_xpos[ws][:, ga], geom_xmat[ws][:, ga], m.geom_size[ga],
             geom_xpos[ws][:, gb], geom_xmat[ws][:, gb], m.geom_size[gb])
    else:
      a, b = ga[ws], gb[ws]
      geo = (pick(geom_xpos[ws], a), pick(geom_xmat[ws], a),
             m.geom_size[a], pick(geom_xpos[ws], b),
             pick(geom_xmat[ws], b), m.geom_size[b])
    extra = ()
    if hulls:
      for side in ('1', '2'):
        if not grp['mesh'][int(side) - 1]:
          extra += (None,)
        elif sel is None:
          extra += (grp['hull' + side],)
        else:
          extra += (m.mesh_hullvert_small[grp['d' + side][sel[ws]]],)
    if grp['extra'].endswith('margin'):
      extra += (margin if margin.dim() == 1 else margin[ws],)
    outs.append(grp['fn'](*geo, *extra))
  return tuple(torch.cat(x, 0) for x in zip(*outs))


def _hfield_narrowphase(m: Model, grp: dict, geom_xpos, geom_xmat):
  """A height field group's (dist, pos, frame), (W, P, NCONH, ...), its
  pairs in grp['order'], in chunks of worlds of at most HFIELD_ELEMENTS
  (world, pair, candidate) entries."""
  W = geom_xpos.shape[0]
  t2 = grp['t2']
  per_world = grp['n'] * collision_hfield.candidates(t2)
  wc = max(1, HFIELD_ELEMENTS // per_world)
  outs = []
  for w in range(0, W, wc):
    gx, gm = geom_xpos[w:w + wc], geom_xmat[w:w + wc]
    parts = []
    for h, hid, pairs in grp['fields']:
      g2 = grp['g2'][pairs]
      shape = (gx.shape[0], len(pairs))
      parts.append(grp['fn'](
          t2, m.hfield_data[hid], m.hfield_nrow[hid], m.hfield_ncol[hid],
          m.hfield_size[hid], gx[:, h, None].expand(shape + (3,)),
          gm[:, h, None].expand(shape + (3, 3)), gx[:, g2], gm[:, g2],
          m.geom_size[g2].expand(shape + (3,))))
    outs.append(tuple(torch.cat(x, 1) for x in zip(*parts)))
  return tuple(torch.cat(x, 0) for x in zip(*outs))


def empty_pool(m: Model, W: int, nconmax: int) -> dict:
  """A pool of nconmax empty slots: no candidate can make a contact."""
  full = lambda shape, v, dt=torch.float32: torch.full(
      (W, nconmax) + shape, v, dtype=dt, device=m.device)
  zero = torch.zeros(W, dtype=torch.int32, device=m.device)
  return dict(
      dist=full((), _EMPTY_DIST), pos=full((3,), 0.0),
      frame=full((3, 3), 0.0), includemargin=full((), 0.0),
      friction=full((5,), 1.0), solref=full((2,), 0.02),
      solreffriction=full((2,), 0.0), solimp=full((5,), 0.9),
      dim=full((), 1, torch.int32), geom=full((2,), -1, torch.int32),
      ncon=zero, ncollision=zero)


def pool(dist, pos, frame, params: dict, rows, nconmax: int,
         dropped=None) -> dict:
  """The contact pool of candidates dist (W, C), pos (W, C, 3) and frame
  (W, C, 3, 3) whose `pair_params` are the rows `rows` of the table
  params, (C,) shared by the worlds or (W, C) per world (`finalize`, JAX
  `collision_driver.py:121`): the candidates with dist < margin keep
  their order in the pool; those past nconmax are dropped and counted in
  ncollision, as are `dropped` (W,) int32 overlaps a broadphase dropped
  before the narrowphase."""
  W, ncand = dist.shape
  active = dist < params['margin'][rows]
  nactive = active.sum(1, dtype=torch.int32)
  idx = torch.arange(ncand, device=dist.device)
  key = torch.where(active, ncand - idx, -idx)
  sel = torch.topk(key, min(nconmax, ncand), dim=1).indices  # (W, C)
  ok = torch.gather(active, 1, sel)
  picked = rows[sel] if rows.dim() == 1 else torch.gather(rows, 1, sel)

  def take(vals, fill, per_world=True):
    if per_world:
      gi = sel.reshape(sel.shape + (1,) * (vals.dim() - 2))
      vals = torch.gather(vals, 1, gi.expand(sel.shape + vals.shape[2:]))
    else:
      vals = vals[picked]
    fill = vals.new_full((), fill)
    out = torch.where(ok.reshape(ok.shape + (1,) * (vals.dim() - 2)),
                      vals, fill)
    if out.shape[1] < nconmax:
      pad = fill.expand((W, nconmax - out.shape[1]) + out.shape[2:])
      out = torch.cat([out, pad], 1)
    return out

  row = lambda k, fill: take(params[k], fill, False)
  return dict(
      dist=take(dist, _EMPTY_DIST), pos=take(pos, 0.0),
      frame=take(frame, 0.0), includemargin=row('includemargin', 0.0),
      friction=row('friction', 1.0), solref=row('solref', 0.02),
      solreffriction=row('solreffriction', 0.0), solimp=row('solimp', 0.9),
      dim=row('condim', 1),
      geom=take(torch.stack([params['g1'], params['g2']], -1), -1, False),
      ncon=torch.clamp(nactive, max=nconmax),
      ncollision=nactive if dropped is None else nactive + dropped)


def collision(m: Model, geom_xpos: torch.Tensor, geom_xmat: torch.Tensor,
              nconmax: int) -> dict:
  """Contact pool for (W, ngeom, 3) geom_xpos and (W, ngeom, 3, 3)
  geom_xmat over the static pair list (`pool`), culled groups as the JAX
  driver culls them, their dropped overlaps in ncollision."""
  W = geom_xpos.shape[0]
  if not m.collision_pairs or nconmax == 0:
    return empty_pool(m, W, nconmax)
  params = candidate_params(m)
  dev = geom_xpos.device
  dropped = None
  dists, poss, frames, rows = [], [], [], []
  for grp in _group_tables(m):
    start, n, k = grp['start'], grp['n'], grp['slots']
    margin = params['margin'][start:start + n]
    if grp['cull']:
      kk = cull_slots(nconmax, n)
      sel, valid, nover = cull(m, geom_xpos, grp, margin, kk)
      over = torch.clamp(nover - kk, min=0)
      dropped = over if dropped is None else dropped + over
      dist, pos, frame = narrowphase(m, grp, geom_xpos, geom_xmat,
                                     margin[sel], sel)
      dist = torch.where(valid[..., None], dist, _EMPTY_DIST)
      row = (start + sel).repeat_interleave(k, dim=1)
    else:
      dist, pos, frame = narrowphase(m, grp, geom_xpos, geom_xmat, margin)
      row = (start + grp['order'] if 'order' in grp else
             torch.arange(start, start + n, device=dev)).repeat_interleave(k)
    npair = dist.shape[1]
    dists.append(dist.reshape(W, npair * k))
    poss.append(pos.reshape(W, npair * k, 3))
    frames.append(frame.reshape(W, npair * k, 3, 3))
    rows.append(row)
  if any(r.dim() == 2 for r in rows):
    rows = [r if r.dim() == 2 else r.expand(W, -1) for r in rows]
    rows = torch.cat(rows, 1)
  else:
    rows = torch.cat(rows)
  return pool(torch.cat(dists, 1), torch.cat(poss, 1), torch.cat(frames, 1),
              params, rows, nconmax, dropped)
