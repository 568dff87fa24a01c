"""Collision over the static pair list: narrowphase per type-pair group,
then order-preserving compaction into the per-world contact pool.

Mirrors `mujoco_warp_tpu/collision_driver.py` (`_candidate_params` :25,
the static-pair path of `collision` :177, `finalize` :121). Together with
`constraint.py` this is the plain PyTorch version of kernel B2
(`kernels/contact.py`).

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

from . import collision_primitive
from .io import MAX_CONTACTS
from .kernels import _build
from .types import Model

# contact pool fill values of empty slots
_EMPTY_DIST = 1e10


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


def _group_tables(m: Model) -> list:
  """Per group of the static list: its geom ids g1, g2 as index tensors
  and its candidates' rows of `candidate_params`, built once per
  model."""
  def make(m):
    out, start = [], 0
    for t1, t2, glist in m.collision_pairs:
      n, k = len(glist), MAX_CONTACTS[(t1, t2)]
      idx = lambda x: torch.as_tensor(x, dtype=torch.long, device=m.device)
      out.append(dict(g1=idx([g for g, _, _ in glist]),
                      g2=idx([g for _, g, _ in glist]), start=start,
                      rep=torch.arange(start, start + n, device=m.device
                                       ).repeat_interleave(k)))
      start += n
    return out
  return _build.model_tables(m, 'collision_groups', make)


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


def pool(dist, pos, frame, cand: dict, nconmax: int, dropped=None) -> dict:
  """The contact pool of candidates dist (W, C), pos (W, C, 3) and frame
  (W, C, 3, 3) with their `pair_params` rows cand, (C, ...) shared by
  the worlds or (W, C, ...) per world (`finalize`, JAX
  `collision_driver.py:121`): the candidates with dist < margin keep
  their order in the pool; those past nconmax are dropped and counted in
  ncollision, as are `dropped` (W,) int32 overlaps a broadphase dropped
  before the narrowphase."""
  W, ncand = dist.shape
  active = dist < cand['margin']
  nactive = active.sum(1, dtype=torch.int32)
  idx = torch.arange(ncand, device=dist.device)
  key = torch.where(active, ncand - idx, -idx)
  sel = torch.topk(key, min(nconmax, ncand), dim=1).indices  # (W, C)
  ok = torch.gather(active, 1, sel)

  shared = cand['g1'].dim() == 1

  def take(vals, fill, per_world=True):
    if per_world:
      gi = sel.reshape(sel.shape + (1,) * (vals.dim() - 2))
      vals = torch.gather(vals, 1, gi.expand(sel.shape + vals.shape[2:]))
    else:
      vals = vals[sel]
    fill = vals.new_full((), fill)
    out = torch.where(ok.reshape(ok.shape + (1,) * (vals.dim() - 2)),
                      vals, fill)
    if out.shape[1] < nconmax:
      pad = fill.expand((W, nconmax - out.shape[1]) + out.shape[2:])
      out = torch.cat([out, pad], 1)
    return out

  row = lambda k, fill: take(cand[k], fill, not shared)
  return dict(
      dist=take(dist, _EMPTY_DIST), pos=take(pos, 0.0),
      frame=take(frame, 0.0), includemargin=row('includemargin', 0.0),
      friction=row('friction', 1.0), solref=row('solref', 0.02),
      solreffriction=row('solreffriction', 0.0), solimp=row('solimp', 0.9),
      dim=row('condim', 1),
      geom=take(torch.stack([cand['g1'], cand['g2']], -1), -1, not shared),
      ncon=torch.clamp(nactive, max=nconmax),
      ncollision=nactive if dropped is None else nactive + dropped)


def collision(m: Model, geom_xpos: torch.Tensor, geom_xmat: torch.Tensor,
              nconmax: int) -> dict:
  """Contact pool for (W, ngeom, 3) geom_xpos and (W, ngeom, 3, 3)
  geom_xmat over the static pair list (`pool`)."""
  W = geom_xpos.shape[0]
  if not m.collision_pairs or nconmax == 0:
    return empty_pool(m, W, nconmax)
  params = candidate_params(m)
  dists, poss, frames = [], [], []
  for (t1, t2, glist), grp in zip(m.collision_pairs, _group_tables(m)):
    g1, g2, n = grp['g1'], grp['g2'], len(glist)
    fn = collision_primitive.COLLIDERS[(t1, t2)]
    start = grp['start']
    extra = ((params['margin'][start:start + n],)
             if (t1, t2) in collision_primitive.NEEDS_MARGIN else ())
    dist, pos, frame = fn(geom_xpos[:, g1], geom_xmat[:, g1],
                          m.geom_size[g1], geom_xpos[:, g2],
                          geom_xmat[:, g2], m.geom_size[g2], *extra)
    k = MAX_CONTACTS[(t1, t2)]
    dists.append(dist.reshape(W, n * k))
    poss.append(pos.reshape(W, n * k, 3))
    frames.append(frame.reshape(W, n * k, 3, 3))
  rep = torch.cat([grp['rep'] for grp in _group_tables(m)])
  return pool(torch.cat(dists, 1), torch.cat(poss, 1), torch.cat(frames, 1),
              {k: v[rep] for k, v in params.items()}, nconmax)
