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

import torch

from . import collision_primitive
from .io import MAX_CONTACTS
from .types import Model

# contact pool fill values of empty slots
_EMPTY_DIST = 1e10


def candidate_params(m: Model) -> dict:
  """Mixed contact parameters of every candidate pair, in pair-list order
  (C mj_contactParam): friction (P, 5), solref, solreffriction (P, 2),
  solimp (P, 5), margin (the detection margin: the pair's margin plus its
  gap), includemargin (the pair's margin) (P,), condim (P,) int32, plus
  the geom ids g1, g2 (P,) int32."""
  g1s = [g for _, _, gl in m.collision_pairs for g, _, _ in gl]
  g2s = [g for _, _, gl in m.collision_pairs for _, g, _ in gl]
  pids = [p for _, _, gl in m.collision_pairs for _, _, p in gl]
  dev = m.device
  ivec = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
  bvec = lambda x: torch.tensor(x, dtype=torch.bool, device=dev)
  pr1 = [m.geom_priority[g] for g in g1s]
  pr2 = [m.geom_priority[g] for g in g2s]
  use1 = bvec([a > b for a, b in zip(pr1, pr2)])
  eq = bvec([a == b for a, b in zip(pr1, pr2)])

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

  condim = []
  for g1, g2, p, a, b in zip(g1s, g2s, pids, pr1, pr2):
    if p >= 0:
      condim.append(m.pair_dim[p])
    else:
      condim.append(m.geom_condim[g1] if a > b else m.geom_condim[g2]
                    if b > a else max(m.geom_condim[g1], m.geom_condim[g2]))
  if any(p >= 0 for p in pids):
    is_pair = bvec([p >= 0 for p in pids])
    pid = [max(p, 0) for p in pids]
    friction = torch.where(is_pair[:, None], m.pair_friction[pid], friction)
    solref = torch.where(is_pair[:, None], m.pair_solref[pid], solref)
    solreffriction = torch.where(is_pair[:, None],
                                 m.pair_solreffriction[pid], solreffriction)
    solimp = torch.where(is_pair[:, None], m.pair_solimp[pid], solimp)
    margin = torch.where(is_pair, m.pair_margin[pid], margin)
    gap = torch.where(is_pair, m.pair_gap[pid], gap)
  return dict(friction=friction, solref=solref,
              solreffriction=solreffriction, solimp=solimp,
              margin=margin + gap, includemargin=margin, condim=ivec(condim),
              g1=ivec(g1s), g2=ivec(g2s))


def _empty_pool(m: Model, W: int, nconmax: int) -> dict:
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


def collision(m: Model, geom_xpos: torch.Tensor, geom_xmat: torch.Tensor,
              nconmax: int) -> dict:
  """Contact pool for (W, ngeom, 3) geom_xpos and (W, ngeom, 3, 3)
  geom_xmat. Candidate contacts with dist < margin keep their candidate
  order in the pool; those past nconmax are dropped and counted in
  ncollision."""
  W = geom_xpos.shape[0]
  if not m.collision_pairs or nconmax == 0:
    return _empty_pool(m, W, nconmax)
  params = candidate_params(m)
  dists, poss, frames, reps = [], [], [], []
  start = 0
  for t1, t2, glist in m.collision_pairs:
    g1 = [g for g, _, _ in glist]
    g2 = [g for _, g, _ in glist]
    fn = collision_primitive.COLLIDERS[(t1, t2)]
    n = len(glist)
    extra = ((params['margin'][start:start + n],)
             if (t1, t2) in collision_primitive.NEEDS_MARGIN else ())
    dist, pos, frame = fn(geom_xpos[:, g1], geom_xmat[:, g1],
                          m.geom_size[g1], geom_xpos[:, g2],
                          geom_xmat[:, g2], m.geom_size[g2], *extra)
    k = MAX_CONTACTS[(t1, t2)]
    dists.append(dist.reshape(W, n * k))
    poss.append(pos.reshape(W, n * k, 3))
    frames.append(frame.reshape(W, n * k, 3, 3))
    reps.append(torch.arange(start, start + n, device=m.device
                             ).repeat_interleave(k))
    start += n
  dist = torch.cat(dists, 1)
  pos = torch.cat(poss, 1)
  frame = torch.cat(frames, 1)
  rep = torch.cat(reps)
  cand = {k: v[rep] for k, v in params.items()}

  active = dist < cand['margin']
  ncand = dist.shape[1]
  ncollision = active.sum(1, dtype=torch.int32)
  idx = torch.arange(ncand, device=m.device)
  key = torch.where(active, ncand - idx, -idx)
  sel = torch.topk(key, min(nconmax, ncand), dim=1).indices  # (W, C)
  ok = torch.gather(active, 1, sel)

  def take(vals, fill, per_world=False):
    if per_world:
      gi = sel.reshape(sel.shape + (1,) * (vals.dim() - 2))
      vals = torch.gather(vals, 1, gi.expand(sel.shape + vals.shape[2:]))
    else:                                          # per-candidate table
      vals = vals[sel]
    fill = torch.as_tensor(fill, dtype=vals.dtype, device=vals.device)
    out = torch.where(ok.reshape(ok.shape + (1,) * (vals.dim() - 2)),
                      vals, fill)
    if out.shape[1] < nconmax:
      pad = fill.expand((W, nconmax - out.shape[1]) + out.shape[2:])
      out = torch.cat([out, pad], 1)
    return out

  return dict(
      dist=take(dist, _EMPTY_DIST, True), pos=take(pos, 0.0, True),
      frame=take(frame, 0.0, True),
      includemargin=take(cand['includemargin'], 0.0),
      friction=take(cand['friction'], 1.0),
      solref=take(cand['solref'], 0.02),
      solreffriction=take(cand['solreffriction'], 0.0),
      solimp=take(cand['solimp'], 0.9), dim=take(cand['condim'], 1),
      geom=take(torch.stack([cand['g1'], cand['g2']], 1), -1),
      ncon=torch.clamp(ncollision, max=nconmax), ncollision=ncollision)
