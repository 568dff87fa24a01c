"""The large-scene broadphase: a per-step world-AABB test over the
admissible pairs of each type family, the top-K pairs a family by
overlap, the narrowphase on those, and the pool.

Mirrors `mujoco_warp_tpu/collision_sap.py` (`collision` :142,
`_family_slots` :108, `_run_family` :116), which the JAX package's
`collision_driver.collision` hands a model with `sap_meta` (:200).
`io._sap_precompute` sets `Model.sap_families` past
`io.SAP_THRESHOLD` admissible pairs, and then the static pair list is
empty. The JAX package runs these stages as XLA (its contact kernel
refuses such a model), so here they are torch ops on the card.

Each step, each geom's box (`geom_aabb`) becomes a world AABB, center
cw and half sizes hw widened by the geom's margin. A pair's slack is the
least over the axes of hw_a + hw_b - |cw_a - cw_b|; it overlaps where the
slack is >= 0. A family of more pairs than `family_slots` keeps that
many, most overlapping first, ties to the lower pair index (as
`jax.lax.top_k`), and counts the overlaps it drops in ncollision. The
pairs of a family are taken in chunks of at most CHUNK_ELEMENTS (world,
pair) entries, with a running top-K, so that no (nworld, pairs, 3)
tensor of a whole family is built. The sums run as the JAX package's
run on the CPU, so that the slacks are bit-equal there.

Contact parameters come from a per-pair table built once per model
(`sap_tables`), C MuJoCo's mix of `collision_driver.pair_params`: a
pair's margin and gap are the sums of the geoms', where the JAX
package's `_dyn_params` takes the larger (:83-84; ROADMAP §C, C5). The
AABB test widens each geom by its own margin, as the JAX package does.
"""

from __future__ import annotations

import torch

from . import collision_driver
from . import collision_primitive
from .io import MAX_CONTACTS
from .kernels import _build
from .types import Model

# (world, pair) entries of one chunk of the AABB test: at 8192 worlds,
# 4096 pairs, each (nworld, chunk, 3) float32 temporary 400 MB
CHUNK_ELEMENTS = 1 << 25

_LOW = 1 << 32          # a composite key's pair-index part
_INDEX_TOP = (1 << 31) - 1


def family_slots(count: int, nconmax: int) -> int:
  """Pairs a family of `count` keeps a step (`_family_slots` :108)."""
  return max(8, min(count, max(2 * nconmax, 64)))


def sap_tables(m: Model) -> dict:
  """`collision_driver.pair_params` of every row of sap_pairs, and the
  rows' geom ids as index tensors, built once per model."""
  def make(m):
    pairs = m.sap_pairs.cpu().numpy()
    params = collision_driver.pair_params(
        m, pairs[:, 0], pairs[:, 1], m.sap_pairid.cpu().numpy())
    return dict(params=params, g1=m.sap_pairs[:, 0].long(),
                g2=m.sap_pairs[:, 1].long())
  return _build.model_tables(m, 'sap', make)


def world_aabbs(m: Model, geom_xpos, geom_xmat):
  """(cw, hw) (W, ngeom, 3): each geom's box center in the world and its
  half sizes along the world axes plus the geom's margin
  (`collision` :151-154)."""
  ac, ah = m.geom_aabb[:, 0], m.geom_aabb[:, 1]
  # row i: fma(m_i2, v2, fma(m_i1, v1, m_i0 v0)), as XLA contracts the
  # JAX package's einsum on the CPU (addcmul is a fused multiply-add on
  # the CPU)
  mv = lambda mat, v: torch.addcmul(torch.addcmul(
      mat[..., 0] * v[:, None, 0], mat[..., 1], v[:, None, 1]),
      mat[..., 2], v[:, None, 2])
  cw = geom_xpos + mv(geom_xmat, ac)
  hw = mv(torch.abs(geom_xmat), ah) + m.geom_margin[:, None]
  return cw, hw


def _sortable(x):
  """float32 -> int64 of the same order (-0.0 below +0.0)."""
  bits = x.view(torch.int32)
  return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()


def slack(cw, hw, g1, g2):
  """(W, P) each pair's least overlap over the axes, hw_a + hw_b - |cw_a -
  cw_b| (`collision` :160-163); g1, g2 (P,) long geom ids."""
  return torch.amin((hw[:, g1] + hw[:, g2]) - torch.abs(cw[:, g1] -
                                                        cw[:, g2]), -1)


def cull(cw, hw, g1, g2, kk: int):
  """The family's kk pairs of greatest slack, ties to the lower pair
  index: (sel (W, kk) long pair rows, most overlapping first; valid (W,
  kk) bool, the pair overlaps; noverlap (W,) int32 its overlapping
  pairs). g1, g2 (P,) long the family's geom ids."""
  W, P = cw.shape[0], g1.shape[0]
  chunk = max(kk, CHUNK_ELEMENTS // W)
  best = None
  noverlap = torch.zeros(W, dtype=torch.int32, device=cw.device)
  for s in range(0, P, chunk):
    a, b = g1[s:s + chunk], g2[s:s + chunk]
    sl = slack(cw, hw, a, b)
    mask = sl >= 0
    noverlap += mask.sum(1, dtype=torch.int32)
    key = torch.where(mask, sl, float('-inf'))
    rows = torch.arange(s, s + a.shape[0], device=cw.device)
    # the slack's order first, then the lower row: every key distinct
    comp = _sortable(key) * _LOW + (_INDEX_TOP - rows)
    if best is not None:
      comp = torch.cat([best, comp], 1)
    best = torch.topk(comp, kk, dim=1).values
  sel = _INDEX_TOP - (best & (_LOW - 1))
  valid = (best >> 32) > _sortable(cw.new_full((), float('-inf')))
  return sel, valid, noverlap


def _pick(x, g):
  """x[w, g[w, k]] of per-world x (W, n, ...) at the per-world ids g."""
  return torch.gather(x, 1, g.reshape(g.shape + (1,) * (x.dim() - 2)).expand(
      g.shape + x.shape[2:]))


def collision(m: Model, geom_xpos: torch.Tensor, geom_xmat: torch.Tensor,
              nconmax: int) -> dict:
  """Contact pool of (W, ngeom, 3) geom_xpos and (W, ngeom, 3, 3)
  geom_xmat over sap_pairs (`collision` :142; the pool as
  `collision_driver.pool`, the dropped overlaps in ncollision)."""
  W = geom_xpos.shape[0]
  if nconmax == 0:
    return collision_driver.empty_pool(m, W, nconmax)
  tables = sap_tables(m)
  params = tables['params']
  cw, hw = world_aabbs(m, geom_xpos, geom_xmat)
  dropped = torch.zeros(W, dtype=torch.int32, device=geom_xpos.device)
  dists, poss, frames, cands = [], [], [], []
  for t1, t2, start, count in m.sap_families:
    g1, g2 = (tables[k][start:start + count] for k in ('g1', 'g2'))
    kk = family_slots(count, nconmax)
    if kk < count:
      sel, valid, noverlap = cull(cw, hw, g1, g2, kk)
      dropped += torch.clamp(noverlap - kk, min=0)
    else:
      sel = torch.arange(count, device=cw.device).expand(W, count)
      valid = slack(cw, hw, g1, g2) >= 0
    rows = start + sel                                   # (W, kk)
    cand = {k: v[rows] for k, v in params.items()}
    ga, gb = cand['g1'].long(), cand['g2'].long()
    extra = ((cand['margin'],)
             if (t1, t2) in collision_primitive.NEEDS_MARGIN else ())
    dist, pos, frame = collision_primitive.COLLIDERS[(t1, t2)](
        _pick(geom_xpos, ga), _pick(geom_xmat, ga), m.geom_size[ga],
        _pick(geom_xpos, gb), _pick(geom_xmat, gb), m.geom_size[gb], *extra)
    k = MAX_CONTACTS[(t1, t2)]
    n = sel.shape[1]
    dists.append(torch.where(valid[..., None], dist,
                             collision_driver._EMPTY_DIST).reshape(W, n * k))
    poss.append(pos.reshape(W, n * k, 3))
    frames.append(frame.reshape(W, n * k, 3, 3))
    cands.append({key: v.repeat_interleave(k, dim=1)
                  for key, v in cand.items()})
  cand = {key: torch.cat([c[key] for c in cands], 1) for key in cands[0]}
  return collision_driver.pool(torch.cat(dists, 1), torch.cat(poss, 1),
                               torch.cat(frames, 1), cand, nconmax, dropped)
