"""The schedule of kernels B7 (tree_ldl) and B8 (tree_solve), and the
Euler re-solve that calls B7 without its factor.

* `kernels.batch_linalg.tree_schedule` and the packed tables the kernels
  read (`_tree_tables`) against a walk up the dof tree, on the humanoid,
  three_humanoids and a branching forest of two roots.
* The order claim the kernels' bits rest on: the schedule replayed in
  float32 torch ops (the factor's pairs step by step, Lᵀ z = b by the
  steps' entries, L x = y by depth levels) gives x and LD bit for bit
  equal to the plain `batch_linalg.tree_ldl_solve_batched`, and B8's
  sweeps the same x from that LD.
* The Euler re-solve of three_humanoids' unfused step asks B7 for x
  alone, and its step equals the step that asks for the factor, bit for
  bit.

No JAX here: the plain versions are held against the JAX package in
tests/test_torch_batch_linalg.py and tests/test_torch_factor_solves.py.
"""

import numpy as np
import pytest
import torch

import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import batch_linalg as bl
from mujoco_warp_tpu_torch import models, smooth
from mujoco_warp_tpu_torch.kernels import batch_linalg as kb

# two roots: 0 with the branches 1-3 and 4-5, 6 with 7-11
FOREST = (-1, 0, 1, 1, 0, 4, -1, 6, 6, 7, 7, 8)
TREES = dict(humanoid=models.HUMANOID_NPZ,
             three_humanoids=models.THREE_HUMANOIDS_NPZ, forest=FOREST)


def _parents(tree):
  if isinstance(TREES[tree], tuple):
    return TREES[tree]
  return mt.load_model(TREES[tree], device='cpu').dof_parentid


def _walk(parent):
  """Per dof, its ancestors from the parent up and its tree's root."""
  up = []
  for k in range(len(parent)):
    chain, i = [], parent[k]
    while i >= 0:
      chain.append(i)
      i = parent[i]
    up.append(chain)
  return up, [u[-1] if u else k for k, u in enumerate(up)]


@pytest.mark.parametrize('tree', sorted(TREES))
def test_tree_tables_match_a_tree_walk(tree):
  """Rows, steps, pairs, entries, levels and the dense map of B7's and
  B8's schedule, and their packing, from a walk up the dof tree."""
  parent = _parents(tree)
  nv = len(parent)
  up, root = _walk(parent)
  sc = kb.tree_schedule(parent)
  # packed rows: k, then its ancestors from the parent up
  slot, nnz = {}, 0
  for k in range(nv):
    assert sc['row_start'][k] == nnz
    for j in [k, *up[k]]:
      assert sc['chain'][nnz] == j and sc['src'][nnz] == k * nv + j
      slot[(k, j)] = nnz
      nnz += 1
  assert sc['nnz'] == nnz and sc['row_start'][-1] == nnz
  assert sc['pos'] == [slot.get((e // nv, e % nv), -1)
                       for e in range(nv * nv)]
  # steps: every row with ancestors once, one row a tree a step, each
  # tree's rows in descending order
  rows = [k for step in sc['steps'] for k in step]
  assert sorted(rows) == [k for k in range(nv) if up[k]]
  last = {}
  for t, step in enumerate(sc['steps']):
    assert 0 < len(step) <= kb.STEP_ROWS
    assert len({root[k] for k in step}) == len(step), t
    for k in step:
      assert last.get(root[k], (nv, -1))[0] > k
      assert last.get(root[k], (nv, -1))[1] < t
      last[root[k]] = (k, t)
  # pairs: (ancestor i, column j) of each row k, i at or below j on k's
  # chain; entries: row k's off-diagonal entries
  for step, pairs, entries in zip(sc['steps'], sc['pairs'], sc['entries']):
    want_p, want_e = [], []
    for r, k in enumerate(step):
      for ia, i in enumerate(up[k]):
        want_e.append((slot[(k, i)], r, i, k))
        want_p += [(slot[(k, i)], slot[(k, j)], slot[(i, j)], r)
                   for j in up[k][ia:]]
    assert sorted(pairs) == sorted(want_p)
    assert len(set(p[2] for p in pairs)) == len(pairs)    # distinct dst
    assert sorted(entries) == sorted(want_e)
  # depth levels
  for lv in range(len(sc['level_start']) - 1):
    got = sc['level_row'][sc['level_start'][lv]:sc['level_start'][lv + 1]]
    assert got == [k for k in range(nv) if len(up[k]) == lv], lv
  assert sc['level_start'][-1] == nv
  # the packing the kernels read
  t = kb._tree_tables(parent, 'cpu')
  assert (t['nv'], t['nnz'], t['nstep']) == (nv, nnz, len(sc['steps']))
  assert t['nlevel'] == max(len(u) for u in up) + 1
  off = t['step_off'].tolist()
  assert off[0] == [0, 0, 0] and len(off) == t['nstep'] + 1
  pair, entry = t['pair'].tolist(), t['entry'].tolist()
  for s, step in enumerate(sc['steps']):
    assert [slot[(k, k)] for k in step] == \
        t['step_row'].tolist()[off[s][0]:off[s + 1][0]]
    assert [(w0 & 0xffff, w0 >> 16, w1 & 0xffff, w1 >> 16)
            for w0, w1 in pair[off[s][1]:off[s + 1][1]]] == sc['pairs'][s]
    assert [(w0 & 0xffff, w0 >> 16, w1 & 0xffff, w1 >> 16)
            for w0, w1 in entry[off[s][2]:off[s + 1][2]]] == \
        sc['entries'][s]
  assert t['pos'].dtype == torch.int16 and t['pos'].tolist() == sc['pos']
  for key in ('src', 'row_start', 'chain', 'level_start', 'level_row'):
    assert t[key].tolist() == sc[key], key


def test_tree_tables_cap_their_shared_memory():
  """A world's packed rows and x must fit TREE_WARPS worlds a block."""
  chain = tuple(range(-1, 179))              # nv 180: 16,290 entries
  with pytest.raises(ValueError, match='cap'):
    kb._tree_tables(chain, 'cpu')
  assert kb._tree_tables(chain[:150], 'cpu')['nnz'] == 150 * 151 // 2


def _replay(qM, b, sc, diag=None):
  """x and the dense LD of (qM + diag) x = b by the schedule, in float32
  torch ops, as the kernels run it: per step the reciprocal pivots of its
  rows, its pairs, its rows' scaling; then the sweeps."""
  W, nv = b.shape
  P = qM.reshape(W, nv * nv)[:, sc['src']].clone()
  rs = torch.tensor(sc['row_start'][:-1])
  if diag is not None:
    P[:, rs] = P[:, rs] + diag
  for rows, pairs, entries in zip(sc['steps'], sc['pairs'], sc['entries']):
    diag_e = torch.tensor([sc['row_start'][k] for k in rows])
    inv = 1.0 / torch.clamp(P[:, diag_e], min=bl.MINVAL)
    a, bb, dst, slot = (torch.tensor(c) for c in zip(*pairs))
    c = P[:, a] * inv[:, slot]
    P[:, dst] = P[:, dst] - c * P[:, bb]
    e, slot = torch.tensor([q[0] for q in entries]), torch.tensor(
        [q[1] for q in entries])
    P[:, e] = P[:, e] * inv[:, slot]
  ld = torch.zeros(W, nv * nv)
  ld[:, sc['src']] = P
  return _replay_sweeps(P, b, sc), ld.reshape(W, nv, nv)


def _replay_sweeps(P, b, sc):
  x = b.clone()
  for entries in sc['entries']:             # Lᵀ z = b, step by step
    e, _, i, k = (torch.tensor(c) for c in zip(*entries))
    x[:, i] = x[:, i] - P[:, e] * x[:, k]
  x = x / torch.clamp(P[:, torch.tensor(sc['row_start'][:-1])],
                      min=bl.MINVAL)
  for lv in range(1, len(sc['level_start']) - 1):   # L x = y by levels
    k = torch.tensor(sc['level_row'][sc['level_start'][lv]:
                                     sc['level_start'][lv + 1]])
    s = torch.tensor(sc['row_start'])[k]
    v = x[:, k]
    for ia in range(1, lv + 1):
      v = v - P[:, s + ia] * x[:, torch.tensor(sc['chain'])[s + ia]]
    x[:, k] = v
  return x


def _three_humanoids(nworld, seed=0):
  m = mt.load_model(models.THREE_HUMANOIDS_NPZ, device='cpu')
  d = mt.make_batch(m, mt.make_data(m, nconmax=100), nworld,
                    qpos_noise=0.05,
                    generator=torch.Generator().manual_seed(seed))
  return m, d


@pytest.mark.parametrize('with_diag', [False, True])
def test_schedule_replays_the_plain_factor_bit_for_bit(with_diag):
  """The kernels' order, replayed on three_humanoids' qM (8 worlds):
  x and LD bit-equal to the plain version's, and B8's sweeps on that LD
  give the same x."""
  m, d = _three_humanoids(8)
  qM = smooth.smooth(m, d.qpos, d.qvel)['qM']
  rng = np.random.default_rng(3)
  b = torch.tensor(rng.normal(0, 10, (8, m.nv)), dtype=torch.float32)
  diag = m.opt.timestep * m.dof_damping if with_diag else None
  sc = kb.tree_schedule(m.dof_parentid)
  x, ld = _replay(qM, b, sc, diag)
  xr, ldr = bl.tree_ldl_solve_batched(qM, b, m.dof_parentid, diag=diag,
                                      return_factor=True)
  assert torch.equal(x, xr)
  assert torch.equal(ld, ldr)
  P = ld.reshape(8, -1)[:, sc['src']]
  assert torch.equal(_replay_sweeps(P, b, sc), xr)
  assert torch.equal(bl.tree_solve_from_factor_batched(ld, b,
                                                       m.dof_parentid), xr)


@pytest.mark.parametrize('nv', [27, 81])
def test_m_solve_is_m_solve_factor_without_the_factor(nv):
  """x of m_solve_factor without the factor (return_factor=False, the
  Euler re-solve's call) equals its x with the factor bit for bit on both
  layouts (B5 on the humanoid's nv 27, B7 on three_humanoids' nv 81)."""
  m = mt.load_model(models.HUMANOID_NPZ if nv == 27
                    else models.THREE_HUMANOIDS_NPZ, device='cpu')
  d = mt.make_batch(m, mt.make_data(m, nconmax=24), 4, qpos_noise=0.05,
                    generator=torch.Generator().manual_seed(1))
  qM = smooth.smooth(m, d.qpos, d.qvel)['qM']
  b = torch.tensor(np.random.default_rng(2).normal(0, 1, (4, nv)),
                   dtype=torch.float32)
  diag = m.opt.timestep * m.dof_damping
  kb.launches.update(dict.fromkeys(kb.launches, 0))
  for dg in (None, diag):
    x, _ = kb.m_solve_factor(qM, b, m.dof_parentid, diag=dg)
    assert torch.equal(kb.m_solve_factor(qM, b, m.dof_parentid, diag=dg,
                                         return_factor=False), x)
  assert kb.launches == dict.fromkeys(kb.launches, 0)


def test_euler_resolve_asks_for_x_alone(monkeypatch):
  """Three_humanoids' unfused step calls B7 twice: fwd_acceleration with
  the factor, the Euler re-solve without it; its qacc, qvel and qpos are
  those of the step whose re-solve writes the factor, bit for bit."""
  m, d = _three_humanoids(2, seed=4)
  d = mt.step_batched(m, d)
  asked = []
  tree_ldl = kb.tree_ldl

  def spy(*args, return_factor=False, **kw):
    asked.append(return_factor)
    return tree_ldl(*args, return_factor=return_factor, **kw)

  monkeypatch.setattr(kb, 'tree_ldl', spy)
  out = mt.step_batched(m, d)
  assert asked == [True, False]
  asked.clear()
  solve = kb.m_solve_factor

  def with_factor(*args, return_factor=True, **kw):
    x, factor = solve(*args, return_factor=True, **kw)
    return (x, factor) if return_factor else x

  monkeypatch.setattr(kb, 'm_solve_factor', with_factor)
  ref = mt.step_batched(m, d)
  assert asked == [True, True]
  assert int(ref.ncon.sum()) > 0
  for name in ('qacc', 'qvel', 'qpos', 'qacc_warmstart'):
    assert torch.equal(getattr(out, name), getattr(ref, name)), name
