"""Kernels B7 (`tree_ldl`), B8 (`tree_solve`), B5 (`spd_solve`) and B6
(`cho_solve`): the batched linear solves of the unfused step, in
`csrc/batch_linalg.cu`.

* B7 replaces `tree_ldl_solve_batched`
  (`mujoco_warp_tpu/pallas/batch_linalg.py:314`): tree-sparse LDL of qM
  (+ a diagonal) and the solve, for `fwd_acceleration` (with the factor)
  and the Euler damping re-solve (without). Its schedule, and B8's, is
  `tree_schedule`, read by the kernels from tables at run time.
* B8 replaces `tree_solve_from_factor_batched` (:369): the solve from
  B7's packed factor LD, the CG solver's preconditioner past nv 32.
* B5 replaces `spd_solve_batched` (`pallas/batch_linalg.py:103`): dense
  Cholesky and solve of the Newton Hessian, n <= 96.
* B6 replaces `cho_solve_batched` (:177): the solve from B5's lower
  factor L, the CG solver's preconditioner up to nv 32.

`m_solve_factor` and `m_cho_solve` are the solves with the mass matrix
qM that keep a factor in Data.qLD and read it back: both ask
`uses_tree_factor` which layout qLD has, so B6 never reads an LD nor B8
an L. `m_solve_factor(..., return_factor=False)` solves for x alone and
writes no factor.

Their plain versions are `mujoco_warp_tpu_torch.batch_linalg`'s functions
of the same names, which run for CPU tensors; a CUDA tensor launches the
kernel or raises. `launches` counts each kernel's launches.
"""

from __future__ import annotations

import torch

from .. import batch_linalg as plain
from . import _build

SPD_MAXN = 96    # compile-time cap of csrc/batch_linalg.cu

launches = {'tree_ldl': 0, 'spd_solve': 0, 'cho_solve': 0, 'tree_solve': 0}
# B7's launches without the factor (the Euler re-solve's), also
# counted in launches['tree_ldl']
launches_no_factor = 0

# B7's and B8's schedule (tree_schedule), one struct for both kernels
TreeTables = _build.struct(
    'TreeTables', ('src', 'row_start', 'chain', 'step_off', 'step_row',
                   'pair', 'entry', 'level_start', 'level_row', 'pos'), (),
    ('nv', 'nnz', 'nstep', 'nlevel'))
TreeLdlParams = _build.struct('TreeLdlParams', ('a', 'b', 'diag', 'x', 'ld'),
                              (), ('nworld',), base=TreeTables)
TreeSolveParams = _build.struct('TreeSolveParams', ('ld', 'b', 'x'), (),
                                ('nworld',), base=TreeTables)
SpdParams = _build.struct('SpdParams', ('a', 'b', 'x', 'l'), (),
                          ('nworld', 'n'))
ChoSolveParams = _build.struct('ChoSolveParams', ('l', 'b', 'x'), (),
                               ('nworld', 'n'))

# B7 and B8 run TREE_WARPS worlds a block (TREE_WARPS of
# csrc/batch_linalg.cu), each world's packed rows and x in shared memory:
# at most TREE_MAXWORDS words a world within the H100's 227 KB a block
# (cudaDevAttrMaxSharedMemoryPerBlockOptin), which also keeps the tables'
# 16-bit entry indices in range
TREE_WARPS = 4
TREE_MAXWORDS = 232448 // (4 * TREE_WARPS)
# rows of one step of the factor: lane r holds step row r's reciprocal
# pivot, which the kernel reads by __shfl_sync from lane `slot`, so a step
# has at most the warp's 32 rows
STEP_ROWS = 32
assert STEP_ROWS == 32, 'the kernel shuffles a step row\'s pivot in a warp'


def tree_schedule(dof_parentid) -> dict:
  """B7's and B8's schedule for a dof tree, as lists.

  Packed layout: row k holds k, then its ancestors from the parent up
  (`chain`), at [row_start[k], row_start[k + 1]); entry e of a world is
  a[src[e]] of its (nv, nv) matrix.

  Factor: the rows with ancestors in reverse order, each tree's rows one
  step after another and the rows of different trees side by side (no
  two share an entry), at most STEP_ROWS a step: `steps`, lists of rows.
  Per step, `pairs` (a, b, dst, slot): one multiply-add of the row in
  slot `slot`, P[dst] -= (P[a] / D) P[b], for each pair ia <= jb of its
  ancestors' positions (a = s + ia, b = s + jb, dst = row_start[i] + jb -
  ia for the ancestor i at ia, whose own chain is the rest of row k's);
  `entries` (e, slot, i, k): the row's off-diagonal entries e, column i,
  which the factor scales by 1 / D and the sweep Lᵀ z = b reads.

  Sweep L x = y: the rows by depth (`level_row`, level d at
  [level_start[d], level_start[d + 1])); a row of depth d has d
  ancestors, all of lower depth. `pos[k * nv + j]` is the packed entry of
  (k, j), -1 off the pattern, for the dense LD."""
  anc = plain.dof_ancestors(dof_parentid)
  nv = len(anc)
  chain, row_start = [], [0]
  for k, up in enumerate(anc):
    chain += [k, *up]
    row_start.append(len(chain))
  src = [k * nv + j for k, up in enumerate(anc) for j in (k, *up)]
  pos = [-1] * (nv * nv)
  for e, s in enumerate(src):
    pos[s] = e
  steps, tree_next = [], {}
  for k in range(nv - 1, -1, -1):
    if not anc[k]:
      continue
    root = anc[k][-1]
    t = tree_next.get(root, 0)
    while t < len(steps) and len(steps[t]) == STEP_ROWS:
      t += 1
    if t == len(steps):
      steps.append([])
    steps[t].append(k)
    tree_next[root] = t + 1
  pairs, entries = [], []
  for rows in steps:
    pairs.append([])
    entries.append([])
    for slot, k in enumerate(rows):
      s, n = row_start[k], row_start[k + 1] - row_start[k]
      for ia in range(1, n):
        i = chain[s + ia]
        entries[-1].append((s + ia, slot, i, k))
        pairs[-1] += [(s + ia, s + jb, row_start[i] + jb - ia, slot)
                      for jb in range(ia, n)]
  depth = [len(up) for up in anc]
  nlevel = max(depth) + 1
  level_row = sorted(range(nv), key=lambda k: (depth[k], k))
  level_start = [sum(d < lv for d in depth) for lv in range(nlevel + 1)]
  return dict(nv=nv, nnz=len(chain), chain=chain, row_start=row_start,
              src=src, pos=pos, steps=steps, pairs=pairs, entries=entries,
              level_row=level_row, level_start=level_start)


def _tree_tables(dof_parentid, device) -> dict:
  """tree_schedule as the kernels read it (TreeTables): per step its
  first row, pair and entry (`step_off`, (nstep + 1, 3)), each row by its
  diagonal entry (`step_row`), a pair as two words (a | b << 16, dst |
  slot << 16) and an entry as (e | slot << 16, i | k << 16)."""
  words = sum(2 + len(up) for up in plain.dof_ancestors(dof_parentid))
  if words > TREE_MAXWORDS:
    raise ValueError(f'tree_ldl kernel: {words} words a world (cap '
                     f'{TREE_MAXWORDS})')
  sc = tree_schedule(dof_parentid)
  off, step_row, pair, entry = [[0, 0, 0]], [], [], []
  for rows, prs, ents in zip(sc['steps'], sc['pairs'], sc['entries']):
    step_row += [sc['row_start'][k] for k in rows]
    pair += [(a | b << 16, dst | slot << 16) for a, b, dst, slot in prs]
    entry += [(e | slot << 16, i | k << 16) for e, slot, i, k in ents]
    off.append([len(step_row), len(pair), len(entry)])
  i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
  return dict(src=i32(sc['src']), row_start=i32(sc['row_start']),
              chain=i32(sc['chain']), step_off=i32(off),
              step_row=i32(step_row), pair=i32(pair), entry=i32(entry),
              level_start=i32(sc['level_start']),
              level_row=i32(sc['level_row']),
              pos=torch.tensor(sc['pos'], dtype=torch.int16, device=device),
              nv=sc['nv'], nnz=sc['nnz'],
              nstep=len(sc['steps']), nlevel=len(sc['level_start']) - 1)


_TREE_TABLES: dict = {}


def _cached_tree_tables(dof_parentid: tuple, nv: int, device) -> dict:
  """B7's and B8's tables for this tree on this device, built once."""
  if len(dof_parentid) != nv:
    raise ValueError(f'{len(dof_parentid)} dof parents for nv={nv}')
  key = (dof_parentid, str(device))
  if key not in _TREE_TABLES:
    _TREE_TABLES[key] = _tree_tables(dof_parentid, device)
  return _TREE_TABLES[key]


def tree_ldl(a, b, dof_parentid, diag=None, return_factor: bool = False):
  """x (and the packed LD with return_factor) of (a + diag(diag)) x = b,
  as `batch_linalg.tree_ldl_solve_batched`."""
  if a.device.type == 'cpu':
    return plain.tree_ldl_solve_batched(a, b, dof_parentid, diag=diag,
                                        return_factor=return_factor)
  return _launch_tree_ldl(a, b, tuple(dof_parentid), diag, return_factor)


def _launch_tree_ldl(a, b, dof_parentid, diag, return_factor):
  global launches_no_factor
  W, nv = b.shape
  dev = a.device
  _build.check('a', a, (W, nv, nv), device=dev)
  _build.check('b', b, (W, nv), device=dev)
  if diag is not None:
    _build.check('diag', diag, (nv,), device=dev)
  t = _cached_tree_tables(dof_parentid, nv, dev)
  x = torch.empty((W, nv), dtype=torch.float32, device=dev)
  ld = (torch.empty((W, nv, nv), dtype=torch.float32, device=dev)
        if return_factor else None)
  _build.launch('batch_linalg', TreeLdlParams,
                dict(t, a=a, b=b, diag=diag, x=x, ld=ld, nworld=W), dev,
                entry='tree_ldl_')
  launches['tree_ldl'] += 1
  if not return_factor:
    launches_no_factor += 1
  return (x, ld) if return_factor else x


def spd_solve(a, b, return_factor: bool = False):
  """x (and the lower factor L with return_factor) of a x = b, as
  `batch_linalg.spd_solve_batched`."""
  if a.device.type == 'cpu':
    return plain.spd_solve_batched(a, b, return_factor=return_factor)
  return _launch_spd_solve(a, b, return_factor)


def _launch_spd_solve(a, b, return_factor):
  W, n = b.shape
  if n > SPD_MAXN:
    raise ValueError(f'spd_solve kernel: n={n} (cap {SPD_MAXN})')
  dev = a.device
  _build.check('a', a, (W, n, n), device=dev)
  _build.check('b', b, (W, n), device=dev)
  x = torch.empty((W, n), dtype=torch.float32, device=dev)
  l = (torch.empty((W, n, n), dtype=torch.float32, device=dev)
       if return_factor else None)
  _build.launch('batch_linalg', SpdParams,
                dict(a=a, b=b, x=x, l=l, nworld=W, n=n), dev,
                entry='spd_solve_')
  launches['spd_solve'] += 1
  return (x, l) if return_factor else x


def tree_solve(ld, b, dof_parentid):
  """x of (Lᵀ D L) x = b from B7's packed factor ld, as
  `batch_linalg.tree_solve_from_factor_batched`."""
  if ld.device.type == 'cpu':
    return plain.tree_solve_from_factor_batched(ld, b, dof_parentid)
  return _launch_tree_solve(ld, b, tuple(dof_parentid))


def _launch_tree_solve(ld, b, dof_parentid):
  W, nv = b.shape
  dev = ld.device
  _build.check('ld', ld, (W, nv, nv), device=dev)
  _build.check('b', b, (W, nv), device=dev)
  t = _cached_tree_tables(dof_parentid, nv, dev)
  x = torch.empty((W, nv), dtype=torch.float32, device=dev)
  _build.launch('batch_linalg', TreeSolveParams,
                dict(t, ld=ld, b=b, x=x, nworld=W), dev,
                entry='tree_solve_')
  launches['tree_solve'] += 1
  return x


def cho_solve(l, b):
  """x of l lᵀ x = b from B5's lower factor l, as
  `batch_linalg.cho_solve_batched`."""
  if l.device.type == 'cpu':
    return plain.cho_solve_batched(l, b)
  return _launch_cho_solve(l, b)


def _launch_cho_solve(l, b):
  W, n = b.shape
  if n > SPD_MAXN:
    raise ValueError(f'cho_solve kernel: n={n} (cap {SPD_MAXN})')
  dev = l.device
  _build.check('l', l, (W, n, n), device=dev)
  _build.check('b', b, (W, n), device=dev)
  x = torch.empty((W, n), dtype=torch.float32, device=dev)
  _build.launch('batch_linalg', ChoSolveParams,
                dict(l=l, b=b, x=x, nworld=W, n=n), dev, entry='cho_solve_')
  launches['cho_solve'] += 1
  return x


def uses_tree_factor(nv: int) -> bool:
  """The layout of Data.qLD on the unfused step: B7's packed tree LD past
  nv 32, B5's lower Cholesky factor up to it, as the JAX package's
  `solver._tree_ldl_ok` (`mujoco_warp_tpu/solver.py:67`) decides for
  `m_solve_factor` and `m_cho_solve` alike."""
  return nv > 32


def m_solve_factor(qM, b, dof_parentid, diag=None,
                   return_factor: bool = True):
  """(x, factor) of (qM + diag(diag)) x = b: B7 and its packed LD, or B5
  on the dense sum and its lower L (`solver.m_solve_factor` :139). With
  return_factor=False x alone, no factor written, for a caller that keeps
  none (the Euler re-solve); x does not depend on it."""
  if uses_tree_factor(b.shape[1]):
    return tree_ldl(qM, b, dof_parentid, diag=diag,
                    return_factor=return_factor)
  a = qM if diag is None else qM + torch.diag(diag)
  return spd_solve(a, b, return_factor=return_factor)


def m_cho_solve(factor, b, dof_parentid):
  """x from the factor `m_solve_factor` returned (`solver.m_cho_solve`
  :162): B8 on a packed LD, B6 on a lower L."""
  if uses_tree_factor(b.shape[1]):
    return tree_solve(factor, b, dof_parentid)
  return cho_solve(factor, b)
