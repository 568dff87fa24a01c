"""Kernels B7 (`tree_ldl`), B8 (`tree_solve`), B5 (`spd_solve`) and B6
(`cho_solve`): the batched linear solves of the unfused step, in
`csrc/batch_linalg.cu`.

* B7 replaces `tree_ldl_solve_batched`
  (`mujoco_warp_tpu/pallas/batch_linalg.py:314`): tree-sparse LDL of qM
  (+ a diagonal) and the solve, for `fwd_acceleration` and the Euler
  damping re-solve.
* B8 replaces `tree_solve_from_factor_batched` (:369): the solve from
  B7's packed factor LD, the CG solver's preconditioner past nv 32.
* B5 replaces `spd_solve_batched` (`pallas/batch_linalg.py:103`): dense
  Cholesky and solve of the Newton Hessian, n <= 96.
* B6 replaces `cho_solve_batched` (:177): the solve from B5's lower
  factor L, the CG solver's preconditioner up to nv 32.

`m_solve_factor` and `m_cho_solve` are the solves with the mass matrix
qM that keep a factor in Data.qLD and read it back: both ask
`uses_tree_factor` which layout qLD has, so B6 never reads an LD nor B8
an L.

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

TreeLdlParams = _build.struct(
    'TreeLdlParams', ('a', 'b', 'diag', 'chain', 'row_of', 'row_start',
                      'depth', 'anc', 'x', 'ld'), (), ('nworld', 'nv', 'nnz'))
TreeSolveParams = _build.struct(
    'TreeSolveParams', ('ld', 'b', 'chain', 'row_of', 'row_start', 'x'), (),
    ('nworld', 'nv', 'nnz'))
SpdParams = _build.struct('SpdParams', ('a', 'b', 'x', 'l'), (),
                          ('nworld', 'n'))
ChoSolveParams = _build.struct('ChoSolveParams', ('l', 'b', 'x'), (),
                               ('nworld', 'n'))


def _tree_tables(dof_parentid, device) -> dict:
  """The packed layout of B7: row k holds k, then its ancestors from the
  parent up (`chain`), at [row_start[k], row_start[k + 1])."""
  anc = plain.dof_ancestors(dof_parentid)
  chain, row_of, row_start = [], [], [0]
  for k, up in enumerate(anc):
    chain += [k, *up]
    row_of += [k] * (1 + len(up))
    row_start.append(len(chain))
  i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
  return dict(chain=i32(chain), row_of=i32(row_of), row_start=i32(row_start),
              depth=i32([len(up) for up in anc]),
              anc=plain.packed_mask(dof_parentid, device).to(torch.uint8),
              nnz=len(chain))


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
                dict(t, a=a, b=b, diag=diag, x=x, ld=ld, nworld=W, nv=nv),
                dev, entry='tree_ldl_')
  launches['tree_ldl'] += 1
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
                dict(t, ld=ld, b=b, x=x, nworld=W, nv=nv), dev,
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


def m_solve_factor(qM, b, dof_parentid, diag=None):
  """(x, factor) of (qM + diag(diag)) x = b: B7 and its packed LD, or B5
  on the dense sum and its lower L (`solver.m_solve_factor` :139)."""
  if uses_tree_factor(b.shape[1]):
    return tree_ldl(qM, b, dof_parentid, diag=diag, return_factor=True)
  a = qM if diag is None else qM + torch.diag(diag)
  return spd_solve(a, b, return_factor=True)


def m_cho_solve(factor, b, dof_parentid):
  """x from the factor `m_solve_factor` returned (`solver.m_cho_solve`
  :162): B8 on a packed LD, B6 on a lower L."""
  if uses_tree_factor(b.shape[1]):
    return tree_solve(factor, b, dof_parentid)
  return cho_solve(factor, b)
