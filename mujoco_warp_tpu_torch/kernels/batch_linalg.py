"""Kernels B7 (`tree_ldl`) and B5 (`spd_solve`): the batched linear solves
of the unfused step, in `csrc/batch_linalg.cu`.

* B7 replaces `tree_ldl_solve_batched`
  (`mujoco_warp_tpu/pallas/batch_linalg.py:314`): tree-sparse LDL of qM
  (+ a diagonal) and the solve, for `fwd_acceleration` and the Euler
  damping re-solve.
* B5 replaces `spd_solve_batched` (`pallas/batch_linalg.py:103`): dense
  Cholesky and solve of the Newton Hessian, n <= 96.

Their plain versions are `mujoco_warp_tpu_torch.batch_linalg`'s functions
of the same names, which run for CPU tensors; a CUDA tensor launches the
kernel or raises. `launches` counts each kernel's launches.
"""

from __future__ import annotations

import torch

from .. import batch_linalg as plain
from . import _build

SPD_MAXN = 96    # compile-time cap of csrc/batch_linalg.cu

launches = {'tree_ldl': 0, 'spd_solve': 0}

TreeLdlParams = _build.struct(
    'TreeLdlParams', ('a', 'b', 'diag', 'chain', 'row_of', 'row_start',
                      'depth', 'anc', 'x', 'ld'), (), ('nworld', 'nv', 'nnz'))
SpdParams = _build.struct('SpdParams', ('a', 'b', 'x', 'l'), (),
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
  if len(dof_parentid) != nv:
    raise ValueError(f'tree_ldl: {len(dof_parentid)} parents for nv={nv}')
  key = (dof_parentid, str(dev))
  if key not in _TREE_TABLES:
    _TREE_TABLES[key] = _tree_tables(dof_parentid, dev)
  t = _TREE_TABLES[key]
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
