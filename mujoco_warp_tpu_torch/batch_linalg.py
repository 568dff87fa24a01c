"""Batched linear solves of the unfused step, plain PyTorch versions of
kernels B7, B8, B5 and B6 (`kernels/batch_linalg.py`,
`csrc/batch_linalg.cu`).

* `tree_ldl_solve_batched`: qM (+ a diagonal) = Lᵀ D L over the dof tree
  and the solve, following `ldl_factor_rows` / `ldl_solve_rows`
  (`mujoco_warp_tpu/pallas/batch_linalg.py:257-291`). qM[i, j] is nonzero
  only where j is an ancestor of i, so the factor in reverse dof order
  has no fill-in.
* `spd_solve_batched`: dense Cholesky of an SPD matrix and the solve,
  following `_cholesky_solve_body` (`pallas/batch_linalg.py:62-99`).

* `tree_solve_from_factor_batched`: the solve alone from the packed
  factor LD the first returns (`ldl_solve_rows`, :276-291).
* `cho_solve_batched`: the solve alone from the lower factor L the second
  returns, following `_solve_from_factor_body` (:153-173).

All take (W, n, n) and (W, n) float32 tensors and floor their pivots at
MINVAL where the TPU kernels do.
"""

from __future__ import annotations

import torch

MINVAL = 1e-15


def dof_ancestors(dof_parentid) -> tuple:
  """Per dof, its strict ancestors from the parent up (descending
  index order), as `pallas/batch_linalg.dof_ancestors` (:244)."""
  anc = []
  for k in range(len(dof_parentid)):
    chain = []
    i = int(dof_parentid[k])
    while i >= 0:
      chain.append(i)
      i = int(dof_parentid[i])
    anc.append(tuple(chain))
  return tuple(anc)


def packed_mask(dof_parentid, device=None) -> torch.Tensor:
  """(nv, nv) bool: the entries of the packed LD factor, the diagonal
  and each row's ancestor columns."""
  nv = len(dof_parentid)
  mask = torch.eye(nv, dtype=torch.bool, device=device)
  for k, chain in enumerate(dof_ancestors(dof_parentid)):
    for i in chain:
      mask[k, i] = True
  return mask


def tree_ldl_solve_batched(a, b, dof_parentid, diag=None,
                           return_factor: bool = False):
  """Solve (a[w] + diag(diag)) x[w] = b[w] by the tree LDL of a.

  a (W, nv, nv) with the tree sparsity of dof_parentid, b (W, nv), diag
  (nv,) or None. Returns x (W, nv), and with return_factor the packed
  factor LD (W, nv, nv): L[k, i] at the ancestor columns i of row k, D[k]
  on the diagonal, zeros everywhere else (the TPU kernel leaves garbage
  in the strict upper triangle; consumers read only the packed
  entries)."""
  anc = dof_ancestors(dof_parentid)
  nv = len(anc)
  ld = a.clone()
  if diag is not None:
    ld = ld + torch.diag(diag.to(a.dtype))
  for k in range(nv - 1, -1, -1):
    if not anc[k]:
      continue
    rowk = ld[:, k].clone()                 # final: descendants are done
    inv_dk = 1.0 / torch.clamp(rowk[:, k], min=MINVAL)
    for i in anc[k]:
      c = rowk[:, i] * inv_dk
      ld[:, i] = ld[:, i] - c[:, None] * rowk
      ld[:, k, i] = c
  x = _tree_sweeps(ld, b, anc)
  if not return_factor:
    return x
  mask = packed_mask(dof_parentid, a.device)
  return x, torch.where(mask, ld, torch.zeros_like(ld))


def _tree_sweeps(ld, b, anc):
  """x of (Lᵀ D L) x = b from the packed entries of ld, in the order of
  `ldl_solve_rows`: Lᵀ z = b, y = z / max(D, MINVAL), L x = y."""
  nv = len(anc)
  xs = list(b.unbind(1))
  for k in range(nv - 1, -1, -1):           # Lᵀ z = b
    for i in anc[k]:
      xs[i] = xs[i] - ld[:, k, i] * xs[k]
  for k in range(nv):                       # y = z / D
    xs[k] = xs[k] / torch.clamp(ld[:, k, k], min=MINVAL)
  for k in range(nv):                       # L x = y
    for i in anc[k]:
      xs[k] = xs[k] - ld[:, k, i] * xs[i]
  return torch.stack(xs, 1)


def tree_solve_from_factor_batched(ld, b, dof_parentid):
  """Solve from the packed factor ld (W, nv, nv) that
  `tree_ldl_solve_batched(..., return_factor=True)` returns; only its
  packed entries are read. b (W, nv) -> x (W, nv)."""
  return _tree_sweeps(ld, b, dof_ancestors(dof_parentid))


def spd_solve_batched(a, b, return_factor: bool = False):
  """Solve a[w] x[w] = b[w] for SPD a (W, n, n) by Cholesky.

  Column j of the factor starts from row j of a (the TPU kernel's
  contiguous read; a symmetric a makes them equal) and its pivot is
  rsqrt(max(s_jj, MINVAL)). Returns x (W, n), and with return_factor the
  lower factor L (W, n, n) with zeros above the diagonal."""
  n = a.shape[-1]
  L = a.transpose(1, 2).clone()
  for j in range(n):
    inv = torch.rsqrt(torch.clamp(L[:, j, j], min=MINVAL))
    L[:, j:, j] = L[:, j:, j] * inv[:, None]
    col = L[:, j + 1:, j]
    L[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
  L = torch.tril(L)
  x = cho_solve_batched(L, b)
  return (x, L) if return_factor else x


def cho_solve_batched(l, b):
  """Solve l[w] l[w]ᵀ x[w] = b[w] from the lower factor l (W, n, n) that
  `spd_solve_batched(..., return_factor=True)` returns; its lower
  triangle is read. Both sweeps run by columns: y[j] loses l[j, k] y[k]
  for k = 0 .. j - 1 in that order, as the TPU kernel's row-oriented
  forward sweep subtracts them, and the backward sweep is its saxpy with
  row k of l."""
  n = l.shape[-1]
  y = b.clone()
  for k in range(n):                        # L y = b
    y[:, k] = y[:, k] / l[:, k, k]
    y[:, k + 1:] -= l[:, k + 1:, k] * y[:, k:k + 1]
  for k in range(n - 1, -1, -1):            # Lᵀ x = y
    y[:, k] = y[:, k] / l[:, k, k]
    y[:, :k] -= l[:, k, :k] * y[:, k:k + 1]
  return y
