"""The port's solves from a factor (plain versions of kernels B6 and B8,
`mujoco_warp_tpu_torch/batch_linalg.py`, and their wrappers) against the
JAX package on the CPU.

* B6 `cho_solve_batched` against the TPU kernel `cho_solve_batched` run in
  interpret mode (the function takes no `interpret` argument, so the test
  passes it to `pallas_call` for the call) and against the JAX CPU
  dispatch `solver.cho_solve`, on the lower factor of Newton-Hessian
  shaped SPD matrices, at 2e-5 of scale.
* B8 `tree_solve_from_factor_batched` against the TPU kernel
  `tree_solve_from_factor_batched(..., interpret=True)` (as
  tests/test_tree_ldl.py) on the packed LD of hopper and humanoid mass
  matrices at 2e-5 of scale; on three_humanoids (nv 81) against float64.
  B8's x equals B7's own x for the same right-hand side exactly: both run
  the same sweeps on the same factor.
* `m_solve_factor` / `m_cho_solve` pick B5 + B6 up to nv 32 and B7 + B8
  above it, by one function.
* Without a card, the launch paths raise instead of running a plain
  version, and count nothing.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import solver as jsolver
from mujoco_warp_tpu.pallas import batch_linalg as jbl
from mujoco_warp_tpu_torch import batch_linalg as bl
from mujoco_warp_tpu_torch.kernels import batch_linalg as kb

from test_torch_batch_linalg import _hessians, _qms, _solve64
from torch_parity import build

TOL = 2e-5


def _close(a, b, scale, tol=TOL):
  np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                             atol=tol * scale)


@pytest.mark.parametrize('n', [5, 27])
def test_cho_solve_matches_jax_kernel(n, monkeypatch):
  a, b = _hessians(n, nworld=6)
  _, L = bl.spd_solve_batched(torch.tensor(a), torch.tensor(b),
                              return_factor=True)
  x = bl.cho_solve_batched(L, torch.tensor(b))
  x64 = _solve64(a, b)
  scale = np.abs(x64).max()
  monkeypatch.setattr(jbl.pl, 'pallas_call', functools.partial(
      jbl.pl.pallas_call, interpret=True))
  x_kernel = jbl.cho_solve_batched(jnp.asarray(L.numpy()), jnp.asarray(b))
  x_cpu = jsolver.cho_solve(build('hopper')[1], jnp.asarray(L.numpy()),
                            jnp.asarray(b))
  _close(x.numpy(), x_kernel, scale)
  _close(x.numpy(), x_cpu, scale)
  _close(x.numpy(), x64, scale, 1e-4)       # the factor's own float32 error
  # the same sweeps as the factoring solve: B5's x for the same b
  torch.testing.assert_close(
      x, bl.spd_solve_batched(torch.tensor(a), torch.tensor(b)), rtol=0,
      atol=0)
  # only the lower triangle is read
  junk = L + torch.triu(torch.full_like(L, 7.0), 1)
  torch.testing.assert_close(bl.cho_solve_batched(junk, torch.tensor(b)), x,
                             rtol=0, atol=0)
  kb.launches.update(cho_solve=0)
  torch.testing.assert_close(kb.cho_solve(L, torch.tensor(b)), x, rtol=0,
                             atol=0)
  assert kb.launches['cho_solve'] == 0


@pytest.mark.parametrize('scene', ['hopper', 'humanoid'])
def test_tree_solve_matches_jax_kernel(scene):
  qm, _, parentid = _qms(scene)
  w, nv, _ = qm.shape
  rng = np.random.default_rng(4)
  b0 = rng.normal(0, 1, (w, nv)).astype(np.float32)
  b = rng.normal(0, 1, (w, nv)).astype(np.float32)
  _, ld = bl.tree_ldl_solve_batched(torch.tensor(qm), torch.tensor(b0),
                                    parentid, return_factor=True)
  x = bl.tree_solve_from_factor_batched(ld, torch.tensor(b), parentid)
  x64 = _solve64(qm, b)
  scale = np.abs(x64).max()
  x_kernel = jbl.tree_solve_from_factor_batched(
      jnp.asarray(ld.numpy()), jnp.asarray(b), parentid, interpret=True)
  _close(x.numpy(), x_kernel, scale)
  _close(x.numpy(), x64, scale, 2e-4)
  torch.testing.assert_close(
      x, bl.tree_ldl_solve_batched(torch.tensor(qm), torch.tensor(b),
                                   parentid), rtol=0, atol=0)
  # only the packed entries are read: the TPU kernel's LD carries garbage
  # above the diagonal
  junk = torch.where(bl.packed_mask(parentid), ld, torch.full_like(ld, 7.0))
  torch.testing.assert_close(
      bl.tree_solve_from_factor_batched(junk, torch.tensor(b), parentid), x,
      rtol=0, atol=0)
  kb.launches.update(tree_solve=0)
  torch.testing.assert_close(kb.tree_solve(ld, torch.tensor(b), parentid), x,
                             rtol=0, atol=0)
  assert kb.launches['tree_solve'] == 0


def test_tree_solve_three_humanoids():
  qm, jm, parentid = _qms('three_humanoids', nworld=4)
  w, nv, _ = qm.shape
  assert nv == 81
  b = np.random.default_rng(5).normal(0, 1, (w, nv)).astype(np.float32)
  x7, ld = bl.tree_ldl_solve_batched(torch.tensor(qm), torch.tensor(b),
                                     parentid, return_factor=True)
  x = bl.tree_solve_from_factor_batched(ld, torch.tensor(b), parentid)
  torch.testing.assert_close(x, x7, rtol=0, atol=0)
  x64 = _solve64(qm, b)
  _close(x.numpy(), x64, np.abs(x64).max())
  # the JAX package's CPU dispatch of the same solve from its own factor
  _, fac = jsolver.m_solve_factor(jm, jnp.asarray(qm), jnp.asarray(b))
  _close(x.numpy(), jsolver.m_cho_solve(jm, fac, jnp.asarray(b)),
         np.abs(x64).max())


def test_m_solve_factor_and_m_cho_solve_agree_on_the_layout():
  assert not kb.uses_tree_factor(27) and not kb.uses_tree_factor(32)
  assert kb.uses_tree_factor(33) and kb.uses_tree_factor(81)
  for scene, tree in (('humanoid', False), ('three_humanoids', True)):
    qm, _, parentid = _qms(scene, nworld=2)
    w, nv, _ = qm.shape
    rng = np.random.default_rng(6)
    b = torch.tensor(rng.normal(0, 1, (w, nv)).astype(np.float32))
    diag = torch.tensor(np.abs(rng.normal(0, 0.5, nv)).astype(np.float32))
    for dg in (None, diag):
      a = qm + (np.diag(dg.numpy())[None] if dg is not None else 0)
      x, fac = kb.m_solve_factor(torch.tensor(qm), b, parentid, diag=dg)
      x64 = _solve64(a, b.numpy())
      _close(x.numpy(), x64, np.abs(x64).max())
      mask = bl.packed_mask(parentid).numpy()
      if tree:       # packed LD: unit-lower L off the diagonal, D on it
        assert not fac.numpy()[:, ~mask].any()
      else:          # lower Cholesky factor
        Ln = fac.double().numpy()
        assert not np.triu(Ln, 1).any()
        _close(Ln @ Ln.transpose(0, 2, 1), a, np.abs(a).max(), 2e-6)
      b2 = torch.tensor(rng.normal(0, 1, (w, nv)).astype(np.float32))
      x2 = kb.m_cho_solve(fac, b2, parentid)
      x2_64 = _solve64(a, b2.numpy())
      _close(x2.numpy(), x2_64, np.abs(x2_64).max())


@pytest.mark.parametrize('kernel', ['cho_solve', 'tree_solve'])
def test_launch_refuses_cpu_tensors(kernel):
  """The kernels have no CPU mode: their launch path raises on a CPU
  tensor and counts no launch."""
  qm, _, parentid = _qms('hopper', nworld=2)
  a, b = torch.tensor(qm), torch.zeros(qm.shape[:2])
  kb.launches.update({kernel: 0})
  with pytest.raises(ValueError, match='expected a tensor on'):
    if kernel == 'tree_solve':
      kb._launch_tree_solve(a, b, parentid)
    else:
      kb._launch_cho_solve(a, b)
  assert kb.launches[kernel] == 0


def test_cuda_path_raises_without_a_card():
  """A CUDA tensor goes to its kernel, never to the plain version: with
  no card, asking for one fails before anything is computed."""
  if torch.cuda.is_available():
    pytest.skip('a card is present: the kernel tests cover this path')
  with pytest.raises((RuntimeError, AssertionError)):
    kb.cho_solve(torch.eye(3, device='cuda')[None], torch.ones(1, 3))


def test_caps_and_tables():
  with pytest.raises(ValueError, match='cap'):
    kb._launch_cho_solve(torch.zeros(1, 97, 97), torch.zeros(1, 97))
  with pytest.raises(ValueError, match='dof parents'):
    kb._cached_tree_tables((-1, 0), 3, 'cpu')
  # B7 and B8 share one table cache
  parentid = (-1, 0, 1, 0)
  t = kb._cached_tree_tables(parentid, 4, 'cpu')
  assert kb._cached_tree_tables(parentid, 4, 'cpu') is t
  assert t['nnz'] == 4 + 0 + 1 + 2 + 1
