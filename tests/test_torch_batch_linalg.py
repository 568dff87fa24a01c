"""The port's batched solves (plain versions of kernels B7 and B5,
`mujoco_warp_tpu_torch/batch_linalg.py`, and their wrappers) against the
JAX package on the CPU.

* B7 `tree_ldl_solve_batched` against the JAX kernel in interpret mode on
  humanoid and hopper qMs from C MuJoCo's mj_fullM, with and without the
  extra diagonal: x and the packed LD (ancestor entries and diagonal) at
  rtol = atol = 2e-4, as tests/test_tree_ldl.py. On three_humanoids (nv
  81, where interpret mode costs half a minute) against float64 and the
  JAX CPU dispatch `solver.m_solve_factor`.
* B5 `spd_solve_batched` at n in {5, 27, 81} against the JAX
  `solver.spd_solve` (its CPU reference) and float64, on Newton-Hessian
  shaped SPD matrices qM + Jᵀ D J.
* Without a card, the CUDA path raises instead of running a plain
  version.
"""

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import solver as jsolver
from mujoco_warp_tpu.pallas import batch_linalg as jbl
from mujoco_warp_tpu_torch import batch_linalg as bl
from mujoco_warp_tpu_torch.kernels import batch_linalg as kb

from torch_parity import build


def _qms(scene, nworld=6, seed=0):
  """(W, nv, nv) float32 mass matrices at randomized qpos, the JAX
  Model and the dof parents."""
  mjm, jm, _ = build(scene)
  mjd = mujoco.MjData(mjm)
  rng = np.random.default_rng(seed)
  qms = []
  for _ in range(nworld):
    mjd.qpos[:] = mjm.qpos0 + rng.normal(0, 0.1, mjm.nq)
    mujoco.mj_forward(mjm, mjd)
    full = np.zeros((mjm.nv, mjm.nv))
    mujoco.mj_fullM(mjm, mjd, full)
    qms.append(full)
  return (np.stack(qms).astype(np.float32), jm,
          tuple(int(p) for p in mjm.dof_parentid))


def _solve64(a, b):
  return np.linalg.solve(a.astype(np.float64),
                         b.astype(np.float64)[..., None])[..., 0]


@pytest.mark.parametrize('with_diag', [False, True])
@pytest.mark.parametrize('scene', ['hopper', 'humanoid'])
def test_tree_ldl_matches_jax_kernel(scene, with_diag):
  qm, _, parentid = _qms(scene)
  w, nv, _ = qm.shape
  rng = np.random.default_rng(1)
  b = rng.normal(0, 1, (w, nv)).astype(np.float32)
  diag = (np.abs(rng.normal(0, 0.5, nv)).astype(np.float32)
          if with_diag else None)
  # without a diagonal the JAX kernel gets zeros: its sum with them is
  # exact, and one interpret-mode compile serves both cases
  x_ref, ld_ref = jbl.tree_ldl_solve_batched(
      jnp.asarray(qm), jnp.asarray(b), parentid,
      diag=jnp.zeros(nv, jnp.float32) if diag is None else jnp.asarray(diag),
      return_factor=True, interpret=True)
  x, ld = bl.tree_ldl_solve_batched(
      torch.tensor(qm), torch.tensor(b), parentid,
      diag=None if diag is None else torch.tensor(diag), return_factor=True)
  np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=2e-4,
                             atol=2e-4)
  mask = bl.packed_mask(parentid).numpy()
  np.testing.assert_allclose(ld.numpy()[:, mask],
                             np.asarray(ld_ref)[:, mask], rtol=2e-4,
                             atol=2e-4)
  assert not ld.numpy()[:, ~mask].any()     # zeros off the packed entries
  a = qm + (np.diag(diag)[None] if with_diag else 0)
  np.testing.assert_allclose(x.numpy(), _solve64(a, b), rtol=2e-4,
                             atol=2e-4)
  # the wrapper runs the plain version for CPU tensors, launching nothing
  kb.launches.update(tree_ldl=0)
  xw = kb.tree_ldl(torch.tensor(qm), torch.tensor(b), parentid,
                   diag=None if diag is None else torch.tensor(diag))
  torch.testing.assert_close(xw, x, rtol=0, atol=0)
  assert kb.launches['tree_ldl'] == 0


def test_tree_ldl_three_humanoids():
  qm, jm, parentid = _qms('three_humanoids', nworld=4)
  w, nv, _ = qm.shape
  assert nv == 81
  rng = np.random.default_rng(3)
  b = rng.normal(0, 1, (w, nv)).astype(np.float32)
  diag = (float(jm.opt.timestep) * np.asarray(jm.dof_damping)).astype(
      np.float32)
  # the JAX CPU dispatch adds the diagonal to qM (solver.py:156-158) and
  # then factors: both systems go through it as one batch
  a = np.concatenate([qm, qm + np.diag(diag)[None]])
  x_ref, _ = jsolver.m_solve_factor(jm, jnp.asarray(a),
                                    jnp.asarray(np.concatenate([b, b])))
  x_ref = np.asarray(x_ref).reshape(2, w, nv)
  for i, d in enumerate((None, diag)):
    x = bl.tree_ldl_solve_batched(
        torch.tensor(qm), torch.tensor(b), parentid,
        diag=None if d is None else torch.tensor(d)).numpy()
    x64 = _solve64(a[i * w:(i + 1) * w], b)
    scale = np.abs(x64).max()
    np.testing.assert_allclose(x, x64, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(x, x_ref[i], rtol=0, atol=2e-5 * scale)


def _hessians(n, nworld=4, seed=0):
  """SPD a = M + Jᵀ diag(D) J of a Newton step with n dofs, and b."""
  rng = np.random.default_rng(seed)
  r = rng.normal(size=(nworld, n, n))
  M = r @ r.transpose(0, 2, 1) / n + 0.05 * np.eye(n)
  J = rng.normal(size=(nworld, 3 * n, n))
  D = rng.uniform(0, 50, (nworld, 3 * n)) * (rng.uniform(size=(
      nworld, 3 * n)) < 0.5)
  a = M + np.einsum('wjn,wj,wjk->wnk', J, D, J)
  return (a.astype(np.float32),
          rng.normal(size=(nworld, n)).astype(np.float32))


@pytest.mark.parametrize('n', [5, 27, 81])
def test_spd_solve_matches_jax(n):
  a, b = _hessians(n)
  jm = build('hopper')[1]
  x_ref = np.asarray(jsolver.spd_solve(jm, jnp.asarray(a), jnp.asarray(b)))
  x, L = bl.spd_solve_batched(torch.tensor(a), torch.tensor(b),
                              return_factor=True)
  x64 = _solve64(a, b)
  scale = np.abs(x64).max()
  np.testing.assert_allclose(x.numpy(), x64, rtol=0, atol=1e-4 * scale)
  np.testing.assert_allclose(x.numpy(), x_ref, rtol=0, atol=1e-4 * scale)
  Ln = L.numpy().astype(np.float64)
  assert not np.triu(Ln, 1).any()
  np.testing.assert_allclose(Ln @ Ln.transpose(0, 2, 1), a, rtol=0,
                             atol=2e-5 * np.abs(a).max())
  kb.launches.update(spd_solve=0)
  torch.testing.assert_close(kb.spd_solve(torch.tensor(a), torch.tensor(b)),
                             x, rtol=0, atol=0)
  assert kb.launches['spd_solve'] == 0


@pytest.mark.parametrize('kernel', ['tree_ldl', 'spd_solve'])
def test_launch_refuses_cpu_tensors(kernel):
  """The kernels have no CPU mode: their launch path raises on a CPU
  tensor and counts no launch."""
  qm, _, parentid = _qms('hopper', nworld=2)
  a, b = torch.tensor(qm), torch.zeros(qm.shape[:2])
  kb.launches.update({kernel: 0})
  with pytest.raises(ValueError, match='expected a tensor on'):
    if kernel == 'tree_ldl':
      kb._launch_tree_ldl(a, b, parentid, None, False)
    else:
      kb._launch_spd_solve(a, b, False)
  assert kb.launches[kernel] == 0


def test_cuda_path_raises_without_a_card():
  """A CUDA tensor goes to its kernel, never to the plain version: with
  no card, asking for one fails before anything is computed."""
  if torch.cuda.is_available():
    pytest.skip('a card is present: the kernel tests cover this path')
  with pytest.raises((RuntimeError, AssertionError)):
    kb.spd_solve(torch.eye(3, device='cuda')[None], torch.ones(1, 3))


def test_spd_solve_refuses_n_past_its_cap():
  with pytest.raises(ValueError, match='cap'):
    kb._launch_spd_solve(torch.zeros(1, 97, 97), torch.zeros(1, 97), False)
