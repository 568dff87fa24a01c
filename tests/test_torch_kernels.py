"""The port's kernel wrappers (B1 smooth, B2 contact, B3 glue).

On the CPU a wrapper runs its plain version and launches nothing. On the
card each kernel is held against its plain version (tests marked `cuda`,
skipped without a device). This file imports neither JAX nor `mujoco`, so
it also runs on a machine with the card and without them:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py
"""

import pytest
import torch

import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import forward, models, smooth, solver, support
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch.kernels import glue as kg
from mujoco_warp_tpu_torch.kernels import smooth as ks
from mujoco_warp_tpu_torch.utils import benchmark

NCONMAX = 24


@pytest.fixture
def cuda():
  """The CUDA device, or skip: the kernels have no CPU mode."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (kernels have no CPU mode)')
  return torch.device('cuda')


def _state(device, nworld, nstep):
  """Humanoid worlds stepped into contact through the port itself."""
  m = mt.load_model(models.HUMANOID_NPZ, device=device)
  gen = torch.Generator(device=device).manual_seed(0)
  d = mt.make_batch(m, mt.make_data(m, nconmax=NCONMAX), nworld,
                    qpos_noise=0.02, generator=gen)
  d, _ = benchmark.benchmark(m, d, nstep=nstep)
  return m, d


def _stages(m, d):
  """Inputs and outputs of the three kernels' stages for the state d."""
  sm = ks.smooth(m, d.qpos, d.qvel)
  c_in = (m, sm['qpos'], d.qvel, sm['geom_xpos'], sm['geom_xmat'],
          sm['subtree_com'], sm['cdof'], NCONMAX)
  con = kc.contact(*c_in)
  qfx = d.qfrc_applied + support.xfrc_accumulate(
      m, d.xfrc_applied, sm['xipos'], sm['subtree_com'],
      sm['cdof']) - sm['qfrc_bias']
  g_in = (m, sm['qM'], con['efc_J'], con['efc_D'], con['efc_aref'],
          con['efc_frictionloss'], sm['qpos'], d.qvel, d.ctrl, qfx,
          d.qacc_warmstart)
  return sm, c_in, con, g_in


def _close(a, b, name, tol):
  """|a - b| <= tol * max(1, max |b|), or exact for integers."""
  a, b = a.cpu(), b.cpu()
  if not b.dtype.is_floating_point:
    assert torch.equal(a, b), name
    return
  scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
  err = float((a - b).abs().max()) if b.numel() else 0.0
  assert err <= tol * scale, f'{name}: {err} > {tol} * {scale}'


def test_wrappers_run_plain_on_cpu():
  m, d = _state('cpu', 3, 10)
  for mod in (ks, kc, kg):
    mod.launches = 0
  sm, c_in, con, g_in = _stages(m, d)
  for name, ref in smooth.smooth(m, d.qpos, d.qvel).items():
    torch.testing.assert_close(sm[name], ref, rtol=0, atol=0)
  for name, ref in kc.plain(*c_in).items():
    torch.testing.assert_close(con[name], ref, rtol=0, atol=0)
  out = kg.glue(*g_in)
  for name, ref in forward.glue(*g_in).items():
    torch.testing.assert_close(out[name], ref, rtol=0, atol=0)
  assert (ks.launches, kc.launches, kg.launches) == (0, 0, 0)


def test_wrappers_refuse_models_past_their_caps():
  m, d = _state('cpu', 2, 0)
  sm = smooth.smooth(m, d.qpos, d.qvel)
  with pytest.raises(ValueError):
    kc._launch(m, sm['qpos'], d.qvel, sm['geom_xpos'], sm['geom_xmat'],
               sm['subtree_com'], sm['cdof'], kc.MAXCON + 1)


@pytest.mark.parametrize('kernel', ['smooth', 'contact', 'glue'])
def test_launch_refuses_cpu_tensors(kernel):
  """The kernels have no CPU mode: their launch path raises on a CPU
  tensor and counts no launch."""
  m, d = _state('cpu', 2, 0)
  sm, c_in, _, g_in = _stages(m, d)
  mod, args = {'smooth': (ks, (m, d.qpos, d.qvel)),
               'contact': (kc, c_in), 'glue': (kg, g_in)}[kernel]
  mod.launches = 0
  with pytest.raises(ValueError, match='expected a tensor on'):
    mod._launch(*args)
  assert mod.launches == 0


@pytest.mark.cuda
def test_smooth_kernel_matches_plain(cuda):
  m, d = _state(cuda, 256, 60)
  ks.launches = 0
  out = ks.smooth(m, d.qpos, d.qvel)
  torch.cuda.synchronize()
  assert ks.launches == 1
  for name, ref in smooth.smooth(m, d.qpos, d.qvel).items():
    _close(out[name], ref, name, 2e-5)


@pytest.mark.cuda
def test_contact_kernel_matches_plain(cuda):
  m, d = _state(cuda, 256, 60)
  _, c_in, _, _ = _stages(m, d)
  kc.launches = 0
  out = kc.contact(*c_in)
  torch.cuda.synchronize()
  assert kc.launches == 1
  ref = kc.plain(*c_in)
  assert int(ref['ncon'].sum()) > 0
  for name in ref:
    # aref = -b vel - k imp pos carries vel's rounding times b (~135)
    _close(out[name], ref[name], name, 2e-3 if name == 'efc_aref' else 2e-5)


@pytest.mark.cuda
def test_glue_kernel_matches_plain(cuda):
  # The solve fixes qacc only as far as its stopping rule (the objective
  # within tolerance * meaninertia * nv): with the same niter, one world's
  # qacc may still differ by ~5e-5 of this batch's scale, as it does 100
  # steps in. So the elementwise bounds hold at this state, and the
  # objective below is what decides in general.
  m, d = _state(cuda, 256, 60)
  _, _, _, g_in = _stages(m, d)
  kg.launches = 0
  out = kg.glue(*g_in)
  torch.cuda.synchronize()
  assert kg.launches == 1
  ref = forward.glue(*g_in)
  # the step tolerances of tests/test_glue_kernel.py:52-66
  for name in ('qacc', 'qacc_euler', 'qacc_smooth', 'qLD', 'actuator_force',
               'qfrc_actuator', 'qfrc_spring', 'qfrc_damper',
               'qfrc_passive', 'qfrc_smooth', 'qvel'):
    _close(out[name], ref[name], name, 5e-5)
  for name in ('qfrc_constraint', 'efc_force'):
    _close(out[name], ref[name], name, 5e-4)
  _close(out['qpos'], ref['qpos'], 'qpos', 5e-6)
  dn = (out['solver_niter'] - ref['solver_niter']).abs()
  assert int(dn.max()) <= 4, dn.bincount().tolist()
  # the solve is held to its objective: within one unit of the stopping
  # rule's tolerance * meaninertia * nv (see chip_smoke.py)
  f64 = [x.double() for x in g_in[1:6]]
  qfs = ref['qfrc_smooth'].double()
  qsm = solver.cho_solve(solver.cholesky(f64[0]), qfs)
  obj = lambda qa: solver.objective(*f64, qfs, qsm, qa.double(), 0, 0)
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * m.nv
  assert float((obj(out['qacc']) - obj(ref['qacc'])).abs().max()) <= unit


@pytest.mark.cuda
def test_step_batched_launches_each_kernel_once(cuda):
  m, d = _state(cuda, 256, 20)
  for mod in (ks, kc, kg):
    mod.launches = 0
  d = mt.step_batched(m, d)
  torch.cuda.synchronize()
  assert (ks.launches, kc.launches, kg.launches) == (1, 1, 1)
  assert bool(torch.isfinite(d.qpos).all())
