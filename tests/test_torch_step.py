"""Whole steps of the port against the JAX package: 3 batched port steps
(plain path on the CPU) against 3 steps of jax.vmap(mujoco_warp_tpu.step),
with the tolerances of tests/test_glue_kernel.py:52-66, scale-relative;
solver_niter within 4 (the port's solve follows the glue kernel's
linesearch, not the XLA solver's). Also the benchmark harness's Halton
control noise against the JAX functions."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import forward
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch.kernels import glue as kg
from mujoco_warp_tpu_torch.kernels import smooth as ks

from torch_parity import assert_close, build, states

jbench = importlib.import_module('mujoco_warp_tpu.utils.benchmark')
tbench = importlib.import_module('mujoco_warp_tpu_torch.utils.benchmark')

STEP_TOL = (('qpos', 5e-6), ('qvel', 5e-5), ('qacc', 5e-5),
            ('qfrc_smooth', 5e-5), ('qfrc_actuator', 5e-5),
            ('qfrc_passive', 5e-5), ('actuator_force', 5e-5),
            ('qfrc_constraint', 5e-4), ('time', 0.0),
            ('actuator_length', 5e-6), ('actuator_velocity', 5e-5),
            ('actuator_moment', 0.0))


def _start(scene, nworld):
  mjm, jm, m = build(scene)
  q, v = states(mjm, nworld, nstep={'humanoid': 150,
                                     'hopper_friction': 300}[scene],
                qpos_noise=0.02)
  c = (0.3 * np.random.default_rng(1).standard_normal(
      (nworld, mjm.nu))).astype(np.float32)
  return jm, m, q, v, c


@pytest.mark.parametrize('scene', ['humanoid', 'hopper_friction'])
def test_step_matches_jax(scene):
  jm, m, q, v, c = _start(scene, 4)
  nconmax = {'humanoid': 24, 'hopper_friction': 8}[scene]
  jd = mjwt.make_data(jm, nconmax=nconmax)
  br = jax.vmap(lambda qq, vv, cc: jd.replace(qpos=qq, qvel=vv, ctrl=cc))(
      jnp.asarray(q), jnp.asarray(v), jnp.asarray(c))
  step = jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd)))
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=nconmax)
  assert forward.glue_mode(m) == {'humanoid': 0, 'hopper_friction': 1}[scene]
  for _ in range(3):
    br = step(br)
    d = mt.step_batched(m, d)
  assert int(np.asarray(br.ncon).sum()) > 0
  for name, tol in STEP_TOL:
    assert_close(getattr(d, name).numpy(), np.asarray(getattr(br, name)),
                 name, tol)
  dn = np.abs(d.solver_niter.numpy().astype(np.int64) -
              np.asarray(br.solver_niter, np.int64))
  assert dn.max() <= 4


def test_halton_and_ctrl_noise_match_jax():
  idx = np.arange(0, 200000, 97, dtype=np.int32)
  for base in (2, 3, 5, 22):
    np.testing.assert_allclose(
        tbench.halton(torch.tensor(idx), base).numpy(),
        np.asarray(jbench.halton(jnp.asarray(idx), base)), rtol=0,
        atol=1e-6)
  _, jm, m = build('humanoid')
  ctrl = np.random.default_rng(0).uniform(-1, 1, (8, m.nu)).astype(
      np.float32)
  wid = np.arange(8, dtype=np.int32)
  for step in (0, 17, 999):
    ref = jax.vmap(lambda cc, ww: jbench.ctrl_noise(jm, cc, ww, step))(
        jnp.asarray(ctrl), jnp.asarray(wid))
    out = tbench.ctrl_noise(m, torch.tensor(ctrl), torch.tensor(wid), step)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_step_stages_and_cpu_dispatch():
  _, m, q, v, c = _start('humanoid', 2)
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=24)
  names = [n for n, _ in forward.glue_stages(m, d)]
  assert names == ['smooth_mega[cuda]', 'contact_efc_mega[cuda]',
                   'act_len_vel', 'solve_glue[cuda]']
  for mod in (ks, kc, kg):
    mod.launches = 0
  # one first step, one warm-up step and one timed step
  d2, res = tbench.benchmark(m, d, nstep=1)
  assert (ks.launches, kc.launches, kg.launches) == (0, 0, 0)
  assert res['nstep'] == 1 and np.isfinite(res['steps_per_sec'])
  assert bool(torch.isfinite(d2.qpos).all())
  np.testing.assert_allclose(d2.time.numpy(), 3 * float(m.opt.timestep),
                             rtol=1e-6)
