"""A humanoid step of the port with the elliptic cone (impratio 10)
against the JAX package, from C MuJoCo states with contacts: the glue
list, whose solve is B3e's plain version, 2 batched steps against 2 steps
of jax.vmap(mujoco_warp_tpu.step) at STEP_TOL of tests/test_torch_step.py
(scale-relative), solver_niter within 4. The JAX step on the CPU solves
with `_solve_xla` and its iterative linesearch, the port with the TPU
kernel's linesearch, so the two part by the solver's tolerance: qacc is
2.2e-5 of scale apart after two steps, 9.1e-5 after three. Its
three_humanoids step is in tests/test_torch_step_elliptic_three.py.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import forward, solver
from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch.kernels import glue as kg
from mujoco_warp_tpu_torch.kernels import newton as kn
from mujoco_warp_tpu_torch.kernels import smooth as ks
from mujoco_warp_tpu_torch.types import ConeType

from test_torch_step import STEP_TOL
from torch_parity import SCENES, assert_close, states

ELLIPTIC = ['opt.cone=elliptic', 'opt.impratio=10']


def _reset():
  for mod in (ks, kc, kg, kn):
    mod.launches = 0
  kg.launches_ell = kn.launches_ell = 0
  kb.launches.update(dict.fromkeys(kb.launches, 0))
  solver.counts.update(dict.fromkeys(solver.counts, 0))


def _start(mjm, nworld):
  mjm.opt.cone = int(ConeType.ELLIPTIC)
  mjm.opt.impratio = 10
  q, v = states(mjm, nworld, nstep=150, qpos_noise=0.02)
  c = (0.3 * np.random.default_rng(1).standard_normal(
      (nworld, mjm.nu))).astype(np.float32)
  return q, v, c


def test_humanoid_elliptic_step_matches_jax():
  mjm = mujoco.MjModel.from_xml_string(SCENES['humanoid'])
  q, v, c = _start(mjm, 4)
  jm = mjwt.put_model(mjm)
  # the port's model is the pyramidal one with its options overridden
  m = mt.override_model(mt.put_model(
      mujoco.MjModel.from_xml_string(SCENES['humanoid']), device='cpu'),
                        ELLIPTIC)
  jd = mjwt.make_data(jm, nconmax=24)
  br = jax.vmap(lambda qq, vv, cc: jd.replace(qpos=qq, qvel=vv, ctrl=cc))(
      jnp.asarray(q), jnp.asarray(v), jnp.asarray(c))
  step = jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd)))
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v, ctrl=c), nconmax=24)
  assert [n for n, _ in forward.batched_stages(m, d)][-1] == \
      'solve_glue[cuda]'
  _reset()
  for _ in range(2):
    br = step(br)
    d = mt.step_batched(m, d)
  assert int(np.asarray(br.ncon).sum()) > 0
  for name, tol in STEP_TOL + (('qacc_warmstart', 5e-5),):
    assert_close(getattr(d, name).numpy(), np.asarray(getattr(br, name)),
                 name, tol)
  dn = np.abs(d.solver_niter.numpy().astype(np.int64) -
              np.asarray(br.solver_niter, np.int64))
  assert dn.max() <= 4
  # on the CPU the wrappers ran their plain versions
  assert (ks.launches, kc.launches, kg.launches, kg.launches_ell) == (0,) * 4
