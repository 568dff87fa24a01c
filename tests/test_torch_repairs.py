"""Faults of the port against the reference, repaired (ROADMAP §C):

- C1: the unfused Euler step re-solved with h·dof_damping even with the
  damper disabled; C MuJoCo's mj_Euler does not, and the glue path did
  not either. Held against C MuJoCo's mj_step on both paths.
- C2: the Newton and glue gate let through row counts past kernels B3's
  and B4's cap (nj <= 256), which then raised on the card.
- C3: the harness's metrics meant other things than the JAX harness's
  under the same names (`mujoco_warp_tpu/utils/benchmark.py:269-292`).
"""

import mujoco
import numpy as np
import torch

import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import forward, models
from mujoco_warp_tpu_torch.types import SolverType
from mujoco_warp_tpu_torch.utils import benchmark

import fixtures

# a hinge pendulum with damping 50 and the damper disabled; the joint's
# limit (inactive here) gives the glue list its one efc row
DAMPER_OFF = """
<mujoco>
  <option timestep="0.01"><flag damper="disable"/></option>
  <worldbody>
    <body>
      <joint type="hinge" axis="0 1 0" damping="50" limited="true"
             range="-170 170"/>
      <geom type="capsule" size="0.05" fromto="0 0 0 0 0 -1"/>
    </body>
  </worldbody>
</mujoco>
"""
GLUE = ['smooth_mega[cuda]', 'contact_efc_mega[cuda]', 'act_len_vel',
        'solve_glue[cuda]']


def test_euler_with_the_damper_disabled_matches_c_mujoco():
  """One step from qpos 0.5, qvel 1: C MuJoCo (3.10) gives qvel
  0.93195069, the explicit h·qacc; keeping h·damping in the Euler
  re-solve would give 0.94197255. The unfused list (reached with CG) and
  the glue list (Newton) both give C MuJoCo's answer."""
  mjm = mujoco.MjModel.from_xml_string(DAMPER_OFF)
  mjd = mujoco.MjData(mjm)
  mjd.qpos[0], mjd.qvel[0] = 0.5, 1.0
  mujoco.mj_step(mjm, mjd)
  np.testing.assert_allclose(mjd.qvel[0], 0.93195069, rtol=0, atol=1e-8)
  m = mt.put_model(mjm, device='cpu')
  cg = m.replace(opt=m.opt.replace(solver=int(SolverType.CG)))
  for mm, stages in ((m, GLUE), (cg, None)):
    d = mt.data_from_numpy(mm, dict(qpos=np.array([[0.5]]),
                                    qvel=np.array([[1.0]])))
    names = [n for n, _ in forward.batched_stages(mm, d)]
    if stages is None:
      assert names[-2:] == ['solve', 'euler']
    else:
      assert names == stages
    d = mt.step_batched(mm, d)
    np.testing.assert_allclose(d.qvel.numpy()[0, 0], mjd.qvel[0], rtol=0,
                               atol=2e-7)
    np.testing.assert_allclose(d.qpos.numpy()[0, 0], mjd.qpos[0], rtol=0,
                               atol=2e-7)


def test_newton_gate_asks_for_the_kernels_row_cap():
  """The humanoid at nconmax 64 has 277 efc rows, past B3's and B4's
  cap of 256: the step takes the unfused list (B5 solves at nv 27). At
  nconmax 24 (117 rows) it keeps the glue list."""
  m = mt.load_model(models.HUMANOID_NPZ, device='cpu')
  d = mt.make_data(m, nconmax=64)
  assert d.efc_J.shape[1] == 277
  assert not forward.uses_newton_kernel(m, d)
  assert not forward.uses_glue_kernel(m, d)
  assert ([n for n, _ in forward.batched_stages(m, d)] ==
          [n for n, _ in forward.unfused_stages(m, d)])
  assert forward.forward_stages(m, d)[-1][0] == 'solve'
  d = mt.make_data(m, nconmax=24)
  assert d.efc_J.shape[1] == 117
  assert [n for n, _ in forward.batched_stages(m, d)] == GLUE
  assert forward.forward_stages(m, d)[-1][0] == 'solve[cuda]'


def test_benchmark_has_the_jax_harness_meaning():
  """Three worlds of falling spheres, one of them with NaN qpos: one
  first step, min(20, nstep) warm-up steps and max(nstep - warm-up - 1,
  1) timed ones, the noise's step index running on; converged_worlds
  counts the worlds without NaN; the means are the final state's."""
  m = mt.put_model(mujoco.MjModel.from_xml_string(fixtures.SPHERES),
                   device='cpu')
  # the NaN world never converges: it runs every iteration of each solve
  m = m.replace(opt=m.opt.replace(iterations=10))
  d0 = mt.make_data(m, nconmax=8, nworld=3)
  qpos = d0.qpos.clone()
  qpos[:, 2] += torch.tensor([-0.03, 0.0, -0.01])   # in contact
  qpos[1] = float('nan')
  d0 = d0.replace(qpos=qpos)
  h = float(m.opt.timestep)
  for nstep, timed, total in ((23, 2, 23), (3, 1, 5), (0, 1, 2)):
    assert benchmark.total_steps(nstep) == total
    d, res = benchmark.benchmark(m, d0, nstep=nstep)
    assert res['nstep'] == timed
    np.testing.assert_allclose(d.time.numpy(), total * h, rtol=1e-6)
    assert res['converged_worlds'] == 2
    assert bool(torch.isnan(d.qpos[1]).all())
    assert bool(torch.isfinite(d.qpos[[0, 2]]).all())
    assert int(d.ncon[0]) > 0
    assert res['ncon_mean'] == float(d.ncon.float().mean())
    assert res['nefc_mean'] == float(d.nefc.float().mean())
    assert res['solver_niter_mean'] == float(d.solver_niter.float().mean())
    assert res['solver_niter_max'] == int(d.solver_niter.max())
    if nstep == 3:   # the same steps as an untimed rollout
      ref = benchmark.rollout(m, d0, total)
      torch.testing.assert_close(d.qpos, ref.qpos, rtol=0, atol=0,
                                 equal_nan=True)
