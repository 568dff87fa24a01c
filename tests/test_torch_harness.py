"""The port's benchmark harness and io functions against the JAX
package's, on the CPU: the control noise with a device step index,
STATE_FIELDS (the Data fields a step reads, which a replayed CUDA graph
copies back), the replay predicate on the paths of PERF.md §4, the
keyframe fields, and reset_data, reset_data_masked, find_keys,
make_trajectory and benchmark_replay on an inline keyframed MJCF at 5e-5
(tests/fixtures.py:140), scale-relative."""

import importlib

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu import io as jio
from mujoco_warp_tpu import parallel as jparallel
from mujoco_warp_tpu_torch import forward, io, models
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch.kernels import glue as kg
from mujoco_warp_tpu_torch.kernels import newton as kn
from mujoco_warp_tpu_torch.kernels import smooth as ks
from mujoco_warp_tpu_torch.types import (CONTACT_TENSORS, DATA_TENSORS,
                                         IntegratorType, SolverType)

from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import KEYED, assert_close, build, build_sap, states

jbench = importlib.import_module('mujoco_warp_tpu.utils.benchmark')
tbench = importlib.import_module('mujoco_warp_tpu_torch.utils.benchmark')

TOL = 5e-5


@pytest.fixture(scope='module')
def keyed():
  mjm = mujoco.MjModel.from_xml_string(KEYED)
  return mjm, mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')


def test_ctrl_noise_with_a_device_step_matches_int_and_jax():
  _, jm, m = build('humanoid')
  ctrl = torch.tensor(np.random.default_rng(0).uniform(-1, 1, (8, m.nu)),
                      dtype=torch.float32)
  wid = torch.arange(8, dtype=torch.int32)
  for step in (0, 1, 17, 999, 1 << 20):
    by_int = tbench.ctrl_noise(m, ctrl, wid, step)
    by_tensor = tbench.ctrl_noise(m, ctrl, wid,
                                  torch.tensor(step, dtype=torch.int32))
    assert torch.equal(by_int, by_tensor), step
    ref = jax.vmap(lambda cc, ww: jbench.ctrl_noise(jm, cc, ww, step))(
        jnp.asarray(ctrl.numpy()), jnp.asarray(wid.numpy()))
    np.testing.assert_allclose(by_tensor.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def _poison(d):
  """d with every field outside STATE_FIELDS filled with garbage: NaN,
  a far integer, or the bool's negation."""
  def bad(t):
    if t.is_floating_point():
      return torch.full_like(t, float('nan'))
    if t.dtype == torch.bool:
      return ~t
    return torch.full_like(t, -123457)
  contact = d.contact.replace(**{k: bad(getattr(d.contact, k))
                                 for k in CONTACT_TENSORS})
  return d.replace(contact=contact, **{
      k: bad(getattr(d, k)) for k in DATA_TENSORS
      if k not in tbench.STATE_FIELDS})


def _path_model(scene, variant):
  if scene == 'aloha_sdf':
    # the voxel grids from the .npz: voxelizing them takes minutes
    return io.load_model(models.ALOHA_SDF_NPZ, device='cpu')
  if scene == 'kitchen':
    return io.load_model(models.KITCHEN_NPZ, device='cpu')
  _, _, m = build_sap() if scene == 'sap_grid' else build(scene)
  if variant == 'rk4':
    m = m.replace(opt=m.opt.replace(integrator=int(IntegratorType.RK4)))
  elif variant == 'cg':
    m = m.replace(opt=m.opt.replace(solver=int(SolverType.CG)))
  elif variant == 'elliptic':
    m = mt.override_model(m, ['opt.cone=elliptic', 'opt.impratio=10'])
  elif variant in ('implicitfast', 'implicitfast_cg'):
    m = m.replace(opt=m.opt.replace(
        integrator=int(IntegratorType.IMPLICITFAST)))
    if variant == 'implicitfast_cg':
      m = m.replace(opt=m.opt.replace(solver=int(SolverType.CG)))
  return m


@pytest.mark.parametrize('scene,variant,nconmax', [
    ('humanoid', None, 24), ('humanoid', 'rk4', 24), ('humanoid', 'cg', 24),
    ('three_humanoids', None, 100), ('humanoid', 'implicitfast', 24),
    ('franka_emika_panda', None, 1), ('apptronik_apollo_flat', None, 16),
    ('aloha_pot', None, 24)])
def test_state_fields_are_all_a_step_reads(scene, variant, nconmax):
  """A step from d and from d with every other field poisoned give the
  same bits in every field the step writes; the fields it neither reads
  nor writes pass through untouched (a replayed graph returns them as
  the static input holds them, which is as the first step left them).
  A model with equalities reads eq_active, a state field: the step from
  d with it negated gives other equality rows."""
  m = _path_model(scene, variant)
  mjm = build(scene)[0]
  q, v = states(mjm, 2, nstep=40, qpos_noise=0.02)
  d = mt.data_from_numpy(m, dict(qpos=q, qvel=v), nconmax=nconmax)
  one_step = tbench.noise_step(m, d.nworld)
  step = torch.tensor(3, dtype=torch.int32)
  d = one_step(d, step)             # every field holds a step's values
  poisoned = _poison(d)
  out, out_p = one_step(d, step), one_step(poisoned, step)
  passed = []
  for k in DATA_TENSORS:
    if getattr(out_p, k) is getattr(poisoned, k) and \
        k not in tbench.STATE_FIELDS:
      passed.append(k)
      continue
    np.testing.assert_array_equal(getattr(out_p, k).numpy(),
                                  getattr(out, k).numpy(), err_msg=k)
    if getattr(out, k).is_floating_point():
      assert not bool(torch.isnan(getattr(out, k)).any()), k
  for k in CONTACT_TENSORS:
    np.testing.assert_array_equal(getattr(out_p.contact, k).numpy(),
                                  getattr(out.contact, k).numpy(),
                                  err_msg=k)
  assert 'actuator_moment' in passed
  assert not set(passed) & set(tbench.STATE_FIELDS)
  if m.neq:
    flipped = one_step(d.replace(eq_active=~d.eq_active), step)
    assert not torch.equal(flipped.ne, out.ne)


class _HostWatch(TorchDispatchMode):
  """Records, outside the kernels' wrappers, each op that builds a tensor
  from host data (`lift_fresh`: a list index, torch.tensor) or reads a
  tensor on the host (`_local_scalar_dense`: float(), bool(), .item()).
  On the card the first copies to the card and the second waits for it;
  under a CUDA graph capture either raises. The wrappers stand for one
  launch of their kernel, whose host work is the launch alone."""

  def __init__(self):
    super().__init__()
    self.paused = 0
    self.seen = []

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    if not self.paused and func in (torch.ops.aten.lift_fresh.default,
                                    torch.ops.aten._local_scalar_dense.default):
      self.seen.append(str(func))
    return func(*args, **(kwargs or {}))


@pytest.fixture
def watch(monkeypatch):
  mode = _HostWatch()
  for mod, name in ((ks, 'smooth'), (kc, 'contact'), (kg, 'glue'),
                    (kn, 'newton_solve')):
    def launch(*args, _wrapper=getattr(mod, name), **kw):
      mode.paused += 1
      out = _wrapper(*args, **kw)
      mode.paused -= 1
      return out
    monkeypatch.setattr(mod, name, launch)
  return mode


# (path, scene, options, the list, forward_batched rather than a step,
# replayed): PERF.md §4
PATHS = [
    ('P1', 'humanoid', None, False, True),
    ('P2', 'three_humanoids', None, False, False),
    ('P3', 'humanoid', None, True, True),
    ('P4', 'humanoid', 'rk4', False, True),
    ('P5', 'humanoid', 'cg', False, False),
    ('P6', 'three_humanoids', 'cg', False, False),
    ('P7', 'humanoid', 'elliptic', False, True),
    ('P8', 'humanoid', 'elliptic_rk4', False, True),
    ('P9', 'three_humanoids', 'elliptic', False, False),
    ('P11', 'humanoid', 'implicitfast', False, True),
    ('P12', 'three_humanoids', 'implicitfast', False, False),
    ('P13', 'humanoid', 'implicitfast_cg', False, False),
    ('P14', 'franka_emika_panda', None, False, True),
    ('P15', 'apptronik_apollo_flat', None, False, True),
    # P16's list (`collision`, `make_constraint`) on the SAP grid, a
    # model past the large-scene threshold that steps at a CPU test's cost
    ('P16', 'sap_grid', None, False, True),
    # P17: aloha_pot's list, the static driver's `collision` (the cull,
    # MPR) in B2's place, B3e
    ('P17', 'aloha_pot', None, False, True),
    # P18: aloha_sdf's list, the SDF groups' descents in `collision`
    ('P18', 'aloha_sdf', None, False, True),
    # P20: kitchen's unfused list, the SAP `collision` with its MPR
    # families (`test_kitchen_collision_makes_no_host_sync`)
    ('P20', 'kitchen', None, False, False),
]


@pytest.mark.parametrize('path,scene,variant,fwd,replayed', PATHS,
                         ids=[p[0] for p in PATHS])
def test_replay_predicate_on_the_paths(path, scene, variant, fwd, replayed,
                                       watch):
  """`forward.replays` says which paths the harness replays as one CUDA
  graph: exactly those whose solve stage is a kernel (B3, B3e, B4,
  B4-elliptic) and whose step, once the model's tables are built, makes
  no host sync and builds no tensor from host data; a list with the
  unfused solve (its host syncs) steps eagerly."""
  if variant == 'elliptic_rk4':
    m = _path_model(scene, 'elliptic')
    m = m.replace(opt=m.opt.replace(integrator=int(IntegratorType.RK4)))
  else:
    m = _path_model(scene, variant)
  nconmax = {'humanoid': 24, 'franka_emika_panda': 1,
             'apptronik_apollo_flat': 16, 'sap_grid': 8,
             'aloha_pot': 24, 'aloha_sdf': 32,
             'kitchen': 64}.get(scene, 100)
  d = mt.make_data(m, nconmax=nconmax, nworld=2)
  stages = forward.forward_stages(m, d) if fwd else \
      forward.batched_stages(m, d)
  names = [n for n, _ in stages]
  assert forward.replays(m, d) == replayed, path
  kernel_solve = {'solve_glue[cuda]', 'solve[cuda]'} & set(names)
  assert bool(kernel_solve) == replayed, (path, names)
  step = torch.tensor(0, dtype=torch.int32)
  run = (lambda dd: mt.forward_batched(m, dd)) if fwd else \
      (lambda dd: tbench.noise_step(m, 2)(dd, step))
  d = run(d)                        # builds the model's tables
  with watch:
    run(d)
  assert bool(watch.seen) != replayed, (path, watch.seen)


def test_kitchen_collision_makes_no_host_sync(watch):
  """kitchen steps eagerly (the unfused solve syncs the host), but its
  `collision` stage, the large-scene broadphase with the MPR families,
  makes no host sync and builds no tensor from host data once the
  model's tables are built."""
  m = _path_model('kitchen', None)
  d = mt.make_data(m, nconmax=64, nworld=2)
  stages = forward.batched_stages(m, d)
  for name, fn in stages[:[n for n, _ in stages].index('collision')]:
    d = fn(d)
  collide = dict(stages)['collision']
  collide(d)                        # builds the model's tables
  with watch:
    out = collide(d)
  assert not watch.seen, watch.seen
  assert int(out.ncon.min()) == 64


def test_a_glue_list_with_cameras_and_lights_makes_no_host_sync(watch):
  mjm = mujoco.MjModel.from_xml_string(KEYED.replace(
      '<geom type="sphere"', '<camera mode="trackcom" pos="0 -1 0"/>'
      '<light mode="targetbody" target="world" pos="0 0 2"/>'
      '<geom type="sphere"'))
  m = mt.put_model(mjm, device='cpu')
  d = mt.make_data(m, nconmax=4, nworld=2)
  assert (m.ncam, m.nlight) == (1, 1)
  assert [n for n, _ in forward.batched_stages(m, d)] == [
      'smooth_mega[cuda]', 'camlight', 'contact_efc_mega[cuda]',
      'act_len_vel', 'solve_glue[cuda]']
  assert forward.replays(m, d)
  one_step = tbench.noise_step(m, 2)
  step = torch.tensor(0, dtype=torch.int32)
  d = one_step(d, step)
  with watch:
    one_step(d, step)
  assert not watch.seen


def test_replayed_lists_reach_no_b9_to_b12(monkeypatch):
  """P10: B9-B12 are called alone, outside any stage list, so nothing of
  them is replayed."""
  def refuse(*args, **kw):
    raise AssertionError('a step reached B9-B12')
  for name in ('smooth_front', 'kinematics', 'com_pos', 'crb'):
    monkeypatch.setattr(ks, name, refuse)
  for variant in (None, 'rk4', 'elliptic'):
    m = _path_model('humanoid', variant)
    d = mt.make_data(m, nconmax=24, nworld=2)
    assert forward.replays(m, d)
    tbench.noise_step(m, 2)(d, torch.tensor(0, dtype=torch.int32))


def test_benchmark_on_the_cpu_steps_eagerly():
  _, _, m = build('humanoid')
  d = mt.make_data(m, nconmax=24, nworld=2)
  assert forward.replays(m, d)
  d2, res = tbench.benchmark(m, d, nstep=2)
  assert res['dispatch'] == 'eager'
  np.testing.assert_allclose(d2.time.numpy(), 4 * float(m.opt.timestep),
                             rtol=1e-6)
  ref = tbench.rollout(m, d, 4)
  for k in tbench.STATE_FIELDS:
    assert torch.equal(getattr(d2, k), getattr(ref, k)), k


def test_key_fields_survive_save_and_load(keyed, tmp_path):
  mjm, _, m = keyed
  path = str(tmp_path / 'keyed.npz')
  mt.save_model(m, path)
  m2 = mt.load_model(path, device='cpu')
  assert m2.nkey == mjm.nkey == 4
  for k in ('key_time', 'key_qpos', 'key_qvel', 'key_act', 'key_ctrl',
            'key_mpos', 'key_mquat'):
    assert torch.equal(getattr(m2, k), getattr(m, k)), k
  np.testing.assert_array_equal(m2.key_qpos.numpy(),
                                mjm.key_qpos.astype(np.float32))
  assert tuple(m2.key_mpos.shape) == (4, 0, 3)


@pytest.mark.parametrize('npz,nkey', [(models.HUMANOID_NPZ, 0),
                                      (models.THREE_HUMANOIDS_NPZ, 3)])
def test_committed_models_load_with_their_keyframes(npz, nkey):
  m = mt.load_model(npz, device='cpu')
  assert m.nkey == nkey
  assert tuple(m.key_qpos.shape) == (nkey, m.nq)
  assert tuple(m.key_ctrl.shape) == (nkey, m.nu)


def _jax_batch(jm, nworld, nconmax, fields):
  jd = mjwt.make_data(jm, nconmax=nconmax)
  batch = jparallel.make_batch(jm, jd, nworld)
  return batch.replace(**{k: jnp.asarray(v) for k, v in fields.items()})


def _hold(d, jd, keys, tol=TOL):
  for k in keys:
    assert_close(getattr(d, k).numpy(), np.asarray(getattr(jd, k)), k, tol)


@pytest.mark.parametrize('keyframe', [None, 0, 3])
def test_reset_data_matches_jax(keyed, keyframe):
  _, jm, m = keyed
  d = mt.make_data(m, nconmax=4, nworld=3)
  d = d.replace(qpos=d.qpos + 0.1, qvel=d.qvel + 1.0, ctrl=d.ctrl + 0.3,
                time=d.time + 2.0)
  out = io.reset_data(m, d, keyframe=keyframe)
  ref = jio.reset_data(jm, mjwt.make_data(jm, nconmax=4), keyframe=keyframe)
  assert out.nworld == 3 and out.contact.dist.shape == (3, 4)
  for k in ('time', 'qpos', 'qvel', 'act', 'ctrl', 'qacc_warmstart',
            'qfrc_applied', 'xfrc_applied', 'qacc'):
    want = np.broadcast_to(np.asarray(getattr(ref, k)),
                           tuple(getattr(out, k).shape))
    assert_close(getattr(out, k).numpy(), want, k, TOL)


def test_reset_data_masked_matches_jax(keyed):
  _, jm, m = keyed
  rng = np.random.default_rng(2)
  fields = dict(qpos=rng.normal(size=(4, m.nq)).astype(np.float32),
                qvel=rng.normal(size=(4, m.nv)).astype(np.float32),
                ctrl=rng.normal(size=(4, m.nu)).astype(np.float32),
                time=np.full(4, 0.7, np.float32))
  mask = np.array([True, False, True, False])
  d = mt.data_from_numpy(m, fields, nconmax=4)
  out = io.reset_data_masked(m, d, torch.tensor(mask), keyframe=1)
  ref = jio.reset_data_masked(jm, _jax_batch(jm, 4, 4, fields),
                              jnp.asarray(mask), keyframe=1)
  _hold(out, ref, ('time', 'qpos', 'qvel', 'act', 'ctrl',
                   'qacc_warmstart'))
  assert torch.equal(out.qpos[~torch.tensor(mask)],
                     d.qpos[~torch.tensor(mask)])


def test_find_keys_and_make_trajectory_match_jax(keyed):
  """On the port's Model (its `key_names`, as a loaded .npz holds them)
  against the JAX package's functions on the MJCF's MjModel."""
  mjm, _, m = keyed
  for prefix in ('lift', 'lift_1', '', 'rest', 'none'):
    assert io.find_keys(m, prefix) == jio.find_keys(mjm, prefix), prefix
  keys = io.find_keys(m, 'lift')
  assert keys == [0, 1, 3]
  np.testing.assert_array_equal(
      io.make_trajectory(m, keys),
      jio.make_trajectory(mjm, keys).astype(np.float32))


def test_benchmark_replay_matches_jax(keyed):
  """The replay of the lift_* keyframes' ctrl from the first one's qpos,
  4 worlds, nstep 3 (a first step, 3 warm-up steps and one timed: the
  trajectory's clamp to its last frame is reached)."""
  mjm, jm, m = keyed
  keys = io.find_keys(m, 'lift')
  traj = io.make_trajectory(m, keys)
  qpos = np.broadcast_to(mjm.key_qpos[keys[0]], (4, m.nq)).astype(
      np.float32)
  d = mt.data_from_numpy(m, dict(qpos=qpos), nconmax=4)
  final, res = tbench.benchmark_replay(
      m, d, torch.tensor(traj, dtype=torch.float32), nstep=3)
  ref = jbench.benchmark_replay(jm, _jax_batch(jm, 4, 4, dict(qpos=qpos)),
                                jnp.asarray(traj), nstep=3)
  jd = ref['final']
  assert res['nstep'] == ref['nstep'] and res['dispatch'] == 'eager'
  assert int(np.asarray(jd.ncon).sum()) > 0
  np.testing.assert_array_equal(final.ncon.numpy(), np.asarray(jd.ncon))
  _hold(final, jd, ('time', 'qpos', 'qvel', 'ctrl', 'qacc',
                    'qfrc_constraint'))
  np.testing.assert_array_equal(final.ctrl.numpy(),
                                np.broadcast_to(traj[-1], (4, m.nu)).astype(
                                    np.float32))
