"""aloha_sdf (`benchmarks/scenes/aloha_sdf/scene.xml`, the suite's
`config.txt:15` row) against the JAX package, on the CPU, with the voxel
grids of both packages at resolution 16 (MJWT_SDF_RES; the committed
`.npz` holds them at 48, tests/test_torch_sdf_grids.py).

* The Model: the pair groups, candidate slots, `sdf_grid_of_mesh` and the
  grids' boxes equal the JAX `put_model`'s; the 3 grids sampled from the
  compiler's octrees are bit-equal, the 20 voxelized ones within VOX_TOL
  with the same signs, but for the extrusion's sliver faces (SLIVER_TOL:
  there JAX's float32 distance is off, tests/test_torch_sdf_grids.py).
* The stage list: `kernels.contact.supports` refuses the model (SDF and
  mesh pairs), so the glue list runs `collision` and `make_constraint`
  between B1 and B3e (mode 1), replayed; the mesh-SDF group is not
  culled, mesh-mesh is (MPR, 128 pairs a step at nconmax 32).
* From C MuJoCo states (keyframe gripper_gripper_pot after 1 step: 30
  contacts in C, fingers on the cow; neutral_pose after 60 steps: the cow
  on the table), one JAX step of jax.vmap(step) at 2 worlds: the port's
  `collision` on the JAX step's geom frames gives the JAX pool (ncon,
  ncollision, geom ids and order exactly, the pool full in the first
  world; values at test_torch_aloha.py's TOL, pos along the normal); one
  port step against the JAX step by test_torch_aloha.py's rules (rows at
  ROW_TOL, the solve by its objective).
"""

import mujoco
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import collision_driver, forward, solver
from mujoco_warp_tpu_torch.io import efc_layout
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch import models

from test_torch_aloha import OBJ_UNITS, QACC_TOL, ROW_TOL, STAGES, TOL
from test_torch_step import STEP_TOL
from torch_parity import assert_close, compile_fresh, shared

RES = 16
NCONMAX = 32
# a voxelized grid's values: the two packages' float32 sums part by
# rounding
VOX_TOL = 1e-6
SLIVER_TOL = 1e-4
GROUPS = [(0, 7, 18), (0, 8, 5), (6, 7, 18), (6, 8, 5), (7, 7, 717),
          (7, 8, 239), (8, 8, 10)]


def _mjm():
  return compile_fresh(models.ALOHA_SDF)


def _states(mjm):
  """(qpos, qvel, ctrl, qacc_warmstart) float32 of two C MuJoCo runs:
  keyframe gripper_gripper_pot after 1 step, neutral_pose after 60."""
  rows = []
  for key, n in ((1, 1), (0, 60)):
    d = mujoco.MjData(mjm)
    mujoco.mj_resetDataKeyframe(mjm, d, key)
    for _ in range(n):
      mujoco.mj_step(mjm, d)
    rows.append((d.qpos.copy(), d.qvel.copy(), d.ctrl.copy(),
                 d.qacc_warmstart.copy()))
  return dict(zip(('qpos', 'qvel', 'ctrl', 'qacc_warmstart'),
                  [np.asarray(x, np.float32) for x in zip(*rows)]))


def _at_res(build):
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv('MJWT_SDF_RES', str(RES))
    return build()


@pytest.fixture(scope='module')
def port_model():
  mjm = _mjm()
  return mjm, _at_res(lambda: mt.put_model(mjm, device='cpu'))


_REFERENCE = {}


def _jax_reference():
  """The JAX Model's SDF fields and one JAX step from `_states` at 2
  worlds, as numpy (computed once a run, `torch_parity.shared`, and kept
  by the process)."""
  if _REFERENCE:
    return _REFERENCE['value']

  def make():
    mjm = _mjm()
    jm = _at_res(lambda: mjwt.put_model(mjm))
    fields = _states(mjm)
    jd = mjwt.make_data(jm, nconmax=NCONMAX)
    names = sorted(fields)
    batch = jax.vmap(lambda *a: jd.replace(**dict(zip(names, a))))(
        *[jnp.asarray(fields[k]) for k in names])
    out = jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd)))(batch)
    model = dict(sdf_grids=np.asarray(jm.sdf_grids),
                 sdf_grid_aabb=np.asarray(jm.sdf_grid_aabb),
                 sdf_grid_of_mesh=jm.sdf_grid_of_mesh,
                 collision_pairs=jm.collision_pairs,
                 nxn_candidates=jm.nxn_candidates,
                 sdf_iterations=jm.opt.sdf_iterations,
                 sdf_initpoints=jm.opt.sdf_initpoints)
    return dict(model=model, fields=fields,
                out=jax.tree.map(np.asarray, out))
  _REFERENCE['value'] = shared(f'aloha_sdf_res{RES}', make)
  return _REFERENCE['value']


def test_aloha_sdf_model_matches_jax(port_model):
  mjm, m = port_model
  ref = _jax_reference()['model']
  assert m.collision_pairs == ref['collision_pairs']
  assert [(a, b, len(g)) for a, b, g in m.collision_pairs] == GROUPS
  assert m.nxn_candidates == ref['nxn_candidates'] == 8927
  assert m.sdf_grid_of_mesh == ref['sdf_grid_of_mesh']
  assert (m.opt.sdf_iterations, m.opt.sdf_initpoints) == (
      ref['sdf_iterations'], ref['sdf_initpoints']) == (10, 20)
  np.testing.assert_array_equal(m.sdf_grid_aabb.numpy(), ref['sdf_grid_aabb'])
  grids, jgrids = m.sdf_grids.numpy(), ref['sdf_grids']
  assert grids.shape == jgrids.shape == (23, RES, RES, RES)
  # the fingers' two meshes and the cow
  octree = [m.sdf_grid_of_mesh[i] for i in range(mjm.nmesh)
            if mjm.mesh_octadr[i] >= 0]
  assert len(octree) == 3
  np.testing.assert_array_equal(grids[octree], jgrids[octree])
  # the voxelized ones: within VOX_TOL, but on the extrusion's sliver
  # faces, where JAX's float32 distance is off (tests/
  # test_torch_sdf_grids.py::test_voxelization_matches_jax)
  sliver = m.sdf_grid_of_mesh[0]
  off = np.abs(grids - jgrids) > VOX_TOL
  print(f'voxels over {VOX_TOL:g}: {int(off.sum())}, by grid '
        f'{off.reshape(len(off), -1).sum(1).tolist()}')
  assert not np.delete(off, sliver, 0).any()
  np.testing.assert_allclose(grids[sliver], jgrids[sliver], rtol=0,
                             atol=SLIVER_TOL)
  assert (np.sign(grids) == np.sign(jgrids)).all()
  assert efc_layout(m, NCONMAX) == (2, 4, 16, 4, 150)


def test_aloha_sdf_takes_the_collision_stage(port_model):
  _, m = port_model
  d = mt.make_data(m, nconmax=NCONMAX, nworld=2)
  assert not kc.supports(m, NCONMAX)
  assert [n for n, _ in forward.batched_stages(m, d)] == STAGES
  assert forward.replays(m, d) and forward.glue_mode(m) == 1
  # the JAX driver culls no SDF group; mesh-mesh is culled to 128 pairs
  culled = {(a, b) for a, b, g in m.collision_pairs
            if collision_driver.culls(a, b, len(g))}
  assert culled == {(7, 7)}
  assert collision_driver.cull_slots(NCONMAX, 717) == 128
  assert collision_driver.culls(7, 8, 239) is False
  slots = [grp['slots'] for grp in collision_driver._group_tables(m)]
  assert slots == [4, 20, 5, 20, 5, 20, 20]


def test_aloha_sdf_collision_and_step_match_jax(port_model):
  _, m = port_model
  ref = _jax_reference()
  new, fields = ref['out'], ref['fields']
  gx, gm = torch.tensor(new.geom_xpos), torch.tensor(new.geom_xmat)

  # the pool
  con = collision_driver.collision(m, gx, gm, NCONMAX)
  for k in ('ncon', 'ncollision'):
    np.testing.assert_array_equal(con[k].numpy(), getattr(new, k), k)
  assert new.ncon[0] == NCONMAX and new.ncollision[0] > NCONMAX  # full
  assert (new.ncon > 0).all()
  np.testing.assert_array_equal(con['geom'].numpy(), new.contact.geom)
  np.testing.assert_array_equal(con['dim'].numpy(), new.contact.dim)
  sdf_geoms = [g for g in range(m.ngeom) if m.geom_type[g] == 8]
  live = new.contact.geom[..., 0] >= 0
  assert np.isin(new.contact.geom[live], sdf_geoms).any(-1).all()
  assert (new.contact.dim[live] == 4).any()
  for k in ('dist', 'frame', 'includemargin', 'friction', 'solref',
            'solreffriction', 'solimp'):
    assert_close(con[k].numpy(), getattr(new.contact, k), k, TOL)
  dpos = con['pos'].numpy() - new.contact.pos
  assert_close((dpos * new.contact.frame[..., 0, :]).sum(-1),
               np.zeros(dpos.shape[:-1]), 'pos', TOL)

  # one step
  d = mt.step_batched(m, mt.data_from_numpy(m, fields, nconmax=NCONMAX))
  for k in ('ncon', 'ncollision', 'ne', 'nf', 'nl', 'nefc'):
    np.testing.assert_array_equal(getattr(d, k).numpy(), getattr(new, k), k)
  for name, tol in STEP_TOL:
    if name not in ('qpos', 'qvel', 'qacc', 'qfrc_constraint'):
      assert_close(getattr(d, name).numpy(), getattr(new, name), name, tol)
  np.testing.assert_array_equal(d.efc_active.numpy(), new.efc_active)
  assert_close(d.efc_J.numpy(), new.efc_J * new.efc_active[..., None],
               'efc_J', TOL)
  # the fingers' torsional rows: condim 4 on a free body
  ne, nf, nl, S, _ = efc_layout(m, NCONMAX)
  tors = d.efc_J[:, ne + nf + nl:].reshape(2, NCONMAX, S, m.nv)[..., 3, :]
  assert (tors[d.contact.dim == 4].abs().amax(-1) > 0).any()
  base = ne + nf + nl
  for k in ('efc_D', 'efc_aref', 'efc_pos', 'efc_frictionloss'):
    a, b = getattr(d, k).numpy(), getattr(new, k)
    assert_close(a[:, :base], b[:, :base], k, TOL)
    assert_close(a[:, base:], b[:, base:], k, ROW_TOL)
  x = [getattr(d, k).double() for k in ('qM', 'efc_J', 'efc_D', 'efc_aref',
                                         'efc_frictionloss', 'qfrc_smooth')]
  cone = solver.cone_inputs(m, d.contact)
  K = solver.Cone(m, x[2], (cone[0].double(), cone[1], cone[2].double()))
  qsm = torch.linalg.solve(x[0], x[5])
  cost = [solver.objective(*x, qsm, qa.double(), ne, nf, cone=K)
          for qa in (d.qacc, torch.tensor(new.qacc))]
  unit = float(m.opt.tolerance * m.stat.meaninertia * m.nv)
  assert (cost[0] <= cost[1] + OBJ_UNITS * unit).all(), (cost, unit)
  assert_close(d.qacc.numpy(), new.qacc, 'qacc', QACC_TOL)
  # qvel advances by h qacc: h times qacc's tolerance (at qacc's scale,
  # which the stiff finger contacts raise far past qvel's)
  h = float(m.opt.timestep)
  dv = QACC_TOL * h * max(1.0, float(np.abs(new.qacc).max()))
  np.testing.assert_allclose(d.qvel.numpy(), new.qvel, rtol=0, atol=dv)
  assert_close(d.qpos.numpy(), new.qpos, 'qpos', 5e-6)
