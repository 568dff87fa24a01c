"""The large-scene broadphase (`collision_sap.py`, `io._sap_precompute`)
and the stage list around it against the JAX package, on the CPU.

* apptronik_apollo_terrain (`scene_terrain.xml`, the one test that loads
  it): the port's SAP families, pair rows, <pair> ids and count equal
  the JAX package's `io._sap_precompute` (numpy, exact); its Model and
  the committed `.npz` hold them.
* The vectorised `io._collision_pairs` equals the JAX package's loop on
  the committed models and on a scene with <exclude>, <pair>,
  contype/conaffinity and parent-child filtering.
* The SAP grid (`torch_parity.SAP_GRID`, zero margins, SAP forced on
  both sides at 6 worlds and nconmax 8, so that the 64 pairs a family
  keeps drop overlaps, and grid boxes tie in slack): the port's pool on
  the JAX step's geom frames, with each family's pairs in one chunk and
  in chunks of 70 (the running top-K merged across chunks), equals the
  JAX pool: ncon, ncollision (the drops included), geom ids and order
  exactly, dist, pos and frame at 5e-5 (capsule-box points and frames at
  CB_TOL, the JAX tests' 2e-3 for that collider, test_torch_apollo.py);
  each culled family's top 64 equals `jax.lax.top_k`'s; its world AABBs
  and slacks are bit-equal to the JAX package's; one port step against
  jax.vmap(mujoco_warp_tpu.step) at STEP_TOL, where a world that misses
  it must be one where the JAX solve stopped in fewer iterations and the
  port's qacc costs no more on the port's rows than the JAX qacc (at
  most one such world).
* Its per-pair contact parameters equal the JAX package's `_dyn_params`
  but for the pair margin and gap: C MuJoCo's sums, where the JAX
  package takes the larger (ROADMAP §C, C5).
* The stage lists: a SAP model runs `collision` and `make_constraint`
  in every list; the humanoid, three_humanoids, franka and apollo_flat
  keep B2 (`kernels.contact.supports`).
* A static group past the JAX driver's cull threshold (2,048 primitive
  pairs) under the SAP threshold, which the gate refused before the
  static driver culled: the stage choice, the kept pairs with their ties
  and the pool against JAX `collision`.
"""

import mujoco
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import io as jio
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import collision_sap, forward, io, models, solver
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch.types import IntegratorType, SolverType

from test_torch_apollo import CB_TOL
from test_torch_step import STEP_TOL
from torch_parity import (FILES, SAP_GRID, assert_close, build_sap,
                          sap_grid_states)

TOL = 5e-5
NWORLD = 6
NCONMAX = 8
TERRAIN_FAMILIES = [(3, 3, 71), (3, 6, 73856), (6, 6, 21094)]


def test_terrain_sap_arrays_match_jax(monkeypatch):
  monkeypatch.delenv('MJWT_SAP_THRESHOLD', raising=False)
  mjm = mujoco.MjModel.from_xml_path(models.APOLLO_TERRAIN)
  meta, leaves, count = jio._sap_precompute(mjm)
  families, pairs, pairid, n = io._sap_precompute(mjm)
  assert families == meta.families and meta.plane_groups == ()
  assert [(a, b, c) for a, b, _, c in families] == TERRAIN_FAMILIES
  assert n == count == 95021
  np.testing.assert_array_equal(pairs, leaves['sap_pairs'])
  np.testing.assert_array_equal(pairid, leaves['sap_pairid'])
  m = mt.put_model(mjm, device='cpu')
  assert m.sap_families == families and m.collision_pairs == ()
  assert m.nxn_candidates == 95021 and m.condim_max == 3
  assert mt.efc_layout(m, 48) == (0, 19, 19, 4, 230)
  np.testing.assert_array_equal(m.sap_pairs.numpy(), pairs)
  np.testing.assert_array_equal(m.sap_pairid.numpy(), pairid)
  np.testing.assert_array_equal(
      m.geom_aabb.numpy(), mjm.geom_aabb.reshape(-1, 2, 3).astype(np.float32))
  loaded = io.load_model(models.APOLLO_TERRAIN_NPZ, device='cpu')
  for k in mt.types.MODEL_STATICS:
    assert getattr(loaded, k) == getattr(m, k), k
  for k in mt.types.MODEL_TENSORS:
    assert torch.equal(getattr(loaded, k), getattr(m, k)), k


FILTERS = """<mujoco><worldbody>
  <geom name="floor" type="plane" size="2 2 .1"/>
  <body name="a" pos="0 0 .5"><freejoint/>
    <geom name="a1" type="capsule" size=".05 .1"/>
    <geom name="a2" type="sphere" size=".05" pos=".1 0 0"/>
    <body name="b" pos="0 0 .3"><joint type="hinge"/>
      <geom name="b1" type="capsule" size=".04 .1"/>
      <body name="c" pos="0 0 .3"><joint type="hinge"/>
        <geom name="c1" type="sphere" size=".05"/></body></body></body>
  <body name="d" pos="1 0 .5"><freejoint/>
    <geom name="d1" type="capsule" size=".1 .1"/>
    <geom name="d2" type="sphere" size=".05" contype="2" conaffinity="2"/>
  </body>
  <body name="e" pos="-1 0 .5"><freejoint/>
    <geom name="e1" type="capsule" size=".05 .1"/></body>
</worldbody>
<contact><exclude body1="a" body2="d"/><pair geom1="c1" geom2="a2"/>
  <pair geom1="e1" geom2="b1" margin="0.01"/></contact></mujoco>"""


@pytest.mark.parametrize('scene', ['humanoid'] + sorted(FILES) +
                         ['filters'])
def test_collision_pairs_match_the_jax_loop(scene):
  if scene == 'filters':
    mjm = mujoco.MjModel.from_xml_string(FILTERS)
  elif scene == 'humanoid':
    mjm = mujoco.MjModel.from_xml_path(models.HUMANOID)
  else:
    mjm = mujoco.MjModel.from_xml_path(FILES[scene])
  assert io._collision_pairs(mjm) == jio._collision_pairs(mjm)
  if scene == 'filters':
    pairs = {(t1, t2): gl for t1, t2, gl in io._collision_pairs(mjm)[0]}
    assert (1, 3, -1) not in pairs[(3, 3)]        # a1-b1: parent and child
    assert (1, 5, -1) not in pairs[(3, 3)]        # a1-d1: <exclude>
    assert (3, 7, 1) in pairs[(3, 3)]             # e1-b1: its <pair> alone
    assert pairs[(2, 2)] == ((2, 4, 0),)          # a2-c1: its <pair> alone
    assert all(6 not in (g1, g2) for gl in pairs.values()
               for g1, g2, _ in gl)               # d2: contype 2


@pytest.fixture(scope='module')
def grid():
  """The SAP grid in both packages, NWORLD states, and one step of
  jax.vmap(mujoco_warp_tpu.step) from them (compiled once)."""
  mjm, jm, m = build_sap()
  q = sap_grid_states(mjm, NWORLD)
  jd = mjwt.make_data(jm, nconmax=NCONMAX)
  batch = jax.vmap(lambda qq: jd.replace(qpos=qq))(jnp.asarray(q))
  new = jax.jit(jax.vmap(lambda dd: mjwt.step(jm, dd)))(batch)
  return mjm, jm, m, q, jax.tree.map(np.asarray, new)


def _pair_type(m, g):
  return (m.geom_type[g[0]], m.geom_type[g[1]])


def _assert_pool_matches(m, out, new):
  """The port's pool `out` against the JAX step's pool of `new`: counts,
  geom ids and order exactly, the rest at TOL (capsule-box pos and frame
  at CB_TOL)."""
  for k in ('ncon', 'ncollision'):
    np.testing.assert_array_equal(out[k].numpy(), getattr(new, k), k)
  np.testing.assert_array_equal(out['geom'].numpy(), new.contact.geom)
  np.testing.assert_array_equal(out['dim'].numpy(), new.contact.dim)
  assert (out['ncon'] == NCONMAX).sum() >= 4
  cb = np.array([[ncon > c and _pair_type(m, gg) == (3, 6)
                  for c, gg in enumerate(row)]
                 for ncon, row in zip(out['ncon'].tolist(),
                                      out['geom'].tolist())])
  for k in ('dist', 'pos', 'frame', 'includemargin', 'friction', 'solref',
            'solreffriction', 'solimp'):
    a, b = out[k].numpy().copy(), getattr(new.contact, k).copy()
    if k in ('pos', 'frame'):
      assert_close(a[cb], b[cb], f'capsule-box {k}', CB_TOL)
      a[cb] = b[cb]
    assert_close(a, b, k, TOL)


def test_sap_pool_and_step_match_jax(grid, monkeypatch):
  mjm, jm, m, q, new = grid
  assert m.sap_families == jm.sap_meta.families
  assert [(a, b, c) for a, b, _, c in m.sap_families] == [
      (3, 3, 1), (3, 6, 292), (6, 6, 289)]
  gx, gm = torch.tensor(new.geom_xpos), torch.tensor(new.geom_xmat)
  # the AABBs and slacks, bit for bit
  cw, hw = collision_sap.world_aabbs(m, gx, gm)
  ac, ah = jm.geom_aabb[:, 0], jm.geom_aabb[:, 1]
  jcw, jhw = jax.jit(jax.vmap(lambda p, r: (
      p + jnp.einsum('nij,nj->ni', r, ac),
      jnp.einsum('nij,nj->ni', jnp.abs(r), ah) + jm.geom_margin[:, None])))(
          new.geom_xpos, new.geom_xmat)
  np.testing.assert_array_equal(cw.numpy(), np.asarray(jcw))
  np.testing.assert_array_equal(hw.numpy(), np.asarray(jhw))
  slacks = []
  for _, _, start, count in m.sap_families[1:]:
    g1 = m.sap_pairs[start:start + count, 0].long()
    g2 = m.sap_pairs[start:start + count, 1].long()
    sl = collision_sap.slack(cw, hw, g1, g2)
    jsl = jax.jit(lambda c, h: jnp.min(h[:, g1.numpy()] + h[:, g2.numpy()] -
                                       jnp.abs(c[:, g1.numpy()] -
                                               c[:, g2.numpy()]), -1))(
                                                   jcw, jhw)
    np.testing.assert_array_equal(sl.numpy(), np.asarray(jsl))
    key = torch.where(sl >= 0, sl, float('-inf'))
    slacks.append((g1, g2, sl, np.asarray(jax.lax.top_k(
        jnp.asarray(key.numpy()), 64)[1])))
  # the pool of the JAX step's geom frames and each culled family's top
  # 64 with its ties, the families in one chunk and in chunks of 70 pairs
  # (the running top-K merged across 5 chunks a family)
  for chunk in (collision_sap.CHUNK_ELEMENTS, NWORLD * 70):
    monkeypatch.setattr(collision_sap, 'CHUNK_ELEMENTS', chunk)
    _assert_pool_matches(m, collision_sap.collision(m, gx, gm, NCONMAX), new)
    for g1, g2, sl, jsel in slacks:
      sel, valid, nover = collision_sap.cull(cw, hw, g1, g2, 64)
      np.testing.assert_array_equal(sel.numpy(), jsel)
      np.testing.assert_array_equal(valid.numpy(),
                                    np.take_along_axis(sl.numpy(), jsel, 1)
                                    >= 0)
      np.testing.assert_array_equal(nover.numpy(), (sl >= 0).sum(1).numpy())
  g1, g2, sl, _ = slacks[1]
  sel, _, nover = collision_sap.cull(cw, hw, g1, g2, 64)
  assert (nover > 64).all()
  picked = torch.gather(sl, 1, sel)
  assert (picked[:, 1:] == picked[:, :-1]).sum() > 100      # ties
  # one step against the JAX step
  d = mt.data_from_numpy(m, dict(qpos=q), nconmax=NCONMAX)
  assert [n for n, _ in forward.batched_stages(m, d)] == [
      'smooth_mega[cuda]', 'collision', 'make_constraint', 'act_len_vel',
      'solve_glue[cuda]']
  d = mt.step_batched(m, d)
  off = np.zeros(NWORLD, bool)
  for name, tol in STEP_TOL:
    a, b = getattr(d, name).numpy(), getattr(new, name)
    if a.size:
      scale = max(1.0, float(np.abs(b).max()))
      off |= (np.abs(a - b) > tol * scale).reshape(NWORLD, -1).any(1)
  assert off.sum() <= 1, off
  for w in np.nonzero(off)[0]:
    assert int(new.solver_niter[w]) < int(d.solver_niter[w])
    x = [getattr(d, k)[w:w + 1].double() for k in (
        'qM', 'efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss',
        'qfrc_smooth')]
    qsm = torch.linalg.solve(x[0], x[5])
    ne, nf, _, _, _ = mt.efc_layout(m, 0)
    cost = [float(solver.objective(*x, qsm, qacc.double(), ne, nf))
            for qacc in (d.qacc[w:w + 1], torch.tensor(new.qacc[w:w + 1]))]
    assert cost[0] <= cost[1], cost
  for name, tol in STEP_TOL:
    assert_close(getattr(d, name).numpy()[~off], getattr(new, name)[~off],
                 name, tol)


def test_sap_pair_params_match_jax_but_the_margin_rule():
  """The per-pair table of the large-scene broadphase (`sap_tables`)
  against the JAX package's `_dyn_params` on every admissible pair of
  the SAP grid with margin 0.002 and gap 0.001 on every geom: friction,
  solref, solreffriction, solimp and condim equal; margin and gap follow
  C MuJoCo's sums (the detection margin 0.006, includemargin 0.004)
  where the JAX package takes the larger of each (0.002, 0.001; ROADMAP
  §C, C5)."""
  from mujoco_warp_tpu import collision_sap as jsap
  xml = SAP_GRID.replace('<worldbody>', '<default><geom margin="0.002" '
                         'gap="0.001"/></default><worldbody>', 1)
  _, jm, m = build_sap(xml)
  p = collision_sap.sap_tables(m)['params']
  pairs = m.sap_pairs.numpy()
  ref = jsap._dyn_params(jm, jnp.asarray(pairs[:, 0]),
                         jnp.asarray(pairs[:, 1]),
                         jnp.asarray(m.sap_pairid.numpy()), jnp.float32)
  for k, r in zip(('friction', 'solref', 'solreffriction', 'solimp'), ref):
    np.testing.assert_array_equal(p[k].numpy(), np.asarray(r), k)
  np.testing.assert_array_equal(p['condim'].numpy(), np.asarray(ref[6]))
  np.testing.assert_allclose(p['margin'].numpy(), 0.006, rtol=1e-6)
  np.testing.assert_allclose(p['includemargin'].numpy(), 0.004, rtol=1e-6)
  np.testing.assert_allclose(np.asarray(ref[4]), 0.002, rtol=1e-6)
  np.testing.assert_allclose(np.asarray(ref[5]), 0.001, rtol=1e-6)


_PATH_MODELS = {
    'three_humanoids': (models.THREE_HUMANOIDS_NPZ, 100, [
        'smooth_mega[cuda]', 'camlight', 'contact_efc_mega[cuda]',
        'transmission', 'velocity_glue', 'passive', 'fwd_actuation',
        'fwd_acceleration', 'solve', 'euler']),
    'humanoid': (models.HUMANOID_NPZ, 24, [
        'smooth_mega[cuda]', 'contact_efc_mega[cuda]', 'act_len_vel',
        'solve_glue[cuda]']),
    'franka_emika_panda': (models.FRANKA_NPZ, 1, [
        'smooth_mega[cuda]', 'camlight', 'contact_efc_mega[cuda]',
        'act_len_vel', 'solve_glue[cuda]']),
    'apptronik_apollo_flat': (models.APOLLO_NPZ, 16, [
        'smooth_mega[cuda]', 'camlight', 'contact_efc_mega[cuda]',
        'act_len_vel', 'sensor_pos', 'sensor_vel', 'solve_glue[cuda]',
        'sensor_acc', 'advance']),
}


@pytest.mark.parametrize('scene', sorted(_PATH_MODELS))
def test_models_below_the_threshold_keep_b2(scene):
  path, nconmax, names = _PATH_MODELS[scene]
  m = io.load_model(path, device='cpu')
  d = mt.make_data(m, nconmax=nconmax, nworld=2)
  assert m.sap_families == () and m.sap_pairs.shape == (0, 2)
  assert [n for n, _ in forward.batched_stages(m, d)] == names
  assert 'contact_efc_mega[cuda]' in [
      n for n, _ in forward.forward_stages(m, d)]
  assert kc.supports(m, nconmax) and not kc.supports(m, kc.MAXCON + 1)


@pytest.mark.parametrize('variant', ['glue', 'forward', 'rk4', 'cg',
                                     'implicitfast'])
def test_sap_model_runs_collision_and_make_constraint(variant):
  """Every list of a SAP model: no B2, `collision` then
  `make_constraint` after B1 (the JAX package's XLA stages there)."""
  _, _, m = build_sap()
  opt = dict(rk4=dict(integrator=int(IntegratorType.RK4)),
             cg=dict(solver=int(SolverType.CG)),
             implicitfast=dict(integrator=int(IntegratorType.IMPLICITFAST))
             ).get(variant, {})
  m = m.replace(opt=m.opt.replace(**opt))
  d = mt.make_data(m, nconmax=NCONMAX, nworld=2)
  stages = (forward.forward_stages(m, d) if variant == 'forward' else
            forward.batched_stages(m, d))
  names = [n for n, _ in stages]
  assert names[:3] == ['smooth_mega[cuda]', 'collision', 'make_constraint']
  assert 'contact_efc_mega[cuda]' not in names
  assert forward.uses_glue_kernel(m, d) == (variant in ('glue', 'forward',
                                                        'implicitfast'))
  out = forward._run(stages[:3], d.replace(qpos=torch.tensor(
      sap_grid_states(mujoco.MjModel.from_xml_string(SAP_GRID), 2))))
  assert int(out.ncon.min()) > 0 and int(out.nefc.min()) > 0


def _group_scene(ncapsule, nbox, box=0.01):
  """ncapsule capsules on one free body over nbox boxes (half size box)
  on the world body: one capsule-box group of ncapsule * nbox pairs."""
  caps = ''.join(f'<geom type="capsule" size=".01 .02" pos="{0.05 * i} 0 0"'
                 '/>' for i in range(ncapsule))
  boxes = ''.join(f'<geom type="box" size="{box} {box} {box}" '
                  f'pos="{0.05 * i} 1 0"/>' for i in range(nbox))
  return (f'<mujoco><worldbody>{boxes}<body pos="0 0 1"><freejoint/>{caps}'
          '</body></worldbody></mujoco>')


@pytest.mark.parametrize('ncapsule,uncut', [(21, False), (16, True)])
def test_gate_refuses_a_static_group_past_the_cull(ncapsule, uncut):
  """A static group of primitive pairs past the JAX driver's cull
  threshold (2,048) under the SAP threshold, which the gate refused
  before the port had the cull: 21 x 100 = 2,100 capsule-box pairs (boxes
  of half size 0.05, so that a capsule's bounding sphere meets up to 5 of
  them) take `collision` and `make_constraint` in B2's place, and on 3
  worlds whose capsules hang over the boxes (one shifted by half a
  spacing, where the distances tie) the port's cull keeps the JAX
  driver's pairs in its order (`jax.lax.top_k`: 64 at nconmax 4) and its
  pool equals JAX `collision`'s, the dropped overlaps in ncollision; 16 x
  128 = 2,048 is not past it and keeps B2."""
  nbox = 128 if uncut else 100
  mjm = mujoco.MjModel.from_xml_string(_group_scene(ncapsule, nbox, 0.05))
  m = mt.put_model(mjm, device='cpu')
  assert [(t1, t2, len(gl)) for t1, t2, gl in m.collision_pairs] == [
      (3, 6, ncapsule * nbox)]
  d = mt.make_data(m, nconmax=4, nworld=3)
  names = [n for n, _ in forward.batched_stages(m, d)][:3]
  if uncut:
    assert names[:2] == ['smooth_mega[cuda]', 'contact_efc_mega[cuda]']
    return
  assert names == ['smooth_mega[cuda]', 'collision', 'make_constraint']
  q = np.tile(mjm.qpos0, (3, 1)).astype(np.float32)
  q[:, 1] = 1.0                                   # over the boxes
  q[:, 2] = [0.05, 0.05, 0.055]
  q[1, 0] = 0.025                                 # between two boxes: ties
  jm = mjwt.make_data(mjwt.put_model(mjm), nconmax=4)
  jmodel = mjwt.put_model(mjm)
  from mujoco_warp_tpu import collision_driver as jcd
  from mujoco_warp_tpu import smooth as jsmooth
  new = jax.tree.map(np.asarray, jax.jit(jax.vmap(
      lambda qq: jcd.collision(jmodel, jsmooth.kinematics(
          jmodel, jm.replace(qpos=qq)))))(jnp.asarray(q)))
  gx, gm = torch.tensor(new.geom_xpos), torch.tensor(new.geom_xmat)
  from mujoco_warp_tpu_torch import collision_driver
  grp = collision_driver._group_tables(m)[0]
  assert grp['cull'] and collision_driver.cull_slots(4, 2100) == 64
  sel, valid, nover = collision_driver.cull(
      m, gx, grp, collision_driver.candidate_params(m)['margin'], 64)
  g1, g2 = grp['g1'].numpy(), grp['g2'].numpy()
  dvec = new.geom_xpos[:, g1] - new.geom_xpos[:, g2]
  d2 = jnp.sum(dvec * dvec, -1)
  rsum = jnp.asarray(mjm.geom_rbound[g1] + mjm.geom_rbound[g2], jnp.float32)
  overlap = d2 <= rsum * rsum
  jsel = np.asarray(jax.lax.top_k(jnp.where(overlap, -d2, -jnp.inf), 64)[1])
  np.testing.assert_array_equal(sel.numpy(), jsel)
  np.testing.assert_array_equal(nover.numpy(), np.asarray(overlap).sum(1))
  assert (nover > 64).all()
  picked = np.take_along_axis(np.asarray(d2), jsel, 1)
  assert (picked[1, 1:] == picked[1, :-1]).sum() > 10            # ties
  con = collision_driver.collision(m, gx, gm, 4)
  _assert_cull_pool(m, con, new)


def _assert_cull_pool(m, out, new):
  for k in ('ncon', 'ncollision'):
    np.testing.assert_array_equal(out[k].numpy(), getattr(new, k), k)
  np.testing.assert_array_equal(out['geom'].numpy(), new.contact.geom)
  assert (out['ncollision'] > out['ncon'] + 64).all()
  for k in ('dist', 'pos', 'frame', 'friction', 'solref', 'solimp'):
    tol = CB_TOL if k in ('pos', 'frame') else TOL
    assert_close(out[k].numpy(), getattr(new.contact, k), k, tol)


def test_sap_gate_refuses_unported_families_and_planes():
  """A SAP family without a port collider (capsule-cylinder) and plane
  pairs under the large-scene broadphase are refused; an MPR family
  (sphere-mesh) is admitted, with JAX `put_model`'s families."""
  cyl = _group_scene(1, 5).replace('type="box" size="0.01 0.01 0.01"',
                                   'type="cylinder" size=".01 .01"')
  with pytest.raises(NotImplementedError, match=r'\(3, 5\)'):
    build_sap(cyl, threshold=1)
  plane = _group_scene(1, 5).replace(
      '<worldbody>', '<worldbody><geom type="plane" size="1 1 1"/>')
  with pytest.raises(NotImplementedError, match='plane pairs'):
    build_sap(plane, threshold=1)
  mesh = _group_scene(1, 5).replace(
      '<mujoco>', '<mujoco><asset><mesh name="tet" vertex="0 0 0  .01 0 0  '
      '0 .01 0  0 0 .01"/></asset>').replace(
          'type="capsule" size=".01 .02"', 'type="mesh" mesh="tet"').replace(
              'type="box" size="0.01 0.01 0.01"', 'type="sphere" size=".01"')
  _, jm, m = build_sap(mesh, threshold=1)
  assert m.sap_families == jm.sap_meta.families == ((2, 7, 0, 5),)
  np.testing.assert_array_equal(m.sap_pairs.numpy(), np.asarray(jm.sap_pairs))
