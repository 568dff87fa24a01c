"""kitchen (`benchmarks/scenes/kitchen/kitchen.xml`, the suite's row,
`benchmarks/suite.py:42-48`: 256 worlds, nconmax 64, 100 steps) and the
MPR families of the large-scene broadphase, against the JAX package and
C MuJoCo, on the CPU.

* The Model: the committed `.npz` equals `put_model`; the families
  (cylinder-cylinder 16,842, cylinder-box 115,674, box-box 103,132
  pairs), the pair rows and the efc layout equal JAX `put_model`'s; the
  unfused stage list runs `collision` and `make_constraint` with B1, B7
  and B5 and no B2; each family keeps 128 pairs (2,304 candidate slots);
  B1 holds 3 worlds a block.
* A synthetic scene built with threshold 1 (`_synthetic`: cylinders,
  boxes and a mesh on free bodies over a grid of boxes) has
  cylinder-cylinder, cylinder-box (culled), box-box and box-mesh
  families. On the geom frames of JAX `collision` at 6 worlds, in one
  chunk and in chunks of 30 pairs, each culled family keeps
  `jax.lax.top_k`'s pairs in its order; each family's narrowphase on
  those pairs is held against the JAX collider on them (`_hold_family`):
  box-box at 5e-5; MPR by tests/test_torch_convex.py's rules, as its
  witness on a flat support (a cylinder's cap or side, a box's face)
  moves with rounding: the base contact found in the same pairs, its
  dist and normal at 5e-5 in all but F32_SHARE, its point along the
  normal at 5e-5, at most SLOT_SHARE of the pairs with another number of
  contacts. The pool (`_hold_pool`): ncon exactly; ncollision differs
  by the candidates active in one package only, each of which rests on
  a face (|dist| under RESTING in one package), has a cylinder, or lies
  in a pair let part above (another number of contacts, or the base
  contact off); in at least SAME_SHARE of the worlds both packages'
  first nconmax active candidates are the same, and there the pool
  exactly (geom ids and order, dist and frame at 5e-5, pos along the
  normal); in every world the pool's pairs in order, one package's a
  prefix of the other's.
* The same scene under the threshold: the static driver's groups take
  cylinder-cylinder and cylinder-box through MPR and cull them as the
  JAX driver does; its pool against JAX `collision` by ncon and pair
  order.
* kitchen at 2 worlds (world 0 at qpos0, the suite's start; world 1 with
  the joints drawn across their ranges, `_rich`, where cylinders touch
  boxes and cylinders), against one `jax.jit(forward.step_batched)` of
  the JAX package (compiled once in the run, `torch_parity.shared`):
  - B1's plain version against the JAX step's smooth outputs at 2e-5
    and against C MuJoCo's mj_kinematics, mj_comPos and mj_crb (float64)
    at 2e-5;
  - the port's `collision` on the JAX step's geom frames, by the
    synthetic scene's rules (`_hold_families`, `_hold_pool`), with
    three culled families; world 0's pool exactly. Kitchen's boxes rest
    face on face: where the port's rounded products give such a pair
    dist 0 (no contact), XLA's contracted ones give -1e-8 (a contact,
    counted in ncollision; the pool is full before them);
  - one port step against the JAX step, the `collision` stage giving
    the JAX step's pool: the rows, the solve by its objective, qacc at
    QACC_TOL, qvel and qpos at h times that; and the step on its own
    kinematics, whose pool may part from JAX's where B1's rounding moves
    a resting contact (|dist| under 2e-5) in or out of the cull's 128
    pairs or the pool, or where a cylinder's MPR finds another number of
    contacts: every geom pair of one pool missing from the other is of
    one of these kinds. Its solver_niter at qpos0 against C MuJoCo's
    mj_step from the same state, within NITER_C.
"""

import mujoco
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import importlib

import mujoco_warp_tpu as mjwt
from mujoco_warp_tpu import collision_convex as jcc
from mujoco_warp_tpu import collision_primitive as jcp
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import (collision_driver, collision_sap, forward,
                                   io, models, smooth, solver)
from mujoco_warp_tpu_torch.io import efc_layout
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch.kernels import smooth as ks
from mujoco_warp_tpu_torch.types import GeomType

from test_torch_aloha import OBJ_UNITS, QACC_TOL, ROW_TOL, TOL
from test_torch_convex import F32_SHARE, SLOT_SHARE
from test_torch_kernels import smooth_block_host
from test_torch_step import STEP_TOL
from torch_parity import assert_close, build_sap, shared

jforward = importlib.import_module('mujoco_warp_tpu.forward')

NCONMAX = 64
FAMILIES = [(5, 5, 0, 16842), (5, 6, 16842, 115674), (6, 6, 132516, 103132)]
STAGES = ['smooth_mega[cuda]', 'camlight', 'collision', 'make_constraint',
          'transmission', 'velocity_glue', 'passive', 'fwd_actuation',
          'fwd_acceleration', 'solve', 'euler']
SMOOTH_TOL = 2e-5
# a contact resting on a face: |dist| under this (B1's rounding moves it
# in or out of the cull's pairs or the pool)
RESTING = 2e-5
# the least share of worlds whose pools take the same candidates in both
# packages (measured: kitchen 1 of 2, world 0 at qpos0; the synthetic
# scene 5 of 6)
SAME_SHARE = 0.5
# solver_niter at qpos0 (the suite's start) against C MuJoCo's, which
# solves every contact (667 there; no pool of 64) in float64 (measured:
# port and JAX 2, C MuJoCo 1). In the rich world the pool keeps 64 of C
# MuJoCo's 197 contacts, and the counts are printed only (port 7, JAX 6,
# C MuJoCo 1)
NITER_C = 2


@pytest.fixture(scope='module')
def kitchen():
  mjm = mujoco.MjModel.from_xml_path(models.KITCHEN)
  return mjm, mt.put_model(mjm, device='cpu')


def _rich(mjm, m, seed=0):
  """qpos (nq,) float32 with the joints drawn across their ranges: of 16
  seeded candidates, the first whose pool (the port's collision on its
  kinematics) holds cylinder-cylinder and cylinder-box contacts."""
  rng = np.random.default_rng(seed)
  n = 16
  q = np.tile(mjm.qpos0, (n, 1))
  for j in range(mjm.njnt):
    q[:, mjm.jnt_qposadr[j]] = rng.uniform(*mjm.jnt_range[j], n)
  q = q.astype(np.float32)
  sm = smooth.smooth(m, torch.tensor(q), torch.zeros(n, mjm.nv))
  con = collision_sap.collision(m, sm['geom_xpos'], sm['geom_xmat'], NCONMAX)
  t = np.asarray(m.geom_type)
  g = con['geom'].numpy()
  kinds = [{(t[a], t[b]) for a, b in g[w] if a >= 0} for w in range(n)]
  w = next(w for w in range(n) if {(5, 5), (5, 6)} <= kinds[w])
  return q[w]


def _states(mjm, m):
  """(qpos, qvel) float32 of the two worlds."""
  q = np.stack([mjm.qpos0, _rich(mjm, m)]).astype(np.float32)
  v = np.stack([np.zeros(mjm.nv), 0.1 * np.random.default_rng(1)
                .standard_normal(mjm.nv)]).astype(np.float32)
  return dict(qpos=q, qvel=v)


_REFERENCE = {}


def _jax_reference():
  """One jax.jit(forward.step_batched) of the JAX package from `_states`
  at 2 worlds, as numpy (computed once a run, `torch_parity.shared`, and
  kept by the process)."""
  if _REFERENCE:
    return _REFERENCE['value']

  def make():
    mjm = mujoco.MjModel.from_xml_path(models.KITCHEN)
    jm = mjwt.put_model(mjm)
    fields = _states(mjm, mt.put_model(mjm, device='cpu'))
    jd = mjwt.make_data(jm, nconmax=NCONMAX)
    batch = jax.vmap(lambda q, v: jd.replace(qpos=q, qvel=v))(
        jnp.asarray(fields['qpos']), jnp.asarray(fields['qvel']))
    out = jax.jit(lambda dd: jforward.step_batched(jm, dd))(batch)
    return dict(fields=fields, out=jax.tree.map(np.asarray, out))
  _REFERENCE['value'] = shared('kitchen', make)
  return _REFERENCE['value']


def test_kitchen_npz_matches_put_model(kitchen):
  _, m = kitchen
  loaded = io.load_model(models.KITCHEN_NPZ, device='cpu')
  a, sa = io.model_to_numpy(m)
  b, sb = io.model_to_numpy(loaded)
  assert sa == sb
  assert sorted(a) == sorted(b)
  for k in a:
    np.testing.assert_array_equal(a[k], b[k], k)


def test_kitchen_takes_the_large_scene_broadphase(kitchen):
  """The families and their colliders, the stage list, the efc layout
  and B1's block."""
  _, m = kitchen
  assert [tuple(f) for f in m.sap_families] == FAMILIES
  assert m.collision_pairs == () and m.nxn_candidates == 235648
  d = mt.make_data(m, nconmax=NCONMAX, nworld=2)
  assert [n for n, _ in forward.batched_stages(m, d)] == STAGES
  assert not forward.replays(m, d) and not kc.supports(m, NCONMAX)
  assert not forward.uses_glue_kernel(m, d)
  fams = collision_sap.sap_tables(m)['families']
  assert [(f['slots'], f['extra']) for f in fams] == [
      (5, 'hulls+margin'), (5, 'hulls+margin'), (8, 'margin')]
  kept = [collision_sap.family_slots(n, NCONMAX) for *_, n in FAMILIES]
  assert kept == [128] * 3
  assert sum(k * f['slots'] for k, f in zip(kept, fams)) == 2304
  assert efc_layout(m, NCONMAX) == (0, 1, 62, 4, 319)
  # B1: 14,716 words a world, 3 worlds a block at 32 lanes
  nnz = ks.tree_tables(m.body_parentid, m.dof_parentid)['nnz']
  assert ks._block(smooth_block_host(), m, nnz) == (4 * 14716, 3)


def test_kitchen_model_matches_jax(kitchen):
  mjm, m = kitchen
  jm = mjwt.put_model(mjm)
  assert m.sap_families == jm.sap_meta.families == tuple(FAMILIES)
  assert jm.sap_meta.plane_groups == ()
  np.testing.assert_array_equal(m.sap_pairs.numpy(), np.asarray(jm.sap_pairs))
  np.testing.assert_array_equal(m.sap_pairid.numpy(),
                                np.asarray(jm.sap_pairid))
  assert m.nxn_candidates == jm.nxn_candidates
  assert efc_layout(m, NCONMAX) == tuple(mjwt.io.efc_layout(jm, NCONMAX))


def test_kitchen_smooth_matches_mujoco_and_jax(kitchen):
  """B1's plain version on kitchen's 328 bodies against the JAX step's
  smooth outputs and against C MuJoCo (float64) at SMOOTH_TOL."""
  mjm, m = kitchen
  ref = _jax_reference()
  q, v = ref['fields']['qpos'], ref['fields']['qvel']
  out = smooth.smooth(m, torch.tensor(q), torch.tensor(v))
  new = ref['out']
  for name in smooth.OUTPUTS:
    if name != 'qpos':
      assert_close(out[name].numpy(), getattr(new, name), name, SMOOTH_TOL)
  d = mujoco.MjData(mjm)
  for w in range(2):
    d.qpos[:] = q[w]
    mujoco.mj_kinematics(mjm, d)
    mujoco.mj_comPos(mjm, d)
    mujoco.mj_crb(mjm, d)
    mujoco.mj_makeM(mjm, d)
    qm = np.zeros((mjm.nv, mjm.nv))
    mujoco.mj_fullM(mjm, d, qm)
    # a subtree of no mass (kitchen's two hinged shelf groups): C MuJoCo
    # puts its com at the body's xipos, the JAX package (and the port) at
    # 0; no stage reads it there (cinert and cdof read the root's)
    com = d.subtree_com.copy()
    com[mjm.body_subtreemass < mujoco.mjMINVAL] = 0.0
    for name, c in (('xpos', d.xpos), ('xquat', d.xquat),
                    ('xmat', d.xmat), ('xipos', d.xipos),
                    ('geom_xpos', d.geom_xpos), ('geom_xmat', d.geom_xmat),
                    ('site_xpos', d.site_xpos), ('site_xmat', d.site_xmat),
                    ('xanchor', d.xanchor), ('xaxis', d.xaxis),
                    ('subtree_com', com), ('cinert', d.cinert),
                    ('cdof', d.cdof), ('crb', d.crb), ('qM', qm)):
      assert_close(out[name][w].numpy(), c, f'{name} against C MuJoCo',
                   SMOOTH_TOL)


def _assert_pool(con, new, worlds=None):
  """The port's pool against the JAX pool in `worlds` (all by default):
  ncon, geom ids and order exactly, dist, frame and the parameters at
  TOL, pos along the normal at TOL."""
  w = slice(None) if worlds is None else worlds
  np.testing.assert_array_equal(con['ncon'].numpy()[w], new.ncon[w])
  np.testing.assert_array_equal(con['geom'].numpy()[w], new.contact.geom[w])
  np.testing.assert_array_equal(con['dim'].numpy()[w], new.contact.dim[w])
  for k in ('dist', 'frame', 'includemargin', 'friction', 'solref',
            'solreffriction', 'solimp'):
    assert_close(con[k].numpy()[w], getattr(new.contact, k)[w], k, TOL)
  dpos = con['pos'].numpy()[w] - new.contact.pos[w]
  assert_close((dpos * new.contact.frame[w][..., 0, :]).sum(-1),
               np.zeros(dpos.shape[:-1]), 'pos', TOL)


def test_kitchen_collision_matches_jax(kitchen):
  mjm, m = kitchen
  new = _jax_reference()['out']
  active, jactive, loose, culled, _ = _hold_families(
      m, mjwt.put_model(mjm), new, NCONMAX)
  assert culled == 3
  gx, gm = torch.tensor(new.geom_xpos), torch.tensor(new.geom_xmat)
  con = collision_sap.collision(m, gx, gm, NCONMAX)
  assert (con['ncon'] == NCONMAX).all()
  same = _hold_pool(con, new, active, jactive, loose, NCONMAX)
  assert same[0]
  t = np.asarray(m.geom_type)
  g = new.contact.geom[1]
  assert {(5, 5), (5, 6), (6, 6)} <= {(t[a], t[b]) for a, b in g if a >= 0}


def _hold_step(m, d, new):
  """One port step d against the JAX step new: the counts, everything
  before the solve and the rows; the solve by its objective, qacc at
  QACC_TOL of scale, qvel and qpos at h times qacc's and qvel's."""
  for k in ('ncon', 'ne', 'nf', 'nl', 'nefc'):
    np.testing.assert_array_equal(getattr(d, k).numpy(), getattr(new, k), k)
  for name, tol in STEP_TOL:
    if name not in ('qpos', 'qvel', 'qacc', 'qfrc_constraint'):
      assert_close(getattr(d, name).numpy(), getattr(new, name), name, tol)
  np.testing.assert_array_equal(d.efc_active.numpy(), new.efc_active)
  assert_close(d.efc_J.numpy(), new.efc_J * new.efc_active[..., None],
               'efc_J', TOL)
  ne, nf, nl, _, _ = efc_layout(m, NCONMAX)
  base = ne + nf + nl
  for k in ('efc_D', 'efc_aref', 'efc_pos', 'efc_frictionloss'):
    a, b = getattr(d, k).numpy(), getattr(new, k)
    assert_close(a[:, :base], b[:, :base], k, TOL)
    assert_close(a[:, base:], b[:, base:], k, ROW_TOL)
  x = [getattr(d, k).double() for k in ('qM', 'efc_J', 'efc_D', 'efc_aref',
                                        'efc_frictionloss', 'qfrc_smooth')]
  qsm = torch.linalg.solve(x[0], x[5])
  cost = [solver.objective(*x, qsm, qa.double(), ne, nf)
          for qa in (d.qacc, torch.tensor(new.qacc))]
  unit = float(m.opt.tolerance * m.stat.meaninertia * m.nv)
  assert (cost[0] <= cost[1] + OBJ_UNITS * unit).all(), (cost, unit)
  assert_close(d.qacc.numpy(), new.qacc, 'qacc', QACC_TOL)
  h = float(m.opt.timestep)
  dv = QACC_TOL * h * max(1.0, float(np.abs(new.qacc).max()))
  np.testing.assert_allclose(d.qvel.numpy(), new.qvel, rtol=0, atol=dv)
  np.testing.assert_allclose(d.qpos.numpy(), new.qpos, rtol=0,
                             atol=max(5e-6 * float(np.abs(new.qpos).max()),
                                      h * dv))


def test_kitchen_step_matches_jax(kitchen):
  mjm, m = kitchen
  ref = _jax_reference()
  new, fields = ref['out'], ref['fields']
  t = np.asarray(m.geom_type)
  # the step on its own kinematics: a geom pair of one pool missing from
  # the other rests on a face (B1's rounding moves it in or out of the
  # cull's pairs or the pool) or has a cylinder (MPR's flat supports:
  # another number of contacts, test_torch_kitchen's collision test)
  d = mt.step_batched(m, mt.data_from_numpy(m, fields, nconmax=NCONMAX))
  np.testing.assert_array_equal(d.ncon.numpy(), new.ncon)
  parted = 0
  for w in range(2):
    a = {tuple(g): i for i, g in enumerate(d.contact.geom[w].tolist())}
    b = {tuple(g): i for i, g in enumerate(new.contact.geom[w].tolist())}
    for g in set(a) ^ set(b):
      dist = (float(d.contact.dist[w, a[g]]) if g in a else
              float(new.contact.dist[w, b[g]]))
      assert abs(dist) < RESTING or GeomType.CYLINDER in t[list(g)], (
          w, g, dist)
      parted += 1
  print(f'geom pairs in one pool and not the other: {parted}')
  # the same step with `collision` giving the JAX step's pool: the rows,
  # the solve and the advance in every world
  jpool = {k: torch.tensor(getattr(new.contact, k)) for k in (
      'dist', 'pos', 'frame', 'includemargin', 'friction', 'solref',
      'solreffriction', 'solimp', 'dim', 'geom')}
  jpool.update(ncon=torch.tensor(new.ncon),
               ncollision=torch.tensor(new.ncollision))
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(collision_sap, 'collision', lambda *args: dict(jpool))
    d = mt.step_batched(m, mt.data_from_numpy(m, fields, nconmax=NCONMAX))
  np.testing.assert_array_equal(d.contact.geom.numpy(), new.contact.geom)
  _hold_step(m, d, new)
  # solver_niter against C MuJoCo from the same state
  cd = mujoco.MjData(mjm)
  for w in range(2):
    cd.qpos[:], cd.qvel[:] = fields['qpos'][w], fields['qvel'][w]
    mujoco.mj_step(mjm, cd)
    niter = int(cd.solver_niter[0])
    print(f'world {w}: solver_niter port {int(d.solver_niter[w])}, JAX '
          f'{int(new.solver_niter[w])}, C MuJoCo {niter} ({cd.ncon} '
          f'contacts)')
    if w == 0:
      assert abs(int(d.solver_niter[w]) - niter) <= NITER_C


def _synthetic() -> str:
  """A 10 x 10 grid of boxes and three cylinder posts on the world body,
  under four cylinders (a disk of radius 0.4 lying on the grid, a long
  one lying on the disk, an upright one on a corner of the grid, a short
  one on the posts), a box and a mesh (an irregular hull of 8 vertices)
  on free bodies, all margins 0. The mesh's contype pairs it with boxes
  only, so that the families are cylinder-cylinder (18 pairs),
  cylinder-box (407: the disk's box overlaps some 81 grid boxes, past the
  64 a family keeps at nconmax 8, their slacks tied), box-box (100) and
  box-mesh (101)."""
  grid = ''.join(
      f'<geom type="box" size=".05 .05 .05" pos="{0.1 * i - 0.45:.2f} '
      f'{0.1 * j - 0.45:.2f} 0" contype="3" conaffinity="3"/>'
      for i in range(10) for j in range(10))
  posts = ''.join(f'<geom type="cylinder" size=".03 .1" pos="{x} {y} .15"/>'
                  for x, y in ((0.65, 0), (0.65, 0.1), (-0.65, 0)))
  hull = ' '.join(f'{x} {y} {z}' for x, y, z in (
      (-.05, -.04, -.03), (.05, -.04, -.03), (-.05, .04, -.03),
      (.05, .04, -.03), (-.03, -.02, .03), (.04, -.03, .03),
      (-.03, .03, .03), (.02, .02, .04)))
  return f"""<mujoco><asset><mesh name="hull" vertex="{hull}"/></asset>
  <worldbody>{grid}{posts}
  <body pos="0 0 .069"><freejoint/>
    <geom type="cylinder" size=".4 .02"/></body>
  <body pos=".05 .05 .118"><freejoint/>
    <geom type="cylinder" size=".03 .25" euler="0 90 30"/></body>
  <body pos="-.42 .42 .109"><freejoint/>
    <geom type="cylinder" size=".04 .06"/></body>
  <body pos=".65 .05 .279"><freejoint/>
    <geom type="cylinder" size=".03 .03" euler="90 0 0"/></body>
  <body pos=".42 -.42 .089"><freejoint/>
    <geom type="box" size=".06 .06 .04" euler="0 0 20" contype="3"
          conaffinity="3"/></body>
  <body pos="-.42 -.42 .079"><freejoint/>
    <geom type="mesh" mesh="hull" contype="2" conaffinity="2"/></body>
  </worldbody></mujoco>"""


SYNTH_NWORLD = 6
SYNTH_NCONMAX = 8


def _synthetic_states(mjm) -> np.ndarray:
  """World 0 at qpos0; the others with each free body moved up to 3 cm
  in x and y, -4..2 mm in z, and turned up to 0.1 rad about a random
  axis."""
  rng = np.random.default_rng(0)
  q = np.tile(mjm.qpos0, (SYNTH_NWORLD, 1))
  for w in range(1, SYNTH_NWORLD):
    for b in range(mjm.nbody - 1):
      q[w, 7 * b:7 * b + 2] += rng.uniform(-0.03, 0.03, 2)
      q[w, 7 * b + 2] += rng.uniform(-0.004, 0.002)
      axis = rng.standard_normal(3)
      angle = rng.uniform(0, 0.1)
      dq = np.r_[np.cos(angle / 2),
                 np.sin(angle / 2) * axis / np.linalg.norm(axis)]
      mujoco.mju_mulQuat(q[w, 7 * b + 3:7 * b + 7],
                         q[w, 7 * b + 3:7 * b + 7].copy(), dq)
  return q.astype(np.float32)


@pytest.fixture(scope='module')
def synthetic():
  """The synthetic scene in both packages, its states, and JAX
  `collision` on them (the JAX driver sends the model to
  `collision_sap.collision`; computed once a run,
  `torch_parity.shared`)."""
  from mujoco_warp_tpu import collision_driver as jcd
  from mujoco_warp_tpu import smooth as jsmooth
  mjm, jm, m = build_sap(_synthetic(), threshold=1)

  def make():
    q = _synthetic_states(mjm)
    jd = mjwt.make_data(jm, nconmax=SYNTH_NCONMAX)
    new = jax.jit(jax.vmap(lambda qq: jcd.collision(
        jm, jsmooth.kinematics(jm, jd.replace(qpos=qq)))))(jnp.asarray(q))
    return jax.tree.map(np.asarray, new)
  return mjm, jm, m, shared('synthetic_mpr', make)


def _jax_family(jm, t1, t2, g1, g2, gx, gm):
  """The JAX collider of a family on per-world pairs (W, kk) of geom ids,
  given what `_run_family` gives it (hulls, margin 0): (dist, pos,
  frame) numpy (W, kk, k, ...)."""
  fn = jcp.COLLIDERS.get((t1, t2))
  size = np.asarray(jm.geom_size)
  w = np.arange(g1.shape[0])[:, None]
  args = [gx[w, g1], gm[w, g1], size[g1], gx[w, g2], gm[w, g2], size[g2]]
  if fn is None:
    fn = jcc.collider(t1, t2, int(jm.opt.disableflags))[0]
    small, did = np.asarray(jm.mesh_hullvert_small), np.asarray(
        jm.geom_dataid)
    hull = lambda g, t: (small[did[g]] if t == GeomType.MESH else
                         np.zeros(g.shape + (1, 4), np.float32))
    args += [hull(g1, t1), hull(g2, t2), np.zeros(g1.shape, np.float32)]
  elif (t1, t2) in jcp.NEEDS_MARGIN:
    args.append(np.zeros(g1.shape, np.float32))
  out = jax.jit(jax.vmap(jax.vmap(fn)))(*[jnp.asarray(a) for a in args])
  return [np.asarray(x) for x in out]


def _hold_family(label, mpr, out, ref, valid, out64):
  """A family's candidates (dist, pos, frame), (W, kk, k, ...), against
  the JAX collider's on the same pairs, over the pairs that overlap: the
  base contact (slot 0, the deepest of a box-box manifold) found in the
  same pairs, at most SLOT_SHARE of the pairs with another number of
  contacts (a point on a clipping boundary or, for MPR, a flat support);
  MPR's dist and normal at TOL in all but F32_SHARE of the base
  contacts, its point along the normal at TOL
  (tests/test_torch_convex.py); a box-box pair's deepest dist and its
  normal at TOL, and where it has as many contacts in both, every
  contact within TOL of one of JAX's (dist, point of scale, normal). A
  box-box pair off in its deepest contact must be one
  where JAX's float32 collider under jit parts from the same collider in
  float64 (`out64`, the port's), which the port's float32 one meets at
  TOL (measured: one pair of two doors of kitchen's rich state, JAX
  -1.466 where the port, both packages in float64, JAX eager and C
  MuJoCo give -0.00845), in at most F32_SHARE of the pairs. Returns
  (W, kk, k) the port's and JAX's active candidates and (W, kk) the
  pairs let part above: another number of contacts, or the base
  contact off."""
  dist, pos, frame = (x.numpy() for x in out)
  jdist, jpos, jframe = ref
  dist = np.where(valid[..., None], dist, 1e10)
  jdist = np.where(valid[..., None], jdist, 1e10)
  hit = jdist[..., 0] < 1e9
  np.testing.assert_array_equal(dist[..., 0] < 1e9, hit)
  count, jcount = (dist < 1e9).sum(-1), (jdist < 1e9).sum(-1)
  slots = int((count != jcount)[hit].sum())
  normal = jframe[hit][:, 0, 0]
  off = ((np.abs(dist[hit][:, 0] - jdist[hit][:, 0]) > TOL) |
         (np.abs(frame[hit][:, 0, 0] - normal) > TOL).any(-1))
  parted = hit & (count != jcount)
  parted[hit] |= off
  print(f'{label}: {int(hit.sum())} base contacts, {int(off.sum())} off '
        f'by more than {TOL} in dist or normal; pairs with another number '
        f'of contacts: {slots}')
  assert slots <= SLOT_SHARE * max(1, hit.sum()), slots
  if mpr:
    dpos = pos[hit][:, 0] - jpos[hit][:, 0]
    np.testing.assert_allclose((dpos * normal).sum(-1), 0, rtol=0, atol=TOL)
    assert off.sum() <= F32_SHARE * hit.sum(), off.sum()
    return dist < 0, jdist < 0, parted
  if off.any():
    d64 = np.where(valid[..., None], out64[0].numpy(), 1e10)[hit][off, 0]
    n64 = out64[2].numpy()[hit][off, 0, 0]
    ok = ((np.abs(dist[hit][off, 0] - d64) <= TOL) &
          (np.abs(frame[hit][off, 0, 0] - n64) <= TOL).all(-1))
    print(f'{label}: the pairs off, deepest dist: port {dist[hit][off, 0]}, '
          f'JAX {jdist[hit][off, 0]}, float64 {d64}')
    assert ok.all() and off.sum() <= F32_SHARE * hit.sum()
  alike = hit & (count == jcount)
  alike[hit] &= ~off
  # each contact of such a pair against the nearest of JAX's: contacts
  # of equal depth (corners of a face resting on a face) come in either
  # order
  live = (dist < 1e9) & alike[..., None]
  scale = max(1.0, float(np.abs(jpos[jdist < 1e9]).max()))
  err = np.maximum(np.maximum(
      np.abs(dist[..., :, None] - jdist[..., None, :]),
      np.abs(pos[..., :, None, :] - jpos[..., None, :, :]).max(-1) / scale),
      np.abs(frame[..., :, None, 0, :] - jframe[..., None, :, 0, :]).max(-1))
  err = np.where((jdist < 1e9)[..., None, :], err, np.inf).min(-1)
  assert (err[live] <= TOL).all(), float(err[live].max())
  # a face resting on a face (kitchen's boxes): the port's rounded
  # products give dist 0 (no contact) where XLA's contracted ones give
  # -1e-8
  flip = live & ((dist < 0) != (jdist < 0))
  assert (dist[flip] == 0).all() and (jdist[flip] > -TOL).all()
  return dist < 0, jdist < 0, parted


def _hold_families(m, jm, new, nconmax):
  """Each family's kept pairs and narrowphase on the JAX step's geom
  frames against the JAX package's: a culled family's pairs and their
  overlaps exactly against `jax.lax.top_k` on JAX's slacks, the
  narrowphase on them by `_hold_family`. Returns the port's and JAX's
  (W, candidates) active candidates, the candidates that may be active
  in one package only (|dist| under RESTING in one package, a cylinder
  on one side, or a pair that `_hold_family` lets part), the culled
  families and the worlds that drop overlaps there."""
  W = new.geom_xpos.shape[0]
  gx, gm = torch.tensor(new.geom_xpos), torch.tensor(new.geom_xmat)
  tables = collision_sap.sap_tables(m)
  m64 = m.replace(geom_size=m.geom_size.double(),
                  mesh_hullvert_small=m.mesh_hullvert_small.double())
  cw, hw = collision_sap.world_aabbs(m, gx, gm)
  ac, ah = jm.geom_aabb[:, 0], jm.geom_aabb[:, 1]
  jcw = new.geom_xpos + np.asarray(jnp.einsum('wnij,nj->wni', new.geom_xmat,
                                              ac))
  jhw = np.asarray(jnp.einsum('wnij,nj->wni', jnp.abs(new.geom_xmat), ah) +
                   jm.geom_margin[:, None])
  active, jactive, loose, culled, drops = [], [], [], 0, 0
  for (t1, t2, start, count), fam in zip(m.sap_families, tables['families']):
    kk = collision_sap.family_slots(count, nconmax)
    g1, g2 = fam['g1'], fam['g2']
    if kk < count:
      culled += 1
      sel, valid, nover = collision_sap.cull(cw, hw, g1, g2, kk)
      a, b = g1.numpy(), g2.numpy()
      sl = np.min(jhw[:, a] + jhw[:, b] - np.abs(jcw[:, a] - jcw[:, b]), -1)
      jsel = np.asarray(jax.lax.top_k(jnp.where(sl >= 0, sl, -jnp.inf),
                                      kk)[1])
      np.testing.assert_array_equal(sel.numpy(), jsel)
      np.testing.assert_array_equal(nover.numpy(), (sl >= 0).sum(1))
      drops += int((nover > kk).sum())
    else:
      sel = torch.arange(count).expand(W, count)
      valid = collision_sap.slack(cw, hw, g1, g2) >= 0
    out = collision_driver.narrowphase(
        m, fam, gx, gm, tables['params']['margin'][start + sel], sel)
    ref = _jax_family(jm, t1, t2, g1[sel].numpy(), g2[sel].numpy(),
                      new.geom_xpos, new.geom_xmat)
    out64 = collision_driver.narrowphase(
        m64, fam, gx.double(), gm.double(),
        tables['params']['margin'][start + sel].double(), sel)
    act, jact, parted = _hold_family(
        (t1, t2), fam['extra'] == 'hulls+margin', out, ref, valid.numpy(),
        out64)
    active.append(act.reshape(W, -1))
    jactive.append(jact.reshape(W, -1))
    near = np.minimum(*(np.abs(np.where(valid[..., None], x, 1e10))
                        for x in (out[0].numpy(), ref[0])))
    loose.append(((near < RESTING) | (GeomType.CYLINDER in (t1, t2)) |
                  parted[..., None]).reshape(W, -1))
  return (np.concatenate(active, 1), np.concatenate(jactive, 1),
          np.concatenate(loose, 1), culled, drops)


def _hold_pool(con, new, active, jactive, loose, nconmax):
  """The port's pool `con` against the JAX pool of `new`, given each
  package's (W, candidates) active candidates and those that may be
  active in one package only (`loose`): ncon exactly; ncollision
  differs by the candidates active in one package only, every one of
  them `loose`; in at least SAME_SHARE of the worlds the first nconmax
  active candidates are the same, and there the pool exactly
  (`_assert_pool`); in every world the pool's pairs in order, one
  package's a prefix of the other's (a pair of another number of active
  slots leaves more or less room in the full pool for the pairs after
  it). Returns the worlds of the first kind."""
  W = active.shape[0]
  np.testing.assert_array_equal(con['ncon'].numpy(), new.ncon)
  np.testing.assert_array_equal(
      con['ncollision'].numpy() - new.ncollision,
      active.sum(1) - jactive.sum(1))
  first = lambda act: [tuple(np.nonzero(a)[0][:nconmax]) for a in act]
  same = np.array([a == b for a, b in zip(first(active), first(jactive))])
  one = active != jactive
  print(f'worlds whose pools take the same candidates: {int(same.sum())} '
        f'of {W}; candidates active in one package only: '
        f'{one.sum(1).tolist()}, of which neither resting, with a '
        f'cylinder nor in a pair let part: {(one & ~loose).sum(1).tolist()}')
  assert (loose | ~one).all()
  assert same.sum() >= SAME_SHARE * W
  _assert_pool(con, new, same)
  for w in range(W):
    seq = [_pairs(con['geom'].numpy()[w]), _pairs(new.contact.geom[w])]
    n = min(len(x) for x in seq)
    assert seq[0][:n] == seq[1][:n] and n > 0, (w, seq)
  return same


def _pairs(geom) -> list:
  """The pool's geom pairs in order, a pair's slots once."""
  out = []
  for g in map(tuple, geom.tolist()):
    if g[0] >= 0 and (not out or out[-1] != g):
      out.append(g)
  return out


@pytest.mark.parametrize('chunk', ['one', 'of_30'])
def test_synthetic_mpr_families_match_jax(synthetic, chunk, monkeypatch):
  mjm, jm, m, new = synthetic
  assert m.sap_families == jm.sap_meta.families
  assert [(a, b, n) for a, b, _, n in m.sap_families] == [
      (5, 5, 18), (5, 6, 407), (6, 6, 100), (6, 7, 101)]
  if chunk == 'of_30':
    monkeypatch.setattr(collision_sap, 'CHUNK_ELEMENTS', SYNTH_NWORLD * 30)
  active, jactive, loose, culled, drops = _hold_families(m, jm, new,
                                                         SYNTH_NCONMAX)
  assert culled == 3 and drops >= SYNTH_NWORLD - 1
  W, C = SYNTH_NWORLD, SYNTH_NCONMAX
  gx, gm = torch.tensor(new.geom_xpos), torch.tensor(new.geom_xmat)
  con = collision_sap.collision(m, gx, gm, C)
  _hold_pool(con, new, active, jactive, loose, C)
  t = np.asarray(m.geom_type)
  kinds = {(t[a], t[b]) for g in new.contact.geom for a, b in g if a >= 0}
  assert {(5, 5), (5, 6)} <= kinds


def test_static_driver_takes_the_cylinder_pairs_as_jax_does():
  """The synthetic scene under the large-scene threshold: the static
  driver's groups, their colliders (MPR, 5 slots, for cylinder-cylinder
  and cylinder-box) and culls (past 64 MPR or mesh pairs, past 2,048
  others: cylinder-box and box-mesh culled to max(4 nconmax, 64)) as the
  JAX driver's (`collision_driver.py:291-317`), and its pool against JAX
  `collision` on the JAX frames: ncon exactly, the pool's pairs in
  order (one package's a prefix of the other's, `_hold_pool`'s rule)."""
  from mujoco_warp_tpu import collision_driver as jcd
  from mujoco_warp_tpu import smooth as jsmooth
  mjm = mujoco.MjModel.from_xml_string(_synthetic())
  jm, m = mjwt.put_model(mjm), mt.put_model(mjm, device='cpu')
  assert m.sap_families == () and m.collision_pairs == jm.collision_pairs
  groups = collision_driver._group_tables(m)
  assert [(t1, t2, len(g)) for t1, t2, g in m.collision_pairs] == [
      (5, 5, 18), (5, 6, 407), (6, 6, 100), (6, 7, 101)]
  assert [(g['slots'], g['extra'], g['cull']) for g in groups] == [
      (5, 'hulls+margin', False), (5, 'hulls+margin', True),
      (8, 'margin', False), (5, 'hulls+margin', True)]
  assert collision_driver.culls(5, 5, 65) and not collision_driver.culls(
      5, 6, 64)
  assert not any(kc.supports(m, n) for n in (1, SYNTH_NCONMAX))
  q = _synthetic_states(mjm)
  jd = mjwt.make_data(jm, nconmax=SYNTH_NCONMAX)
  new = jax.tree.map(np.asarray, jax.jit(jax.vmap(lambda qq: jcd.collision(
      jm, jsmooth.kinematics(jm, jd.replace(qpos=qq)))))(jnp.asarray(q)))
  con = collision_driver.collision(m, torch.tensor(new.geom_xpos),
                                   torch.tensor(new.geom_xmat),
                                   SYNTH_NCONMAX)
  np.testing.assert_array_equal(con['ncon'].numpy(), new.ncon)
  for w in range(SYNTH_NWORLD):
    seq = [_pairs(con['geom'].numpy()[w]), _pairs(new.contact.geom[w])]
    n = min(len(x) for x in seq)
    assert seq[0][:n] == seq[1][:n] and n > 0, (w, seq)
