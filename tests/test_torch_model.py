"""The port's model compiler and state allocation against the JAX
package: put_model, model_from_numpy and the committed humanoid.npz give
the JAX Model's shared leaves, and make_data the JAX make_data (exact:
integers equal, float copies equal)."""

import dataclasses

import mujoco
import numpy as np
import pytest
import torch

import mujoco_warp_tpu as mjwt
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import io, models, types

from torch_parity import ALL_SCENES, build


def _jax_static(jm, name):
  """The JAX Model's value of the port's static `name`: the port keeps
  the SAP families of the JAX package's sap_meta alone."""
  if name == 'sap_families':
    return jm.sap_meta.families if jm.sap_meta else ()
  return getattr(jm, name)


# the port's statics that the JAX Model has not: the keyframe names
# (`find_keys` reads them from a loaded .npz; held against the MJCF in
# test_aloha_model_matches_jax of test_torch_aloha.py)
_PORT_ONLY = ('key_names',)


def _assert_model_equal(m, jm):
  for name in types.MODEL_STATICS:
    if name in _PORT_ONLY:
      continue
    assert getattr(m, name) == _jax_static(jm, name), name
  for name in types.OPTION_STATICS:
    assert getattr(m.opt, name) == getattr(jm.opt, name), name
  for name in types.MODEL_TENSORS:
    np.testing.assert_array_equal(getattr(m, name).numpy(),
                                  np.asarray(getattr(jm, name)), name)
  for name in types.OPTION_TENSORS:
    np.testing.assert_array_equal(getattr(m.opt, name).numpy(),
                                  np.asarray(getattr(jm.opt, name)), name)
  np.testing.assert_array_equal(m.stat.meaninertia.numpy(),
                                np.asarray(jm.stat.meaninertia))


@pytest.mark.parametrize('scene', ALL_SCENES)
def test_put_model_matches_jax(scene):
  _, jm, m = build(scene)
  _assert_model_equal(m, jm)


def test_model_from_numpy_takes_jax_leaves():
  _, jm, m = build('humanoid')
  leaves = {k: np.asarray(getattr(jm, k)) for k in types.MODEL_TENSORS}
  leaves.update({'opt.' + k: np.asarray(getattr(jm.opt, k))
                 for k in types.OPTION_TENSORS})
  leaves['stat.meaninertia'] = np.asarray(jm.stat.meaninertia)
  statics = {k: getattr(m, k) if k in _PORT_ONLY else _jax_static(jm, k)
             for k in types.MODEL_STATICS}
  statics['opt'] = {k: getattr(jm.opt, k) for k in types.OPTION_STATICS}
  _assert_model_equal(io.model_from_numpy(leaves, statics, device='cpu'),
                      jm)


@pytest.mark.parametrize('scene', ['humanoid', 'three_humanoids',
                                   'franka_emika_panda',
                                   'apptronik_apollo_flat', 'aloha_pot'])
def test_committed_npz_matches_jax(tmp_path, scene):
  """The committed .npz equals a fresh put_model of its MJCF (and so the
  JAX Model's shared leaves, camera, light and equality fields
  included)."""
  _, jm, m = build(scene)
  npz = {'humanoid': models.HUMANOID_NPZ,
         'three_humanoids': models.THREE_HUMANOIDS_NPZ,
         'franka_emika_panda': models.FRANKA_NPZ,
         'apptronik_apollo_flat': models.APOLLO_NPZ,
         'aloha_pot': models.ALOHA_POT_NPZ}[scene]
  _assert_model_equal(io.load_model(npz, device='cpu'), jm)
  path = str(tmp_path / 'm.npz')
  io.save_model(m, path)
  _assert_model_equal(io.load_model(path, device='cpu'), jm)


def test_three_humanoids_model():
  """The suite's scene: sizes, cameras and lights, options and the efc
  layout at nconmax 100."""
  m = io.load_model(models.THREE_HUMANOIDS_NPZ, device='cpu')
  assert (m.nq, m.nv, m.nbody, m.ngeom, m.njnt, m.nu) == (84, 81, 49, 58,
                                                          66, 63)
  assert (m.ncam, m.nlight) == (9, 10)
  assert set(m.cam_mode) == {0, 2} and set(m.light_mode) == {0, 2, 4}
  assert m.cam_mat0.shape == (9, 3, 3) and m.light_dir0.shape == (10, 3)
  assert m.opt.disableflags == 0 and m.opt.ls_parallel and m.has_damping
  assert m.nxn_candidates == 1614
  assert mt.efc_layout(m, 100) == (0, 0, 63, 4, 463)


@pytest.mark.parametrize('scene', ALL_SCENES)
def test_make_data_matches_jax(scene):
  _, jm, m = build(scene)
  jd = mjwt.make_data(jm, nconmax=8)
  d = mt.make_data(m, nconmax=8)
  for f in dataclasses.fields(d):
    if f.name == 'contact':
      continue
    a = getattr(d, f.name)
    assert a.shape[0] == 1, f.name
    np.testing.assert_array_equal(a[0].numpy(),
                                  np.asarray(getattr(jd, f.name)), f.name)
  for f in dataclasses.fields(d.contact):
    np.testing.assert_array_equal(
        getattr(d.contact, f.name)[0].numpy(),
        np.asarray(getattr(jd.contact, f.name)), f.name)


def test_efc_layout_matches_jax():
  _, jm, m = build('humanoid')
  for nconmax in (1, 24, 40):
    assert mt.efc_layout(m, nconmax) == mjwt.io.efc_layout(jm, nconmax)
  assert mt.efc_layout(m, 24) == (0, 0, 21, 4, 117)


def test_data_from_numpy_and_make_batch():
  _, _, m = build('humanoid')
  qpos = np.random.default_rng(0).standard_normal((3, m.nq))
  d = io.data_from_numpy(m, dict(qpos=qpos), nconmax=24)
  assert d.qpos.dtype == torch.float32 and d.nworld == 3
  np.testing.assert_allclose(d.qpos.numpy(), qpos.astype(np.float32))
  assert d.efc_J.shape == (3, 117, 27)
  one = mt.make_data(m, nconmax=24)
  gen = lambda: torch.Generator().manual_seed(7)
  a = mt.make_batch(m, one, 5, qpos_noise=0.01, generator=gen())
  b = mt.make_batch(m, one, 5, qpos_noise=0.01, generator=gen())
  assert a.qpos.shape == (5, m.nq) and a.contact.geom.shape == (5, 24, 2)
  np.testing.assert_array_equal(a.qpos.numpy(), b.qpos.numpy())
  assert float((a.qpos - one.qpos).abs().max()) > 0
  with pytest.raises(ValueError):
    mt.make_batch(m, one, 5, qpos_noise=0.01)


# two free geoms of the given types (sphere and capsule sizes read the
# first values), a pair the gate tests; a mesh geom is a tetrahedron
_PAIR = """<mujoco><asset><mesh name="tet" vertex="0 0 0  .1 0 0  0 .1 0
  0 0 .1"/></asset><worldbody><body><freejoint/><geom type="{}"
  size=".1 .1 .1"/></body><body pos="0 0 1"><freejoint/><geom type="{}"
  size=".1 .1 .1"/></body></worldbody></mujoco>"""
_MESH = 'mesh" mesh="tet'

_OUTSIDE = {
    'tendon': """<mujoco><worldbody><body><joint type="slide"/>
      <geom size=".1" contype="0" conaffinity="0"/><site name="a"/></body>
      <site name="b" pos="0 0 1"/></worldbody><tendon><spatial>
      <site site="a"/><site site="b"/></spatial></tendon></mujoco>""",
    'activation': """<mujoco><option integrator="implicitfast"/>
      <worldbody><body><joint name="j"/><geom size=".1"/></body>
      </worldbody><actuator><general joint="j" dyntype="filter"
      dynprm="0.1"/></actuator></mujoco>""",
    'implicit': """<mujoco><option integrator="implicit"/>
      <worldbody><body><freejoint/><geom size=".1"/></body></worldbody>
      </mujoco>""",
    'pgs': """<mujoco><option solver="PGS"/><worldbody><body>
      <freejoint/><geom size=".1"/></body></worldbody></mujoco>""",
    'sensor': """<mujoco><worldbody><body><joint name="j"/>
      <geom size=".1"/></body></worldbody><sensor><jointpos joint="j"/>
      </sensor></mujoco>""",
    'connect': """<mujoco><worldbody><body name="b"><freejoint/>
      <geom size=".1"/></body></worldbody><equality><connect body1="b"
      anchor="0 0 1"/></equality></mujoco>""",
    'weld': """<mujoco><worldbody><body name="b"><freejoint/>
      <geom size=".1"/></body></worldbody><equality><weld body1="b"/>
      </equality></mujoco>""",
    'tendon_equality': """<mujoco><worldbody><body><joint name="a"
      type="slide"/><geom size=".1"/></body></worldbody><tendon><fixed
      name="t"><joint joint="a" coef="1"/></fixed></tendon><equality>
      <tendon tendon1="t"/></equality></mujoco>""",
    'flex_equality': """<mujoco><worldbody><body name="b1"><freejoint/>
      <geom size=".1"/></body><body name="b2" pos="1 0 0"><freejoint/>
      <geom size=".1"/></body></worldbody><deformable><flex name="f"
      dim="1" body="b1 b2" vertex="0 0 0 0 0 0" element="0 1"/>
      </deformable><equality><flex flex="f"/></equality></mujoco>""",
    'capsule_mesh': _PAIR.format('capsule', _MESH),
    'cylinder_mesh': _PAIR.format('cylinder', _MESH),
    'ellipsoid_mesh': _PAIR.format('ellipsoid', _MESH),
    'framequat_on_a_geom': """<mujoco><worldbody><body><freejoint/>
      <geom name="g" size=".1"/></body></worldbody><sensor><framequat
      objtype="geom" objname="g"/></sensor></mujoco>""",
}


# options and models the gate has opened since: the same test holds that
# they pass, and what the Model then holds (a field of m, or of m.opt)
_INSIDE = {
    'rk4': ("""<mujoco><option integrator="RK4"/><worldbody><body>
      <freejoint/><geom size=".1"/></body></worldbody></mujoco>""",
            'opt.integrator', 1),
    'cg': ("""<mujoco><option solver="CG"/><worldbody><body>
      <freejoint/><geom size=".1"/></body></worldbody></mujoco>""",
           'opt.solver', 1),
    'elliptic': ("""<mujoco><option cone="elliptic"/><worldbody><body>
      <freejoint/><geom size=".1"/></body></worldbody></mujoco>""",
                 'opt.cone', 1),
    'implicitfast': ("""<mujoco><option integrator="implicitfast"/>
      <worldbody><body><freejoint/><geom size=".1"/></body></worldbody>
      </mujoco>""", 'opt.integrator', 3),
    'box_pair': ("""<mujoco><worldbody><geom type="plane" size="1 1 1"/>
      <body><freejoint/><geom type="box" size=".1 .1 .1"/></body>
      </worldbody></mujoco>""", 'collision_pairs',
                 ((0, 6, ((0, 1, -1),)),)),
    'capsule_box': (_PAIR.format('capsule', 'box'), 'collision_pairs',
                    ((3, 6, ((0, 1, -1),)),)),
    'box_box': (_PAIR.format('box', 'box'), 'collision_pairs',
                ((6, 6, ((0, 1, -1),)),)),
    'sphere_box': (_PAIR.format('sphere', 'box'), 'collision_pairs',
                   ((2, 6, ((0, 1, -1),)),)),
    'mesh_mesh': (_PAIR.format(_MESH, _MESH), 'nxn_candidates', 5),
    'sphere_mesh': (_PAIR.format('sphere', _MESH), 'nxn_candidates', 1),
    'box_mesh': (_PAIR.format('box', _MESH), 'nxn_candidates', 5),
    'imu_sensors': ("""<mujoco><worldbody><body><freejoint/>
      <geom size=".1"/><site name="s"/></body></worldbody><sensor>
      <framequat objtype="site" objname="s"/><gyro site="s"/>
      <accelerometer site="s"/><magnetometer site="s"/></sensor>
      </mujoco>""", 'sensor_type', (27, 3, 1, 6)),
    'equality': ("""<mujoco><worldbody><body><joint name="a"/>
      <geom size=".1"/><body><joint name="b"/><geom size=".1"/></body>
      </body></worldbody><equality><joint joint1="a" joint2="b"/>
      </equality></mujoco>""", 'neq', 1),
}


@pytest.mark.parametrize('case', sorted(_OUTSIDE) + sorted(_INSIDE))
def test_put_model_rejects_models_outside_the_gate(case):
  if case in _INSIDE:
    xml, field, value = _INSIDE[case]
    m = mt.put_model(mujoco.MjModel.from_xml_string(xml), device='cpu')
    for name in field.split('.'):
      m = getattr(m, name)
    assert m == value
    return
  mjm = mujoco.MjModel.from_xml_string(_OUTSIDE[case])
  match = {'capsule_mesh': r'\(3, 7\)', 'cylinder_mesh': r'\(5, 7\)',
           'ellipsoid_mesh': r'\(4, 7\)'}.get(case)
  with pytest.raises(NotImplementedError, match=match):
    mt.put_model(mjm, device='cpu')
