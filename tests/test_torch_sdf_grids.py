"""The port's voxel grids (`io._build_sdf_grids`), the committed
`models/aloha_sdf.npz` and the gate of SDF geoms, against the JAX package
on the CPU.

* Octree sampling: the port's `_sample_octree_grid` equals the JAX one bit
  for bit on aloha_sdf's three octree meshes at resolution 48.
* Voxelization: the port's `_voxel_chunk_dist` (torch: the distance in
  float64, the ray parity in float32) against JAX `_voxel_chunk_dist`
  (jitted, on the faces padded as JAX `_voxelize_mesh_grid` pads them, to
  a power of two with triangles at 1e6) on a small mesh, on aloha_sdf's
  128-face mesh at resolution 48 and on its 1,680-face extrusion at 16:
  within VOX_TOL of JAX run in float64, and of JAX in float32 except
  where JAX's float32 is itself off (only on the extrusion, whose sliver
  faces make the barycentric tests' products cancel); no voxel of another
  sign (the count is asserted, so a ray through an edge that parts the
  two float32 orders would show).
* The committed `.npz`: the grids at resolution 48, those of the octree
  meshes and of the 128-face mesh equal to what the port's functions make
  now, and every other leaf and static equal to the port's `put_model`
  now.
* The gate: an SDF geom with a plugin and an explicit <pair> with an SDF
  geom are refused by name.
"""

import mujoco
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mujoco_warp_tpu import io as jio
import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import io, models, types

from torch_parity import compile_fresh

VOX_TOL = 1e-6
RES = 48
MESH_128 = 24                        # aloha_sdf's 128-face mesh
MESH_SLIVER = 0                      # an extrusion of sliver faces
SMALL = """<mujoco><asset><mesh name="m" vertex="0.1 0 0  -0.08 0.02 0
  0 0.12 0.01  0.01 -0.09 0  0 0.01 0.1  0.02 0 -0.11"/></asset>
  <worldbody><geom type="mesh" mesh="m"/></worldbody></mujoco>"""


@pytest.fixture(scope='module')
def aloha_sdf():
  # after aloha_pot, whose meshes MuJoCo's asset cache would hand over
  mujoco.MjModel.from_xml_path(models.ALOHA_POT)
  return compile_fresh(models.ALOHA_SDF)


def test_octree_grids_match_jax(aloha_sdf):
  mjm = aloha_sdf
  octree = [i for i in range(mjm.nmesh) if mjm.mesh_octadr[i] >= 0]
  assert octree == [22, 23, 25]
  for i in octree:
    grid, aabb = io._sample_octree_grid(mjm, i, RES)
    jgrid, jaabb = jio._sample_octree_grid(mjm, i, RES)
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(aabb, jaabb)


def _points_and_faces(mjm, meshid, res):
  """The grid points of a plain mesh as both packages place them, and
  its triangles."""
  vadr, vnum = int(mjm.mesh_vertadr[meshid]), int(mjm.mesh_vertnum[meshid])
  fadr, fnum = int(mjm.mesh_faceadr[meshid]), int(mjm.mesh_facenum[meshid])
  verts = np.asarray(mjm.mesh_vert[vadr:vadr + vnum], np.float32)
  faces = np.asarray(mjm.mesh_face[fadr:fadr + fnum], np.int64)
  lo, hi = verts.min(0), verts.max(0)
  pad = 0.15 * (hi - lo).max() + 1e-4
  lo, hi = lo - pad, hi + pad
  axes = [np.linspace(lo[k], hi[k], res, dtype=np.float32)
          for k in range(3)]
  gx, gy, gz = np.meshgrid(*axes, indexing='ij')
  return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3), verts[faces]


@pytest.mark.parametrize('scene,meshid,res',
                         [('small', 0, 16), ('aloha_sdf', MESH_128, RES),
                          ('aloha_sdf', MESH_SLIVER, 16)])
def test_voxelization_matches_jax(aloha_sdf, scene, meshid, res):
  mjm = (mujoco.MjModel.from_xml_string(SMALL) if scene == 'small' else
         aloha_sdf)
  pts, tri = _points_and_faces(mjm, meshid, res)
  grid, aabb = io._voxelize_mesh_grid(mjm, meshid, res)
  # JAX pads the faces to a power of two (at least 128) with triangles
  # at 1e6, and the points to chunks of 2048
  fpad = max(128, 1 << int(np.ceil(np.log2(len(tri)))))
  jtri = np.concatenate([tri, np.full((fpad - len(tri), 3, 3), 1e6,
                                      np.float32)])
  step = 2048
  padded = np.concatenate([pts, np.zeros((-len(pts) % step, 3), np.float32)])

  def jax_dist(dtype):
    with jax.enable_x64(dtype == np.float64):
      fn = jax.jit(jio._voxel_chunk_dist)
      return np.concatenate([np.asarray(fn(
          jnp.asarray(padded[i:i + step], dtype), jnp.asarray(jtri, dtype)))
          for i in range(0, len(padded), step)])[:len(pts)]
  ref32, ref64 = jax_dist(np.float32), jax_dist(np.float64)
  out = grid.reshape(-1)
  # the port's distance is JAX's function in float64, rounded
  np.testing.assert_allclose(np.abs(out), np.abs(ref64), rtol=0,
                             atol=VOX_TOL)
  # against float32 JAX: over VOX_TOL only where JAX's own float32 error
  # is (the barycentric tests' products cancel on sliver faces)
  off = np.abs(np.abs(out) - np.abs(ref32)) > VOX_TOL
  own = np.abs(np.abs(ref32) - np.abs(ref64)) > VOX_TOL / 2
  flips = int((np.sign(out) != np.sign(ref32)).sum())
  print(f'{scene} mesh {meshid} at {res}: {len(tri)} faces, {len(pts)} '
        f'voxels; against float32 JAX max |diff| '
        f'{np.abs(np.abs(out) - np.abs(ref32)).max():.3e}, {int(off.sum())} '
        f'over {VOX_TOL:g} (JAX float32 off its float64 by more than '
        f'{VOX_TOL / 2:g} in {int(own.sum())}); {flips} of another sign')
  assert not (off & ~own).any()
  assert (off.sum() > 0) == (meshid == MESH_SLIVER and scene != 'small')
  assert flips == 0
  # voxels inside and out (the extrusion, 2 cm thick, holds no voxel at
  # resolution 16)
  assert (out > 0).any() and ((out < 0).any() or meshid == MESH_SLIVER)
  jgrid_aabb = np.stack([0.5 * (pts.min(0) + pts.max(0)),
                         0.5 * (pts.max(0) - pts.min(0))])
  np.testing.assert_allclose(aabb, jgrid_aabb, rtol=0, atol=1e-6)


def test_committed_npz_holds_the_grids(aloha_sdf):
  mjm = aloha_sdf
  m = io.load_model(models.ALOHA_SDF_NPZ, device='cpu')
  assert m.sdf_grids.shape == (23, RES, RES, RES)
  assert m.key_names == ('neutral_pose', 'gripper_gripper_pot',
                         'gripper_gripper')
  gom = m.sdf_grid_of_mesh
  for i in (22, 23, 25):
    grid, aabb = io._sample_octree_grid(mjm, i, RES)
    np.testing.assert_array_equal(m.sdf_grids[gom[i]].numpy(), grid)
    np.testing.assert_array_equal(m.sdf_grid_aabb[gom[i]].numpy(), aabb)
  grid, aabb = io._voxelize_mesh_grid(mjm, MESH_128, RES)
  np.testing.assert_array_equal(m.sdf_grids[gom[MESH_128]].numpy(), grid)
  np.testing.assert_array_equal(m.sdf_grid_aabb[gom[MESH_128]].numpy(), aabb)
  # put_model now, its grids passed through (voxelizing takes minutes)
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(io, '_build_sdf_grids', lambda _: (
        m.sdf_grids.numpy(), m.sdf_grid_aabb.numpy(),
        list(m.sdf_grid_of_mesh)))
    fresh = mt.put_model(mjm, device='cpu')
  for k in types.MODEL_STATICS:
    assert getattr(m, k) == getattr(fresh, k), k
  for k in types.MODEL_TENSORS:
    assert torch.equal(getattr(m, k), getattr(fresh, k)), k
  for k in types.OPTION_STATICS:
    assert getattr(m.opt, k) == getattr(fresh.opt, k), k
  for k in types.OPTION_TENSORS:
    assert torch.equal(getattr(m.opt, k), getattr(fresh.opt, k)), k


TORUS_XML = """<mujoco>
  <extension><plugin plugin="mujoco.sdf.torus"><instance name="t">
    <config key="radius1" value="0.35"/><config key="radius2" value="0.15"/>
  </instance></plugin></extension>
  <asset><mesh name="tm"><plugin instance="t"/></mesh></asset>
  <worldbody>
    <geom type="plane" size="2 2 .1"/>
    <body pos="0 0 0.5"><freejoint/>
      <geom type="sdf" name="tg" mesh="tm"><plugin instance="t"/></geom>
    </body>
  </worldbody>
</mujoco>"""

PAIR_XML = """<mujoco>
  <asset><mesh name="octa" vertex="0.12 0 0  -0.12 0 0  0 0.12 0
    0 -0.12 0  0 0 0.1  0 0 -0.1"/></asset>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 0.1"/>
    <body pos="0 0 0.3"><freejoint/>
      <geom name="s" type="sdf" mesh="octa"/></body>
  </worldbody>
  <contact><pair geom1="floor" geom2="s"/></contact>
</mujoco>"""


def test_gate_refuses_sdf_plugins_and_explicit_pairs():
  with pytest.raises(NotImplementedError, match='SDF geom plugins'):
    mt.put_model(mujoco.MjModel.from_xml_string(TORUS_XML), device='cpu')
  with pytest.raises(NotImplementedError,
                     match=r'explicit <pair> with an SDF geom \(0, 8\)'):
    mt.put_model(mujoco.MjModel.from_xml_string(PAIR_XML), device='cpu')
  # the same scene without the <pair> passes, its pair through the SDF
  # narrowphase with sdf_initpoints slots (MuJoCo's default, 40)
  mjm = mujoco.MjModel.from_xml_string(PAIR_XML.replace(
      '<contact><pair geom1="floor" geom2="s"/></contact>', ''))
  m = mt.put_model(mjm, device='cpu')
  assert [(a, b, len(g)) for a, b, g in m.collision_pairs] == [(0, 8, 1)]
  assert m.nxn_candidates == m.opt.sdf_initpoints == 40
  assert io.pair_slots(0, 8, m.opt) == io.pair_slots(0, 8, mjm.opt) == 40
