"""Benchmark scene assets: MJCF sources and their compiled `.npz` form.

`humanoid.npz` is `io.save_model(io.put_model(MjModel(humanoid.xml)))`,
`three_humanoids.npz` the same of the benchmark suite's scene
`benchmarks/scenes/humanoid/three_humanoids.xml` (three humanoids
attached to one world, nv 81) and `franka_emika_panda.npz` of the
suite's `benchmarks/scenes/franka_emika_panda/scene.xml` (the Panda arm,
nv 9; its meshes collide with nothing, and the Model holds no mesh
data) and `apptronik_apollo_flat.npz` of the suite's
`benchmarks/scenes/apptronik_apollo/scene_flat.xml` (the Apollo
humanoid on a plane, nv 25, four IMU sensors; no mesh is read) and
`apptronik_apollo_terrain.npz` of `scene_terrain.xml` (the same robot on
5,272 boxes of terrain: 95,021 admissible pairs, so the Model takes the
large-scene broadphase and holds its pair arrays) and
`apptronik_apollo_hfield.npz` of `scene_hfield.xml` (the same robot on a
588 x 1,121 height field, whose normalized heights the Model holds) and
`aloha_pot.npz` of
`benchmarks/scenes/aloha_pot/scene.xml` (two ALOHA arms over a pot on a
table: nv 23, 190 mesh geoms whose convex hulls, full and decimated, the
Model holds, and the keyframe names of the `lift_pot` replay) and
`aloha_sdf.npz` of `benchmarks/scenes/aloha_sdf/scene.xml` (the same arms
with SDF fingers over a cow, an SDF geom: nv 22; the Model holds the
hulls and the 23 voxel grids at resolution 48 of the meshes an SDF pair
reads, 3 sampled from the compiler's octrees and 20 voxelized, which takes
most of the regeneration's time) and `kitchen.npz` of
`benchmarks/scenes/kitchen/kitchen.xml` (a furnished kitchen: nv 68, 328
bodies, 1,608 geoms, 235,648 admissible cylinder and box pairs, so the
Model takes the large-scene broadphase and holds its pair arrays; its
49 meshes collide with nothing, and their hulls, which the Model holds as
`put_model` makes them, are read by no pair; 1.3 MB). They are
committed so that a machine without the `mujoco` bindings can load the
models (`io.load_model`).
Regenerate them after a change to the compiler:

    python -m mujoco_warp_tpu_torch.models.regenerate
"""

import os

_DIR = os.path.dirname(__file__)
_ROOT = os.path.dirname(os.path.dirname(_DIR))


def path(name: str) -> str:
  return os.path.join(_DIR, name if name.endswith('.xml') else name + '.xml')


HUMANOID = path('humanoid')
HUMANOID_NPZ = os.path.join(_DIR, 'humanoid.npz')
# the suite's scene lives in the checkout, beside the package
THREE_HUMANOIDS = os.path.join(_ROOT, 'benchmarks', 'scenes', 'humanoid',
                               'three_humanoids.xml')
THREE_HUMANOIDS_NPZ = os.path.join(_DIR, 'three_humanoids.npz')
FRANKA = os.path.join(_ROOT, 'benchmarks', 'scenes', 'franka_emika_panda',
                      'scene.xml')
FRANKA_NPZ = os.path.join(_DIR, 'franka_emika_panda.npz')
APOLLO = os.path.join(_ROOT, 'benchmarks', 'scenes', 'apptronik_apollo',
                      'scene_flat.xml')
APOLLO_NPZ = os.path.join(_DIR, 'apptronik_apollo_flat.npz')
APOLLO_TERRAIN = os.path.join(_ROOT, 'benchmarks', 'scenes',
                              'apptronik_apollo', 'scene_terrain.xml')
APOLLO_TERRAIN_NPZ = os.path.join(_DIR, 'apptronik_apollo_terrain.npz')
APOLLO_HFIELD = os.path.join(_ROOT, 'benchmarks', 'scenes',
                             'apptronik_apollo', 'scene_hfield.xml')
APOLLO_HFIELD_NPZ = os.path.join(_DIR, 'apptronik_apollo_hfield.npz')
ALOHA_POT = os.path.join(_ROOT, 'benchmarks', 'scenes', 'aloha_pot',
                         'scene.xml')
ALOHA_POT_NPZ = os.path.join(_DIR, 'aloha_pot.npz')
ALOHA_SDF = os.path.join(_ROOT, 'benchmarks', 'scenes', 'aloha_sdf',
                         'scene.xml')
ALOHA_SDF_NPZ = os.path.join(_DIR, 'aloha_sdf.npz')
KITCHEN = os.path.join(_ROOT, 'benchmarks', 'scenes', 'kitchen',
                       'kitchen.xml')
KITCHEN_NPZ = os.path.join(_DIR, 'kitchen.npz')
