"""Data model of the PyTorch port: enums, Option, Statistic, Model,
Contact and Data as dataclasses of tensors.

Field names follow the JAX package (`mujoco_warp_tpu/types.py`) so the
parity tests compare like with like. Only the fields the ported
`step_batched` paths (humanoid, three_humanoids, franka_emika_panda,
apptronik_apollo_flat) read or write are present. Two differences:

* Structural metadata (tree topology, joint types, collision pair lists)
  stays in static Python ints and tuples, as in the JAX Model; numeric
  parameters are float32 tensors (the equalities' active flags bool).
* Data is batch-native: every tensor leads with `nworld`, like the JAX
  batch after `parallel.make_batch`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Tuple

import torch


class DisableBit(enum.IntFlag):
  """mjtDisableBit."""
  CONSTRAINT = 1 << 0
  EQUALITY = 1 << 1
  FRICTIONLOSS = 1 << 2
  LIMIT = 1 << 3
  CONTACT = 1 << 4
  SPRING = 1 << 5
  DAMPER = 1 << 6
  GRAVITY = 1 << 7
  CLAMPCTRL = 1 << 8
  WARMSTART = 1 << 9
  FILTERPARENT = 1 << 10
  ACTUATION = 1 << 11
  REFSAFE = 1 << 12
  SENSOR = 1 << 13
  MIDPHASE = 1 << 14
  EULERDAMP = 1 << 15
  AUTORESET = 1 << 16
  NATIVECCD = 1 << 17
  ISLAND = 1 << 18
  MULTICCD = 1 << 19


class EnableBit(enum.IntFlag):
  OVERRIDE = 1 << 0
  ENERGY = 1 << 1
  FWDINV = 1 << 2
  INVDISCRETE = 1 << 3


class JointType(enum.IntEnum):
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3

  def dof_width(self) -> int:
    return {0: 6, 1: 3, 2: 1, 3: 1}[self.value]

  def qpos_width(self) -> int:
    return {0: 7, 1: 4, 2: 1, 3: 1}[self.value]


class GeomType(enum.IntEnum):
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7
  SDF = 8


class SolverType(enum.IntEnum):
  PGS = 0
  CG = 1
  NEWTON = 2


class IntegratorType(enum.IntEnum):
  EULER = 0
  RK4 = 1
  IMPLICIT = 2
  IMPLICITFAST = 3


class ConeType(enum.IntEnum):
  PYRAMIDAL = 0
  ELLIPTIC = 1


class EqType(enum.IntEnum):
  CONNECT = 0
  WELD = 1
  JOINT = 2
  TENDON = 3
  FLEX = 4


class TrnType(enum.IntEnum):
  JOINT = 0
  JOINTINPARENT = 1
  SLIDERCRANK = 2
  TENDON = 3
  SITE = 4
  BODY = 5


class DynType(enum.IntEnum):
  NONE = 0
  INTEGRATOR = 1
  FILTER = 2
  FILTEREXACT = 3
  MUSCLE = 4


class GainType(enum.IntEnum):
  FIXED = 0
  AFFINE = 1
  MUSCLE = 2


class BiasType(enum.IntEnum):
  NONE = 0
  AFFINE = 1
  MUSCLE = 2


class WrapType(enum.IntEnum):
  JOINT = 1
  PULLEY = 2
  SITE = 3
  SPHERE = 4
  CYLINDER = 5


class ConstraintType(enum.IntEnum):
  """efc row types (mjtConstraint)."""
  EQUALITY = 0
  FRICTION_DOF = 1
  FRICTION_TENDON = 2
  LIMIT_JOINT = 3
  LIMIT_TENDON = 4
  CONTACT_FRICTIONLESS = 5
  CONTACT_PYRAMIDAL = 6
  CONTACT_ELLIPTIC = 7


SensorType = enum.IntEnum('SensorType', [
    'TOUCH', 'ACCELEROMETER', 'VELOCIMETER', 'GYRO', 'FORCE', 'TORQUE',
    'MAGNETOMETER', 'RANGEFINDER', 'CAMPROJECTION', 'JOINTPOS', 'JOINTVEL',
    'TENDONPOS', 'TENDONVEL', 'ACTUATORPOS', 'ACTUATORVEL', 'ACTUATORFRC',
    'JOINTACTFRC', 'TENDONACTFRC', 'BALLQUAT', 'BALLANGVEL',
    'JOINTLIMITPOS', 'JOINTLIMITVEL', 'JOINTLIMITFRC', 'TENDONLIMITPOS',
    'TENDONLIMITVEL', 'TENDONLIMITFRC', 'FRAMEPOS', 'FRAMEQUAT',
    'FRAMEXAXIS', 'FRAMEYAXIS', 'FRAMEZAXIS', 'FRAMELINVEL', 'FRAMEANGVEL',
    'FRAMELINACC', 'FRAMEANGACC', 'SUBTREECOM', 'SUBTREELINVEL',
    'SUBTREEANGMOM', 'INSIDESITE', 'GEOMDIST', 'GEOMNORMAL', 'GEOMFROMTO',
    'CONTACT', 'E_POTENTIAL', 'E_KINETIC', 'CLOCK', 'TACTILE', 'PLUGIN',
    'USER'], start=0)
SensorType.__doc__ = 'mjtSensor.'


class State(enum.IntFlag):
  """mjtState component bitflags."""
  TIME = 1 << 0
  QPOS = 1 << 1
  QVEL = 1 << 2
  ACT = 1 << 3
  WARMSTART = 1 << 4
  CTRL = 1 << 5
  QFRC_APPLIED = 1 << 6
  XFRC_APPLIED = 1 << 7
  EQ_ACTIVE = 1 << 8
  MOCAP_POS = 1 << 9
  MOCAP_QUAT = 1 << 10
  PHYSICS = QPOS | QVEL | ACT
  FULLPHYSICS = TIME | PHYSICS
  USER = (CTRL | QFRC_APPLIED | XFRC_APPLIED | EQ_ACTIVE | MOCAP_POS |
          MOCAP_QUAT)
  INTEGRATION = FULLPHYSICS | USER | WARMSTART


class ObjType(enum.IntEnum):
  UNKNOWN = 0
  BODY = 1
  XBODY = 2
  JOINT = 3
  GEOM = 5
  SITE = 6
  CAMERA = 7


IntTuple = Tuple[int, ...]


def _tensor_fields(cls) -> tuple[str, ...]:
  return tuple(f.name for f in dataclasses.fields(cls)
               if f.type in ('torch.Tensor', 'Option', 'Statistic',
                             'Contact'))


class _Tensors:
  """`.to(device)` and `.replace(**kw)` for dataclasses of tensors."""

  def replace(self, **kw):
    return dataclasses.replace(self, **kw)

  def to(self, device):
    return dataclasses.replace(self, **{
        k: getattr(self, k).to(device) for k in _tensor_fields(type(self))})


@dataclasses.dataclass(frozen=True)
class Option(_Tensors):
  """Physics options: continuous values are tensors, enums and counts
  are static."""
  timestep: torch.Tensor
  tolerance: torch.Tensor
  ls_tolerance: torch.Tensor
  gravity: torch.Tensor
  impratio: torch.Tensor
  magnetic: torch.Tensor
  integrator: int
  cone: int
  solver: int
  iterations: int
  ls_iterations: int
  ls_parallel: int
  disableflags: int
  enableflags: int
  # the SDF narrowphase's descents: passes on the clearance sum, and
  # starting points a pair (`collision_sdf.py`)
  sdf_iterations: int
  sdf_initpoints: int


@dataclasses.dataclass(frozen=True)
class Statistic(_Tensors):
  meaninertia: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class Model(_Tensors):
  """Static model (humanoid-path subset of the JAX Model)."""
  # sizes
  nq: int
  nv: int
  nu: int
  na: int
  nbody: int
  njnt: int
  ngeom: int
  nsite: int
  ncam: int
  nlight: int
  neq: int
  nmocap: int
  ngravcomp: int
  nsensor: int
  npair: int
  nexclude: int
  ntendon: int
  nkey: int
  # each keyframe's name ('' for none), which `io.find_keys` reads
  key_names: Tuple[str, ...]
  # structure
  body_parentid: IntTuple
  body_rootid: IntTuple
  body_weldid: IntTuple
  body_mocapid: IntTuple
  body_jntadr: IntTuple
  body_jntnum: IntTuple
  body_dofadr: IntTuple
  body_dofnum: IntTuple
  body_levels: Tuple[IntTuple, ...]
  jnt_type: IntTuple
  jnt_qposadr: IntTuple
  jnt_dofadr: IntTuple
  jnt_bodyid: IntTuple
  jnt_limited: IntTuple
  jnt_actfrclimited: IntTuple
  dof_bodyid: IntTuple
  dof_jntid: IntTuple
  dof_parentid: IntTuple
  dof_ancestor_rows: Tuple[IntTuple, ...]
  dof_hasfrictionloss: IntTuple
  geom_type: IntTuple
  geom_bodyid: IntTuple
  # each geom's mesh id (-1 for a geom without mesh data)
  geom_dataid: IntTuple
  geom_condim: IntTuple
  geom_priority: IntTuple
  site_bodyid: IntTuple
  cam_mode: IntTuple
  cam_bodyid: IntTuple
  cam_targetbodyid: IntTuple
  light_mode: IntTuple
  light_bodyid: IntTuple
  light_targetbodyid: IntTuple
  actuator_trntype: IntTuple
  actuator_dyntype: IntTuple
  actuator_gaintype: IntTuple
  actuator_biastype: IntTuple
  actuator_trnid: Tuple[IntTuple, ...]
  actuator_ctrllimited: IntTuple
  actuator_forcelimited: IntTuple
  # equality constraints: type (EqType) and the two objects (joint ids of
  # a JOINT equality; obj2 -1 for one joint)
  eq_type: IntTuple
  eq_obj1id: IntTuple
  eq_obj2id: IntTuple
  # collision structure: ((type1, type2, ((g1, g2, pairid), ...)), ...)
  collision_pairs: Tuple[Any, ...]
  nxn_candidates: int
  # the large-scene broadphase (`collision_sap.py`): ((type1, type2,
  # start, count), ...) over the rows of sap_pairs; () where the static
  # pair list serves (then collision_pairs is the list, else ())
  sap_families: Tuple[Any, ...]
  # each mesh's row of sdf_grids (-1 for none; (-1,) without meshes)
  sdf_grid_of_mesh: IntTuple
  condim_max: int
  pair_dim: IntTuple
  has_damping: bool
  # sensors (FRAMEQUAT, GYRO, ACCELEROMETER, MAGNETOMETER: the gate):
  # type (SensorType), datatype, needstage (1 pos, 2 vel, 3 acc), the
  # object and the reference object (type ObjType, id; refid -1 for
  # none), address and width in sensordata
  sensor_type: IntTuple
  sensor_datatype: IntTuple
  sensor_needstage: IntTuple
  sensor_objtype: IntTuple
  sensor_objid: IntTuple
  sensor_reftype: IntTuple
  sensor_refid: IntTuple
  sensor_adr: IntTuple
  sensor_dim: IntTuple
  nsensordata: int
  # numeric parameters
  opt: Option
  stat: Statistic
  qpos0: torch.Tensor
  qpos_spring: torch.Tensor
  body_pos: torch.Tensor
  body_quat: torch.Tensor
  body_ipos: torch.Tensor
  body_iquat: torch.Tensor
  body_mass: torch.Tensor
  body_subtreemass: torch.Tensor
  body_inertia: torch.Tensor
  body_invweight0: torch.Tensor
  jnt_solref: torch.Tensor
  jnt_solimp: torch.Tensor
  jnt_pos: torch.Tensor
  jnt_axis: torch.Tensor
  jnt_stiffness: torch.Tensor
  jnt_range: torch.Tensor
  jnt_actfrcrange: torch.Tensor
  jnt_margin: torch.Tensor
  dof_solref: torch.Tensor
  dof_solimp: torch.Tensor
  dof_frictionloss: torch.Tensor
  dof_armature: torch.Tensor
  dof_damping: torch.Tensor
  dof_invweight0: torch.Tensor
  geom_pos: torch.Tensor
  geom_quat: torch.Tensor
  geom_size: torch.Tensor
  geom_friction: torch.Tensor
  geom_solref: torch.Tensor
  geom_solimp: torch.Tensor
  geom_solmix: torch.Tensor
  geom_margin: torch.Tensor
  geom_gap: torch.Tensor
  site_pos: torch.Tensor
  site_quat: torch.Tensor
  cam_pos: torch.Tensor
  cam_quat: torch.Tensor
  cam_poscom0: torch.Tensor
  cam_pos0: torch.Tensor
  cam_mat0: torch.Tensor
  light_pos: torch.Tensor
  light_dir: torch.Tensor
  light_poscom0: torch.Tensor
  light_pos0: torch.Tensor
  light_dir0: torch.Tensor
  actuator_gainprm: torch.Tensor
  actuator_biasprm: torch.Tensor
  actuator_ctrlrange: torch.Tensor
  actuator_forcerange: torch.Tensor
  actuator_gear: torch.Tensor
  pair_solref: torch.Tensor
  pair_solreffriction: torch.Tensor
  pair_solimp: torch.Tensor
  pair_margin: torch.Tensor
  pair_gap: torch.Tensor
  pair_friction: torch.Tensor
  # (ngeom, 2, 3) each geom's box in its frame (center, half sizes)
  geom_aabb: torch.Tensor
  # (ngeom,) each geom's bounding-sphere radius about its frame's origin
  geom_rbound: torch.Tensor
  # (nmesh, V, 4) each mesh's convex-hull vertices in its geom frame,
  # padded (xyz, 1 valid or 0 padding); (nmesh, <= io.HULL_SMALL, 4) the
  # same decimated, which the culled narrowphase reads; (0, 1, 4) without
  # meshes
  mesh_hullvert: torch.Tensor
  mesh_hullvert_small: torch.Tensor
  # (P, 2) int32 the admissible pairs of the large-scene broadphase by
  # family, g1 of the family's type1; (P,) int32 their <pair> ids (-1
  # for none); (0, 2) and (0,) without it
  sap_pairs: torch.Tensor
  sap_pairid: torch.Tensor
  # (G, R, R, R) the signed-distance voxel grids of the meshes that an
  # SDF pair reads, and (G, 2, 3) each grid's box in its mesh's frame
  # (center, half sizes); (1, 1, 1, 1) and (1, 2, 3) zeros without
  sdf_grids: torch.Tensor
  sdf_grid_aabb: torch.Tensor
  # (neq, 11) data (a JOINT equality's polycoef in 0:5), (neq, 2),
  # (neq, 5), (neq,) bool
  eq_data: torch.Tensor
  eq_solref: torch.Tensor
  eq_solimp: torch.Tensor
  eq_active0: torch.Tensor
  # (nsensor,) each sensor's cutoff (0: none)
  sensor_cutoff: torch.Tensor
  # keyframes: (nkey,), (nkey, nq), (nkey, nv), (nkey, na), (nkey, nu),
  # (nkey, nmocap, 3), (nkey, nmocap, 4)
  key_time: torch.Tensor
  key_qpos: torch.Tensor
  key_qvel: torch.Tensor
  key_act: torch.Tensor
  key_ctrl: torch.Tensor
  key_mpos: torch.Tensor
  key_mquat: torch.Tensor
  # (nv, nv) 0/1: dof j is an ancestor (or self) of dof i
  dof_ancestor_mask: torch.Tensor
  # (nbody, nbody) 0/1: body c is in the subtree of body b
  body_subtree_mask: torch.Tensor
  # (nbody, nv) 0/1: dof j moves body b
  body_dof_ancestor_mask: torch.Tensor
  # (nv, nv) strict-ancestor mask of the cdof_dot partial velocities
  dof_vpre_mask: torch.Tensor

  @property
  def device(self) -> torch.device:
    return self.qpos0.device


MODEL_TENSORS = tuple(f for f in _tensor_fields(Model)
                      if f not in ('opt', 'stat'))
MODEL_STATICS = tuple(f.name for f in dataclasses.fields(Model)
                      if f.name not in MODEL_TENSORS + ('opt', 'stat'))
OPTION_TENSORS = _tensor_fields(Option)
OPTION_STATICS = tuple(f.name for f in dataclasses.fields(Option)
                       if f.name not in OPTION_TENSORS)


@dataclasses.dataclass(frozen=True)
class Contact(_Tensors):
  """Per-world contact pool of fixed capacity nconmax; (nworld, nconmax,
  ...) tensors, empty slots have geom == -1."""
  dist: torch.Tensor
  pos: torch.Tensor
  frame: torch.Tensor          # (W, C, 3, 3) rows: normal, tangent1, tangent2
  includemargin: torch.Tensor
  friction: torch.Tensor
  solref: torch.Tensor
  solreffriction: torch.Tensor
  solimp: torch.Tensor
  dim: torch.Tensor            # int32
  geom: torch.Tensor           # (W, C, 2) int32
  efc_address: torch.Tensor    # int32


@dataclasses.dataclass(frozen=True)
class Data(_Tensors):
  """Batched dynamic state; every tensor leads with nworld."""
  time: torch.Tensor
  ncon: torch.Tensor
  ne: torch.Tensor
  nf: torch.Tensor
  nl: torch.Tensor
  nefc: torch.Tensor
  ncollision: torch.Tensor
  solver_niter: torch.Tensor
  qpos: torch.Tensor
  qvel: torch.Tensor
  act: torch.Tensor
  ctrl: torch.Tensor
  qacc_warmstart: torch.Tensor
  qfrc_applied: torch.Tensor
  xfrc_applied: torch.Tensor
  eq_active: torch.Tensor      # (W, neq) bool
  xpos: torch.Tensor
  xquat: torch.Tensor
  xmat: torch.Tensor
  xipos: torch.Tensor
  ximat: torch.Tensor
  xanchor: torch.Tensor
  xaxis: torch.Tensor
  geom_xpos: torch.Tensor
  geom_xmat: torch.Tensor
  site_xpos: torch.Tensor
  site_xmat: torch.Tensor
  cam_xpos: torch.Tensor
  cam_xmat: torch.Tensor
  light_xpos: torch.Tensor
  light_xdir: torch.Tensor
  subtree_com: torch.Tensor
  cinert: torch.Tensor
  cdof: torch.Tensor
  crb: torch.Tensor
  cvel: torch.Tensor
  cdof_dot: torch.Tensor
  cacc: torch.Tensor
  cfrc_ext: torch.Tensor       # (W, nbody, 6) from rne_postconstraint
  cfrc_int: torch.Tensor       # (W, nbody, 6)
  qM: torch.Tensor
  qLD: torch.Tensor
  actuator_length: torch.Tensor
  actuator_moment: torch.Tensor
  actuator_velocity: torch.Tensor
  actuator_force: torch.Tensor
  act_dot: torch.Tensor
  qfrc_spring: torch.Tensor
  qfrc_damper: torch.Tensor
  qfrc_passive: torch.Tensor
  qfrc_bias: torch.Tensor
  qfrc_actuator: torch.Tensor
  qfrc_smooth: torch.Tensor
  qacc_smooth: torch.Tensor
  qacc_euler: torch.Tensor
  qfrc_constraint: torch.Tensor
  qacc: torch.Tensor
  contact: Contact
  efc_type: torch.Tensor
  efc_id: torch.Tensor
  efc_J: torch.Tensor
  efc_pos: torch.Tensor
  efc_margin: torch.Tensor
  efc_D: torch.Tensor
  efc_vel: torch.Tensor
  efc_aref: torch.Tensor
  efc_frictionloss: torch.Tensor
  efc_force: torch.Tensor
  efc_active: torch.Tensor
  sensordata: torch.Tensor     # (W, nsensordata)

  @property
  def nworld(self) -> int:
    return self.qpos.shape[0]


DATA_TENSORS = tuple(f for f in _tensor_fields(Data) if f != 'contact')
CONTACT_TENSORS = _tensor_fields(Contact)

del Any
