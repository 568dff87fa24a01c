"""Sensors of the port's gate (FRAMEQUAT, MAGNETOMETER, GYRO,
ACCELEROMETER on sites and bodies), staged as position, velocity and
acceleration sensors, over a batch of worlds.

Mirrors `mujoco_warp_tpu/sensor.py`: `_obj_frame` :213, `_obj_quat`
:228, `_obj_body`, `_apply_cutoff` :258, `sensor_pos` :279, `sensor_vel`
:432 and `sensor_acc` :517 (the acceleration stage first runs
`support.rne_postconstraint`, which replaces cacc). Noise is not
applied, as in the JAX package and C MuJoCo. `io.put_model` refuses
every other sensor type by name.
"""

from __future__ import annotations

import torch

from . import math
from . import support
from .types import Data, DisableBit, Model, ObjType, SensorType

# the sensors that read rne_postconstraint's cacc (and pre-advance qvel)
RNE_POST_SENSORS = (SensorType.ACCELEROMETER,)


def _obj_frame(m: Model, d: Data, objtype: int, objid: int):
  """World position (W, 3) and frame (W, 3, 3) of a sensor's object."""
  if objtype == ObjType.BODY:
    return d.xipos[:, objid], d.ximat[:, objid]
  if objtype == ObjType.XBODY:
    return d.xpos[:, objid], d.xmat[:, objid]
  if objtype == ObjType.SITE:
    return d.site_xpos[:, objid], d.site_xmat[:, objid]
  raise NotImplementedError(f'sensor object type {objtype}')


def _obj_quat(m: Model, d: Data, objtype: int, objid: int):
  """World orientation (W, 4) of a sensor's object."""
  if objtype == ObjType.BODY:
    return math.mul_quat(d.xquat[:, objid], m.body_iquat[objid])
  if objtype == ObjType.XBODY:
    return d.xquat[:, objid]
  if objtype == ObjType.SITE:
    return math.mul_quat(d.xquat[:, m.site_bodyid[objid]],
                         m.site_quat[objid])
  raise NotImplementedError(f'sensor object type {objtype}')


def _obj_body(m: Model, objtype: int, objid: int) -> int:
  if objtype in (ObjType.BODY, ObjType.XBODY):
    return objid
  if objtype == ObjType.SITE:
    return m.site_bodyid[objid]
  raise NotImplementedError(f'sensor object type {objtype}')


def _mtv(mat, v):
  """mat^T v of (W, 3, 3) frames and (W, 3) or (3,) vectors."""
  return torch.einsum('wji,wj->wi', mat, v.expand(mat.shape[:-1]))


def _apply_cutoff(m: Model, sd, stage: int):
  """Clamp the stage's sensors with a cutoff > 0 to [-cutoff, cutoff]."""
  for s in range(m.nsensor):
    if m.sensor_needstage[s] != stage:
      continue
    adr, dim = m.sensor_adr[s], m.sensor_dim[s]
    c = m.sensor_cutoff[s]
    window = sd[:, adr:adr + dim]
    clamped = torch.minimum(torch.maximum(window, -c), c)
    sd[:, adr:adr + dim] = torch.where(c > 0, clamped, window)
  return sd


def _active(m: Model) -> bool:
  return m.nsensor > 0 and not m.opt.disableflags & DisableBit.SENSOR


def sensor_pos(m: Model, d: Data) -> Data:
  """FRAMEQUAT (relative to the reference object's frame when there is
  one) and MAGNETOMETER (opt.magnetic in the object's frame)."""
  if not _active(m):
    return d
  sd = d.sensordata.clone()
  for s in range(m.nsensor):
    if m.sensor_needstage[s] != 1:
      continue
    stype, adr = m.sensor_type[s], m.sensor_adr[s]
    objtype, objid = m.sensor_objtype[s], m.sensor_objid[s]
    if stype == SensorType.FRAMEQUAT:
      q = _obj_quat(m, d, objtype, objid)
      refid = m.sensor_refid[s]
      if refid >= 0:
        rq = _obj_quat(m, d, m.sensor_reftype[s], refid)
        rq = torch.cat([rq[:, :1], -rq[:, 1:]], -1)
        q = math.mul_quat(rq, q)
      sd[:, adr:adr + 4] = q
    elif stype == SensorType.MAGNETOMETER:
      _, mat = _obj_frame(m, d, objtype, objid)
      sd[:, adr:adr + 3] = _mtv(mat, m.opt.magnetic)
    else:
      raise NotImplementedError(f'position sensor {SensorType(stype).name}')
  return d.replace(sensordata=_apply_cutoff(m, sd, 1))


def sensor_vel(m: Model, d: Data) -> Data:
  """GYRO: the object's angular velocity in its frame."""
  if not _active(m):
    return d
  sd = d.sensordata.clone()
  for s in range(m.nsensor):
    if m.sensor_needstage[s] != 2:
      continue
    stype, adr = m.sensor_type[s], m.sensor_adr[s]
    objtype, objid = m.sensor_objtype[s], m.sensor_objid[s]
    if stype == SensorType.GYRO:
      body = _obj_body(m, objtype, objid)
      _, mat = _obj_frame(m, d, objtype, objid)
      sd[:, adr:adr + 3] = _mtv(mat, d.cvel[:, body, :3])
    else:
      raise NotImplementedError(f'velocity sensor {SensorType(stype).name}')
  return d.replace(sensordata=_apply_cutoff(m, sd, 2))


def needs_rne_post(m: Model) -> bool:
  """Whether an acceleration sensor reads rne_postconstraint, and so
  the velocity before the step's advance (JAX `forward._needs_preadv`)."""
  return _active(m) and any(t in RNE_POST_SENSORS for t in m.sensor_type)


def sensor_acc(m: Model, d: Data) -> Data:
  """ACCELEROMETER: the object's linear acceleration in its frame,
  gravity included, after rne_postconstraint."""
  if not _active(m):
    return d
  if needs_rne_post(m):
    d = d.replace(**support.rne_postconstraint(m, d))
  sd = d.sensordata.clone()
  for s in range(m.nsensor):
    if m.sensor_needstage[s] != 3:
      continue
    stype, adr = m.sensor_type[s], m.sensor_adr[s]
    objtype, objid = m.sensor_objtype[s], m.sensor_objid[s]
    if stype == SensorType.ACCELEROMETER:
      pos, mat = _obj_frame(m, d, objtype, objid)
      acc, _ = support.object_acceleration(m, d, pos,
                                           _obj_body(m, objtype, objid))
      sd[:, adr:adr + 3] = _mtv(mat, acc[:, 3:])
    else:
      raise NotImplementedError(
          f'acceleration sensor {SensorType(stype).name}')
  return d.replace(sensordata=_apply_cutoff(m, sd, 3))
