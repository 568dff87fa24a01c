"""Box-box collision: the separating-axis search and the contact manifold
of C MuJoCo's mjc_BoxBox, up to 8 contacts a pair.

Mirrors `mujoco_warp_tpu/collision_box.py` (`_sat` :50, `_face_case`
:125, `_edge_case` :220, `box_box` :385) over leading batch axes: every
branch is a mask, the face and the edge manifolds are both built (24
candidate points each) and one is selected, and the 8 deepest valid
candidates are kept, ties to the lower candidate index. Empty slots
carry dist 1e10. Each product is rounded and the sums run in one order,
as kernel B2 computes them without contraction, so that a candidate at
a clipping boundary is valid in both or in neither.
"""

from __future__ import annotations

import numpy as np
import torch

from . import math

_EPS = 1e-12
_BIG = 1e10

# rotations that take face k of a box to +z (C mjc_BoxBox's rotmore)
ROTMORE = np.zeros((6, 3, 3), dtype=np.float32)
ROTMORE[0, 0, 2], ROTMORE[0, 1, 1], ROTMORE[0, 2, 0] = -1, 1, 1
ROTMORE[1, 0, 0], ROTMORE[1, 1, 2], ROTMORE[1, 2, 1] = 1, -1, 1
ROTMORE[2, 0, 0], ROTMORE[2, 1, 1], ROTMORE[2, 2, 2] = 1, 1, 1
ROTMORE[3, 0, 2], ROTMORE[3, 1, 1], ROTMORE[3, 2, 0] = 1, 1, -1
ROTMORE[4, 0, 0], ROTMORE[4, 1, 2], ROTMORE[4, 2, 1] = 1, 1, -1
ROTMORE[5, 0, 0], ROTMORE[5, 1, 1], ROTMORE[5, 2, 2] = -1, 1, -1


def _mm(a, b):
  return torch.stack([math.mv3(a, b[..., :, j]) for j in range(3)], -1)


def _t(mat):
  return mat.transpose(-1, -2)


def _take(x, idx):
  """x[..., idx] for an int64 index tensor idx of the leading shape."""
  return torch.gather(x, -1, idx[..., None])[..., 0]


def _row(mat, idx):
  """Row idx of each (..., 3, 3) matrix."""
  return torch.gather(mat, -2, idx[..., None, None].expand(
      idx.shape + (1, 3)))[..., 0, :]


def _rotmore(idx, like):
  return torch.as_tensor(ROTMORE, dtype=like.dtype, device=like.device)[idx]


def _sign(b):
  return torch.where(b, 1.0, -1.0)


def _sat(pos21, pos12, rot21, rot21abs, s1, s2, margin):
  """The separating-axis scan in C's candidate order: (fail, axis_code
  (0-5 a face of box 1, 6-11 of box 2, 12 + 3 i + j the edge pair i,
  j), the edge axis, whether it points from box 2 to box 1, and the
  edges' corner bits cle1, cle2)."""
  rot12 = _t(rot21)
  plen2 = math.mv3(rot21abs, s2)
  plen1 = math.mtv3(rot21abs, s1)
  ss = s1 + s2
  sep = margin + 3.0 * ((ss[..., 0] + ss[..., 1]) + ss[..., 2])
  shape = sep.shape
  dev = sep.device
  axis_code = torch.full(shape, -1, dtype=torch.int64, device=dev)
  fail = torch.zeros(shape, dtype=torch.bool, device=dev)
  for i in range(3):
    c1 = -torch.abs(pos21[..., i]) + s1[..., i] + plen2[..., i]
    c2 = -torch.abs(pos12[..., i]) + s2[..., i] + plen1[..., i]
    fail = fail | (c1 < -margin) | (c2 < -margin)
    upd = c1 < sep
    axis_code = torch.where(upd, i + 3 * (pos21[..., i] < 0).long(),
                            axis_code)
    sep = torch.where(upd, c1, sep)
    upd = c2 < sep
    axis_code = torch.where(upd, i + 3 * (pos12[..., i] < 0).long() + 6,
                            axis_code)
    sep = torch.where(upd, c2, sep)

  clnorm = torch.zeros_like(pos21)
  inv = torch.zeros(shape, dtype=torch.bool, device=dev)
  cle1 = torch.zeros(shape, dtype=torch.int64, device=dev)
  cle2 = torch.zeros(shape, dtype=torch.int64, device=dev)
  zero = torch.zeros(shape, dtype=pos21.dtype, device=dev)
  for i in range(3):
    for j in range(3):
      r = rot12[..., j, :]
      if i == 0:
        cross = torch.stack([zero, -r[..., 2], r[..., 1]], -1)
      elif i == 1:
        cross = torch.stack([r[..., 2], zero, -r[..., 0]], -1)
      else:
        cross = torch.stack([-r[..., 1], r[..., 0], zero], -1)
      clen = torch.sqrt(math.dot3(cross, cross))
      ok = clen >= 1e-9
      clen_s = torch.where(ok, clen, torch.ones_like(clen))
      axis = cross / clen_s[..., None]
      box_dist = math.dot3(pos21, axis)
      c3 = -torch.abs(box_dist)
      for k in range(3):
        if k != i:
          c3 = c3 + s1[..., k] * torch.abs(axis[..., k])
        if k != j:
          c3 = c3 + s2[..., k] * rot21abs[..., i, 3 - k - j] / clen_s
      fail = fail | (ok & (c3 < -margin))
      upd = ok & (c3 < sep * (1.0 - 1e-12))
      c1b = torch.zeros_like(cle1)
      c2b = torch.zeros_like(cle2)
      for k in range(3):
        if k != i:
          bit = (axis[..., k] > 0) ^ (box_dist < 0)
          c1b = c1b + bit.long() * (1 << k)
        if k != j:
          bit = ((rot21[..., i, 3 - k - j] > 0) ^ (box_dist < 0) ^
                 (((k - j + 3) % 3) == 1))
          c2b = c2b + bit.long() * (1 << k)
      sep = torch.where(upd, c3, sep)
      axis_code = torch.where(upd, 12 + i * 3 + j, axis_code)
      clnorm = torch.where(upd[..., None], axis, clnorm)
      inv = torch.where(upd, box_dist < 0, inv)
      cle1 = torch.where(upd, c1b, cle1)
      cle2 = torch.where(upd, c2b, cle2)
  fail = fail | (axis_code < 0)
  return fail, axis_code, clnorm, inv, cle1, cle2


def _vec(x, y, z):
  x, y, z = torch.broadcast_tensors(x, y, z)
  return torch.stack([x, y, z], -1)


def _face_case(axis_code, pos21, pos12, rot21, p1, m1, s1, p2, m2, s2,
               margin):
  """The manifold of a face axis: the incident face's edges clipped
  against the reference face's rectangle, the rectangle's corners
  inside the incident face, and the incident face's corners inside the
  rectangle (24 candidates: depth, world point, validity; and the
  normal)."""
  rot12 = _t(rot21)
  code = torch.clamp(axis_code, 0, 11)
  rotmore = _rotmore(code % 6, pos21)
  bi = (code // 6) == 1
  r = _mm(rotmore, torch.where(bi[..., None, None], rot12, rot21))
  p = math.mv3(rotmore, torch.where(bi[..., None], pos12, pos21))
  ss = torch.abs(math.mv3(rotmore, torch.where(bi[..., None], s2, s1)))
  s_o = torch.where(bi[..., None], s1, s2)
  lx, ly, hz = ss[..., 0], ss[..., 1], ss[..., 2]
  p = torch.stack([p[..., 0], p[..., 1], p[..., 2] - hz], -1)

  rt = [r[..., :, i] for i in range(3)]           # rows of r^T
  clc = [r[..., 2, i] < 0 for i in range(3)]
  lp = p
  for i in range(3):
    lp = lp + rt[i] * s_o[..., i:i + 1] * _sign(clc[i])[..., None]
  wf = torch.stack([(torch.abs(r[..., 2, i]) < 0.5).to(p.dtype)
                    for i in range(3)], -1)
  dirs = wf.sum(-1)
  cns = torch.stack([rt[i] * s_o[..., i:i + 1] *
                     torch.where(clc[i], -2.0, 2.0)[..., None]
                     for i in range(3)], -2)      # (..., 3, 3)
  order = torch.sort(-wf, dim=-1, stable=True).indices
  cn1 = _row(cns, order[..., 0]) * _take(wf, order[..., 0])[..., None]
  cn2 = _row(cns, order[..., 1]) * _take(wf, order[..., 1])[..., None]
  dirs2 = dirs == 2

  pts, valids = [], []
  lines = [(lp, cn1, dirs >= 1), (lp, cn2, dirs2), (lp + cn1, cn2, dirs2),
           (lp + cn2, cn1, dirs2)]
  for la, lb, lex in lines:
    for q in (0, 1):
      denom_ok = torch.abs(lb[..., q]) > 1e-9
      br = 1.0 / torch.where(denom_ok, lb[..., q], 1.0)
      for j in (-1.0, 1.0):
        l = ss[..., q] * j
        c1 = (l - la[..., q]) * br
        c2 = la[..., 1 - q] + lb[..., 1 - q] * c1
        valids.append(lex & denom_ok & (c1 >= 0) & (c1 <= 1) &
                      (torch.abs(c2) <= ss[..., 1 - q]))
        pts.append(la + c1[..., None] * lb)

  ax_, bx_ = cn1[..., 0], cn2[..., 0]
  ay_, by_ = cn1[..., 1], cn2[..., 1]
  det = ax_ * by_ - bx_ * ay_
  cdet = 1.0 / torch.where(torch.abs(det) < _EPS, 1.0, det)
  for i in range(4):
    llx = lx if i // 2 else -lx
    lly = ly if i % 2 else -ly
    x = llx - lp[..., 0]
    y = lly - lp[..., 1]
    u = (x * by_ - y * bx_) * cdet
    v = (y * ax_ - x * ay_) * cdet
    valids.append(dirs2 & (u > 0) & (v > 0) & (u < 1) & (v < 1))
    pts.append(_vec(llx, lly, lp[..., 2] + u * cn1[..., 2] +
                    v * cn2[..., 2]))

  for i in range(4):
    exist = dirs2 | (i < 2)
    tmpv = lp + (i & 1) * cn1 + (1.0 if i & 2 else 0.0) * cn2
    valids.append(exist & (tmpv[..., 0] > -lx) & (tmpv[..., 0] < lx) &
                  (tmpv[..., 1] > -ly) & (tmpv[..., 1] < ly))
    pts.append(tmpv)

  pts = torch.stack(pts, -2)                      # (..., 24, 3)
  depth = pts[..., 2]
  valid = torch.stack(valids, -1) & (depth <= margin[..., None])
  out = torch.stack([pts[..., 0], pts[..., 1], pts[..., 2] * 0.5 +
                     hz[..., None]], -1)
  rw = _mm(torch.where(bi[..., None, None], m2, m1), _t(rotmore))
  pw = torch.where(bi[..., None], p2, p1)
  normal = torch.where(bi, -1.0, 1.0)[..., None] * rw[..., :, 2]
  world = math.mv3(rw[..., None, :, :], out) + pw[..., None, :]
  return depth, world, normal, valid


def _edge_case(axis_code, pos21, rot21, rot21abs, clnorm, inv, cle1, cle2,
               p1, m1, s1, s2, margin):
  """The manifold of an edge-edge axis: box 2's face nearest box 1,
  projected along the axis onto box 1's face, clipped against its
  rectangle (24 candidates, as `_face_case`)."""
  code = torch.clamp(axis_code - 12, 0, 8)
  edge1 = code // 3
  edge2 = code % 3

  ax1 = 1 - (edge2 & 1)
  ax2 = 2 - (edge2 & 2)
  r21_e1 = _row(rot21abs, edge1)
  swap2 = _take(r21_e1, ax1) < _take(r21_e1, ax2)
  ax1, ax2 = torch.where(swap2, ax2, ax1), torch.where(swap2, ax1, ax2)
  pax1 = 1 - (edge1 & 1)
  pax2 = 2 - (edge1 & 2)
  r12_e2 = _row(_t(rot21abs), edge2)
  swap1 = _take(r12_e2, pax1) < _take(r12_e2, pax2)
  pax1, pax2 = torch.where(swap1, pax2, pax1), torch.where(swap1, pax1, pax2)

  bit1 = ((cle1 >> pax2) & 1).bool()
  rotmore = _rotmore(torch.where(bit1, pax2, pax2 + 3), pos21)
  p = math.mv3(rotmore, pos21)
  rnorm = math.mv3(rotmore, clnorm)
  r = _mm(rotmore, rot21)
  rt = _t(r)
  s = torch.abs(math.mtv3(rotmore, s1))
  lx, ly, hz = s[..., 0], s[..., 1], s[..., 2]
  p = torch.stack([p[..., 0], p[..., 1], p[..., 2] - hz], -1)

  sgn = lambda bits, a: _sign(((bits >> a) & 1).bool())[..., None]
  rt_ax1, rt_ax2, rt_e2 = _row(rt, ax1), _row(rt, ax2), _row(rt, edge2)
  s2_ax1 = _take(s2, ax1)[..., None]
  s2_ax2 = _take(s2, ax2)[..., None]
  s2_e2 = _take(s2, edge2)[..., None]

  pt0 = p + rt_ax1 * s2_ax1 * sgn(cle2, ax1) + rt_ax2 * s2_ax2 * sgn(
      cle2, ax2)
  pt1 = pt0 - rt_e2 * s2_e2
  pt0 = pt0 + rt_e2 * s2_e2
  pt2 = p + rt_ax1 * s2_ax1 * (-sgn(cle2, ax1)) + rt_ax2 * s2_ax2 * sgn(
      cle2, ax2)
  pt3 = pt2 - rt_e2 * s2_e2
  pt2 = pt2 + rt_e2 * s2_e2
  quad = [pt0, pt1, pt2, pt3]
  axi_lp, axi_cn1, axi_cn2 = pt0, pt1 - pt0, pt2 - pt0

  norm_ok = torch.abs(rnorm[..., 2]) >= 1e-9
  isign = torch.where(inv, -1.0, 1.0)
  innorm = isign / torch.where(norm_ok, rnorm[..., 2], 1.0)
  proj = [q - rnorm * (q[..., 2] * isign * innorm)[..., None]
          for q in quad]
  pts_lp, pts_cn1, pts_cn2 = proj[0], proj[1] - proj[0], proj[2] - proj[0]

  pts, depths, valids = [], [], []
  lines = [(pts_lp, pts_cn1, axi_lp, axi_cn1),
           (pts_lp, pts_cn2, axi_lp, axi_cn2),
           (pts_lp + pts_cn1, pts_cn2, axi_lp + axi_cn1, axi_cn2),
           (pts_lp + pts_cn2, pts_cn1, axi_lp + axi_cn2, axi_cn1)]
  for la, lb, lua, lub in lines:
    for q in (0, 1):
      denom_ok = torch.abs(lb[..., q]) > 1e-9
      br = 1.0 / torch.where(denom_ok, lb[..., q], 1.0)
      for j in (-1.0, 1.0):
        l = s[..., q] * j
        c1 = (l - la[..., q]) * br
        c2 = la[..., 1 - q] + lb[..., 1 - q] * c1
        zval = (lua[..., 2] + lub[..., 2] * c1) * innorm
        valids.append(denom_ok & (c1 >= 0) & (c1 <= 1) &
                      (torch.abs(c2) <= s[..., 1 - q]) & (zval <= margin))
        pt = lua * 0.5 + c1[..., None] * lub * 0.5
        add = [0.5 * l, 0.5 * c2] if q == 0 else [0.5 * c2, 0.5 * l]
        pt = torch.stack([pt[..., 0] + add[0], pt[..., 1] + add[1],
                          pt[..., 2]], -1)
        pts.append(pt)
        depths.append(pt[..., 2] * innorm * 2.0)
  nl = torch.stack(valids, -1).sum(-1)

  ax_, bx_ = pts_cn1[..., 0], pts_cn2[..., 0]
  ay_, by_ = pts_cn1[..., 1], pts_cn2[..., 1]
  det = ax_ * by_ - bx_ * ay_
  cdet = 1.0 / torch.where(torch.abs(det) < _EPS, 1.0, det)
  corner = []
  for i in range(4):
    llx = lx if i // 2 else -lx
    lly = ly if i % 2 else -ly
    x = llx - pts_lp[..., 0]
    y = lly - pts_lp[..., 1]
    u = (x * by_ - y * bx_) * cdet
    v = (y * ax_ - x * ay_) * cdet
    loose = ~(((u < 0) | (u > 1)) & ((v < 0) | (v > 1)))
    strict = (u >= 0) & (v >= 0) & (u <= 1) & (v <= 1)
    accept = torch.where(nl == 0, loose, strict)
    uc = torch.clamp(u, 0.0, 1.0)
    vc = torch.clamp(v, 0.0, 1.0)
    wc = 1.0 - uc - vc
    vtmp = (quad[0] * wc[..., None] + quad[1] * uc[..., None] +
            quad[2] * vc[..., None])
    pt = _vec(llx, lly, torch.zeros_like(llx))
    dvec = pt - vtmp
    tc1 = math.dot3(dvec, dvec)
    accept = accept & ~((vtmp[..., 2] > 0) & (tc1 > margin * margin))
    pts.append(0.5 * (pt + vtmp))
    depths.append(torch.sqrt(tc1) * torch.where(vtmp[..., 2] < 0, -1.0,
                                                1.0))
    corner.append(accept)
    valids.append(accept)
  nf = torch.stack(corner, -1).sum(-1)

  for i in range(4):
    pu = quad[i]
    x, y = pu[..., 0], pu[..., 1]
    loose = ~(((x < -lx) | (x > lx)) & ((y < -ly) | (y > ly)))
    strict = (x >= -lx) & (x <= lx) & (y >= -ly) & (y <= ly)
    accept = torch.where((nl == 0) & (nf != 0), loose, strict)
    c1v = torch.zeros_like(x)
    tmp = [x, y]
    for jq in range(2):
      below = pu[..., jq] < -s[..., jq]
      above = pu[..., jq] > s[..., jq]
      c1v = c1v + torch.where(below, (pu[..., jq] + s[..., jq]) ** 2,
                              torch.where(above, (pu[..., jq] - s[..., jq])
                                          ** 2, 0.0))
      tmp[jq] = torch.where(below, -s[..., jq] * 0.5,
                            torch.where(above, s[..., jq] * 0.5, tmp[jq]))
    c1v = c1v + (pu[..., 2] * innorm) ** 2
    accept = accept & ~((pu[..., 2] > 0) & (c1v > margin * margin))
    pts.append((_vec(tmp[0], tmp[1], torch.zeros_like(x)) + pu) * 0.5)
    depths.append(torch.sqrt(c1v) * torch.where(pu[..., 2] < 0, -1.0, 1.0))
    valids.append(accept)

  pts = torch.stack(pts, -2)
  depth = torch.stack(depths, -1)
  valid = torch.stack(valids, -1) & norm_ok[..., None]
  rw = _mm(m1, _t(rotmore))
  normal = isign[..., None] * math.mv3(rw, rnorm)
  out = torch.stack([pts[..., 0], pts[..., 1], pts[..., 2] +
                     hz[..., None]], -1)
  world = math.mv3(rw[..., None, :, :], out) + p1[..., None, :]
  return depth, world, normal, valid


def box_box(p1, m1, s1, p2, m2, s2, margin):
  """Up to 8 contacts between boxes (pos (..., 3), mat (..., 3, 3), size
  (..., 3), margin (...)): dist (..., 8), pos (..., 8, 3), frame (...,
  8, 3, 3), the 8 deepest valid candidates deepest first."""
  margin = torch.as_tensor(margin, dtype=p1.dtype, device=p1.device)
  margin = margin.expand(p1.shape[:-1])
  s1, s2 = s1.expand(p1.shape), s2.expand(p1.shape)
  pos21 = math.mtv3(m1, p2 - p1)
  pos12 = math.mtv3(m2, p1 - p2)
  rot21 = _mm(_t(m1), m2)
  rot21abs = torch.abs(rot21)
  fail, axis_code, clnorm, inv, cle1, cle2 = _sat(
      pos21, pos12, rot21, rot21abs, s1, s2, margin)
  fd, fw, fn, fv = _face_case(axis_code, pos21, pos12, rot21, p1, m1, s1,
                              p2, m2, s2, margin)
  ed, ew, en, ev = _edge_case(axis_code, pos21, rot21, rot21abs, clnorm,
                              inv, cle1, cle2, p1, m1, s1, s2, margin)
  is_face = axis_code < 12
  depth = torch.where(is_face[..., None], fd, ed)
  world = torch.where(is_face[..., None, None], fw, ew)
  normal = torch.where(is_face[..., None], fn, en)
  valid = torch.where(is_face[..., None], fv, ev) & ~fail[..., None]

  key = torch.where(valid, -depth, -float('inf'))
  sel = torch.sort(key, dim=-1, descending=True, stable=True).indices[
      ..., :8]
  valid8 = torch.gather(valid, -1, sel)
  dist = torch.where(valid8, torch.gather(depth, -1, sel), _BIG)
  pos = torch.where(valid8[..., None], torch.gather(
      world, -2, sel[..., None].expand(sel.shape + (3,))), 0.0)
  frame = math.make_frame(normal)[..., None, :, :].expand(
      dist.shape + (3, 3))
  return dist, pos, frame
