"""How far the float32 SDF narrowphase lies from float64 on phase (v)'s
rich state, against how far the float64 narrowphase itself moves when
its inputs change by a few float32 ulps.

    python3 mujoco_warp_tpu_torch/utils/sdf_witness.py

On aloha_sdf's rich state (chip_smoke.py phase (v): 8192 worlds,
nconmax 32, gripper_gripper_pot with noise on the arms, SDF_PREP steps)
and its SDF_HOLD_WORLDS worlds, for each SDF group: the descents whose
boxes meet, those whose step-size choices part between float32 and
float64, and those whose dist, pos or frame lie over SDF_TOL of scale
from float64's. Then, for each change of the float32 geom frames (1, 4
and 8 ulps up and down; four draws of 1 and of 4 ulps, each element up
or down at random from seed 7), how many of those are not within
SDF_ULP_FACTOR times the float64 descent's move under it, for all three
values and for dist and pos alone; and the float64 normal and distance
at each float32 descent's own end point (pos + n dist / 2). Lists the
over-tolerance descents with their errors, moves and the gap |n1 - n2|
of the two normalized gradients there. Needs a card.
"""

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
  sys.path.insert(0, HERE)
  import torch
  import chip_smoke as cs
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import (collision_driver, collision_sdf as sdf,
                                     io, math, models)
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.types import GeomType
  if not torch.cuda.is_available():
    print('sdf_witness: no CUDA device', file=sys.stderr)
    return 1
  t0 = time.perf_counter()
  print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True).stdout.strip())
  print('build', _build.build_all())
  m = mt.load_model(models.ALOHA_SDF_NPZ, device='cuda')
  rich0 = io.reset_data(m, mt.make_data(m, nconmax=cs.SDF_NCONMAX),
                        keyframe=io.find_keys(m, 'gripper_gripper_pot')[0])
  gen = torch.Generator(device='cuda').manual_seed(cs.SEED)
  rich = cs._aloha_state(m, rich0, cs.SDF_NWORLD, gen, cs.SDF_PREP)
  W = rich.geom_xpos.shape[0]
  ws = torch.arange(0, W, max(1, W // cs.SDF_HOLD_WORLDS),
                    device='cuda')[:cs.SDF_HOLD_WORLDS]
  gx, gm = rich.geom_xpos[ws], rich.geom_xmat[ws]
  TOL, F = cs.SDF_TOL, cs.SDF_ULP_FACTOR
  rg = torch.Generator(device='cuda').manual_seed(7)

  def nud(x, n, up):
    for _ in range(n):
      x = torch.nextafter(x, torch.full_like(x, float('inf' if up else
                                                       '-inf')))
    return x

  def rnd(x, n):
    s = torch.rand(x.shape, generator=rg, device=x.device) < 0.5
    return torch.where(s, nud(x, n, True), nud(x, n, False))

  for (t1, t2, _), grp in zip(m.collision_pairs,
                              collision_driver._group_tables(m)):
    if grp['extra'] != 'sdf':
      continue
    g1, g2 = grp['g1'], grp['g2']
    args = (gx[:, g1], gm[:, g1], gx[:, g2], gm[:, g2])
    s64 = (grp['side1'].to(torch.float64), grp['side2'].to(torch.float64))
    run = lambda sides, xs: sdf.collide(
        *sides, grp['slots'], m.opt.sdf_iterations, *xs, trace=True)
    a = run((grp['side1'], grp['side2']), args)
    b = run(s64, [x.double() for x in args])
    meet = b[0] < 1e9
    agree = (a[3] == b[3]).all(-1) & meet
    scale = max(1.0, float(b[1].abs().max()))

    def off(x, where):
      return torch.stack([torch.where(where, (u.double() - v).abs().reshape(
          b[0].shape + (-1,)).amax(-1) / scale, 0.0)
                          for u, v in zip(x[:3], b[:3])])
    err = off(a, agree)

    def moves(xs_list):
      out = []
      for xs in xs_list:
        c = run(s64, [x.double() for x in xs])
        out.append(torch.where((c[3] == b[3]).all(-1), off(c, agree),
                               float('inf')))
      return torch.stack(out).amax(0)
    mv = {n: moves([[nud(x, n, True) for x in args],
                    [nud(x, n, False) for x in args]]) for n in (1, 4, 8)}
    mv['rnd1x4'] = moves([[rnd(x, 1) for x in args] for _ in range(4)])
    mv['rnd4x4'] = moves([[rnd(x, 4) for x in args] for _ in range(4)])
    # the float32 descent's own end point: x_w = pos + n dist / 2
    p1, M1, p2, M2 = (x.double() for x in args)
    n32 = a[2][..., 0, :].double()
    xw = a[1].double() + n32 * a[0].double()[..., None] * 0.5
    x1 = sdf._mtv(M1[:, :, None], xw - p1[:, :, None])
    x2 = sdf._mtv(M2[:, :, None], xw - p2[:, :, None])
    s1, gr1 = s64[0].sdf(x1, 1, True)
    s2, gr2 = s64[1].sdf(x2, 1, True)
    n1 = math.normalize(sdf._mv(M1[:, :, None], gr1))
    n2 = math.normalize(sdf._mv(M2[:, :, None], gr2))
    gap = (n1 - n2).norm(dim=-1)
    fown = math.make_frame(math.normalize(n1 - n2))
    own_f = torch.where(agree, (a[2].double() - fown).abs().flatten(
        -2).amax(-1), 0.0)
    own_d = torch.where(agree, (a[0].double() - torch.maximum(s1, s2)).abs()
                        / scale, 0.0)
    over = err > TOL
    names = (GeomType(t1).name, GeomType(t2).name)
    print(names, 'meet', int(meet.sum()), 'parted',
          int(meet.sum() - agree.sum()), 'over', int(over.any(0).sum()),
          [int(x) for x in over.sum((1, 2, 3))], 'own frame>tol',
          int((own_f > TOL).sum()), 'max own frame %.3e' % float(own_f.max()),
          'own dist>tol', int((own_d > TOL).sum()),
          'max own dist %.3e' % float(own_d.max()), flush=True)
    for k, mvk in mv.items():
      exc = over.any(0) & (~over | (err <= F * mvk)).all(0)
      exc_dp = over[:2].any(0) & (~over[:2] | (err[:2] <= F * mvk[:2])).all(0)
      print('   witness', k, 'all-components: excused', int(exc.sum()), 'not',
            int((over.any(0) & ~exc).sum()), '| dist/pos only: over',
            int(over[:2].any(0).sum()), 'excused', int(exc_dp.sum()), 'not',
            int((over[:2].any(0) & ~exc_dp).sum()), flush=True)
    for w, p, k in over.any(0).nonzero().tolist()[:40]:
      print('     ', (w, p, k), 'err',
            ['%.1e' % v for v in err[:, w, p, k].tolist()],
            ' '.join('%s:%s' % (name, ','.join(
                '%.1e' % v for v in mv[name][:, w, p, k].tolist()))
                     for name in mv),
            'own_f %.1e own_d %.1e gap %.2e' % (
                float(own_f[w, p, k]), float(own_d[w, p, k]),
                float(gap[w, p, k])))
  print('seconds', time.perf_counter() - t0)
  return 0


if __name__ == '__main__':
  sys.exit(main())
