"""How far kitchen's MPR families (cylinder-cylinder, cylinder-box) part
from their float64 selves in float32, beside the float64 collider after
one ulp of the frames (the witness of chip_smoke.py's
`_hold_sap_narrowphase`) and beside the float32 collider on frames
rounded to float16 and to bfloat16 (controls the hold must fail).

    python3 mujoco_warp_tpu_torch/utils/mpr_spread.py [NWORLD] \
        [--device cpu]

The state: chip_smoke's rich kitchen state (`_kitchen_rich`, seed 0) at
NWORLD worlds (256 by default), B1's plain version's frames, each
family's pairs kept by the cull at nconmax 64. For each way prints the
pairs with a candidate, the pairs off (`chip_smoke._float64_off` at
KITCHEN_TOL: an error over it or another number of contacts) and their
share, the pairs with another number of contacts, the pairs over each of
1e-5, 1e-4, 1e-3 and 5e-3, and the errors' 50th, 90th and 99th
percentiles.
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv) -> int:
  sys.path.insert(0, HERE)
  import torch
  import chip_smoke as cs
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import collision_driver, collision_sap, models
  from mujoco_warp_tpu_torch import smooth
  from mujoco_warp_tpu_torch.bench import card
  from mujoco_warp_tpu_torch.types import GeomType
  dev = 'cpu' if '--device' in argv and 'cpu' in argv else 'cuda'
  nums = [int(a) for a in argv if a.isdigit()]
  W = nums[0] if nums else 256
  m = mt.load_model(models.KITCHEN_NPZ, device=dev)
  d0 = mt.make_data(m, nconmax=cs.KITCHEN_NCONMAX)
  rich = cs._kitchen_rich(m, d0, W, torch.Generator(device=dev)
                          .manual_seed(cs.SEED))
  sm = smooth.smooth(m, rich.qpos, rich.qvel)
  gx, gm = sm['geom_xpos'], sm['geom_xmat']
  m64 = m.replace(geom_size=m.geom_size.double(),
                  mesh_hullvert_small=m.mesh_hullvert_small.double())
  tables = collision_sap.sap_tables(m)
  cw, hw = collision_sap.world_aabbs(m, gx, gm)
  nudged = lambda x, to: torch.nextafter(x, torch.full_like(x, to)).double()
  print(f'kitchen\'s rich state at {W} worlds; {dev} '
        f'({card() if dev == "cuda" else "the CPU"})')
  for (t1, t2, start, count), fam in zip(m.sap_families, tables['families']):
    if fam['extra'] != 'hulls+margin':
      continue
    kk = collision_sap.family_slots(count, cs.KITCHEN_NCONMAX)
    sel, valid, _ = collision_sap.cull(cw, hw, fam['g1'], fam['g2'], kk)
    margin = tables['params']['margin'][start + sel]

    def run(mm, x, r):
      dist, pos, frame = collision_driver.narrowphase(
          mm, fam, x, r, margin.to(x.dtype), sel)
      return torch.where(valid[..., None], dist, 1e10), pos, frame
    b = run(m64, gx.double(), gm.double())
    scale = max(1.0, float(b[1].abs().max()))
    ways = {
        'float32': run(m, gx, gm),
        'float64, frames + 1 ulp': run(m64, nudged(gx, float('inf')),
                                       nudged(gm, float('inf'))),
        'float64, frames - 1 ulp': run(m64, nudged(gx, float('-inf')),
                                       nudged(gm, float('-inf'))),
        'float32, float16 frames': run(m, gx.half().float(),
                                       gm.half().float()),
        'float32, bfloat16 frames': run(m, gx.bfloat16().float(),
                                        gm.bfloat16().float())}
    print(f'{GeomType(t1).name.lower()}-{GeomType(t2).name.lower()}: {kk} '
          f'of {count} pairs kept')
    for name, a in ways.items():
      off, err, cand, nslot = cs._float64_off(a, b, scale, True,
                                              cs.KITCHEN_TOL)
      nc = max(1, int(cand.sum()))
      e = err[cand].double()
      q = torch.quantile(e, torch.tensor([0.5, 0.9, 0.99], dtype=e.dtype,
                                         device=e.device))
      print(f'  {name:25s} {int(cand.sum())} with a candidate, '
            f'{int(off.sum())} off ({int(off.sum()) / nc:.3f}), '
            f'{int(nslot.sum())} with another number of contacts; over ' +
            ', '.join(f'{t:g} {int((e > t).sum())}'
                      for t in (1e-5, 1e-4, 1e-3, 5e-3)) +
            '; percentiles 50/90/99 ' +
            ' '.join(f'{x:.2e}' for x in q.tolist()))
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
