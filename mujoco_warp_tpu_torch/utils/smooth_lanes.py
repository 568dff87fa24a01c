"""Time kernel B1 (csrc/smooth.cu) at each lane count of
kernels.smooth.LANES on both models, and check that every lane count
gives the same bits.

    python3 mujoco_warp_tpu_torch/utils/smooth_lanes.py

On 8192 worlds of each model after 10 steps (seeded qpos noise), prints
per model and lane count the card's busy time per launch (twice, in the
order 8, 16, 32, 32, 16, 8), the launch shape (blocks and warps resident
per SM), whether the outputs are bit-equal to those at 32 lanes, the
lane count that kernels.smooth chose, and the card's name and power
limit. It exits 1 if a lane count changes a bit. It needs a card.
"""

import json
import os
import sys

NWORLD = 8192
PREP_STEPS = 10


def main() -> int:
  sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__)))))
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import models
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  from mujoco_warp_tpu_torch.bench import card as bench_card
  from mujoco_warp_tpu_torch.utils.compare_trees import device_ms
  card = bench_card()
  bad = 0
  for npz, nconmax in ((models.HUMANOID_NPZ, 24),
                       (models.THREE_HUMANOIDS_NPZ, 100)):
    m = mt.load_model(npz, device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    d = mt.make_batch(m, mt.make_data(m, nconmax=nconmax), NWORLD,
                      qpos_noise=0.01, generator=gen)
    d = bench.rollout(m, d, PREP_STEPS)
    run = lambda: ks.smooth(m, d.qpos, d.qvel)
    run()
    chosen = ks.lanes(m)
    per_entry = _build.model_tables(m, 'smooth', ks._tables)['lanes']
    outs, rows = {}, {}
    for g in ks.LANES + ks.LANES[::-1]:
      per_entry[''] = g
      outs[g] = run()
      grid, block, smem, per_sm = _build.shapes[('smooth', '')]
      rows.setdefault(g, dict(ms=[], blocks_per_sm=per_sm,
                              warps_per_sm=per_sm * block // 32))
      rows[g]['ms'].append(device_ms(run))
    per_entry[''] = chosen
    ref = outs[ks.LANES[-1]]
    for g, out in outs.items():
      diff = [k for k in ref if not torch.equal(out[k], ref[k])]
      rows[g]['bit_equal_to_32'] = not diff
      bad += bool(diff)
    print(json.dumps(dict(model=os.path.basename(npz), chosen=chosen,
                          lanes=rows, card=card)))
  return 1 if bad else 0


if __name__ == '__main__':
  sys.exit(main())
