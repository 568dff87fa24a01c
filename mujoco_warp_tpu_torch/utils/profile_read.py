"""How long torch.profiler takes to read a window of many short kernels,
by its `events()` and by its raw records (`compare_trees.device_records`),
and whether the two agree, on the card.

    python3 mujoco_warp_tpu_torch/utils/profile_read.py

Captures KERNELS one-element additions in one CUDA graph and profiles one
replay with chip_smoke.py's `_profile`, whose first profile of a run reads
its records both ways and prints which way the run keeps; prints the
kernels it recorded, and its own lead and trail kernels. Then times each
way of reading one more profile of a replay, and `compare_trees.device_ms`
of a replay. Needs a card.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KERNELS = 100_000


def main() -> int:
  sys.path.insert(0, HERE)
  import torch
  import chip_smoke as cs
  from mujoco_warp_tpu_torch.bench import card
  from mujoco_warp_tpu_torch.utils.compare_trees import (device_ms,
                                                         device_records)
  x = torch.zeros(1, device='cuda')
  x.add_(1)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(KERNELS):
      x.add_(1)
  print(f'{KERNELS} one-element additions in one graph ({card()})')
  t0 = time.perf_counter()
  rows = cs._profile(graph.replay, 1)
  print(f'  chip_smoke _profile of one replay: {sum(r[1] for r in rows):.0f} '
        f'kernels recorded, {cs._own_recorded()}; raw records kept '
        f'{cs.RAW_RECORDS["ok"]}; {time.perf_counter() - t0:.2f} s in all',
        flush=True)
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    graph.replay()
    torch.cuda.synchronize()
  for raw in (True, False):
    t0 = time.perf_counter()
    recs = device_records(prof, raw=raw)
    print(f'  {"raw records" if raw else "events()":11s}: {len(recs)} '
          f'records, {sum(ms for _, ms in recs):.3f} device ms, read in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
  print(f'  device_ms of one replay: {device_ms(graph.replay, 3):.3f} ms')
  return 0


if __name__ == '__main__':
  sys.exit(main())
