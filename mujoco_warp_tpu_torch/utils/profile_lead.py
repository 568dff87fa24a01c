"""How many of a profiled window's first kernels torch.profiler records on
the card, and how many short kernels a profile must start with so that
it records them all.

    python3 mujoco_warp_tpu_torch/utils/profile_lead.py

On aloha_pot at 8192 worlds (chip_smoke.py phase (u)) profiles, three
times each, windows that begin with the lift_pot replay's step, whose
ctrl takes three kernels before B1: one replayed step and one eager step
after 0, 16 and chip_smoke's PROFILE_LEAD kernels of the profile's own
(`torch.cuda._sleep` of PROFILE_LEAD_CYCLES cycles, waited for); and
chip_smoke's counted window of the lift_pot replay (`benchmark_replay`
over ALOHA_COUNT steps, chip_smoke's `_profile`). Prints the launches
of B1 and B3e that each window recorded, and of the lead kernels. Needs
a card.
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRIES = 3


def main() -> int:
  sys.path.insert(0, HERE)
  import torch
  import chip_smoke as cs
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import io, models
  from mujoco_warp_tpu_torch.bench import card
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  _build.build_all()
  m = mt.load_model(models.ALOHA_POT_NPZ, device='cuda')
  W, C = cs.ALOHA_NWORLD, cs.ALOHA_NCONMAX
  keys = io.find_keys(m, 'lift_pot')
  d0 = io.reset_data(m, mt.make_data(m, nconmax=C), keyframe=keys[0])
  traj = torch.as_tensor(io.make_trajectory(m, keys), device='cuda')
  batch = mt.make_batch(m, d0, W)
  one_step = bench.replay_step(m, W, traj)
  step = torch.full((), 1, dtype=torch.int32, device='cuda')
  bench.warm_step(one_step, batch, step)
  graph = bench.GraphStep(one_step, batch, step)
  print(f'aloha_pot at {W} worlds, the lift_pot replay ({card()})')

  def count(fn, lead, nstep=1):
    rows = cs._profile(fn, nstep, lead)
    c = cs._card_counts(rows, nstep)
    return c['smooth'], c['glue_ell'], int(round(sum(r[1] for r in rows) *
                                                 nstep))
  for lead in (0, 16, cs.PROFILE_LEAD):
    for label, fn in (('one replayed step', graph.replay),
                      ('one eager step', lambda: bench.warm_step(
                          one_step, batch, step))):
      seen = [count(fn, lead) for _ in range(TRIES)]
      print(f'  {label} after {lead} lead kernels: (B1, B3e, all '
            f'kernels) recorded in {TRIES} windows {seen}', flush=True)
  nstep = cs._bench_nstep(cs.ALOHA_COUNT)
  seen = [count(lambda: bench.benchmark_replay(m, batch, traj, nstep=nstep),
                cs.PROFILE_LEAD) for _ in range(TRIES)]
  print(f'  benchmark_replay over {cs.ALOHA_COUNT} steps after '
        f'{cs.PROFILE_LEAD} lead kernels: (B1, B3e, all kernels) recorded '
        f'in {TRIES} windows {seen}; each kernel runs once a step')

  # how many of the lead kernels themselves are recorded
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  for lead in (16, cs.PROFILE_LEAD):
    seen = []
    for _ in range(TRIES):
      torch.cuda.synchronize()
      with torch.profiler.profile(activities=acts) as prof:
        for _ in range(lead):
          torch.cuda._sleep(cs.PROFILE_LEAD_CYCLES)
        torch.cuda.synchronize()
      seen.append(sum(1 for e in prof.events() if e.device_type ==
                      torch.autograd.DeviceType.CUDA and
                      'spin_kernel' in e.name))
    print(f'  {lead} lead kernels alone: recorded {seen}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
