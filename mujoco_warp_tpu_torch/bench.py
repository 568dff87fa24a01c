"""Headline benchmark of the PyTorch port: the humanoid at 8192 worlds,
nconmax 24, 1000 steps with OU-Halton ctrl noise, the protocol of the
JAX package's `bench.py` (the reference's `benchmarks/config.txt:22`).
Prints one JSON line with `bench.py`'s keys, plus `dispatch`; `device`
is the card's name and power limit, as nvidia-smi reads them.

    python -m mujoco_warp_tpu_torch.bench [--device cuda|cpu]

BENCH_NWORLD, BENCH_NSTEP and BENCH_NCONMAX change the sizes, as they do
for `bench.py`. The model is the committed `models/humanoid.npz`.

Baseline: the reference mujoco_warp on its nightly GPU rig, 2,729,192
steps/s (BASELINE.md).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from . import io, models
from .parallel import make_batch
from .utils.benchmark import benchmark

BASELINE = 2_729_192.0


def card() -> str:
  """The first card's name and power limit, as nvidia-smi reads them."""
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True,
      timeout=60).stdout
  return out.strip().splitlines()[0]


def main(argv=None) -> dict:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
  args = p.parse_args(argv)
  if args.device == 'cuda' and not torch.cuda.is_available():
    raise SystemExit('no CUDA device: pass --device cpu to run on the CPU')
  nworld = int(os.environ.get('BENCH_NWORLD', 8192))
  nstep = int(os.environ.get('BENCH_NSTEP', 1000))
  nconmax = int(os.environ.get('BENCH_NCONMAX', 24))

  m = io.load_model(models.HUMANOID_NPZ, device=args.device)
  d = make_batch(m, io.make_data(m, nconmax=nconmax), nworld)
  _, metrics = benchmark(m, d, nstep=nstep)

  value = metrics['steps_per_sec']
  result = {
      'metric': 'humanoid_steps_per_sec',
      'value': round(value, 1),
      'unit': 'env-steps/s',
      'vs_baseline': round(value / BASELINE, 4),
      'nworld': nworld,
      'nstep': metrics['nstep'],
      'jit_time_s': round(metrics['jit_time'], 2),
      'step_time_us': round(metrics['step_time_us'], 1),
      'converged_worlds': metrics['converged_worlds'],
      'ncon_mean': round(metrics['ncon_mean'], 2),
      'solver_niter_mean': round(metrics['solver_niter_mean'], 2),
      'device': card() if args.device == 'cuda' else 'cpu',
      'dispatch': metrics['dispatch'],
  }
  print(json.dumps(result))
  return result


if __name__ == '__main__':
  main()
