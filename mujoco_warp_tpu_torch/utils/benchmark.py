"""Benchmark harness: OU control noise with Halton quasirandomness and a
plain stepping loop (mirrors `mujoco_warp_tpu/utils/benchmark.py`:
`halton` :22, `ctrl_noise` :42, `benchmark` :147).

`benchmark` follows the JAX harness's protocol and gives its metrics
their meaning there; `rollout` steps without timing. The loop steps from
Python and synchronizes the card around the timed steps; capturing the
step in a CUDA graph is later work.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..forward import step_batched
from ..types import Data, Model


def halton(index: torch.Tensor, base) -> torch.Tensor:
  """Radical inverse of int32 `index` in a static integer base, float32,
  equal to the JAX package's halton digit for digit. With a sequence of
  bases the result gains a last axis, one entry per base, in one pass
  (a base's digits past int32 range are zero and add nothing)."""
  bases = [int(b) for b in np.atleast_1d(base)]
  dev = index.device
  idx = index.to(torch.int32)[..., None]
  b = torch.tensor(bases, dtype=torch.int32, device=dev)
  ndig = max(int(np.floor(31 / np.log2(bb))) + 1 for bb in bases)
  # 1 / b^(d+1) rounded to float32, per digit and base
  bpow = np.power(np.asarray(bases, np.float64)[None, :],
                  -np.arange(1, ndig + 1)[:, None]).astype(np.float32)
  bpow = torch.tensor(bpow, device=dev)
  r = torch.zeros(idx.shape[:-1] + (len(bases),), dtype=torch.float32,
                  device=dev)
  for d in range(ndig):
    r = r + bpow[d] * (idx % b).to(torch.float32)
    idx = idx // b
  return r if np.ndim(base) else r[..., 0]


def ctrl_noise(m: Model, ctrl: torch.Tensor, worldid: torch.Tensor, step: int,
               std: float = 0.01, rate_s: float = 0.1) -> torch.Tensor:
  """Ornstein-Uhlenbeck control noise for (W, nu) ctrl; worldid (W,)
  int32. Deterministic: the same (world, step) gets the same noise."""
  nu = ctrl.shape[-1]
  if nu == 0:
    return ctrl
  rate = torch.exp(-m.opt.timestep / rate_s)
  scale = std * torch.sqrt(1.0 - rate * rate)
  limited = torch.tensor(m.actuator_ctrllimited, dtype=torch.bool,
                         device=ctrl.device)
  lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  midpoint = torch.where(limited, 0.5 * (lo + hi), 0.0)
  halfrange = torch.where(limited, 0.5 * (hi - lo), 1.0)
  idx = (step + 1) * (worldid.to(torch.int32) + 1)
  h = halton(idx, range(2, nu + 2))
  new = rate * ctrl + (1.0 - rate) * midpoint
  new = new + scale * halfrange * (2.0 * h - 1.0)
  return torch.where(limited, torch.minimum(torch.maximum(new, lo), hi),
                     new)


def rollout(m: Model, d: Data, nstep: int, start: int = 0,
            ctrlnoise_std: float = 0.01,
            ctrlnoise_rate: float = 0.1) -> Data:
  """Step every world of d nstep times with control noise, the steps
  numbered from `start` (the noise's step index), untimed."""
  worldid = torch.arange(d.nworld, dtype=torch.int32, device=d.qpos.device)
  for i in range(start, start + nstep):
    d = d.replace(ctrl=ctrl_noise(m, d.ctrl, worldid, i, ctrlnoise_std,
                                  ctrlnoise_rate))
    d = step_batched(m, d)
  return d


def benchmark(m: Model, d: Data, nstep: int, ctrlnoise_std: float = 0.01,
              ctrlnoise_rate: float = 0.1) -> tuple[Data, dict]:
  """The JAX harness's protocol and metrics
  (`mujoco_warp_tpu/utils/benchmark.py:269-292`): one first step (the
  JAX harness's compile step), min(20, nstep) warm-up steps, then
  max(nstep - warm-up - 1, 1) timed steps, the step index running on
  through all of them. converged_worlds counts the worlds with no NaN in
  qpos; ncon_mean, nefc_mean, solver_niter_mean (and _max) are read from
  the final state. Returns the final Data and the metrics."""
  nworld = d.nworld
  sync = (torch.cuda.synchronize if d.qpos.is_cuda else lambda: None)
  noise = dict(ctrlnoise_std=ctrlnoise_std, ctrlnoise_rate=ctrlnoise_rate)
  t0 = time.perf_counter()
  d = rollout(m, d, 1, **noise)
  sync()
  first_time = time.perf_counter() - t0
  warmup = min(20, nstep)
  d = rollout(m, d, warmup, start=1, **noise)
  sync()
  steps_done = max(nstep - warmup - 1, 1)
  t0 = time.perf_counter()
  d = rollout(m, d, steps_done, start=1 + warmup, **noise)
  sync()
  run_time = time.perf_counter() - t0
  nan_worlds = int(torch.isnan(d.qpos).any(-1).sum())
  return d, dict(
      nworld=nworld, nstep=steps_done, first_step_time=first_time,
      seconds=run_time,
      steps_per_sec=steps_done * nworld / max(run_time, 1e-9),
      step_time_us=1e6 * run_time / steps_done,
      converged_worlds=nworld - nan_worlds,
      ncon_mean=float(d.ncon.float().mean()),
      nefc_mean=float(d.nefc.float().mean()),
      solver_niter_mean=float(d.solver_niter.float().mean()),
      solver_niter_max=int(d.solver_niter.max()))


def total_steps(nstep: int) -> int:
  """The steps `benchmark(m, d, nstep)` takes in all."""
  warmup = min(20, nstep)
  return 1 + warmup + max(nstep - warmup - 1, 1)
