"""mjwt-torch-testspeed: the benchmark CLI of the PyTorch port (mirrors
`mujoco_warp_tpu/testspeed.py`). Loads a model, applies option
overrides, steps a world batch with OU-Halton ctrl noise (or replays
keyframe ctrl), and reports the JAX CLI's metrics (steps/s, jit time,
ncon/nefc stats, solver iterations, per-stage times, memory) as text or
one JSON line, plus `dispatch`: `graph` where each step is one CUDA graph
replay (`forward.replays`), `eager` where not.

The model is an MJCF, compiled through the `mujoco` bindings, or a `.npz`
written by `io.save_model` (the card's machine has no bindings: use the
committed `models/*.npz` there); both hold the keyframes and their
names, which `--replay` reads. It runs on the card unless `--device cpu`.

Usage:
  python -m mujoco_warp_tpu_torch.testspeed PATH.xml|PATH.npz
      [--nworld N] [--nstep N] [--nconmax N] [-o opt.solver=cg ...]
      [--output human|json] [--event_trace] [--keyframe K]
      [--ctrlnoise_std S] [--replay PREFIX] [--function NAME]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import forward
from . import io
from .parallel import make_batch
from .types import CONTACT_TENSORS, DATA_TENSORS, MODEL_TENSORS
from .types import OPTION_TENSORS
from .utils.benchmark import benchmark, benchmark_replay


def _time_us(fn, arg, nrep: int) -> tuple:
  """(fn(arg), microseconds a call over nrep more calls on the same
  input): CUDA events on the card, the host clock on the CPU."""
  res = fn(arg)
  if not arg.qpos.is_cuda:
    t0 = time.perf_counter()
    for _ in range(nrep):
      fn(arg)
    return res, (time.perf_counter() - t0) / nrep * 1e6
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(nrep):
    fn(arg)
  end.record()
  torch.cuda.synchronize()
  return res, start.elapsed_time(end) / nrep * 1e3


def _stage_names(m, d) -> list:
  """The event-trace key of each stage of `forward.batched_stages`, as
  the JAX CLI names them: `step.forward.<stage>`, and `step.<stage>` for
  the integrator after an unfused list (a glue list integrates inside
  solve_glue)."""
  names = [n for n, _ in forward.batched_stages(m, d)]
  keys = [f'step.forward.{n}' for n in names]
  if not forward.uses_glue_kernel(m, d):
    keys[-1] = f'step.{names[-1]}'
  return keys


def _stage_times(m, d, nrep: int = 20) -> dict:
  """Time of each stage of the step's list (JAX `_stage_times`,
  `testspeed.py:25`), each on the output of the one before. Stage
  boundaries materialize every output, so the stages add up to more than
  a step."""
  out = {}
  for key, (_, fn) in zip(_stage_names(m, d),
                          forward.batched_stages(m, d)):
    d, out[key] = _time_us(fn, d, nrep)
  return out


def _benchmark_function(m, d, name: str, nrep: int) -> dict:
  """Time one stage of the step's list by name (JAX
  `_benchmark_function`, `testspeed.py:65`) on the state a whole forward
  pass through the list leaves."""
  stages = forward.batched_stages(m, d)
  names = [n for n, _ in stages]
  if name not in names:
    raise SystemExit(f'unknown stage {name!r}; choices: {names}')
  b = d
  for _, fn in stages:
    b = fn(b)
  fn = dict(stages)[name]
  sync = torch.cuda.synchronize if b.qpos.is_cuda else lambda: None
  t0 = time.perf_counter()
  fn(b)
  sync()
  first = time.perf_counter() - t0
  nrep = max(min(nrep, 1000), 10)
  _, us = _time_us(fn, b, nrep)
  return {
      'function': name,
      'nworld': d.nworld,
      'nrep': nrep,
      'jit_time_s': round(first, 2),
      'time_us': round(us, 1),
      'per_world_ns': round(us * 1e3 / d.nworld, 2),
  }


def _mb(tensors) -> float:
  return round(sum(t.numel() * t.element_size() for t in tensors) / 1e6, 2)


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('model', help='an MJCF, or a .npz of io.save_model')
  p.add_argument('--nworld', type=int, default=8192)
  p.add_argument('--nstep', type=int, default=1000)
  p.add_argument('--nconmax', type=int, default=None)
  p.add_argument('-o', '--override', action='append', default=[])
  p.add_argument('--output', choices=('human', 'json'), default='human')
  p.add_argument('--event_trace', action='store_true')
  p.add_argument('--keyframe', type=int, default=None)
  p.add_argument('--ctrlnoise_std', type=float, default=0.01)
  p.add_argument('--replay', default=None, metavar='PREFIX',
                 help='replay the ctrl of the keyframes whose name starts '
                      'with PREFIX')
  p.add_argument('--function', default='step', metavar='NAME',
                 help='time one stage of the step by name instead of the '
                      'whole step; stage names as --event_trace prints '
                      'them, e.g. smooth_mega[cuda], solve_glue[cuda]')
  p.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
  args = p.parse_args(argv)
  if args.device == 'cuda' and not torch.cuda.is_available():
    raise SystemExit('no CUDA device: pass --device cpu to run on the CPU')
  if args.model.endswith('.npz'):
    m = io.load_model(args.model, device=args.device)
  else:
    import mujoco
    m = io.put_model(mujoco.MjModel.from_xml_path(args.model),
                     device=args.device)
  if args.override:
    m = io.override_model(m, args.override)
  d = io.make_data(m, nconmax=args.nconmax)
  if args.keyframe is not None:
    d = io.reset_data(m, d, keyframe=args.keyframe)
  batch = make_batch(m, d, args.nworld)

  if args.function != 'step':
    metrics = _benchmark_function(m, batch, args.function, args.nstep)
    print(json.dumps(metrics) if args.output == 'json' else
          '\n'.join(f'{k:28s} {v}' for k, v in metrics.items()))
    return

  if args.replay is not None:
    keys = io.find_keys(m, args.replay)
    if not keys:
      raise SystemExit(f'no keyframes match prefix {args.replay!r}')
    traj = torch.as_tensor(io.make_trajectory(m, keys),
                           dtype=torch.float32, device=args.device)
    batch = batch.replace(
        qpos=m.key_qpos[keys[0]].expand_as(batch.qpos).clone())
    final, metrics = benchmark_replay(m, batch, traj, nstep=args.nstep)
  else:
    final, metrics = benchmark(m, batch, nstep=args.nstep,
                               ctrlnoise_std=args.ctrlnoise_std)
  del metrics['solver_niter_max']   # not a key of the JAX CLI

  # memory report (JAX testspeed.py:163-175)
  metrics['model_memory_mb'] = _mb(
      [getattr(m, k) for k in MODEL_TENSORS] +
      [getattr(m.opt, k) for k in OPTION_TENSORS] + [m.stat.meaninertia])
  metrics['data_memory_mb'] = _mb(
      [getattr(final, k) for k in DATA_TENSORS] +
      [getattr(final.contact, k) for k in CONTACT_TENSORS])
  metrics['nefc_mean'] = float(final.nefc.float().mean())
  metrics['ncon_p95'] = float(torch.quantile(final.ncon.float(), 0.95))
  metrics['solver_niter_p95'] = float(torch.quantile(
      final.solver_niter.float(), 0.95))

  if args.event_trace:
    # on the final state: the same shapes, contacts and rows active
    metrics['event_trace_us'] = {k: round(v, 1) for k, v in
                                 _stage_times(m, final).items()}

  if args.output == 'json':
    print(json.dumps(metrics))
  else:
    for k, v in metrics.items():
      print(f'{k:28s} {v}')


if __name__ == '__main__':
  main()
