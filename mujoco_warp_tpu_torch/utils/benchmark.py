"""Benchmark harness: OU control noise with Halton quasirandomness and
the JAX harness's stepping protocol (mirrors
`mujoco_warp_tpu/utils/benchmark.py`: `halton` :22, `ctrl_noise` :42,
`benchmark` :147, `benchmark_replay` :297).

The JAX harness compiles one step (the ctrl, then `step_batched`) into one
device program and dispatches it once a step on donated buffers, with the
step index on the device. Here that step is one CUDA graph, captured once
on static buffers and replayed once a step (`GraphStep`), on every path
whose stage list makes no host sync (`forward.replays`). The other paths,
and every path on the CPU, run the same step function eagerly. `rollout`
is the eager loop with a Python step index: the replay is held against it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import forward
from ..forward import step_batched
from ..kernels import _build
from ..types import Data, Model

# The Data fields that a step reads: its output depends on the input Data
# only through these and the shapes of the rest (a test fills every other
# field with NaN). A replayed step copies just these back into its static
# input; the graph's outputs hold every other field. eq_active is the
# user's to toggle between steps: a replayed step reads the static
# input's, as an eager step reads the Data's.
STATE_FIELDS = ('time', 'qpos', 'qvel', 'act', 'ctrl', 'qacc_warmstart',
                'qfrc_applied', 'xfrc_applied', 'eq_active')


def _halton_tables(bases, device) -> tuple:
  """int32 bases (nb,) and float32 1 / b^(d+1) per digit and base."""
  bases = [int(b) for b in bases]
  ndig = max(int(np.floor(31 / np.log2(b))) + 1 for b in bases)
  bpow = np.power(np.asarray(bases, np.float64)[None, :],
                  -np.arange(1, ndig + 1)[:, None]).astype(np.float32)
  return (torch.tensor(bases, dtype=torch.int32, device=device),
          torch.tensor(bpow, device=device))


def _radical_inverse(index: torch.Tensor, b, bpow) -> torch.Tensor:
  idx = index.to(torch.int32)[..., None]
  r = torch.zeros(idx.shape[:-1] + b.shape, dtype=torch.float32,
                  device=idx.device)
  for d in range(bpow.shape[0]):
    r = r + bpow[d] * (idx % b).to(torch.float32)
    idx = idx // b
  return r


def halton(index: torch.Tensor, base) -> torch.Tensor:
  """Radical inverse of int32 `index` in a static integer base, float32,
  equal to the JAX package's halton digit for digit. With a sequence of
  bases the result gains a last axis, one entry per base, in one pass
  (a base's digits past int32 range are zero and add nothing)."""
  r = _radical_inverse(index, *_halton_tables(np.atleast_1d(base),
                                              index.device))
  return r if np.ndim(base) else r[..., 0]


def _noise_tables(m: Model) -> dict:
  b, bpow = _halton_tables(range(2, m.nu + 2), m.device)
  limited = torch.tensor(m.actuator_ctrllimited, dtype=torch.bool,
                         device=m.device)
  return dict(bases=b, bpow=bpow, limited=limited)


def ctrl_noise(m: Model, ctrl: torch.Tensor, worldid: torch.Tensor, step,
               std: float = 0.01, rate_s: float = 0.1) -> torch.Tensor:
  """Ornstein-Uhlenbeck control noise for (W, nu) ctrl; worldid (W,)
  int32; step a Python int or a 0-d int32 tensor on ctrl's device (the
  same noise bit for bit). Deterministic: the same (world, step) gets the
  same noise. Its tables are built once per model, so a call builds no
  tensor from host data."""
  nu = ctrl.shape[-1]
  if nu == 0:
    return ctrl
  t = _build.model_tables(m, 'ctrl_noise', _noise_tables)
  rate = torch.exp(-m.opt.timestep / rate_s)
  scale = std * torch.sqrt(1.0 - rate * rate)
  limited = t['limited']
  lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  midpoint = torch.where(limited, 0.5 * (lo + hi), 0.0)
  halfrange = torch.where(limited, 0.5 * (hi - lo), 1.0)
  idx = (step + 1) * (worldid.to(torch.int32) + 1)
  h = _radical_inverse(idx, t['bases'], t['bpow'])
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


def noise_step(m: Model, nworld: int, ctrlnoise_std: float = 0.01,
               ctrlnoise_rate: float = 0.1):
  """The harness's step with control noise: (Data, step) -> Data, step a
  0-d int32 tensor (JAX `one_step`, `utils/benchmark.py:173-186`)."""
  worldid = torch.arange(nworld, dtype=torch.int32, device=m.device)

  def one_step(d: Data, step: torch.Tensor) -> Data:
    return step_batched(m, d.replace(ctrl=ctrl_noise(
        m, d.ctrl, worldid, step, ctrlnoise_std, ctrlnoise_rate)))
  return one_step


def replay_step(m: Model, nworld: int, traj: torch.Tensor):
  """The replay's step: the ctrl of keyframe trajectory `traj` (nkey, nu)
  at the step index, clamped to its last frame, in every world (JAX
  `benchmark_replay`'s `one_step`, `utils/benchmark.py:306-311`)."""
  last = traj.shape[0] - 1

  def one_step(d: Data, step: torch.Tensor) -> Data:
    row = traj.index_select(0, torch.clamp(step, max=last).reshape(1))
    ctrl = row.expand(nworld, traj.shape[1]).contiguous()
    return step_batched(m, d.replace(ctrl=ctrl))
  return one_step


class GraphStep:
  """One step, `one_step(d, step)`, captured as a CUDA graph on static
  buffers: the step, then its STATE_FIELDS copied into the static input
  Data and 1 added to the step index. Each `replay` takes one step.

  Capture from a warm process: the step must have run eagerly once at
  these shapes, which sets each kernel's shared-memory attributes,
  launch shapes, B1's lanes and the model tables. The wrappers allocate
  their outputs in the graph's private pool, where their addresses stay
  fixed from replay to replay."""

  def __init__(self, one_step, d: Data, step: torch.Tensor):
    static = d.replace(**{k: getattr(d, k).clone() for k in STATE_FIELDS})
    self._step = step.clone()
    self._graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(self._graph):
      out = one_step(static, self._step)
      for k in STATE_FIELDS:
        new, old = getattr(out, k), getattr(static, k)
        if new is not old:
          old.copy_(new)
      self._step += 1
    self.data = out.replace(**{k: getattr(static, k) for k in STATE_FIELDS})

  def replay(self) -> None:
    self._graph.replay()


def warm_step(one_step, d: Data, step: torch.Tensor) -> Data:
  """one_step run eagerly on a side stream, as PyTorch's recipe warms up
  before a capture."""
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    out = one_step(d, step)
  torch.cuda.current_stream().wait_stream(side)
  return out


def replayed(m: Model, d: Data, nstep: int, start: int = 0,
             ctrlnoise_std: float = 0.01,
             ctrlnoise_rate: float = 0.1) -> Data:
  """`rollout` by graph replay on the card: one eager step from d warms
  the kernels (its result is dropped), one step is captured from d at
  step index `start` and replayed nstep times. The caller checks that
  `forward.replays(m, d)`."""
  one_step = noise_step(m, d.nworld, ctrlnoise_std, ctrlnoise_rate)
  step = torch.full((), start, dtype=torch.int32, device=d.qpos.device)
  warm_step(one_step, d, step)
  graph = GraphStep(one_step, d, step)
  for _ in range(nstep):
    graph.replay()
  return graph.data


def _protocol(m: Model, d: Data, nstep: int, one_step) -> tuple[Data, dict]:
  """The JAX harness's protocol and metrics
  (`mujoco_warp_tpu/utils/benchmark.py:269-292`): one first step, run
  eagerly (with the capture, the JAX harness's compile step: jit_time),
  min(20, nstep) warm-up steps, then max(nstep - warm-up - 1, 1) timed
  steps, the step index running on through all of them; by graph replay
  where `forward.replays` and d is on the card, else eagerly (`dispatch`).
  converged_worlds counts the worlds with no NaN in qpos; ncon_mean,
  nefc_mean, solver_niter_mean (and _max) are read from the final state.
  Returns the final Data and the metrics."""
  nworld = d.nworld
  replay = d.qpos.is_cuda and forward.replays(m, d)
  sync = torch.cuda.synchronize if d.qpos.is_cuda else lambda: None
  step = torch.zeros((), dtype=torch.int32, device=d.qpos.device)
  t0 = time.perf_counter()
  if replay:
    d = warm_step(one_step, d, step)
    step += 1
    captured = GraphStep(one_step, d, step)
    run = captured.replay
  else:
    def run():
      nonlocal d
      d = one_step(d, step)
      step.add_(1)
    run()
  sync()
  jit_time = time.perf_counter() - t0
  warmup = min(20, nstep)
  for _ in range(warmup):
    run()
  sync()
  steps_done = max(nstep - warmup - 1, 1)
  t0 = time.perf_counter()
  for _ in range(steps_done):
    run()
  sync()
  run_time = time.perf_counter() - t0
  if replay:
    d = captured.data
  nan_worlds = int(torch.isnan(d.qpos).any(-1).sum())
  return d, dict(
      nworld=nworld, nstep=steps_done, jit_time=jit_time, run_time=run_time,
      steps_per_sec=steps_done * nworld / max(run_time, 1e-9),
      step_time_us=1e6 * run_time / steps_done,
      converged_worlds=nworld - nan_worlds,
      ncon_mean=float(d.ncon.float().mean()),
      nefc_mean=float(d.nefc.float().mean()),
      solver_niter_mean=float(d.solver_niter.float().mean()),
      solver_niter_max=int(d.solver_niter.max()),
      dispatch='graph' if replay else 'eager')


def benchmark(m: Model, d: Data, nstep: int, ctrlnoise_std: float = 0.01,
              ctrlnoise_rate: float = 0.1) -> tuple[Data, dict]:
  """nstep steps of every world of d with control noise, by `_protocol`."""
  return _protocol(m, d, nstep, noise_step(m, d.nworld, ctrlnoise_std,
                                           ctrlnoise_rate))


def benchmark_replay(m: Model, d: Data, traj: torch.Tensor,
                     nstep: int) -> tuple[Data, dict]:
  """nstep steps of every world of d with the ctrl of a keyframe
  trajectory (`io.make_trajectory`) in place of noise, clamped to its
  last frame, by `_protocol` (JAX `benchmark_replay`, `:297`)."""
  return _protocol(m, d, nstep, replay_step(m, d.nworld, traj))


def total_steps(nstep: int) -> int:
  """The steps `benchmark(m, d, nstep)` takes in all."""
  warmup = min(20, nstep)
  return 1 + warmup + max(nstep - warmup - 1, 1)
