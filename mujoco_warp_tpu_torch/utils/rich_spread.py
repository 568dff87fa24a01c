"""How far kernel B3 and the plain solve land above the float64 solve on
apptronik_apollo_flat's contact-rich state.

    python3 mujoco_warp_tpu_torch/utils/rich_spread.py [SEEDS]

For each seed (0 to SEEDS - 1, 4 by default) builds chip_smoke.py's
apollo states at 8192 worlds and nconmax 16 (P15's batch, then the
contact-rich state from the same generator, as phase (s) draws them:
seed 0 is phase (s)'s state) and runs B3's solve on the rich state's
inputs six ways: kernel B3 of this checkout; the same source built with
`--fmad=false` (no multiply-add contracted); the plain solve in float32,
after a 1-ulp change of qfx up and down; and in float64. For each way
prints the worlds whose objective lies more than TOL_OBJ units of
tolerance * meaninertia * nv above the float64 solve's (and their sum
of units), the worlds more than TOL_OBJ above the float32 plain
solve's, and the mean solver_niter. Needs a card.
"""

import contextlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOL_OBJ = 1.0


@contextlib.contextmanager
def _glue_without_contraction():
  """Launch kernel B3 from its source built with nvcc's --fmad=false (no
  multiply-add contracted, the rest as built) while inside."""
  import ctypes
  from mujoco_warp_tpu_torch.kernels import _build
  out = _build._target('glue') + '.fmad_false.so'
  if not os.path.exists(out):
    subprocess.run([_build._nvcc(), *_build.FLAGS, '--fmad=false', '-o',
                    out + '.tmp', os.path.join(_build.CSRC, 'glue.cu')],
                   check=True, capture_output=True)
    os.replace(out + '.tmp', out)
  lib = ctypes.CDLL(out)
  lib.error_string.argtypes = [ctypes.c_int]
  lib.error_string.restype = ctypes.c_char_p
  saved = _build.library('glue')
  _build._loaded['glue'] = lib
  try:
    yield
  finally:
    _build._loaded['glue'] = saved


def main(argv) -> int:
  sys.path.insert(0, HERE)
  import torch
  import chip_smoke as cs
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import forward, models
  from mujoco_warp_tpu_torch.kernels import glue as kg
  seeds = int(argv[0]) if argv else 4
  m = mt.load_model(models.APOLLO_NPZ, device='cuda')
  W, C = cs.APOLLO_NWORLD, cs.APOLLO_NCONMAX
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * m.nv
  f64 = lambda args: [x.double() if torch.is_tensor(x) and
                      x.is_floating_point() else x for x in args]
  totals = {}
  for seed in range(seeds):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    mt.make_batch(m, mt.make_data(m, nconmax=C), W, qpos_noise=cs.QPOS_NOISE,
                  generator=gen)
    rich = cs._apollo_rich(m, W, gen)
    _, _, _, g_in = cs._glue_inputs(m, rich, C)
    ways = {'kernel': kg.glue(m, *g_in)}
    with _glue_without_contraction():
      ways['kernel --fmad=false'] = kg.glue(m, *g_in)
    ways['plain'] = forward.glue(m, *g_in)
    qfx = g_in[8]
    for name, to in (('plain qfx + 1 ulp', float('inf')),
                     ('plain qfx - 1 ulp', float('-inf'))):
      ways[name] = forward.glue(m, *g_in[:8], torch.nextafter(
          qfx, torch.full_like(qfx, to)), g_in[9])
    exact = forward.glue(m, *f64(g_in))
    qfs = ways['kernel']['qfrc_smooth']
    objective = lambda x: cs._objective(m, *g_in[:5], qfs, x['qacc'])
    o_x, o_p = objective(exact), objective(ways['plain'])
    print(f'seed {seed}: mean solver_niter float64 '
          f'{float(exact["solver_niter"].float().mean()):.3f}')
    for name, out in ways.items():
      above = (objective(out) - o_x) / unit
      over = above > TOL_OBJ
      row = (int(over.sum()), float(above[over].sum()),
             int(((objective(out) - o_p) / unit > TOL_OBJ).sum()))
      for k, v in zip(('above float64', 'units', 'above plain'), row):
        totals.setdefault(name, {}).setdefault(k, 0)
        totals[name][k] += v
      print(f'  {name:20s} above the float64 objective by more than '
            f'{TOL_OBJ:g} unit in {row[0]} of {W} worlds ({row[1]:.4g} units '
            f'in all), above the float32 plain solve\'s in {row[2]}; mean '
            f'solver_niter {float(out["solver_niter"].float().mean()):.3f}',
            flush=True)
  print(f'over {seeds} seeds: {totals}')
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
