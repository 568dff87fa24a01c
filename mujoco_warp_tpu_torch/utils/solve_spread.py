"""How often the Newton solve's outcome turns on rounding.

    python3 mujoco_warp_tpu_torch/utils/solve_spread.py [STATES [OTHER]]

Steps the humanoid's main path (8192 worlds, nconmax 24, seeded qpos
noise) 100 times, then for each of STATES states (one step apart, 40 by
default) counts the worlds where kernel B3 of this checkout, kernel B3
built from the checkout at OTHER (if given), and the plain solve after a
1-ulp change of qfx miss chip_smoke phase (c)'s per-world criteria
against the plain solve on the same inputs: the step tolerances, the
objective within TOL_OBJ units, solver_niter within NITER_MAX. The
linesearch's polish keeps a step only strictly inside its bracket
(ROADMAP §C): a solve that lands exactly on a root before its last
polish step bisects away by the sign of the next phi', so which worlds
miss turns on an ulp. Prints each state's worlds (world, niter, plain
niter), the totals and the largest count in one state; the plain
solve's is chip_smoke's LOTTERY_WORLDS. Needs a card.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NWORLD = 8192
PREP_STEPS = 100
# chip_smoke's TOL_B3 and TOL_B3_OTHER, of max(1, max |plain|); TOL_OBJ
# units of tolerance * meaninertia * nv; NITER_MAX
TOL = dict(qpos=5e-6, qfrc_constraint=5e-4, efc_force=5e-4)
TOL_OTHER = 5e-5
TOL_OBJ = 1.0
NITER_MAX = 4


def _other_glue(root: str, tmp: str):
  """Kernel B3's library built from the checkout at root."""
  from mujoco_warp_tpu_torch.kernels import _build
  out = os.path.join(tmp, 'glue_other.so')
  subprocess.run([_build._nvcc(), *_build.FLAGS, '-o', out, os.path.join(
      root, 'mujoco_warp_tpu_torch', 'csrc', 'glue.cu')], check=True,
                 capture_output=True)
  lib = ctypes.CDLL(out)
  lib.error_string.argtypes = [ctypes.c_int]
  lib.error_string.restype = ctypes.c_char_p
  return lib


def main(argv) -> int:
  sys.path.insert(0, HERE)
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import forward, models, solver
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  from mujoco_warp_tpu_torch.utils.compare_trees import NCONMAX, glue_inputs
  states = int(argv[0]) if argv else 40
  libs = {'this': _build.library('glue')}
  os.makedirs(os.path.join(HERE, 'build'), exist_ok=True)
  tmp = tempfile.mkdtemp(dir=os.path.join(HERE, 'build'))
  if len(argv) > 1:
    libs['other'] = _other_glue(argv[1], tmp)
  m = mt.load_model(models.HUMANOID_NPZ, device='cuda')
  gen = torch.Generator(device='cuda').manual_seed(0)
  d = mt.make_batch(m, mt.make_data(m, nconmax=NCONMAX), NWORLD,
                    qpos_noise=0.01, generator=gen)
  d = bench.rollout(m, d, PREP_STEPS)
  keys = [k for k in kg.OUTPUTS if k != 'solver_niter']
  ne, nf, _, _, _ = mt.efc_layout(m, NCONMAX)
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * m.nv

  def missed(out, ref, objective):
    bad = torch.zeros(NWORLD, dtype=torch.bool, device='cuda')
    for k in keys:
      scale = max(1.0, float(ref[k].abs().max()))
      err = (out[k] - ref[k]).abs().reshape(NWORLD, -1).amax(1) / scale
      bad |= err > TOL.get(k, TOL_OTHER)
    gap = (objective(out['qacc']) - objective(ref['qacc'])) / unit
    bad |= gap.abs() > TOL_OBJ
    bad |= (out['solver_niter'] - ref['solver_niter']).abs() > NITER_MAX
    return [(w, int(out['solver_niter'][w]), int(ref['solver_niter'][w]))
            for w in bad.nonzero()[:, 0].tolist()]

  totals = dict.fromkeys(list(libs) + ['plain_ulp'], 0)
  peak = dict.fromkeys(totals, 0)
  for t in range(states):
    _, _, g_in = glue_inputs(m, d)
    ref = forward.glue(m, *g_in)
    f64 = [x.double() for x in g_in[:5]]
    qfs = ref['qfrc_smooth'].double()
    qsm = solver.cho_solve(solver.cholesky(f64[0]), qfs)
    objective = lambda qacc: solver.objective(*f64, qfs, qsm, qacc.double(),
                                              ne, nf)
    row = {}
    for name, lib in libs.items():
      _build._loaded['glue'] = lib
      row[name] = missed(kg.glue(m, *g_in), ref, objective)
    _build._loaded['glue'] = libs['this']
    qfx = g_in[8]
    row['plain_ulp'] = missed(forward.glue(
        m, *g_in[:8], torch.nextafter(qfx, torch.full_like(qfx, float('inf'))),
        g_in[9]), ref, objective)
    for k, v in row.items():
      totals[k] += len(v)
      peak[k] = max(peak[k], len(v))
    print(f'state {PREP_STEPS + t}: {row}', flush=True)
    d = bench.rollout(m, d, 1, start=PREP_STEPS + t)
  print(f'worlds missing the criteria over {states} states of {NWORLD}: '
        f'{totals}; the most in one state: {peak}')
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
