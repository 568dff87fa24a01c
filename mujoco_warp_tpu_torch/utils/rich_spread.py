"""How far a solve kernel and the plain solve land above the float64
solve on an ill-conditioned state, and how much of that is the kernel's
multiply-adds.

    python3 mujoco_warp_tpu_torch/utils/rich_spread.py [SCENE] [SEEDS]

SCENE (apollo by default) is one of
  apollo  apptronik_apollo_flat's contact-rich state at 8192 worlds,
          nconmax 16 (P15's batch, then the rich state from the same
          generator, as phase (s) draws them), kernel B3 in mode 0;
  aloha   P17's state (chip_smoke.py phase (u): aloha_pot at 8192
          worlds, nconmax 24, lift_pot0 with noise on the arms), kernel
          B3e in mode 1;
  aloha_sdf  phase (v)'s rich state (aloha_sdf at 8192 worlds, nconmax
          32, gripper_gripper_pot with noise on the arms), kernel B3e in
          mode 1;
  apollo_hfield  P19's state (phase (w): apptronik_apollo_hfield at 8192
          worlds, nconmax 32, keyframe 0 stepped as many steps as P19's
          timed run takes; seeds past 0 add QPOS_NOISE first), kernel B3
          in mode 0.
For each seed (0 to SEEDS - 1, 4 by default; seed 0 is chip_smoke's
state) runs the solve on the state's inputs six ways: the kernel of this
checkout; the same source built with `--fmad=false` (no multiply-add
contracted); the plain solve in float32, after a 1-ulp change of qfx up
and down; and in float64. For each way prints the worlds whose objective
lies more than TOL_OBJ units of tolerance * meaninertia * nv above the
float64 solve's (their units in all, and how many of them the float32
plain solve shares), the worlds more than TOL_OBJ above the float32
plain solve's, the worlds over chip_smoke's elliptic tolerances
(`_check_ell_solve`'s) against it and against the float64 solve, and
the mean solver_niter. On aloha, aloha_sdf and apollo_hfield it also
prints, once, how far kernel
B1's outputs lie from its plain version's in float32 ulps at their scale
(max(1, max |plain|), as chip_smoke compares them), beside the plain
version's own after qpos moves by 1, 2, 4 and 8 ulps. Needs a card.
"""

import contextlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOL_OBJ = 1.0
SCENES = ('apollo', 'aloha', 'aloha_sdf', 'apollo_hfield')


@contextlib.contextmanager
def _glue_without_contraction():
  """Launch kernels B3 and B3e from their source built with nvcc's
  --fmad=false (no multiply-add contracted, the rest as built) while
  inside."""
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


def _states(scene, seeds):
  """(model, nworld, [(seed, glue inputs, cone or None, d)] of the scene,
  one a seed; d the Data the inputs were made from, None on apollo."""
  import torch
  import chip_smoke as cs
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import io, models
  if scene == 'apollo':
    m = mt.load_model(models.APOLLO_NPZ, device='cuda')
    W, C = cs.APOLLO_NWORLD, cs.APOLLO_NCONMAX
  elif scene == 'apollo_hfield':
    from mujoco_warp_tpu_torch.utils import benchmark as bench
    m = mt.load_model(models.APOLLO_HFIELD_NPZ, device='cuda')
    W, C = cs.HFIELD_NWORLD, cs.HFIELD_NCONMAX
    d0 = io.reset_data(m, mt.make_data(m, nconmax=C), keyframe=0)

    def state(m, d0, W, gen, noise):
      d = mt.make_batch(m, d0, W, qpos_noise=noise, generator=gen)
      return bench.rollout(m, d, bench.total_steps(cs.HFIELD_NSTEP))
  elif scene == 'aloha':
    m = mt.load_model(models.ALOHA_POT_NPZ, device='cuda')
    W, C = cs.ALOHA_NWORLD, cs.ALOHA_NCONMAX
    d0 = io.reset_data(m, mt.make_data(m, nconmax=C),
                       keyframe=io.find_keys(m, 'lift_pot')[0])
    state = cs._aloha_state
  else:
    m = mt.load_model(models.ALOHA_SDF_NPZ, device='cuda')
    W, C = cs.SDF_NWORLD, cs.SDF_NCONMAX
    d0 = io.reset_data(m, mt.make_data(m, nconmax=C),
                       keyframe=io.find_keys(m, 'gripper_gripper_pot')[0])
    state = lambda *a: cs._aloha_state(*a, cs.SDF_PREP)
  out = []
  for seed in range(seeds):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    if scene == 'apollo':
      mt.make_batch(m, mt.make_data(m, nconmax=C), W,
                    qpos_noise=cs.QPOS_NOISE, generator=gen)
      _, _, _, g_in = cs._glue_inputs(m, cs._apollo_rich(m, W, gen), C)
      out.append((seed, g_in, None, None))
    elif scene == 'apollo_hfield':
      d = state(m, d0, W, gen, cs.QPOS_NOISE if seed else 0.0)
      _, _, _, g_in = cs._collision_glue_inputs(m, d, C)
      out.append((seed, g_in, None, d))
    else:
      d = state(m, d0, W, gen)
      _, con, efc, g_in = cs._collision_glue_inputs(m, d, C)
      out.append((seed, g_in, cs._cone(m, con, efc), d))
  return m, W, out


def _b1_ulps(m, d):
  """Kernel B1's distance from its plain version on d's state, and the
  plain version's after qpos + k ulps, in float32 ulps at each output's
  scale: per output, (median, max) over the worlds of each world's
  largest."""
  import torch
  from mujoco_warp_tpu_torch import smooth
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  ref = smooth.smooth(m, d.qpos, d.qvel)
  eps = float(torch.finfo(torch.float32).eps)

  def dist(out):
    row = {}
    for k in smooth.OUTPUTS:
      if k == 'qpos':
        continue
      scale = max(1.0, float(ref[k].abs().max()))
      w = ((out[k] - ref[k]).abs().reshape(d.nworld, -1).amax(1) /
           (scale * eps))
      row[k] = (float(w.median()), float(w.max()))
    return row
  rows = {'B1': dist(ks.smooth(m, d.qpos, d.qvel))}
  q = d.qpos
  for k in range(1, 9):
    q = torch.nextafter(q, torch.full_like(q, float('inf')))
    if k in (1, 2, 4, 8):
      rows[f'plain(qpos + {k} ulp)'] = dist(smooth.smooth(m, q, d.qvel))
  return rows


def main(argv) -> int:
  sys.path.insert(0, HERE)
  import torch
  import chip_smoke as cs
  from mujoco_warp_tpu_torch import forward
  from mujoco_warp_tpu_torch.bench import card
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import glue as kg
  scene = argv[0] if argv and argv[0] in SCENES else 'apollo'
  argv = argv[1:] if argv and argv[0] in SCENES else argv
  seeds = int(argv[0]) if argv else 4
  _build.build_all()
  m, W, states = _states(scene, seeds)
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * m.nv
  resolve = scene not in ('apollo', 'apollo_hfield')
  tol = dict(qacc=cs.TOL_B3_OTHER, qacc_smooth=cs.TOL_B3_OTHER,
             qLD=cs.TOL_B3_OTHER,
             qacc_euler=5e-4 if resolve else cs.TOL_B3_OTHER,
             qfrc_constraint=5e-4, efc_force=5e-4)
  f64 = lambda xs: [x.double() if torch.is_tensor(x) and
                    x.is_floating_point() else x for x in xs]
  print(f'{scene} at {W} worlds: unit {unit:.4g} ({card()})')
  if states[0][3] is not None:
    for name, row in _b1_ulps(m, states[0][3]).items():
      print(f'  seed 0 {name:20s} ulps at scale (median, max over the '
            f'worlds): ' + ', '.join(f'{k} {a:.2f}/{b:.1f}'
                                     for k, (a, b) in row.items()))
  totals = {}
  for seed, g_in, cone, _ in states:
    kw = {} if cone is None else dict(cone=cone)
    ways = {'kernel': kg.glue(m, *g_in, **kw)}
    with _glue_without_contraction():
      ways['kernel --fmad=false'] = kg.glue(m, *g_in, **kw)
    ways['plain'] = forward.glue(m, *g_in, **kw)
    for name, to in (('plain qfx + 1 ulp', float('inf')),
                     ('plain qfx - 1 ulp', float('-inf'))):
      ways[name] = forward.glue(m, *g_in[:8], torch.nextafter(
          g_in[8], torch.full_like(g_in[8], to)), g_in[9], **kw)
    exact = forward.glue(m, *f64(g_in), **(
        {} if cone is None else dict(cone=tuple(f64(cone)))))
    qfs = ways['kernel']['qfrc_smooth']
    objective = lambda x: cs._objective(m, *g_in[:5], qfs, x['qacc'], cone)
    o_x, o_p = objective(exact), objective(ways['plain'])
    plain_above = (o_p - o_x) / unit > TOL_OBJ
    print(f'seed {seed}: mean solver_niter float64 '
          f'{float(exact["solver_niter"].float().mean()):.3f}')
    for name, out in ways.items():
      above = (objective(out) - o_x) / unit
      over64 = above > TOL_OBJ
      over, _ = cs._worlds_over(out, ways['plain'], tol, list(tol))
      over_x, _ = cs._worlds_over(out, exact, tol, list(tol))
      row = dict(above_float64=int(over64.sum()),
                 units=float(above[over64].sum()),
                 shared_with_plain=int((over64 & plain_above).sum()),
                 above_plain=int(((objective(out) - o_p) / unit >
                                  TOL_OBJ).sum()),
                 over_tolerances=int(over.sum()),
                 over_tolerances_float64=int(over_x.sum()))
      for k, v in row.items():
        totals.setdefault(name, {}).setdefault(k, 0)
        totals[name][k] += v
      print(f'  {name:20s} above the float64 objective by more than '
            f'{TOL_OBJ:g} unit in {row["above_float64"]} of {W} worlds '
            f'({row["units"]:.4g} units in all; {row["shared_with_plain"]} '
            f'of them shared with the float32 plain solve), above the '
            f'float32 plain solve\'s in {row["above_plain"]}, over the '
            f'tolerances against it in {row["over_tolerances"]} (against '
            f'the float64 solve in {row["over_tolerances_float64"]}); mean '
            f'solver_niter {float(out["solver_niter"].float().mean()):.3f}',
            flush=True)
  print(f'{scene} over {seeds} seeds: {totals}')
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
