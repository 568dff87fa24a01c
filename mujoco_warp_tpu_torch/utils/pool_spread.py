"""Why one kitchen step of the kernels parts from the all-plain step
(chip_smoke.py, P20's step): the all-plain step against itself after
small changes of its inputs, on P20's kind of state.

    python3 mujoco_warp_tpu_torch/utils/pool_spread.py [NWORLD] [NSTEP] \
        [--device cpu]

The state: kitchen from qpos0 at NWORLD worlds (256 by default),
nconmax 64, NSTEP steps (100 by default), then chip_smoke's noise
on the joints (`_kitchen_noisy`, seed 0). On it, the all-plain step
against the same step after each change: qpos moved up by 1 ulp; B1's
outputs moved by one ulp each (`chip_smoke._smooth_moved`, seed 1); and,
on the card, the kernel step. For each, prints the worlds whose contact
and row sets agree (`chip_smoke._agree`, blind to which contacts fill
the pool), the worlds whose pools hold other geom pairs, qacc and qvel
over chip_smoke's tolerance (5e-5 of scale) among the worlds whose sets
agree, and how far the contacts' points, efc_J and efc_aref part (also
in the worlds whose sets and pools agree); the Newton Hessian's
condition number at the plain step's solution; then each float32 solve
against the float64 solve on its own inputs.
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv) -> int:
  sys.path.insert(0, HERE)
  import torch
  import chip_smoke as cs
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import models, solver
  from mujoco_warp_tpu_torch.bench import card
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  dev = 'cpu' if '--device' in argv and 'cpu' in argv else 'cuda'
  nums = [int(a) for a in argv if a.isdigit()]
  W, nstep = (nums + [256, 100][len(nums):])[:2]
  m = mt.load_model(models.KITCHEN_NPZ, device=dev)
  d = mt.make_batch(m, mt.make_data(m, nconmax=cs.KITCHEN_NCONMAX), W)
  for _ in range(nstep):
    d = mt.step_batched(m, d)
  d = cs._kitchen_noisy(m, d, torch.Generator(device=dev).manual_seed(0))
  print(f'kitchen at {W} worlds after {nstep} steps and noise; '
        f'{dev} ({card() if dev == "cuda" else "the CPU"})')
  with cs._plain_kernels():
    d_p, sets_p, solves_p = cs._step_recording(m, d)
    runs = {'qpos + 1 ulp': lambda: cs._step_recording(
        m, d.replace(qpos=cs._next_ulp(d.qpos)))}

    def moved():
      plain, ks.smooth = ks.smooth, cs._smooth_moved(
          torch.Generator(device=dev).manual_seed(1))
      try:
        return cs._step_recording(m, d)
      finally:
        ks.smooth = plain
    runs['B1 outputs moved by one ulp'] = moved
    outs = {name: run() for name, run in runs.items()}
  if dev == 'cuda':
    outs['kernel step'] = cs._step_recording(m, d)
  f64 = lambda x: (x.double() if torch.is_tensor(x) and
                   x.is_floating_point() else x)
  for name, (d_u, sets_u, solves_u) in outs.items():
    same = cs._agree(sets_u, sets_p)
    pool = (d_u.contact.geom != d_p.contact.geom).any(-1).any(-1)
    part = {k: (getattr(d_u.contact, k) - getattr(d_p.contact, k)).abs()
            .reshape(W, -1).amax(1) for k in ('dist', 'pos')}
    dj, da = ((solves_u[0][1][i] - solves_p[0][1][i]).abs()
              .reshape(W, -1).amax(1) for i in (2, 4))
    alike = same & ~pool
    print(f'{name}: {int(same.sum())} of {W} worlds with the same contact '
          f'and row sets; {int(pool.sum())} with other geom pairs in the '
          f'pool; per world largest change of a contact\'s dist (median '
          f'{float(part["dist"].median()):.3e}, max '
          f'{float(part["dist"].max()):.3e}), point (median '
          f'{float(part["pos"].median()):.3e}, max '
          f'{float(part["pos"].max()):.3e}), efc_J (median '
          f'{float(dj.median()):.3e}, max {float(dj.max()):.3e}); in the '
          f'{int(alike.sum())} worlds with the same sets and pool: efc_J '
          f'max {float(dj[alike].max()) if alike.any() else 0.0:.3e}, '
          f'efc_aref max {float(da[alike].max()) if alike.any() else 0.0:.3e}')
    for k in ('qacc', 'qvel'):
      a, b = getattr(d_u, k), getattr(d_p, k)
      scale = max(1.0, float(b.abs().max()))
      e = (a - b).abs().amax(1) / scale
      over = (e > cs.TOL_STEP_QACC) & same
      print(f'  {k}: {int(over.sum())} of {int(same.sum())} such worlds '
            f'over {cs.TOL_STEP_QACC:g} of scale {scale:.2f} '
            f'({int((same & ~pool).sum())} of them with the same pool: '
            f'{int((over & ~pool).sum())} over); median '
            f'{float(e.median()):.3e}, max {float(e.max()):.3e}')
  # the Newton Hessian at the plain step's solution: the stiff rows
  # against kitchen's light dofs
  (_, a, k, o), = solves_p
  qM, J, D, aref, fl, typ = a[1:7]
  jaref = torch.einsum('wrn,wn->wr', J, o['qacc']) - aref
  _, _, quad = solver._update_constraint(
      jaref, D, fl, fl / torch.clamp(D, min=solver.MINVAL),
      *solver._row_masks(typ))
  H = qM + torch.bmm((J * (D * quad)[..., None]).transpose(1, 2), J)
  cond = torch.linalg.cond(H.double())
  print(f'the plain step\'s Newton Hessian at its qacc: quadratic rows '
        f'median {float(quad.sum(1).float().median()):.0f}; condition '
        f'number median {float(cond.median()):.3e}, max '
        f'{float(cond.max()):.3e}; qM\'s smallest diagonal '
        f'{float(qM.diagonal(dim1=1, dim2=2).min()):.3e}, D\'s largest '
        f'{float(D.max()):.3e}')
  for name, solves in [('plain', solves_p)] + [
      (n, o[2]) for n, o in outs.items()]:
    (_, a, k, o), = solves
    with cs._plain_kernels():
      ex = solver.solve(*[f64(x) for x in a],
                        **{n: f64(v) for n, v in k.items()})
    scale = max(1.0, float(o['qacc'].abs().max()))
    off = (o['qacc'].double() - ex['qacc']).abs().amax(1) / scale
    print(f'{name} step\'s float32 solve against the float64 solve on its '
          f'inputs: median {float(off.median()):.3e}, max '
          f'{float(off.max()):.3e} of scale {scale:.2f}; '
          f'{int((off <= cs.TOL_STEP_QACC / 10).sum())} of {W} within '
          f'{cs.TOL_STEP_QACC / 10:g}; solver_niter equal in '
          f'{int((o["solver_niter"] == ex["solver_niter"]).sum())}')
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
