"""Run the kernels B1, B2, B3, B4, B3e, B4-elliptic, B5, B6, B7 and B8 of
two checkouts of the port on the same saved inputs, and compare their
outputs bit for bit.

    python3 mujoco_warp_tpu_torch/utils/compare_trees.py inputs FILE
    python3 mujoco_warp_tpu_torch/utils/compare_trees.py run ROOT FILE OUT
    python3 mujoco_warp_tpu_torch/utils/compare_trees.py compare OUT OUT... \
        [--redesigned NAME,...]
    python3 mujoco_warp_tpu_torch/utils/compare_trees.py turns A B DIR \
        [--redesigned NAME,...]

`inputs` steps the humanoid (8192 worlds, nconmax 24, seeded qpos noise)
through this checkout's kernels and saves the inputs of B1 (smooth), B2
(contact), B3 (glue) and B4 (newton, without and with the integration
diagonal hb); B1's and B2's inputs on three_humanoids (8192 worlds,
nconmax 100, after THREE_STEPS steps); on the humanoid with the elliptic
cone (ELLIPTIC, ELL_STEPS steps on from the pyramidal state), the inputs
of B2 (its elliptic rows), B3e (glue with the cone) and B4-elliptic
(newton with the cone); and B2's inputs on three_humanoids with the
elliptic cone (ELL3_STEPS steps from its seeded state). So B2 runs at
all four of its shapes. B5's inputs are the Hessian of three_humanoids'
first Newton direction (as chip_smoke.py phase (f) builds it) and the
humanoid's qM, factored as the CG step factors it (`return_factor`); B6's
are that factor, from this checkout's B5, and the gradient at the warm
start. B7's are its two calls on three_humanoids' state: as
fwd_acceleration calls it (qM and qfrc_smooth, the factor written) and as
the Euler re-solve calls it (qfrc_smooth + qfrc_constraint after the
solve, the diagonal h dof_damping, no factor); B8's are the factor of
the first, from this checkout's B7, and the gradient at the warm start
(as chip_smoke.py phase (j) builds them).
`run` imports `mujoco_warp_tpu_torch` from the checkout at ROOT, builds
its kernels there, runs each kernel on the saved inputs and saves the
outputs and each kernel's time: the card's busy time per launch over 20
launches after one (device_ms), and CUDA events around 20 launches,
which count the host's time too where a wrapper takes longer than its
kernel.
`compare` prints, for the first file against each other, every output
that is not bit-equal and the times side by side; it exits 1 if any
output differs. `--redesigned` names kernels whose design one checkout
changed, so that their bits may differ (REDESIGNABLE: B3e `glue_ell`,
B4-elliptic `newton_ell`, B1 `smooth`, B5 `spd_solve`, B7 `tree_ldl`, B8
`tree_solve`): their differences are printed with the largest absolute
one, and every file's outputs of them are held instead against the plain
version on the saved inputs: B3e and B4-elliptic by
chip_smoke.py's ELLIPTIC count rules (`_check_ell_solve`), B1 at TOL_B1,
B5 (and B6, which runs B5's sweeps), B7 and B8 by `_check_solve`'s
residual and forward error, B5's factor and B7's packed entries of LD at
TOL_B1 and B7's LD zero off those entries; it exits 1 if one misses them,
or if any other kernel's output differs. `turns` saves the inputs (with
this checkout) to DIR, runs the checkouts A and B in turns A, B, B, A,
each in its own process, prints each kernel's times in the four turns
and compares every turn's outputs with the first's. It needs a card.
"""

import json
import os
import sys

# the checkout this script belongs to, which `inputs` runs
HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NWORLD = 8192
NCONMAX = 24
SEED = 0
PREP_STEPS = 100
THREE_STEPS = 10
NCONMAX3 = 100
ELLIPTIC = ['opt.cone=elliptic', 'opt.impratio=10']
ELL_STEPS = 5
ELL3_STEPS = 2
# kernels that `--redesigned` may name, and the calls of `run` that each
# covers: they are held against their plain versions instead of bit for
# bit (hold)
REDESIGNABLE = dict(glue_ell=('glue_ell',), newton_ell=('newton_ell',),
                    smooth=('smooth', 'smooth_three_humanoids'),
                    spd_solve=('spd_solve', 'spd_solve_factor',
                               'cho_solve'),
                    tree_ldl=('tree_ldl', 'tree_ldl_euler'),
                    tree_solve=('tree_solve',))


def contact_inputs(m, d):
  """B2's inputs at the state d (B1's outputs) and B1's outputs."""
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  sm = ks.smooth(m, d.qpos, d.qvel)
  return (sm['qpos'], d.qvel, sm['geom_xpos'], sm['geom_xmat'],
          sm['subtree_com'], sm['cdof']), sm


def glue_inputs(m, d):
  """B2's inputs and B3's (B3e's) at the state d, and the contacts."""
  from mujoco_warp_tpu_torch import support
  from mujoco_warp_tpu_torch.kernels import contact as kc
  c_in, sm = contact_inputs(m, d)
  con = kc.contact(m, *c_in, NCONMAX)
  qfx = d.qfrc_applied + support.xfrc_accumulate(
      m, d.xfrc_applied, sm['xipos'], sm['subtree_com'], sm['cdof']) - \
      sm['qfrc_bias']
  g_in = (sm['qM'], con['efc_J'], con['efc_D'], con['efc_aref'],
          con['efc_frictionloss'], sm['qpos'], d.qvel, d.ctrl, qfx,
          d.qacc_warmstart)
  return c_in, con, g_in


def device_ms(fn, reps: int = 20) -> float:
  """The card's busy time per call of fn, in ms, without the host's time
  between calls: over reps calls after one (torch.profiler), each device
  kernel's mean time times its launches per call. A profile can miss
  some of a kernel's events (seen on the card), so a plain sum over the
  calls would undercount. 0.0 if the profiler saw no device work. Needs
  a card."""
  import torch
  fn()
  torch.cuda.synchronize()
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  per_name = {}
  for e in prof.events():
    if e.device_type == torch.autograd.DeviceType.CUDA:
      n, us = per_name.get(e.name, (0, 0.0))
      per_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
  return sum(us / n * max(1, round(n / reps))
             for n, us in per_name.values()) / 1e3


def make_inputs(path: str) -> None:
  sys.path.insert(0, HERE)
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import forward, models, solver
  from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  m = mt.load_model(models.HUMANOID_NPZ, device='cuda')
  gen = torch.Generator(device='cuda').manual_seed(SEED)
  d = mt.make_batch(m, mt.make_data(m, nconmax=NCONMAX), NWORLD,
                    qpos_noise=0.01, generator=gen)
  d = bench.rollout(m, d, PREP_STEPS)
  c_in, _, g_in = glue_inputs(m, d)
  qfs = kg.glue(m, *g_in)['qfrc_smooth']
  me = mt.override_model(m, ELLIPTIC)
  de = mt.make_data(me, nconmax=NCONMAX, nworld=NWORLD).replace(
      qpos=d.qpos, qvel=d.qvel, ctrl=d.ctrl, time=d.time,
      qacc_warmstart=d.qacc_warmstart)
  de = bench.rollout(me, de, ELL_STEPS)
  ce_in, con_e, ge_in = glue_inputs(me, de)
  cone = solver.cone_inputs(me, mt.Contact(
      **{k: con_e[k] for k in kc.CONTACT_FIELDS}))
  qfs_e = kg.glue(me, *ge_in, cone=cone)['qfrc_smooth']
  m3 = mt.load_model(models.THREE_HUMANOIDS_NPZ, device='cuda')
  d3 = mt.make_batch(m3, mt.make_data(m3, nconmax=NCONMAX3), NWORLD,
                     qpos_noise=0.01, generator=gen)
  d3 = bench.rollout(m3, d3, THREE_STEPS)
  # B5: three_humanoids' first Newton Hessian and gradient; the humanoid's
  # qM as the CG step factors it; B6 on that factor
  pre = d3
  stages = forward.batched_stages(m3, d3)
  for name, fn in stages[:[n for n, _ in stages].index('solve')]:
    pre = fn(pre)
  J, D, fl, qacc = pre.efc_J, pre.efc_D, pre.efc_frictionloss, \
      pre.qacc_warmstart
  # B7 as fwd_acceleration and the Euler re-solve call it, B8 on B7's LD
  post = stages[[n for n, _ in stages].index('solve')][1](pre)
  qfs3 = pre.qfrc_smooth
  ld3 = kb.tree_ldl(pre.qM, qfs3, m3.dof_parentid, return_factor=True)[1]
  grad_ws = torch.einsum('wij,wj->wi', pre.qM, qacc) - qfs3
  jaref = torch.einsum('wrn,wn->wr', J, qacc) - pre.efc_aref
  force, _, quad = solver._update_constraint(
      jaref, D, fl, fl / torch.clamp(D, min=solver.MINVAL),
      *solver._row_masks(pre.efc_type))
  hess = pre.qM + torch.bmm((J * (D * quad)[..., None]).transpose(1, 2), J)
  grad3 = (torch.einsum('wij,wj->wi', pre.qM, qacc) - pre.qfrc_smooth -
           torch.einsum('wrn,wr->wn', J, force))
  qM = ks.smooth(m, d.qpos, d.qvel)['qM']
  grad = torch.einsum('wij,wj->wi', qM, d.qacc_warmstart) - qfs
  factor = kb.spd_solve(qM, qfs, return_factor=True)[1]
  m3e = mt.override_model(m3, ELLIPTIC)
  gen3 = torch.Generator(device='cuda').manual_seed(SEED)
  d3e = mt.make_batch(m3e, mt.make_data(m3e, nconmax=NCONMAX3), NWORLD,
                      qpos_noise=0.01, generator=gen3)
  d3e = bench.rollout(m3e, d3e, ELL3_STEPS)
  torch.save(dict(s_in=(d.qpos, d.qvel), s3_in=(d3.qpos, d3.qvel),
                  c_in=c_in, c3_in=contact_inputs(m3, d3)[0], ce_in=ce_in,
                  ce3_in=contact_inputs(m3e, d3e)[0],
                  g_in=g_in, n_in=g_in[:5] + (qfs, g_in[9]),
                  ge_in=ge_in, ne_in=ge_in[:5] + (qfs_e, ge_in[9]),
                  cone=cone, spd_in=(hess, grad3), spd_factor_in=(qM, qfs),
                  cho_in=(factor, grad), tree_in=(pre.qM, qfs3),
                  tree_euler_in=(pre.qM, qfs3 + post.qfrc_constraint),
                  tree_solve_in=(ld3, grad_ws)), path)


def run(root: str, path: str, out: str) -> None:
  root = os.path.abspath(root)
  sys.path.insert(0, root)
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import models
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import newton as kn
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  if not mt.__file__.startswith(root + '/'):
    raise RuntimeError(f'imported {mt.__file__}, not the checkout {root}')
  _build.build_all()
  inp = torch.load(path)
  m = mt.load_model(models.HUMANOID_NPZ, device='cuda')
  m3 = mt.load_model(models.THREE_HUMANOIDS_NPZ, device='cuda')
  me = mt.override_model(m, ELLIPTIC)
  m3e = mt.override_model(m3, ELLIPTIC)
  hb = m.opt.timestep * m.dof_damping
  hb3 = m3.opt.timestep * m3.dof_damping
  parent3 = m3.dof_parentid
  cone = inp['cone']
  calls = dict(
      smooth=lambda: ks.smooth(m, *inp['s_in']),
      smooth_three_humanoids=lambda: ks.smooth(m3, *inp['s3_in']),
      contact=lambda: kc.contact(m, *inp['c_in'], NCONMAX),
      contact_three_humanoids=lambda: kc.contact(m3, *inp['c3_in'],
                                                 NCONMAX3),
      contact_ell=lambda: kc.contact(me, *inp['ce_in'], NCONMAX),
      contact_ell_three_humanoids=lambda: kc.contact(m3e, *inp['ce3_in'],
                                                     NCONMAX3),
      glue=lambda: kg.glue(m, *inp['g_in']),
      newton=lambda: kn.newton_solve(m, *inp['n_in']),
      newton_hb=lambda: kn.newton_solve(m, *inp['n_in'], hb=hb),
      glue_ell=lambda: kg.glue(me, *inp['ge_in'], cone=cone),
      newton_ell=lambda: kn.newton_solve(me, *inp['ne_in'], cone=cone),
      spd_solve=lambda: kb.spd_solve(*inp['spd_in']),
      spd_solve_factor=lambda: kb.spd_solve(*inp['spd_factor_in'],
                                            return_factor=True),
      cho_solve=lambda: kb.cho_solve(*inp['cho_in']),
      tree_ldl=lambda: kb.tree_ldl(*inp['tree_in'], parent3,
                                   return_factor=True),
      tree_ldl_euler=lambda: kb.tree_ldl(*inp['tree_euler_in'], parent3,
                                         diag=hb3),
      tree_solve=lambda: kb.tree_solve(*inp['tree_solve_in'], parent3))
  outs, ms, wall = {}, {}, {}
  for name, fn in calls.items():
    got = fn()
    outs[name] = (got if isinstance(got, dict) else
                  dict(zip(('x', 'factor'), got)) if isinstance(got, tuple)
                  else dict(x=got))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
      fn()
    end.record()
    torch.cuda.synchronize()
    wall[name] = start.elapsed_time(end) / 20
    ms[name] = device_ms(fn)
  torch.save(dict(outs=outs, ms=ms, wall=wall, root=root, inputs=path),
             out)
  print(json.dumps({'root': root, 'ms': ms, 'wall_ms': wall}))


def hold_elliptic(name: str, inputs: str):
  """fn(label, outs) that holds B3e's (`glue_ell`) or B4-elliptic's
  (`newton_ell`) outputs by chip_smoke.py's ELLIPTIC count rules against
  this checkout's plain version on the saved inputs; it raises if they
  miss them."""
  sys.path.insert(0, HERE)
  import torch
  import chip_smoke
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import forward, models, solver
  inp = torch.load(inputs)
  me = mt.override_model(mt.load_model(models.HUMANOID_NPZ, device='cuda'),
                         ELLIPTIC)
  cone, ulp = inp['cone'], chip_smoke._next_ulp
  if name == 'glue_ell':
    g = inp['ge_in']
    ref = forward.glue(me, *g, cone=cone)
    perturbed = forward.glue(me, *g[:8], ulp(g[8]), g[9], cone=cone)
    return lambda label, out: chip_smoke._check_ell_solve(
        label, me, out, ref, perturbed, g[:5], cone, out['qfrc_smooth'])
  n = inp['ne_in']
  ref = solver.newton_solve(me, *n, cone=cone)
  perturbed = solver.newton_solve(me, *n[:5], ulp(n[5]), n[6], cone=cone)
  return lambda label, out: chip_smoke._check_ell_solve(
      label, me, out, ref, perturbed, n[:5], cone, n[5])


def hold_plain(name: str, inputs: str):
  """fn(label, outs) that holds B1's (`smooth`, `smooth_three_humanoids`)
  outputs at TOL_B1 against this checkout's plain version on the saved
  inputs, B5's (`spd_solve`, `spd_solve_factor`), B6's (`cho_solve`),
  B7's (`tree_ldl`, `tree_ldl_euler`) and B8's (`tree_solve`) x by
  chip_smoke.py's `_check_solve` (residual, forward error against the
  float64 plain version), B5's factor and B7's packed entries of LD at
  TOL_B1 and B7's LD zero elsewhere; it raises if they miss them."""
  sys.path.insert(0, HERE)
  import torch
  import chip_smoke
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import batch_linalg, models, smooth
  inp = torch.load(inputs)
  if name.startswith('smooth'):
    npz = (models.THREE_HUMANOIDS_NPZ if name.endswith('three_humanoids')
           else models.HUMANOID_NPZ)
    m = mt.load_model(npz, device='cuda')
    s_in = inp['s3_in' if name.endswith('three_humanoids') else 's_in']
    ref = smooth.smooth(m, *s_in)
    return lambda label, out: chip_smoke._compare(
        label, out, ref, chip_smoke.TOL_B1, smooth.OUTPUTS)
  if name.startswith('tree'):
    return _hold_tree(name, inp)
  if name == 'cho_solve':
    factor, b = inp['cho_in']
    f64 = factor.double()
    a64 = f64 @ f64.transpose(1, 2)
    plain = batch_linalg.cho_solve_batched(factor, b)
    x64 = batch_linalg.cho_solve_batched(f64, b.double())
    return lambda label, out: chip_smoke._check_solve(
        label, a64, b, out['x'], plain, x64)
  a, b = inp['spd_in' if name == 'spd_solve' else 'spd_factor_in']
  plain, factor = batch_linalg.spd_solve_batched(a, b, return_factor=True)
  x64 = batch_linalg.spd_solve_batched(a.double(), b.double())

  def hold(label, out):
    chip_smoke._check_solve(label, a, b, out['x'], plain, x64)
    if 'factor' in out:
      chip_smoke._compare(label, out, dict(factor=factor),
                          chip_smoke.TOL_B1, ['factor'])
  return hold


def _hold_tree(name: str, inp: dict):
  """hold_plain's rule for B7 and B8 on three_humanoids' saved inputs."""
  import torch
  import chip_smoke
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import batch_linalg, models
  m3 = mt.load_model(models.THREE_HUMANOIDS_NPZ, device='cuda')
  parent = m3.dof_parentid
  if name == 'tree_solve':
    ld, b = inp['tree_solve_in']
    ld64 = ld.double()
    unit_l = torch.tril(ld64, -1) + torch.eye(m3.nv, dtype=torch.float64,
                                              device=ld.device)
    a64 = unit_l.transpose(1, 2) @ (torch.diagonal(
        ld64, dim1=1, dim2=2)[..., None] * unit_l)
    plain = batch_linalg.tree_solve_from_factor_batched(ld, b, parent)
    x64 = batch_linalg.tree_solve_from_factor_batched(ld64, b.double(),
                                                      parent)
    return lambda label, out: chip_smoke._check_solve(
        label, a64, b, out['x'], plain, x64)
  diag = (m3.opt.timestep * m3.dof_damping if name == 'tree_ldl_euler'
          else None)
  qM, b = inp['tree_euler_in' if diag is not None else 'tree_in']
  plain, ld = batch_linalg.tree_ldl_solve_batched(qM, b, parent, diag=diag,
                                                  return_factor=True)
  x64 = batch_linalg.tree_ldl_solve_batched(
      qM.double(), b.double(), parent,
      diag=None if diag is None else diag.double())
  a = qM + (torch.diag(diag) if diag is not None else 0)
  mask = batch_linalg.packed_mask(parent, qM.device)

  def hold(label, out):
    chip_smoke._check_solve(label, a, b, out['x'], plain, x64)
    if 'factor' in out:
      chip_smoke._compare(label, {'LD': out['factor'][:, mask]},
                          {'LD': ld[:, mask]}, chip_smoke.TOL_B1, ['LD'])
      if bool(out['factor'][:, ~mask].any()):
        raise RuntimeError(f'{label}: nonzero LD off the packed entries')
  return hold


def compare(paths, redesigned=()) -> int:
  import torch
  first = torch.load(paths[0])
  covered = {c: k for k in redesigned for c in REDESIGNABLE[k]}
  bad = 0
  for path in paths[1:]:
    other = torch.load(path)
    for name, outs in first['outs'].items():
      diff = [k for k, v in outs.items()
              if not torch.equal(v, other['outs'][name][k])]
      if name not in covered:
        bad += len(diff)
      largest = max((float((outs[k].double() - other['outs'][name][k]
                            .double()).abs().max()) for k in diff),
                    default=0.0)
      print(f'{name}: {first["root"]} against {other["root"]}: '
            f'{"bit-equal" if not diff else "differ in " + str(diff)}'
            f'{f" (largest |diff| {largest:.3g})" if diff else ""}; '
            f'ms {first["ms"][name]:.4f} vs {other["ms"][name]:.4f}')
  for name in sorted(covered):
    hold = (hold_elliptic if covered[name] in ('glue_ell', 'newton_ell')
            else hold_plain)(name, first['inputs'])
    for path in paths:
      run_out = torch.load(path)
      try:
        hold(f'{name} [{run_out["root"]}]', run_out['outs'][name])
      except RuntimeError as e:
        print(f'{name} [{run_out["root"]}]: misses the rules it is held '
              f'by: {e}')
        bad += 1
  return 1 if bad else 0


def turns(a: str, b: str, out_dir: str, redesigned=()) -> int:
  """Inputs from this checkout, then A, B, B, A in their own processes;
  every turn's outputs compared with the first's."""
  import subprocess
  import torch
  os.makedirs(out_dir, exist_ok=True)
  inputs = os.path.join(out_dir, 'inputs.pt')
  make_inputs(inputs)
  torch.cuda.empty_cache()
  outs = []
  for i, root in enumerate((a, b, b, a)):
    outs.append(os.path.join(out_dir, f'turn{i}.pt'))
    subprocess.run([sys.executable, os.path.abspath(__file__), 'run', root,
                    inputs, outs[-1]], check=True)
  ms = [torch.load(p)['ms'] for p in outs]
  print(f'{"kernel":28s} ' + ' '.join(f'{r:>10s}' for r in ('A', 'B', 'B',
                                                             'A')) +
        ' (ms on the card a launch)')
  for name in ms[0]:
    print(f'{name:28s} ' + ' '.join(f'{t[name]:10.4f}' for t in ms))
  return compare(outs, redesigned)


def main(argv) -> int:
  redesigned = ()
  if len(argv) >= 2 and argv[-2] == '--redesigned':
    redesigned = tuple(argv[-1].split(','))
    argv = argv[:-2]
    if not set(redesigned) <= set(REDESIGNABLE):
      print(f'--redesigned: one of {tuple(REDESIGNABLE)}', file=sys.stderr)
      return 2
  if argv[:1] == ['inputs'] and len(argv) == 2:
    make_inputs(argv[1])
    return 0
  if argv[:1] == ['run'] and len(argv) == 4:
    run(*argv[1:])
    return 0
  if argv[:1] == ['compare'] and len(argv) >= 3:
    return compare(argv[1:], redesigned)
  if argv[:1] == ['turns'] and len(argv) == 4:
    return turns(*argv[1:], redesigned)
  print(__doc__, file=sys.stderr)
  return 2


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
