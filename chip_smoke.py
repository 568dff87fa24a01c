"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases:
  (a) print the card's name and power limit; build the CUDA kernels from
      mujoco_warp_tpu_torch/csrc (one nvcc per source, in parallel);
  (b) load the humanoid from its committed .npz and make 8192 worlds with
      seeded qpos noise, nconmax=24;
  (c) step 100 times, then hold each kernel (B1 smooth, B2 contact, B3
      glue) against its plain PyTorch version on the same inputs on the
      card, failing above the stated tolerance;
  (d) with every launch count at 0, run the main path (20 warm-up + 100
      timed steps with OU control noise) and require each kernel to have
      launched once per step; print steps/s and check for NaN;
  (e) from the state the main path left, time each kernel and its plain
      version, compute its bound, and repeat 10 steps of the main path
      under torch.profiler for the device time per kernel name and the
      device's busy share.
  Then three_humanoids (nv 81) from its .npz, 8192 worlds, nconmax 100,
  which runs the unfused step:
  (f) step 10 times, then hold B1 and B2 against their plain versions as
      in (c), B7 (tree_ldl, with and without the Euler diagonal) and B5
      (spd_solve, on the Hessians of the solve's first direction) by the
      packed factor, the per-world residual and the forward error against
      the plain version in float64;
  (g) with every count at 0, run the main path (2 warm-up + 10 timed
      steps) and require B1 and B2 once per step, B7 twice per step and
      B5 once per Newton direction (one per step plus one per pass of the
      solve's loop); hold one whole step of the kernels against the
      all-plain step on the same state (qacc and the solve's objective);
  (h) time each kernel, its plain version and, for B5, torch.linalg.solve
      on the same inputs, with its bound; profile 2 steps.
One JSON line lists every kernel's record.

The last line is {"ok": true, "device": {...}}; any failure raises and
exits non-zero without it. Nothing here imports JAX or the JAX package.
"""

import collections
import contextlib
import json
import subprocess
import sys

NWORLD = 8192
NCONMAX = 24
SEED = 0
QPOS_NOISE = 0.01
PREP_STEPS = 100
WARMUP = 20
NSTEP = 100
# scale-relative tolerances: |kernel - plain| <= tol * max(1, max |plain|)
TOL_B1 = TOL_B2 = 2e-5       # same operations in another order
# B3: the step tolerances of tests/test_glue_kernel.py:52-66 (qpos 5e-6,
# qacc 5e-5, qfrc_constraint 5e-4, the rest 5e-5). Besides, the solve is
# held to its objective: both solutions' cost within TOL_OBJ units of
# tolerance * meaninertia * nv (the unit of its stopping rule). The
# stopping rule is tripped one iteration earlier or later by a 1-ulp
# change of the inputs (phase c prints the plain version's own spread),
# so solver_niter is held per world within NITER_MAX, the bound of that
# test, and the share of worlds within NITER_SLACK of the plain version
# may fall short of the share the plain version keeps against itself,
# after a 1-ulp change of qfrc_smooth, by at most NITER_MARGIN.
TOL_B3 = dict(qpos=5e-6, qfrc_constraint=5e-4, efc_force=5e-4)
TOL_B3_OTHER = 5e-5
TOL_OBJ = 1.0
NITER_MAX = 4
NITER_SLACK = 2
NITER_MARGIN = 0.01
PROFILE_STEPS = 10
# three_humanoids (phases f-h): the benchmark suite's configuration
NCONMAX3 = 100
PREP3 = 10
WARMUP3 = 2
NSTEP3 = 10
PROFILE3 = 2
# B5 and B7 are held by residual and forward error, not elementwise: at
# nv 81 the float32 rounding of either version moves x by more than a
# fixed elementwise bound. Per world, |a x - b|inf / (|a|inf |x|inf +
# |b|inf) <= TOL_RES; over the batch, the kernel's distance from the
# plain version run in float64 is at most FWD_FACTOR times the float32
# plain version's own, plus FWD_FLOOR (both relative to max |x|). The
# packed factor LD is the same arithmetic in the same order: TOL_B1.
TOL_RES = 1e-5
FWD_FACTOR = 4.0
FWD_FLOOR = 1e-6
# one whole step, kernels against plain versions: qacc as B3's (5e-5 of
# max(1, max |qacc|)) over the worlds whose contact and row sets agree
TOL_STEP_QACC = 5e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 flop/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def _card() -> str:
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0]


def _rel_err(a, b) -> tuple[float, float]:
  """(max abs error, max abs error / max(1, max |b|))."""
  a, b = a.float(), b.float()
  if b.numel() == 0:
    return 0.0, 0.0
  err = float((a - b).abs().max())
  return err, err / max(1.0, float(b.abs().max()))


def _compare(name, out, ref, tol, keys, worlds=None, scale=None) -> float:
  """Print and check float fields; returns the max abs error. scale maps
  a field to the error scale that replaces max(1, max |plain|)."""
  worst = 0.0
  for k in keys:
    a, b = out[k], ref[k]
    if worlds is not None:
      a, b = a[worlds], b[worlds]
    t = tol[k] if isinstance(tol, dict) else tol
    err, rel = _rel_err(a, b)
    if scale and k in scale:
      rel = err / scale[k]
    worst = max(worst, err)
    print(f'  {name} {k:18s} abs {err:.3e} rel {rel:.3e} (tol {t:g})')
    if not rel <= t:
      raise RuntimeError(f'{name}: {k} differs from the plain version: '
                         f'{rel:.3e} > {t:g}')
  return worst


def _check_contact(name, m, c_out, c_ref) -> float:
  """Hold kernel B2's outputs against its plain version's: the same
  contact and row sets, except in a few worlds at an activation
  threshold, and the float fields at TOL_B2."""
  import torch
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.types import ConstraintType
  nworld = c_ref['ncon'].shape[0]
  discrete = ('ncon', 'ncollision', 'ne', 'nf', 'nl', 'nefc', 'dim', 'geom',
              'efc_address', 'efc_type', 'efc_id', 'efc_active')
  same = torch.ones(nworld, dtype=torch.bool, device=c_ref['ncon'].device)
  for k in discrete:
    eq = c_out[k] == c_ref[k]
    same &= eq.reshape(nworld, -1).all(1)
  # a world may differ only through a contact or limit at its activation
  # threshold, where the two versions' rounding decides
  valid = c_ref['geom'][..., 0] >= 0
  gap_c = torch.where(valid, (c_ref['dist'] - c_ref['includemargin']).abs(),
                      float('inf')).amin(1)
  valid_k = c_out['geom'][..., 0] >= 0
  gap_k = torch.where(valid_k, (c_out['dist'] -
                                c_out['includemargin']).abs(),
                      float('inf')).amin(1)
  lim = c_ref['efc_type'] == int(ConstraintType.LIMIT_JOINT)
  gap_l = torch.where(lim, (c_ref['efc_pos'] - c_ref['efc_margin']).abs(),
                      float('inf')).amin(1)
  near = torch.minimum(torch.minimum(gap_c, gap_k), gap_l)
  bad = ~same
  nbad = int(bad.sum())
  print(f'  {name} worlds with a different contact/row set: {nbad} of '
        f'{nworld}')
  if nbad > max(8, nworld // 1000) or bool((near[bad] >= 1e-4).any()):
    raise RuntimeError(f'{name}: {nbad} worlds differ in their contact '
                       f'sets, not all at an activation threshold')
  floats = [k for k in c_ref if k not in discrete]
  # aref = -b vel - k imp pos carries vel's rounding times the damping b
  t = _build.model_tables(m, 'contact', kc._tables)
  solref = torch.cat([t['pair_float'][:, 5], t['lim_float'][:, 3],
                      t['fr_float'][:, 0]])
  dmax = torch.cat([t['pair_float'][:, 10], t['lim_float'][:, 6],
                    t['fr_float'][:, 3]]).clamp(1e-4, 0.9999)
  bmax = float((2.0 / (dmax * torch.clamp(
      solref, min=2.0 * float(m.opt.timestep)))).max())
  aref_scale = max(1.0, float(c_ref['efc_aref'][same].abs().max()),
                   bmax * float(c_ref['efc_vel'][same].abs().max()))
  print(f'  {name} efc_aref error scale {aref_scale:.1f} (damping b up to '
        f'{bmax:.1f} times |efc_vel|)')
  return _compare(name, c_out, c_ref, TOL_B2, floats, worlds=same,
                  scale={'efc_aref': aref_scale})


def _cuda_ms(fn, reps: int) -> float:
  import torch
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def _profile(fn, nstep: int) -> list[tuple[str, float, float]]:
  """(kernel name, launches per step, device ms per step) over fn(), which
  runs nstep steps, most device time first; empty if the profiler saw no
  device events."""
  import torch
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    fn()
    torch.cuda.synchronize()
  per_name = collections.defaultdict(lambda: [0, 0.0])
  for e in prof.events():
    if e.device_type == torch.autograd.DeviceType.CUDA:
      per_name[e.name][0] += 1
      per_name[e.name][1] += e.time_range.elapsed_us() / 1e3
  return sorted(((n, c / nstep, ms / nstep) for n, (c, ms)
                 in per_name.items()), key=lambda r: -r[2])


def _nbytes(*groups) -> int:
  total = 0
  for g in groups:
    vals = g.values() if isinstance(g, dict) else g
    total += sum(v.numel() * v.element_size() for v in vals
                 if hasattr(v, 'numel'))
  return total


def _record(records, name, launches, err, source, replaces, run, plain,
            nbytes, flops, library=None):
  """Time a kernel (20 launches), its plain version (3) and, where one
  PyTorch call computes the same function, that call (20); append the
  kernel's record with its bound."""
  ms = _cuda_ms(run, 20)
  plain_ms = _cuda_ms(plain, 3)
  library_ms = _cuda_ms(library, 20) if library else None
  bound_b = nbytes / PEAK_BYTES * 1e3
  bound_f = flops / PEAK_F32 * 1e3
  records.append(dict(
      name=name, route='cuda', source=source, replaces=replaces,
      launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
      bound_ms=max(bound_b, bound_f),
      bound_by='bytes' if bound_b >= bound_f else 'operations',
      library_ms=library_ms))
  lib = f', library {library_ms:.4f} ms' if library else ''
  print(f'  {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms{lib}), bound '
        f'{max(bound_b, bound_f):.4f} ms by '
        f'{records[-1]["bound_by"]} ({nbytes / 1e6:.1f} MB, '
        f'{flops / 1e9:.3f} GFLOP)')


def _flops_b1(m, W) -> float:
  """B1's operations, estimated from the model's sizes."""
  chain = sum(len(r) for r in m.dof_ancestor_rows)
  return W * (430 * m.nbody + 130 * m.njnt + 90 * m.ngeom + 140 * m.nv +
              12 * chain)


def _flops_b2(m, W, c_out, nconmax) -> float:
  """B2's operations, from the model's pairs and this run's contacts."""
  import mujoco_warp_tpu_torch as mt
  pair_flops = {(0, 2): 25, (0, 3): 50, (2, 2): 30, (2, 3): 55, (3, 3): 90}
  per_pair = sum(len(gl) * pair_flops[(t1, t2)]
                 for t1, t2, gl in m.collision_pairs)
  ncon = c_out['ncon'].double().sum().item()
  _, _, nl, stride, _ = mt.efc_layout(m, nconmax)
  return (W * (per_pair + 45 * nl) +
          ncon * (60 + m.nv * (45 + 4 * stride)))


def _print_profile(label, fn, nstep, step_ms, card):
  """Profile fn (nstep steps): device time per kernel name and the busy
  share against the host-clock step_ms."""
  rows = _profile(fn, nstep)
  device_ms = sum(r[2] for r in rows)
  for name, calls, ms in rows[:8]:
    print(f'  {label}: {ms:9.4f} ms/step {calls:6.1f} launches/step  '
          f'{name[:80]}')
  print(json.dumps({label: dict(
      steps=nstep, step_ms=step_ms,
      device_ms=device_ms if rows else 'not measured',
      busy_share=device_ms / step_ms if rows else 'not measured',
      launches_per_step=sum(r[1] for r in rows),
      top=[dict(name=n[:80], launches_per_step=c, ms_per_step=ms)
           for n, c, ms in rows[:8]], card=card)}))


@contextlib.contextmanager
def _plain_kernels():
  """Swap each kernel wrapper of the unfused step for its plain version,
  for the all-plain reference step on the card (which launches and counts
  nothing)."""
  from mujoco_warp_tpu_torch import batch_linalg, smooth
  from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  saved = ks.smooth, kc.contact, kb.tree_ldl, kb.spd_solve
  ks.smooth, kc.contact = smooth.smooth, kc.plain
  kb.tree_ldl = batch_linalg.tree_ldl_solve_batched
  kb.spd_solve = batch_linalg.spd_solve_batched
  yield
  ks.smooth, kc.contact, kb.tree_ldl, kb.spd_solve = saved


def _check_solve(name, a, b, x, x_plain, x64) -> float:
  """Hold a kernel's solution x of a x = b by its per-world residual and
  its forward error (see TOL_RES); returns max |x - x_plain|."""
  import torch
  a64, b64, xd = a.double(), b.double(), x.double()
  r = (torch.einsum('wij,wj->wi', a64, xd) - b64).abs().amax(1)
  res = r / (a64.abs().sum(2).amax(1) * xd.abs().amax(1) + b64.abs().amax(1))
  scale = float(x64.abs().max())
  err = float((xd - x64).abs().max()) / scale
  err_plain = float((x_plain.double() - x64).abs().max()) / scale
  diff = float((x - x_plain).abs().max())
  print(f'  {name} residual max {float(res.max()):.3e} (tol {TOL_RES:g}); '
        f'off the float64 plain version: kernel {err:.3e}, plain '
        f'{err_plain:.3e} of scale {scale:.3e}; |kernel - plain| {diff:.3e}')
  if not float(res.max()) <= TOL_RES:
    raise RuntimeError(f'{name}: residual {float(res.max()):.3e}')
  if not err <= FWD_FACTOR * err_plain + FWD_FLOOR:
    raise RuntimeError(f'{name}: forward error {err:.3e} > {FWD_FACTOR:g} '
                       f'x {err_plain:.3e} + {FWD_FLOOR:g}')
  return diff


def _three_humanoids(card) -> list:
  """Phases (f)-(h) on three_humanoids; returns the kernel records."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import (batch_linalg, forward, models, smooth,
                                     solver)
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  from mujoco_warp_tpu_torch.utils import benchmark as bench

  m = mt.load_model(models.THREE_HUMANOIDS_NPZ, device='cuda')
  d = mt.make_data(m, nconmax=NCONMAX3)
  gen = torch.Generator(device='cuda').manual_seed(SEED)
  d = mt.make_batch(m, d, NWORLD, qpos_noise=QPOS_NOISE, generator=gen)
  _, _, nl, stride, nj = mt.efc_layout(m, NCONMAX3)
  print(f'model: three_humanoids nq={m.nq} nv={m.nv} nbody={m.nbody} '
        f'ngeom={m.ngeom} nu={m.nu} ncam={m.ncam} nlight={m.nlight} '
        f'candidates={m.nxn_candidates} njmax={nj}; nworld={NWORLD} '
        f'nconmax={NCONMAX3}')

  # ---- (f) kernels against their plain versions ----
  d, prep = bench.benchmark(m, d, nstep=PREP3)
  print(f'prep: {PREP3} steps, ncon mean {prep["ncon_mean"]:.2f}, '
        f'solver_niter mean {prep["solver_niter_mean"]:.2f} max '
        f'{prep["solver_niter_max"]}')
  stages = forward.batched_stages(m, d)
  names = [n for n, _ in stages]
  print(f'stages: {" -> ".join(names)}')
  if names != ['smooth_mega[cuda]', 'camlight', 'contact_efc_mega[cuda]',
               'transmission', 'velocity_glue', 'passive', 'fwd_actuation',
               'fwd_acceleration', 'solve', 'euler']:
    raise RuntimeError('three_humanoids does not run the unfused list')
  pre = d
  for _, fn in stages[:names.index('solve')]:
    pre = fn(pre)
  post = stages[names.index('solve')][1](pre)
  errs = {}
  sm_out = ks.smooth(m, d.qpos, d.qvel)
  sm_ref = smooth.smooth(m, d.qpos, d.qvel)
  errs['smooth'] = _compare('B1', sm_out, sm_ref, TOL_B1, smooth.OUTPUTS)
  c_in = (sm_out['qpos'], d.qvel, sm_out['geom_xpos'], sm_out['geom_xmat'],
          sm_out['subtree_com'], sm_out['cdof'])
  c_out = kc.contact(m, *c_in, NCONMAX3)
  c_ref = kc.plain(m, *c_in, NCONMAX3)
  errs['contact'] = _check_contact('B2', m, c_out, c_ref)

  parent = m.dof_parentid
  qM, qfs = pre.qM, pre.qfrc_smooth
  diag = m.opt.timestep * m.dof_damping
  mask = batch_linalg.packed_mask(parent, qM.device)
  errs['tree_ldl'] = 0.0
  for label, b, dg in (('fwd_acceleration', qfs, None),
                       ('euler', qfs + post.qfrc_constraint, diag)):
    x, ld = kb.tree_ldl(qM, b, parent, diag=dg, return_factor=True)
    xr, ldr = batch_linalg.tree_ldl_solve_batched(qM, b, parent, diag=dg,
                                                  return_factor=True)
    x64 = batch_linalg.tree_ldl_solve_batched(
        qM.double(), b.double(), parent,
        diag=None if dg is None else dg.double())
    a = qM + (torch.diag(dg) if dg is not None else 0)
    _compare(f'B7 {label}', {'LD': ld[:, mask]}, {'LD': ldr[:, mask]},
             TOL_B1, ['LD'])
    if bool(ld[:, ~mask].any()):
      raise RuntimeError('B7: nonzero LD outside the packed entries')
    errs['tree_ldl'] = max(errs['tree_ldl'], _check_solve(
        f'B7 {label}', a, b, x, xr, x64))

  # B5 on the Hessian of the solve's first Newton direction
  J, D, fl = pre.efc_J, pre.efc_D, pre.efc_frictionloss
  qacc = pre.qacc_warmstart
  jaref = torch.einsum('wrn,wn->wr', J, qacc) - pre.efc_aref
  force, _, quad = solver._update_constraint(
      jaref, D, fl, fl / torch.clamp(D, min=solver.MINVAL),
      *solver._row_masks(pre.efc_type))
  H = qM + torch.bmm((J * (D * quad)[..., None]).transpose(1, 2), J)
  grad = (torch.einsum('wij,wj->wi', qM, qacc) - qfs -
          torch.einsum('wrn,wr->wn', J, force))
  rows = int(quad.sum())
  print(f'  B5 Hessians: {rows / NWORLD:.2f} quadratic rows per world')
  x = kb.spd_solve(H, grad)
  xr = batch_linalg.spd_solve_batched(H, grad)
  x64 = batch_linalg.spd_solve_batched(H.double(), grad.double())
  errs['spd_solve'] = _check_solve('B5', H, grad, x, xr, x64)

  # ---- (g) the main path, counted and timed ----
  for mod in (ks, kc, kg):
    mod.launches = 0
  kb.launches.update(tree_ldl=0, spd_solve=0)
  solver.counts.update(solve=0, passes=0)
  d, res = bench.benchmark(m, d, nstep=NSTEP3, warmup=WARMUP3)
  steps = WARMUP3 + NSTEP3
  counts = {'smooth[three_humanoids]': ks.launches,
            'contact[three_humanoids]': kc.launches,
            'tree_ldl': kb.launches['tree_ldl'],
            'spd_solve': kb.launches['spd_solve']}
  expect = {'smooth[three_humanoids]': steps,
            'contact[three_humanoids]': steps, 'tree_ldl': 2 * steps,
            'spd_solve': solver.counts['solve'] + solver.counts['passes']}
  print(f'launches in the main path: {counts} for {steps} steps, '
        f'{solver.counts["passes"]} Newton passes after {steps} initial '
        f'directions; glue {kg.launches}')
  if (counts != expect or kg.launches or solver.counts['solve'] != steps or
      not solver.counts['passes']):
    raise RuntimeError(f'launch counts {counts}, expected {expect}')
  for k in ('qpos', 'qvel', 'qacc', 'efc_force', 'cam_xpos', 'light_xpos'):
    if not bool(torch.isfinite(getattr(d, k)).all()):
      raise RuntimeError(f'non-finite {k} after the main path')
  print(f'step: {res["steps_per_sec"]:.1f} steps/s, '
        f'{res["step_time_us"]:.1f} us/step over {NSTEP3} steps at '
        f'{NWORLD} worlds; ncon mean {res["ncon_mean"]:.2f}, solver_niter '
        f'mean {res["solver_niter_mean"]:.2f} max {res["solver_niter_max"]}'
        f', converged {res["converged_worlds"]} of {NWORLD} ({card})')
  print(json.dumps({'step_three_humanoids': dict(res, card=card)}))

  # one whole step of the kernel path against the all-plain path
  d_k = mt.step_batched(m, d)
  with _plain_kernels():
    d_p = mt.step_batched(m, d)
  same = ((d_k.ncon == d_p.ncon) & (d_k.efc_type == d_p.efc_type).all(1) &
          (d_k.efc_active == d_p.efc_active).all(1))
  nbad = NWORLD - int(same.sum())
  print(f'  step: {nbad} of {NWORLD} worlds with a different contact/row '
        f'set')
  if nbad > max(8, NWORLD // 1000):
    raise RuntimeError(f'step: {nbad} worlds differ in their row sets')
  _compare('step', {'qacc': d_k.qacc}, {'qacc': d_p.qacc}, TOL_STEP_QACC,
           ['qacc'], worlds=same)
  f64 = lambda x: x.double()[same]
  objective = lambda qa: solver.objective(
      f64(d_p.qM), f64(d_p.efc_J), f64(d_p.efc_D), f64(d_p.efc_aref),
      f64(d_p.efc_frictionloss), f64(d_p.qfrc_smooth), f64(d_p.qacc_smooth),
      f64(qa), 0, 0)
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * m.nv
  gap = ((objective(d_k.qacc) - objective(d_p.qacc)) / unit).abs()
  dn = (d_k.solver_niter - d_p.solver_niter).abs()
  print(f'  step objective gap / (tolerance * meaninertia * nv): max '
        f'{float(gap.max()):.3e} (tol {TOL_OBJ:g}); solver_niter |diff| '
        f'histogram {dn.bincount().tolist()}')
  if not float(gap.max()) <= TOL_OBJ:
    raise RuntimeError('step: the kernel path misses the plain path\'s '
                       'objective')

  # ---- (h) kernel times, plain times, bounds and library calls ----
  records = []
  W = NWORLD
  record = lambda name, *args, **kw: _record(records, name, counts[name],
                                              errs[name.split('[')[0]],
                                              *args, **kw)
  tables = lambda key, make: _build.model_tables(m, key, make)
  sm_in = (d.qpos, d.qvel)
  sm_out = ks.smooth(m, *sm_in)
  c_in = (sm_out['qpos'], d.qvel, sm_out['geom_xpos'], sm_out['geom_xmat'],
          sm_out['subtree_com'], sm_out['cdof'])
  c_out = kc.contact(m, *c_in, NCONMAX3)
  record('smooth[three_humanoids]', 'mujoco_warp_tpu_torch/csrc/smooth.cu',
         'mujoco_warp_tpu/pallas/smooth_kernels.py:557',
         lambda: ks.smooth(m, *sm_in), lambda: smooth.smooth(m, *sm_in),
         _nbytes(sm_in, sm_out, tables('smooth', ks._tables)),
         _flops_b1(m, W))
  record('contact[three_humanoids]', 'mujoco_warp_tpu_torch/csrc/contact.cu',
         'mujoco_warp_tpu/pallas/contact_kernels.py:1643',
         lambda: kc.contact(m, *c_in, NCONMAX3),
         lambda: kc.plain(m, *c_in, NCONMAX3),
         _nbytes(c_in, c_out, tables('contact', kc._tables)),
         _flops_b2(m, W, c_out, NCONMAX3))
  # B7 as fwd_acceleration calls it (factor written); it needs only the
  # packed entries of qM
  lens = [len(r) for r in m.dof_ancestor_rows]    # each row: dof, ancestors
  nnz, nv = sum(lens), m.nv
  pairs = sum((n - 1) * n // 2 for n in lens)
  bytes_b7 = W * 4 * (nnz + 2 * nv + nv * nv)
  flops_b7 = W * (2 * pairs + 4 * (nnz - nv) + 2 * nv)
  x_only = _cuda_ms(lambda: torch.linalg.solve(qM, qfs), 20)
  print(f'  tree_ldl: torch.linalg.solve for x alone (no packed factor, '
        f'not the same function): {x_only:.4f} ms')
  record('tree_ldl', 'mujoco_warp_tpu_torch/csrc/batch_linalg.cu',
         'mujoco_warp_tpu/pallas/batch_linalg.py:314',
         lambda: kb.tree_ldl(qM, qfs, parent, return_factor=True),
         lambda: batch_linalg.tree_ldl_solve_batched(qM, qfs, parent,
                                                     return_factor=True),
         bytes_b7, flops_b7)
  euler_ms = _cuda_ms(lambda: kb.tree_ldl(qM, qfs, parent, diag=diag), 20)
  print(f'  tree_ldl as euler calls it (diag, no factor): {euler_ms:.4f} ms')
  n = m.nv
  record('spd_solve', 'mujoco_warp_tpu_torch/csrc/batch_linalg.cu',
         'mujoco_warp_tpu/pallas/batch_linalg.py:103',
         lambda: kb.spd_solve(H, grad),
         lambda: batch_linalg.spd_solve_batched(H, grad),
         _nbytes((H, grad, x)), W * (n ** 3 / 3 + 2 * n * n),
         library=lambda: torch.linalg.solve(H, grad))
  _print_profile('profile_three_humanoids',
                 lambda: bench.benchmark(m, d, nstep=PROFILE3), PROFILE3,
                 res['step_time_us'] / 1e3, card)
  return records


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import (forward, models, smooth, solver,
                                     support)
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  from mujoco_warp_tpu_torch.utils import benchmark as bench

  # ---- (a) card and build ----
  card = _card()
  print(f'card: {card}')
  print(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'python {sys.version.split()[0]}')
  secs = _build.build_all()
  print(f'kernel build: {secs:.1f} s (one nvcc per source, in parallel)')
  for name in _build.SOURCES:
    for line in _build.build_log(name).splitlines():
      if 'registers' in line or 'spill' in line:
        print(f'  ptxas {name}: {line.strip()}')

  # ---- (b) model and batch ----
  m = mt.load_model(models.HUMANOID_NPZ, device='cuda')
  d = mt.make_data(m, nconmax=NCONMAX)
  gen = torch.Generator(device='cuda').manual_seed(SEED)
  d = mt.make_batch(m, d, NWORLD, qpos_noise=QPOS_NOISE, generator=gen)
  print(f'model: humanoid nq={m.nq} nv={m.nv} nbody={m.nbody} '
        f'ngeom={m.ngeom} nu={m.nu}; nworld={NWORLD} nconmax={NCONMAX}')

  # ---- (c) kernels against their plain versions ----
  d, prep = bench.benchmark(m, d, nstep=PREP_STEPS)
  print(f'prep: {PREP_STEPS} steps, ncon mean {prep["ncon_mean"]:.2f}')
  errs = {}
  sm_out = ks.smooth(m, d.qpos, d.qvel)
  sm_ref = smooth.smooth(m, d.qpos, d.qvel)
  errs['smooth'] = _compare('B1', sm_out, sm_ref, TOL_B1, smooth.OUTPUTS)

  c_in = (sm_out['qpos'], d.qvel, sm_out['geom_xpos'], sm_out['geom_xmat'],
          sm_out['subtree_com'], sm_out['cdof'])
  c_out = kc.contact(m, *c_in, NCONMAX)
  c_ref = kc.plain(m, *c_in, NCONMAX)
  errs['contact'] = _check_contact('B2', m, c_out, c_ref)

  qfx = d.qfrc_applied + support.xfrc_accumulate(
      m, d.xfrc_applied, sm_out['xipos'], sm_out['subtree_com'],
      sm_out['cdof']) - sm_out['qfrc_bias']
  g_in = (sm_out['qM'], c_out['efc_J'], c_out['efc_D'], c_out['efc_aref'],
          c_out['efc_frictionloss'], sm_out['qpos'], d.qvel, d.ctrl, qfx,
          d.qacc_warmstart)
  g_out = kg.glue(m, *g_in)
  g_ref = forward.glue(m, *g_in)
  keys = [k for k in kg.OUTPUTS if k != 'solver_niter']
  tol3 = {k: TOL_B3.get(k, TOL_B3_OTHER) for k in keys}
  errs['glue'] = _compare('B3', g_out, g_ref, tol3, keys)
  # float32's own floor: both versions against the plain one in float64
  g_f64 = forward.glue(m, *[x.double() if x.is_floating_point() else x
                            for x in g_in])
  for k in ('qacc', 'qfrc_constraint'):
    s = max(1.0, float(g_ref[k].abs().max()))
    dev = lambda g: float((g[k].double() - g_f64[k]).abs().max()) / s
    print(f'  B3 {k:18s} off the float64 plain version: kernel '
          f'{dev(g_out):.3e}, plain {dev(g_ref):.3e} (scale {s:.1f})')
  f64 = lambda x: x.double()
  qfs = f64(g_ref['qfrc_smooth'])
  qsm = solver.cho_solve(solver.cholesky(f64(g_in[0])), qfs)
  ne, nf, _, _, _ = mt.efc_layout(m, NCONMAX)
  objective = lambda qacc: solver.objective(
      *[f64(x) for x in g_in[:5]], qfs, qsm, f64(qacc), ne, nf)
  unit = (float(m.opt.tolerance) * float(m.stat.meaninertia) *
          max(1, m.nv))
  gap = ((objective(g_out['qacc']) - objective(g_ref['qacc'])) /
         unit).abs()
  print(f'  B3 objective gap / (tolerance * meaninertia * nv): max '
        f'{float(gap.max()):.3e} (tol {TOL_OBJ:g})')
  if not float(gap.max()) <= TOL_OBJ:
    raise RuntimeError('B3: the kernel\'s solution misses the plain '
                       'version\'s objective')
  qfx_ulp = torch.nextafter(g_in[8], torch.full_like(g_in[8], float('inf')))
  g_ulp = forward.glue(m, *g_in[:8], qfx_ulp, g_in[9])

  def niter_share(a, b, label):
    dn = (a['solver_niter'] - b['solver_niter']).abs()
    share = float((dn <= NITER_SLACK).float().mean())
    print(f'  B3 solver_niter {label}: |diff| histogram '
          f'{dn.bincount().tolist()}, within {NITER_SLACK}: {share:.4f}')
    return share
  share = niter_share(g_out, g_ref, 'kernel vs plain')
  share_ulp = niter_share(g_ulp, g_ref, 'plain vs plain(qfx + 1 ulp)')
  mean = lambda g: float(g['solver_niter'].float().mean())
  print(f'  B3 solver_niter mean {mean(g_out):.3f} vs plain {mean(g_ref):.3f}')
  dn_max = int((g_out['solver_niter'] - g_ref['solver_niter']).abs().max())
  if dn_max > NITER_MAX:
    raise RuntimeError(f'B3: solver_niter differs by {dn_max} > {NITER_MAX}')
  if share < share_ulp - NITER_MARGIN:
    raise RuntimeError(f'B3: solver_niter differs by more than '
                       f'{NITER_SLACK} in too many worlds')

  # ---- (d) the main path, counted and timed ----
  for mod in (ks, kc, kg):
    mod.launches = 0
  d, res = bench.benchmark(m, d, nstep=NSTEP, warmup=WARMUP)
  counts = {'smooth': ks.launches, 'contact': kc.launches,
            'glue': kg.launches}
  print(f'launches in the main path: {counts} for {WARMUP + NSTEP} steps')
  for name, n in counts.items():
    if n != WARMUP + NSTEP:
      raise RuntimeError(f'{name}: {n} launches for {WARMUP + NSTEP} steps')
  for k in ('qpos', 'qvel', 'qacc', 'efc_force'):
    if not bool(torch.isfinite(getattr(d, k)).all()):
      raise RuntimeError(f'non-finite {k} after the main path')
  print(f'step: {res["steps_per_sec"]:.1f} steps/s, '
        f'{res["step_time_us"]:.1f} us/step over {NSTEP} steps at '
        f'{NWORLD} worlds; ncon mean {res["ncon_mean"]:.2f}, solver_niter '
        f'mean {res["solver_niter_mean"]:.2f}, converged '
        f'{res["converged_worlds"]} of {NWORLD} ({card})')
  print(json.dumps({'step': dict(res, card=card)}))

  # ---- (e) kernel times, plain times and bounds ----
  sm_in = (d.qpos, d.qvel)
  sm_out = ks.smooth(m, *sm_in)
  c_in = (sm_out['qpos'], d.qvel, sm_out['geom_xpos'], sm_out['geom_xmat'],
          sm_out['subtree_com'], sm_out['cdof'])
  c_out = kc.contact(m, *c_in, NCONMAX)
  qfx = d.qfrc_applied + support.xfrc_accumulate(
      m, d.xfrc_applied, sm_out['xipos'], sm_out['subtree_com'],
      sm_out['cdof']) - sm_out['qfrc_bias']
  g_in = (sm_out['qM'], c_out['efc_J'], c_out['efc_D'], c_out['efc_aref'],
          c_out['efc_frictionloss'], sm_out['qpos'], d.qvel, d.ctrl, qfx,
          d.qacc_warmstart)
  g_out = kg.glue(m, *g_in)
  records = []
  nv = m.nv
  W = NWORLD
  record = lambda name, *args: _record(records, name, counts[name],
                                        errs[name], *args)
  flops_b1 = _flops_b1(m, W)
  flops_b2 = _flops_b2(m, W, c_out, NCONMAX)
  _, _, nl, stride, nj = mt.efc_layout(m, NCONMAX)
  nact = c_out['nefc'].double()
  it = g_out['solver_niter'].double()
  per_iter = (4 * nact * nv + 4 * nv * nv + 16 * 8 * nact + 12 * nact +
              nact * nv * (nv + 1) + nv ** 3 / 3 + 2 * nv * nv + 20 * nv)
  flops_b3 = float((nv ** 3 / 3 + 2 * nv * nv + 20 * m.nu + 10 * nv +
                    4 * nact * nv + it * per_iter).sum())
  tables = lambda key, make: _build.model_tables(m, key, make)
  record('smooth', 'mujoco_warp_tpu_torch/csrc/smooth.cu',
         'mujoco_warp_tpu/pallas/smooth_kernels.py:557',
         lambda: ks.smooth(m, *sm_in), lambda: smooth.smooth(m, *sm_in),
         _nbytes(sm_in, sm_out, tables('smooth', ks._tables)), flops_b1)
  record('contact', 'mujoco_warp_tpu_torch/csrc/contact.cu',
         'mujoco_warp_tpu/pallas/contact_kernels.py:1643',
         lambda: kc.contact(m, *c_in, NCONMAX),
         lambda: kc.plain(m, *c_in, NCONMAX),
         _nbytes(c_in, c_out, tables('contact', kc._tables)), flops_b2)
  # B3 needs efc_J and efc_aref only for the rows that can act (D != 0 or
  # frictionloss != 0); the kernel skips the rest
  acting = int(((g_in[2] != 0) | (g_in[4] != 0)).sum())
  bytes_b3_all = _nbytes(g_in, g_out, tables('glue', kg._tables))
  bytes_b3 = (bytes_b3_all - _nbytes(g_in[1:2], g_in[3:4]) +
              acting * (nv + 1) * g_in[1].element_size())
  print(f'  glue: {acting} acting rows of {W * nj} ({acting / W:.2f} per '
        f'world); every efc_J row would move {bytes_b3_all / 1e6:.1f} MB, '
        f'bound {bytes_b3_all / PEAK_BYTES * 1e3:.4f} ms')
  record('glue', 'mujoco_warp_tpu_torch/csrc/glue.cu',
         'mujoco_warp_tpu/pallas/solver_kernels.py:1207',
         lambda: kg.glue(m, *g_in), lambda: forward.glue(m, *g_in),
         bytes_b3, flops_b3)

  # where a step's device time goes, from the state the kernels were
  # timed at; the busy share divides by phase (d)'s host-clock step
  _print_profile('profile', lambda: bench.benchmark(m, d,
                                                    nstep=PROFILE_STEPS),
                 PROFILE_STEPS, res['step_time_us'] / 1e3, card)

  records += _three_humanoids(card)
  print(json.dumps({'kernels': records}))
  print(f'card: {card}')
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
