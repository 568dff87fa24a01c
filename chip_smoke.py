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
      device's busy share; print one JSON line of kernel records.

The last line is {"ok": true, "device": {...}}; any failure raises and
exits non-zero without it. Nothing here imports JAX or the JAX package.
"""

import collections
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
  from mujoco_warp_tpu_torch.types import ConstraintType
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
  discrete = ('ncon', 'ncollision', 'ne', 'nf', 'nl', 'nefc', 'dim', 'geom',
              'efc_address', 'efc_type', 'efc_id', 'efc_active')
  same = torch.ones(NWORLD, dtype=torch.bool, device='cuda')
  for k in discrete:
    eq = c_out[k] == c_ref[k]
    same &= eq.reshape(NWORLD, -1).all(1)
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
  print(f'  B2 worlds with a different contact/row set: {nbad} of {NWORLD}')
  if nbad > max(8, NWORLD // 1000) or bool((near[bad] >= 1e-4).any()):
    raise RuntimeError(f'B2: {nbad} worlds differ in their contact sets, '
                       f'not all at an activation threshold')
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
  print(f'  B2 efc_aref error scale {aref_scale:.1f} (damping b up to '
        f'{bmax:.1f} times |efc_vel|)')
  errs['contact'] = _compare('B2', c_out, c_ref, TOL_B2, floats,
                             worlds=same, scale={'efc_aref': aref_scale})

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
  nv, nb = m.nv, m.nbody
  W = NWORLD

  def record(name, source, replaces, run, plain, nbytes, flops):
    ms = _cuda_ms(run, 20)
    plain_ms = _cuda_ms(plain, 3)
    bound_b = nbytes / PEAK_BYTES * 1e3
    bound_f = flops / PEAK_F32 * 1e3
    records.append(dict(
        name=name, route='cuda', source=source, replaces=replaces,
        launches=counts[name], max_abs_err=errs[name], ms=ms,
        plain_ms=plain_ms, bound_ms=max(bound_b, bound_f),
        bound_by='bytes' if bound_b >= bound_f else 'operations',
        library_ms=None))
    print(f'  {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms), bound '
          f'{max(bound_b, bound_f):.4f} ms by '
          f'{records[-1]["bound_by"]} ({nbytes / 1e6:.1f} MB, '
          f'{flops / 1e9:.3f} GFLOP)')

  # operation counts per world, estimated from the model's sizes (B1, B2)
  # and from this run's contacts, active rows and iterations (B2, B3)
  chain = sum(len(r) for r in m.dof_ancestor_rows)
  flops_b1 = W * (430 * nb + 130 * m.njnt + 90 * m.ngeom + 140 * nv +
                  12 * chain)
  pair_flops = {(0, 2): 25, (0, 3): 50, (2, 2): 30, (2, 3): 55, (3, 3): 90}
  per_pair = sum(len(gl) * pair_flops[(t1, t2)]
                 for t1, t2, gl in m.collision_pairs)
  ncon = c_out['ncon'].double().sum().item()
  _, _, nl, stride, nj = mt.efc_layout(m, NCONMAX)
  flops_b2 = (W * (per_pair + 45 * nl) +
              ncon * (60 + nv * (45 + 4 * stride)))
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
  rows = _profile(lambda: bench.benchmark(m, d, nstep=PROFILE_STEPS),
                  PROFILE_STEPS)
  device_ms = sum(r[2] for r in rows)
  step_ms = res['step_time_us'] / 1e3
  for name, calls, ms in rows[:8]:
    print(f'  profile: {ms:9.4f} ms/step {calls:6.1f} launches/step  '
          f'{name[:80]}')
  print(json.dumps({'profile': dict(
      steps=PROFILE_STEPS, step_ms=step_ms,
      device_ms=device_ms if rows else 'not measured',
      busy_share=device_ms / step_ms if rows else 'not measured',
      launches_per_step=sum(r[1] for r in rows),
      top=[dict(name=n[:80], launches_per_step=c, ms_per_step=ms)
           for n, c, ms in rows[:8]], card=card)}))
  print(json.dumps({'kernels': records}))
  print(f'card: {card}')
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
