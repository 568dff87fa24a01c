"""Where the time of kernels B7 (tree_ldl) and B8 (tree_solve) goes: each
built again with one phase left out, and timed on three_humanoids' qM at
8192 worlds.

    python3 mujoco_warp_tpu_torch/utils/tree_phases.py

Each variant is csrc/batch_linalg.cu with a statement disabled (`if
(false)` before it) or the dense LD's elements written as zeros, built by
nvcc into build/tree_phases/ and loaded in place of the library; its
outputs are wrong by design and not checked. VARIANTS names the
statements by their exact text, so it must be updated with any edit of
them in batch_linalg.cu; a statement not found exactly once stops the
script with an error before anything is built. A phase's time is the full
kernel's minus the variant's. Prints one line a variant: B7 with the
factor written, B7 without it (the Euler call, with the diagonal) and B8,
the card's busy time per launch (`compare_trees.device_ms`), twice. Needs
a card.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NWORLD = 8192
# variant -> (statement of csrc/batch_linalg.cu, replacement)
SKIP = 'if (false) '
VARIANTS = dict(
    full=[],
    no_pairs=[('    for (int q = p0 + lane; q - lane < p1; q += 32) {',
               '    ' + SKIP + 'for (int q = p0 + lane; q - lane < p1; '
               'q += 32) {')],
    no_factor=[('  tree_factor(t, P, lane);\n',
                '  ' + SKIP + 'tree_factor(t, P, lane);\n')],
    no_lt=[('  for (int st = 0; st < t.nstep; ++st) {\n'
            '    const int e1 = ',
            '  ' + SKIP + 'for (int st = 0; st < t.nstep; ++st) {\n'
            '    const int e1 = ')],
    no_lx=[('  for (int lv = 1; lv < t.nlevel; ++lv) {',
            '  ' + SKIP + 'for (int lv = 1; lv < t.nlevel; ++lv) {')],
    gather_only=[('  tree_factor(t, P, lane);\n  tree_sweeps(t, P, x, lane);',
                  '  ' + SKIP + 'tree_factor(t, P, lane);\n  ' + SKIP +
                  'tree_sweeps(t, P, x, lane);'),
                 ('  tree_gather(t, p.ld + w * nv * nv, p.b + w * nv, P, x, '
                  'lane);\n  tree_sweeps(t, P, x, lane);',
                  '  tree_gather(t, p.ld + w * nv * nv, p.b + w * nv, P, x, '
                  'lane);\n  ' + SKIP + 'tree_sweeps(t, P, x, lane);')],
    ld_zeros=[('  const int q = t.pos[e];\n  return q >= 0 ? P[q] : 0.0f;',
               '  return 0.0f;')])


def variant_source(source: str, edits) -> str:
  for old, new in edits:
    if source.count(old) != 1:
      raise RuntimeError(f'{old!r}: {source.count(old)} places in the source')
    source = source.replace(old, new)
  return source


def main() -> int:
  sys.path.insert(0, ROOT)
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import models, smooth
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
  from mujoco_warp_tpu_torch.bench import card as bench_card
  from mujoco_warp_tpu_torch.utils.compare_trees import device_ms
  if not torch.cuda.is_available():
    print('tree_phases needs a CUDA device', file=sys.stderr)
    return 1
  card = bench_card()
  out_dir = os.path.join(ROOT, 'build', 'tree_phases')
  os.makedirs(out_dir, exist_ok=True)
  with open(os.path.join(_build.CSRC, 'batch_linalg.cu')) as f:
    source = f.read()
  sources = {name: variant_source(source, edits)
             for name, edits in VARIANTS.items()}
  procs = {}
  for name, text in sources.items():
    src = os.path.join(out_dir, name + '.cu')
    with open(src, 'w') as f:
      f.write(text)
    procs[name] = subprocess.Popen(
        [_build._nvcc(), *_build.FLAGS, '-I', _build.CSRC, '-o',
         os.path.join(out_dir, name + '.so'), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
  for name, proc in procs.items():
    log = proc.communicate()[0].decode()
    if proc.returncode:
      print(log, file=sys.stderr)
      return 1
  m = mt.load_model(models.THREE_HUMANOIDS_NPZ, device='cuda')
  d = mt.make_batch(m, mt.make_data(m, nconmax=100), NWORLD,
                    qpos_noise=0.05,
                    generator=torch.Generator('cuda').manual_seed(0))
  qM = smooth.smooth(m, d.qpos, d.qvel)['qM']
  b = torch.randn(NWORLD, m.nv, device='cuda',
                  generator=torch.Generator('cuda').manual_seed(1))
  diag = m.opt.timestep * m.dof_damping
  parent = m.dof_parentid
  _, ld = kb.tree_ldl(qM, b, parent, return_factor=True)
  calls = dict(
      factor=lambda: kb.tree_ldl(qM, b, parent, return_factor=True),
      euler=lambda: kb.tree_ldl(qM, b, parent, diag=diag),
      tree_solve=lambda: kb.tree_solve(ld, b, parent))
  print(f'B7 and B8 with a phase left out, ms on the card a launch (twice), '
        f'{NWORLD} three_humanoids worlds, {card}')
  for name in VARIANTS:
    lib = ctypes.CDLL(os.path.join(out_dir, name + '.so'))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    _build._loaded['batch_linalg'] = lib
    times = {c: (device_ms(fn), device_ms(fn)) for c, fn in calls.items()}
    print(f'{name:12s} ' + '  '.join(f'{c} {t0:.4f} {t1:.4f}'
                                      for c, (t0, t1) in times.items()))
  return 0


if __name__ == '__main__':
  sys.exit(main())
