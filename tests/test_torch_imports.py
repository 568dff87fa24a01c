"""Import hygiene of the PyTorch port: its package and chip_smoke.py import
neither JAX nor the JAX package; `mujoco` appears only in the .npz
regeneration script and in testspeed's MJCF loader; and no `try` wraps a
kernel launch or a graph capture or replay (a CUDA tensor goes to its
kernel or raises, it never falls back)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'mujoco_warp_tpu_torch')
FILES = sorted(
    [os.path.join(dp, f) for dp, _, fs in os.walk(PKG) for f in fs
     if f.endswith('.py')] + [os.path.join(ROOT, 'chip_smoke.py')])
MUJOCO_OK = {os.path.join(PKG, 'models', 'regenerate.py'),
             os.path.join(PKG, 'testspeed.py')}
LAUNCHERS = {'launch', '_launch', 'smooth', 'contact', 'glue',
             'step_batched', 'glue_stages', 'benchmark', 'tree_ldl',
             'spd_solve', '_launch_tree_ldl', '_launch_spd_solve',
             'unfused_stages', 'batched_stages', 'solve', 'newton_solve',
             'cho_solve', 'tree_solve', '_launch_cho_solve',
             '_launch_tree_solve', 'm_solve_factor', 'm_cho_solve',
             'forward_stages', 'forward_batched', 'kinematics', 'com_pos',
             'crb', 'smooth_front', '_launch_kinematics', '_launch_com_pos',
             '_launch_crb', '_launch_smooth_front', '_launch_entry',
             'benchmark_replay', '_protocol', 'replayed', 'GraphStep',
             'replay', 'warm_step', 'one_step', 'rollout', 'implicit',
             'step1', 'step2'}


def _imports(tree):
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for a in node.names:
        yield a.name.split('.')[0], node
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module.split('.')[0], node


def _name(path):
  return os.path.relpath(path, ROOT)


@pytest.mark.parametrize('path', FILES, ids=_name)
def test_no_jax_and_no_jax_package(path):
  with open(path) as f:
    tree = ast.parse(f.read(), path)
  for mod, node in _imports(tree):
    assert mod not in ('jax', 'jaxlib', 'mujoco_warp_tpu'), (
        f'{_name(path)}:{node.lineno} imports {mod}')
    if mod == 'mujoco':
      assert path in MUJOCO_OK, f'{_name(path)}:{node.lineno} imports mujoco'


@pytest.mark.parametrize('path', FILES, ids=_name)
def test_no_try_around_a_kernel_launch(path):
  with open(path) as f:
    tree = ast.parse(f.read(), path)
  for node in ast.walk(tree):
    if not isinstance(node, ast.Try):
      continue
    for sub in ast.walk(ast.Module(body=node.body, type_ignores=[])):
      if isinstance(sub, ast.Call):
        fn = sub.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
            fn, 'id', '')
        assert name not in LAUNCHERS, (
            f'{_name(path)}:{node.lineno} wraps {name}() in try')


def test_the_scan_sees_the_package():
  names = {_name(p) for p in FILES}
  for must in ('chip_smoke.py', 'mujoco_warp_tpu_torch/io.py',
               'mujoco_warp_tpu_torch/kernels/glue.py',
               'mujoco_warp_tpu_torch/kernels/smooth.py',
               'mujoco_warp_tpu_torch/kernels/batch_linalg.py',
               'mujoco_warp_tpu_torch/kernels/newton.py',
               'mujoco_warp_tpu_torch/kernels/contact.py',
               'mujoco_warp_tpu_torch/utils/compare_trees.py',
               'mujoco_warp_tpu_torch/solver.py',
               'mujoco_warp_tpu_torch/testspeed.py',
               'mujoco_warp_tpu_torch/bench.py',
               'mujoco_warp_tpu_torch/utils/benchmark.py',
               'mujoco_warp_tpu_torch/forward.py',
               'mujoco_warp_tpu_torch/derivative.py',
               'mujoco_warp_tpu_torch/collision_sdf.py'):
    assert must in names
