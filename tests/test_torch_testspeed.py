"""The port's entry points on the CPU: `mujoco_warp_tpu_torch.testspeed`
against the JAX package's CLI (`mujoco_warp_tpu/testspeed.py`), and
`mujoco_warp_tpu_torch.bench` against the keys of `bench.py`, at a few
worlds."""

import ast
import json
import os

import pytest

from mujoco_warp_tpu import testspeed as jspeed
from mujoco_warp_tpu_torch import bench, forward, models, testspeed
import mujoco_warp_tpu_torch as mt

from torch_parity import KEYED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ['--nworld', '8', '--nstep', '2', '--nconmax', '4', '--output',
         'json']


def _json(capsys) -> dict:
  lines = capsys.readouterr().out.strip().splitlines()
  return json.loads(lines[-1])


@pytest.fixture(scope='module')
def keyed_xml(tmp_path_factory):
  path = tmp_path_factory.mktemp('testspeed') / 'keyed.xml'
  path.write_text(KEYED)
  return str(path)


@pytest.mark.parametrize('extra', [['--keyframe', '1'],
                                   ['--replay', 'lift']])
def test_json_keys_are_the_jax_clis_and_dispatch(keyed_xml, capsys, extra):
  jspeed.main([keyed_xml] + SMALL + extra)
  ref = _json(capsys)
  testspeed.main([keyed_xml] + SMALL + extra + ['--device', 'cpu'])
  out = _json(capsys)
  assert set(out) == set(ref) | {'dispatch'}
  assert out['dispatch'] == 'eager'
  assert out['nworld'] == ref['nworld'] == 8
  assert out['nstep'] == ref['nstep']
  assert out['converged_worlds'] == 8


@pytest.mark.parametrize('options,integrator', [([], None),
                                                (['-o', 'opt.solver=cg'],
                                                 'euler')])
def test_event_trace_names_the_stages_of_the_list(capsys, options,
                                                  integrator):
  testspeed.main([models.HUMANOID_NPZ, '--nworld', '2', '--nstep', '1',
                  '--nconmax', '24', '--output', 'json', '--event_trace',
                  '--device', 'cpu'] + options)
  out = _json(capsys)
  m = mt.load_model(models.HUMANOID_NPZ, device='cpu')
  if options:
    m = mt.override_model(m, options[1])
  d = mt.make_data(m, nconmax=24, nworld=2)
  names = [n for n, _ in forward.batched_stages(m, d)]
  want = [f'step.forward.{n}' for n in names]
  if integrator:
    assert names[-1] == integrator
    want[-1] = f'step.{integrator}'
  assert list(out['event_trace_us']) == want
  assert all(v > 0 for v in out['event_trace_us'].values())


def test_function_times_one_stage(capsys):
  testspeed.main([models.HUMANOID_NPZ, '--nworld', '2', '--nstep', '10',
                  '--nconmax', '24', '--output', 'json', '--function',
                  'act_len_vel', '--device', 'cpu'])
  out = _json(capsys)
  assert set(out) == {'function', 'nworld', 'nrep', 'jit_time_s', 'time_us',
                      'per_world_ns'}
  assert out['function'] == 'act_len_vel' and out['nrep'] == 10


def test_unknown_function_exits_with_the_choices():
  with pytest.raises(SystemExit, match=r"unknown stage 'nope'; choices: "
                     r"\['smooth_mega\[cuda\]', 'contact_efc_mega\[cuda\]', "
                     r"'act_len_vel', 'solve_glue\[cuda\]'\]"):
    testspeed.main([models.HUMANOID_NPZ, '--nworld', '2', '--nconmax', '24',
                    '--function', 'nope', '--device', 'cpu'])


def test_replay_on_an_npz_raises():
  with pytest.raises(SystemExit, match='--replay needs an MJCF'):
    testspeed.main([models.THREE_HUMANOIDS_NPZ, '--nworld', '2',
                    '--replay', 'walk', '--device', 'cpu'])


def _bench_keys() -> list:
  """The keys of the JSON line of the JAX package's bench.py."""
  with open(os.path.join(ROOT, 'bench.py')) as f:
    tree = ast.parse(f.read())
  for node in ast.walk(tree):
    if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
        and getattr(node.targets[0], 'id', '') == 'result'):
      return [k.value for k in node.value.keys]
  raise AssertionError('no result dict in bench.py')


def test_bench_prints_bench_py_keys_and_dispatch(capsys, monkeypatch):
  monkeypatch.setenv('BENCH_NWORLD', '2')
  monkeypatch.setenv('BENCH_NSTEP', '2')
  result = bench.main(['--device', 'cpu'])
  assert _json(capsys) == result
  # bench.py's suite roll-up is not ported
  want = [k for k in _bench_keys() if not k.startswith('suite_')]
  assert list(result) == want + ['dispatch']
  assert result['metric'] == 'humanoid_steps_per_sec'
  assert result['nworld'] == 2 and result['nstep'] == 1
  assert result['device'] == 'cpu' and result['dispatch'] == 'eager'
  assert result['converged_worlds'] == 2
