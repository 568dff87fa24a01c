"""The port's kernel wrappers (B1 smooth, B2 contact, B3 glue, B4 newton,
B5 spd_solve, B6 cho_solve, B7 tree_ldl and B8 tree_solve; with the
elliptic cone, B2's elliptic rows, B3e and B4-elliptic; B1's entries B9
smooth_front, B10 kinematics, B11 com_pos and B12 crb).

On the CPU a wrapper runs its plain version and launches nothing. On the
card each kernel is held against its plain version (tests marked `cuda`,
skipped without a device). This file imports neither JAX nor `mujoco`, so
it also runs on a machine with the card and without them:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py
"""

import ctypes
import os
import shutil
import subprocess
import tempfile
import types

import pytest
import torch

import chip_smoke

import mujoco_warp_tpu_torch as mt
from mujoco_warp_tpu_torch import (batch_linalg, forward, models, smooth,
                                   solver, support)
from mujoco_warp_tpu_torch.kernels import _build
from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
from mujoco_warp_tpu_torch.kernels import contact as kc
from mujoco_warp_tpu_torch.kernels import glue as kg
from mujoco_warp_tpu_torch.kernels import newton as kn
from mujoco_warp_tpu_torch.kernels import smooth as ks
from mujoco_warp_tpu_torch.types import DisableBit, IntegratorType, SolverType
from mujoco_warp_tpu_torch.utils import benchmark

NCONMAX = 24


@pytest.fixture
def cuda():
  """The CUDA device, or skip: the kernels have no CPU mode."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (kernels have no CPU mode)')
  return torch.device('cuda')


ELLIPTIC = ['opt.cone=elliptic', 'opt.impratio=10']


def _state(device, nworld, nstep, npz=models.HUMANOID_NPZ,
           nconmax=NCONMAX, elliptic=False):
  """Worlds stepped into contact through the port itself (with the
  elliptic cone at impratio 10, given `elliptic`)."""
  m = mt.load_model(npz, device=device)
  if elliptic:
    m = mt.override_model(m, ELLIPTIC)
  gen = torch.Generator(device=device).manual_seed(0)
  d = mt.make_batch(m, mt.make_data(m, nconmax=nconmax), nworld,
                    qpos_noise=0.02, generator=gen)
  d = benchmark.rollout(m, d, nstep)
  return m, d


def _stages(m, d):
  """Inputs and outputs of the three kernels' stages for the state d."""
  sm = ks.smooth(m, d.qpos, d.qvel)
  c_in = (m, sm['qpos'], d.qvel, sm['geom_xpos'], sm['geom_xmat'],
          sm['subtree_com'], sm['cdof'], NCONMAX)
  con = kc.contact(*c_in)
  qfx = d.qfrc_applied + support.xfrc_accumulate(
      m, d.xfrc_applied, sm['xipos'], sm['subtree_com'],
      sm['cdof']) - sm['qfrc_bias']
  g_in = (m, sm['qM'], con['efc_J'], con['efc_D'], con['efc_aref'],
          con['efc_frictionloss'], sm['qpos'], d.qvel, d.ctrl, qfx,
          d.qacc_warmstart)
  return sm, c_in, con, g_in


def _close(a, b, name, tol):
  """|a - b| <= tol * max(1, max |b|), or exact for integers."""
  a, b = a.cpu(), b.cpu()
  if not b.dtype.is_floating_point:
    assert torch.equal(a, b), name
    return
  scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
  err = float((a - b).abs().max()) if b.numel() else 0.0
  assert err <= tol * scale, f'{name}: {err} > {tol} * {scale}'


def test_wrappers_run_plain_on_cpu():
  m, d = _state('cpu', 3, 10)
  for mod in (ks, kc, kg):
    mod.launches = 0
  sm, c_in, con, g_in = _stages(m, d)
  for name, ref in smooth.smooth(m, d.qpos, d.qvel).items():
    torch.testing.assert_close(sm[name], ref, rtol=0, atol=0)
  for name, ref in kc.plain(*c_in).items():
    torch.testing.assert_close(con[name], ref, rtol=0, atol=0)
  out = kg.glue(*g_in)
  for name, ref in forward.glue(*g_in).items():
    torch.testing.assert_close(out[name], ref, rtol=0, atol=0)
  assert (ks.launches, kc.launches, kg.launches) == (0, 0, 0)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_Z11glue_kernel6Params' for 'sm_90a'
ptxas info    : Function properties for _Z11glue_kernel6Params
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 120 registers, used 0 barriers, 528 bytes cmem[0]
ptxas info    : Compiling entry function '_Z15glue_ell_kernel9EllParams' for 'sm_90a'
ptxas info    : Function properties for _Z15glue_ell_kernel9EllParams
    16400 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 16400 bytes cumulative stack size, 64 bytes smem, 560 bytes cmem[0]
"""


def test_ptxas_report_is_read_per_kernel(monkeypatch):
  """The build log's ptxas lines, per kernel: chip_smoke and the card's
  tests hold B3 and B4 to no spill stores and a small stack by them."""
  monkeypatch.setattr(_build, 'build_log', lambda name: PTXAS_LOG)
  info = _build.ptxas_info('glue')
  assert info == {
      '_Z11glue_kernel6Params': dict(stack=0, spill_stores=0, spill_loads=0,
                                     registers=120, smem=0),
      '_Z15glue_ell_kernel9EllParams': dict(
          stack=16400, spill_stores=8, spill_loads=12, registers=64,
          smem=64)}


SMOOTH_PTXAS_LOG = """\
ptxas info    : Function properties for _Z13smooth_stagesILi63EEv6Params
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 100 registers, used 0 barriers, 672 bytes cmem[0]
ptxas info    : Function properties for _Z13smooth_stagesILi2EEv6Params
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers, 672 bytes cmem[0]
"""


@pytest.mark.parametrize('kernel, registers', [('smooth_stages<63>', 100),
                                               ('smooth_stages<2>', 56),
                                               ('smooth_stages<6>', None),
                                               ('glue_kernel', None)])
def test_kernel_report_names_template_instantiations(monkeypatch, kernel,
                                                     registers):
  """_build.kernel_report picks one kernel's ptxas report by its name and
  template argument (B1's entries share a name), and raises unless
  exactly one matches."""
  monkeypatch.setattr(_build, 'build_log', lambda name: SMOOTH_PTXAS_LOG)
  if registers is None:
    with pytest.raises(RuntimeError):
      _build.kernel_report('smooth', kernel)
  else:
    assert _build.kernel_report('smooth', kernel)['registers'] == registers


class _FakeLibrary:
  """A kernel library's C interface for the entry `prefix`, counting its
  calls."""

  def __init__(self, params_type, prefix):
    self.calls = dict(params_size=0, launch=0, launch_shape=0)
    self.error_string = lambda err: b'fake'

    def count(name, fn):
      def call(*args):
        self.calls[name] += 1
        return fn(*args)
      return call

    def shape(params, out):
      out[:] = [7, 128, 4, 3]
      return 0
    setattr(self, prefix + 'params_size',
            count('params_size', lambda: ctypes.sizeof(params_type)))
    setattr(self, prefix + 'launch', count('launch', lambda p, stream: 0))
    setattr(self, prefix + 'launch_shape', count('launch_shape', shape))


def test_launch_looks_up_entries_and_shapes_once(monkeypatch):
  """_build.launch checks a library's entry once and queries a warp
  kernel's launch shape (an occupancy query on the card) once per set of
  scalar parameters, then reuses it; every launch still launches."""
  params_type = _build.struct('FakeParams', ('x',), ('h',), ('nworld', 'n'))
  fake = _FakeLibrary(params_type, 'e_')
  monkeypatch.setattr(_build, 'library', lambda name: fake)
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda device=None: types.SimpleNamespace(cuda_stream=0))
  monkeypatch.setattr(_build, 'shapes', {})
  x = torch.zeros(3)
  for n in (5, 5, 5, 6, 5):
    _build.launch('fake', params_type, dict(x=x, h=0.5, nworld=8, n=n),
                  'cpu', entry='e_')
  assert fake.calls == dict(params_size=1, launch=5, launch_shape=2)
  assert _build.shapes == {('fake', 'e_'): (7, 128, 4, 3)}


def test_wrappers_refuse_models_past_their_caps():
  m, d = _state('cpu', 2, 0)
  sm = smooth.smooth(m, d.qpos, d.qvel)
  with pytest.raises(ValueError):
    kc._launch(m, sm['qpos'], d.qvel, sm['geom_xpos'], sm['geom_xmat'],
               sm['subtree_com'], sm['cdof'], kc.MAXCON + 1)


MODELS = dict(
    humanoid=models.HUMANOID_NPZ, three_humanoids=models.THREE_HUMANOIDS_NPZ,
    franka_emika_panda=models.FRANKA_NPZ,
    apptronik_apollo_flat=models.APOLLO_NPZ,
    apptronik_apollo_terrain=models.APOLLO_TERRAIN_NPZ,
    apptronik_apollo_hfield=models.APOLLO_HFIELD_NPZ,
    aloha_pot=models.ALOHA_POT_NPZ, aloha_sdf=models.ALOHA_SDF_NPZ,
    kitchen=models.KITCHEN_NPZ)


# a block's shared memory on the H100 (bytes)
BLOCK_BYTES = 232_448
_HOST = {}


def smooth_block_host() -> ctypes.CDLL:
  """csrc/smooth_layout.cuh built by the host's C++ compiler into a
  library, once a process: its `smooth_block` is the arithmetic that
  B1's launch and `kernels.smooth.block` use (a world's words, worlds a
  block)."""
  if 'lib' not in _HOST:
    cxx = shutil.which('g++') or shutil.which('c++')
    if cxx is None:
      pytest.skip('needs a host C++ compiler')
    out = os.path.join(tempfile.mkdtemp(), 'smooth_layout.so')
    subprocess.run([cxx, '-x', 'c++', '-shared', '-fPIC', '-O1', '-o', out,
                    os.path.join(_build.CSRC, 'smooth_layout.cuh')],
                   check=True, capture_output=True)
    _HOST['lib'] = ctypes.CDLL(out)
  return _HOST['lib']


@pytest.mark.parametrize('model', sorted(MODELS))
def test_smooth_block_holds_the_most_worlds_that_fit(model):
  """B1's worlds a block, by the kernel's own arithmetic
  (csrc/smooth_layout.cuh, built on the host) through
  `kernels.smooth._block`: the most, up to 4, whose layouts fit a
  block's BLOCK_BYTES: 4 on every committed model but kitchen (14,716
  words a world: 3)."""
  m = mt.load_model(MODELS[model], device='cpu')
  nnz = ks.tree_tables(m.body_parentid, m.dof_parentid)['nnz']
  nbytes, worlds = ks._block(smooth_block_host(), m, nnz)
  assert nbytes % 16 == 0
  assert worlds == (3 if model == 'kitchen' else 4)
  assert worlds * nbytes <= BLOCK_BYTES
  assert worlds == 4 or (worlds + 1) * nbytes > BLOCK_BYTES
  if model == 'kitchen':
    assert nbytes == 4 * 14716


def test_smooth_lanes_keep_whole_warps(monkeypatch):
  """`_choose_lanes` takes the fewest lanes that keep MIN_WARPS warps
  resident, of those that make a block of whole warps, by the worlds
  that the launch shape reports: at 3 worlds a block only 32 lanes (a
  block of 24 or 48 threads would split a warp); a world past a block
  is refused (`_block`, on the kernel's own arithmetic)."""
  asked, worlds = [], [3]

  def shape(name, params, values, entry):
    g = values['lanes']
    asked.append((worlds[0], g))
    return (1, worlds[0] * g, 0, 1 if worlds[0] == 3 else 8)
  monkeypatch.setattr(ks._build, 'launch_shape', shape)
  assert ks._choose_lanes({}, '') == 32
  assert asked == [(3, 8), (3, 16), (3, 32)]
  worlds[0] = 4
  assert ks._choose_lanes({}, '') == 16
  assert asked[3:] == [(4, 8), (4, 16)]
  worlds[0] = 2
  assert ks._choose_lanes({}, '') == 32
  assert asked[5:] == [(2, 8), (2, 16), (2, 32)]
  big = types.SimpleNamespace(nq=1, nv=1, nbody=2000, njnt=1)
  with pytest.raises(ValueError):
    ks._block(smooth_block_host(), big, 1)


def _smooth_entries(m, sm):
  """B9-B12 on B1's outputs sm: name -> (wrapper, launch path, count,
  plain version, output names, arguments)."""
  pos = (sm['xpos'], sm['xquat'], sm['xanchor'], sm['xaxis'])
  return dict(
      smooth_front=(ks.smooth_front, ks._launch_smooth_front,
                    'launches_front', ks.plain_smooth_front, ks.FRONT,
                    (m, sm['qpos'])),
      kinematics=(ks.kinematics, ks._launch_kinematics, 'launches_kin',
                  smooth.kinematics, ks.KINEMATICS, (m, sm['qpos'])),
      com_pos=(ks.com_pos, ks._launch_com_pos, 'launches_com',
               ks.plain_com_pos, ks.COM_POS, (m, *pos)),
      crb=(ks.crb, ks._launch_crb, 'launches_crb', smooth.crb, ks.CRB,
           (m, sm['cinert'], sm['cdof'])))


SMOOTH_ENTRIES = ('smooth_front', 'kinematics', 'com_pos', 'crb')


def _named(out, names):
  return out if isinstance(out, dict) else dict(zip(names, out))


def _walk(parent):
  """Each body's depth and children, by walking the tree down from body
  0 (breadth first)."""
  children = {b: [] for b in range(len(parent))}
  for b in range(1, len(parent)):
    children[parent[b]].append(b)
  depth, todo = {0: 0}, [0]
  while todo:
    b = todo.pop(0)
    for c in children[b]:
      depth[c] = depth[b] + 1
      todo.append(c)
  return depth, children


TREES = dict(
    humanoid=None, three_humanoids=None,
    # a star of 40 bodies (a level wider than a warp) and a chain below one
    star=((-1, *[0] * 40, 40, 41, 42), (-1, *range(43))))


@pytest.mark.parametrize('tree', sorted(TREES))
def test_smooth_tree_tables_match_a_tree_walk(tree):
  """B1's level, children and qM tables (kernels.smooth.tree_tables)
  against a walk down the body tree and up the dof chains."""
  if TREES[tree] is None:
    npz = (models.HUMANOID_NPZ if tree == 'humanoid'
           else models.THREE_HUMANOIDS_NPZ)
    m = mt.load_model(npz, device='cpu')
    body_parent, dof_parent = m.body_parentid, m.dof_parentid
  else:
    body_parent, dof_parent = TREES[tree]
  t = ks.tree_tables(body_parent, dof_parent)
  depth, children = _walk(body_parent)
  assert len(depth) == len(body_parent)
  assert t['nlevel'] == max(depth.values()) + 1
  for lv in range(t['nlevel']):
    level = t['level_body'][t['level_start'][lv]:t['level_start'][lv + 1]]
    assert level == sorted(b for b, d in depth.items() if d == lv), lv
  assert t['level_start'][-1] == len(body_parent)
  for b in range(len(body_parent)):
    got = t['child_body'][t['child_start'][b]:t['child_start'][b + 1]]
    assert got == sorted(children[b], reverse=True), b
  nv = len(dof_parent)
  slots, nnz = {}, 0
  for i in range(nv):
    assert t['qm_rowstart'][i] == nnz
    j = i
    while j >= 0:
      slots[(i, j)] = slots[(j, i)] = nnz
      nnz += 1
      j = dof_parent[j]
  assert t['nnz'] == nnz
  for i in range(nv):
    for j in range(nv):
      assert t['qm_slot'][i * nv + j] == slots.get((i, j), ks.QM_NONE)
  if TREES[tree] is None:
    assert nnz == sum(len(r) for r in m.dof_ancestor_rows)


@pytest.mark.parametrize('kernel', ['smooth', 'contact', 'glue',
                                    *SMOOTH_ENTRIES])
def test_launch_refuses_cpu_tensors(kernel):
  """The kernels have no CPU mode: their launch path raises on a CPU
  tensor and counts no launch."""
  m, d = _state('cpu', 2, 0)
  sm, c_in, _, g_in = _stages(m, d)
  table = {'smooth': (ks, 'launches', ks._launch, (m, d.qpos, d.qvel)),
           'contact': (kc, 'launches', kc._launch, c_in),
           'glue': (kg, 'launches', kg._launch, g_in)}
  table.update({k: (ks, count, launch, args) for k, (_, launch, count, _, _,
                                                     args)
                in _smooth_entries(m, sm).items()})
  mod, count, launch, args = table[kernel]
  setattr(mod, count, 0)
  with pytest.raises(ValueError, match='expected a tensor on'):
    launch(*args)
  assert getattr(mod, count) == 0


@pytest.mark.parametrize('entry', SMOOTH_ENTRIES)
def test_smooth_entries_run_plain_on_cpu(entry):
  """B9-B12 on CPU tensors: the plain version, bit for bit, and no
  launch counted."""
  m, d = _state('cpu', 3, 10)
  sm = smooth.smooth(m, d.qpos, d.qvel)
  fn, _, count, plain, names, args = _smooth_entries(m, sm)[entry]
  setattr(ks, count, 0)
  out, ref = _named(fn(*args), names), _named(plain(*args), names)
  assert set(out) == set(names)
  for name in names:
    torch.testing.assert_close(out[name], ref[name], rtol=0, atol=0)
  assert getattr(ks, count) == 0


@pytest.mark.cuda
def test_smooth_kernel_matches_plain(cuda):
  m, d = _state(cuda, 256, 60)
  ks.launches = 0
  out = ks.smooth(m, d.qpos, d.qvel)
  torch.cuda.synchronize()
  assert ks.launches == 1
  for name, ref in smooth.smooth(m, d.qpos, d.qvel).items():
    _close(out[name], ref, name, 2e-5)


@pytest.mark.cuda
def test_smooth_kernel_matches_plain_on_kitchen(cuda):
  """B1 on kitchen's 328 bodies, 3 worlds a block at 32 lanes, at 256
  worlds (85 whole blocks and one of 1 world), the joints drawn across
  their ranges, against its plain version at 2e-5 of scale."""
  m = mt.load_model(models.KITCHEN_NPZ, device=cuda)
  gen = torch.Generator(device=cuda).manual_seed(0)
  W = 256
  d = mt.make_batch(m, mt.make_data(m, nconmax=64), W)
  lo, hi = m.jnt_range[:, 0], m.jnt_range[:, 1]
  qpos = d.qpos.clone()
  qpos[:, torch.tensor(m.jnt_qposadr, device=cuda)] = lo + (hi - lo) * (
      torch.rand((W, m.njnt), generator=gen, device=cuda))
  qvel = 0.1 * torch.randn((W, m.nv), generator=gen, device=cuda)
  ks.launches = 0
  out = ks.smooth(m, qpos, qvel)
  torch.cuda.synchronize()
  assert ks.launches == 1 and ks.lanes(m) == 32
  assert _build.shapes[('smooth', '')][:3] == (86, 96, 3 * 4 * 14716)
  for name, ref in smooth.smooth(m, qpos, qvel).items():
    _close(out[name], ref, name, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('model', ['humanoid', 'three_humanoids'])
def test_smooth_entries_match_plain_and_b1(cuda, model):
  """B9-B12 against their plain versions at 2e-5 of scale, and against
  B1's outputs of the same names bit for bit: they run B1's device code
  on B1's normalized qpos (B11 on B10's outputs, B12 on B11's). B12 also
  on inputs no B11 made."""
  npz, nconmax = ((models.HUMANOID_NPZ, NCONMAX) if model == 'humanoid'
                  else (models.THREE_HUMANOIDS_NPZ, 100))
  m, d = _state(cuda, 256, 20, npz, nconmax)
  sm = ks.smooth(m, d.qpos, d.qvel)
  for entry, (fn, _, count, plain, names, args) in _smooth_entries(
      m, sm).items():
    setattr(ks, count, 0)
    out = _named(fn(*args), names)
    torch.cuda.synchronize()
    assert getattr(ks, count) == 1, entry
    ref = _named(plain(*args), names)
    for name in names:
      _close(out[name], ref[name], f'{entry} {name}', 2e-5)
      assert torch.equal(out[name], sm[name]), f'{entry} {name}'
  gen = torch.Generator(device=cuda).manual_seed(1)
  noisy = [x + 0.05 * torch.randn(x.shape, generator=gen, device=cuda)
           for x in (sm['cinert'], sm['cdof'])]
  for a, b, name in zip(ks.crb(m, *noisy), smooth.crb(m, *noisy), ks.CRB):
    _close(a, b, f'crb {name} (perturbed)', 2e-5)


@pytest.mark.cuda
def test_contact_kernel_matches_plain(cuda):
  m, d = _state(cuda, 256, 60)
  _, c_in, _, _ = _stages(m, d)
  kc.launches = 0
  out = kc.contact(*c_in)
  torch.cuda.synchronize()
  assert kc.launches == 1
  ref = kc.plain(*c_in)
  assert int(ref['ncon'].sum()) > 0
  for name in ref:
    # aref = -b vel - k imp pos carries vel's rounding times b (~135)
    _close(out[name], ref[name], name, 2e-3 if name == 'efc_aref' else 2e-5)


CONES = ('pyramidal', 'elliptic')
CONTACT_MODELS = {'humanoid': (models.HUMANOID_NPZ, NCONMAX, 60),
                  'three_humanoids': (models.THREE_HUMANOIDS_NPZ, 100, 20)}


def _contact_inputs(device, model, cone, nworld=256):
  """(Model, B2's inputs, nconmax) at a state in contact: the humanoid
  after 60 steps, three_humanoids (nv 81) after 20, with either cone."""
  npz, nconmax, nstep = CONTACT_MODELS[model]
  m, d = _state(device, nworld, nstep, npz, nconmax,
                elliptic=cone == 'elliptic')
  sm = ks.smooth(m, d.qpos, d.qvel)
  return m, (sm['qpos'], d.qvel, sm['geom_xpos'], sm['geom_xmat'],
             sm['subtree_com'], sm['cdof']), nconmax


def _contact_matches_plain(m, c_in, nconmax, eq_active=None):
  """Kernel B2 against its plain version at this nconmax; both outputs."""
  out = kc.contact(m, *c_in, nconmax, eq_active)
  torch.cuda.synchronize()
  ref = kc.plain(m, *c_in, nconmax, eq_active)
  for name in ref:
    # aref = -b vel - k imp pos carries vel's rounding times b (~135)
    _close(out[name], ref[name], name, 2e-3 if name == 'efc_aref' else 2e-5)
  return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize('cone', CONES)
@pytest.mark.parametrize('cut', ['1', '2', '7', 'end_caps'])
def test_contact_kernel_pool_cuts_match_plain(cuda, cone, cut):
  """Both entries of B2 where nconmax cuts the pool: 1, 2, an odd 7, and
  between the two end caps of one plane-capsule pair (the slot after the
  cut would hold the pair's second cap)."""
  m, c_in, nconmax = _contact_inputs(cuda, 'humanoid', cone)
  full, _ = _contact_matches_plain(m, c_in, nconmax)
  if cut == 'end_caps':
    geom, ncon = full['geom'], full['ncon']
    same = (geom[:, 1:] == geom[:, :-1]).all(2) & (
        torch.arange(1, nconmax, device=cuda) < ncon[:, None])
    assert bool(same.any()), 'no pair with both caps in contact'
    k = int(same.nonzero()[:, 1].max()) + 1
  else:
    k = int(cut)
  out, ref = _contact_matches_plain(m, c_in, k)
  assert torch.equal(out['ncollision'], full['ncollision'])
  assert torch.equal(out['ncon'], torch.clamp(full['ncon'], max=k))
  assert torch.equal(out['geom'], full['geom'][:, :k])
  assert int((full['ncon'] > k).sum()) > 0, 'the cut drops no contact'


@pytest.mark.cuda
@pytest.mark.parametrize('cone', CONES)
def test_contact_kernel_at_nconmax_0_matches_plain(cuda, cone):
  """Both entries of B2 at nconmax 0 on the humanoid (177 candidate
  pairs, some within the margin): no pool and no collision, ncollision 0
  as the plain version and the JAX package's `collision` give it."""
  m, c_in, nconmax = _contact_inputs(cuda, 'humanoid', cone)
  full, _ = _contact_matches_plain(m, c_in, nconmax)
  assert int(full['ncollision'].sum()) > 0, 'no candidate within the margin'
  out, ref = _contact_matches_plain(m, c_in, 0)
  assert int(ref['ncollision'].abs().sum()) == 0
  assert torch.equal(out['ncollision'], ref['ncollision'])


@pytest.mark.cuda
@pytest.mark.parametrize('cone', CONES)
def test_contact_kernel_three_humanoids_matches_plain(cuda, cone):
  """Both entries of B2 at nv 81 (lanes over dofs in three rounds) and
  1614 candidates (51 rounds of the narrowphase), nconmax 100."""
  m, c_in, nconmax = _contact_inputs(cuda, 'three_humanoids', cone)
  _, ref = _contact_matches_plain(m, c_in, nconmax)
  assert int(ref['ncon'].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('cone', CONES)
@pytest.mark.parametrize('nconmax', [1, 12])
def test_contact_kernel_franka_matches_plain(cuda, cone, nconmax):
  """Both entries of B2 on franka's reach state (chip_smoke phase r):
  plane-box contacts (a box pair's four candidate rows, the corners'
  depth ranks), the joint-equality row, off in a tenth of the worlds; at
  the suite's nconmax 1 and at 12."""
  m = mt.load_model(models.FRANKA_NPZ, device=cuda)
  if cone == 'elliptic':
    m = mt.override_model(m, ELLIPTIC)
  d = chip_smoke._reach_state(m, 256, nconmax, torch.Generator(
      device=cuda).manual_seed(0))
  sm = ks.smooth(m, d.qpos, d.qvel)
  c_in = (sm['qpos'], d.qvel, sm['geom_xpos'], sm['geom_xmat'],
          sm['subtree_com'], sm['cdof'])
  out, ref = _contact_matches_plain(m, c_in, nconmax, d.eq_active)
  assert kc.entry(m) == ('eqbox_ell_' if cone == 'elliptic' else 'eqbox_')
  assert int((ref['ncollision'] >= 8).sum()) > 0
  assert torch.equal(ref['ne'], d.eq_active[:, 0].int())
  assert not bool(d.eq_active.all())


@pytest.mark.cuda
@pytest.mark.parametrize('cone', CONES)
@pytest.mark.parametrize('nconmax', [16, 48])
def test_contact_kernel_apollo_matches_plain(cuda, cone, nconmax):
  """Both `box_` entries of B2 on apollo's contact-rich state (chip_smoke
  phase s): capsule-box contacts (two a pair), box-box contacts (a pair's
  eight candidate rows, the contacts' depth ranks) and the 19 dof
  friction rows; at the suite's nconmax 16 and at 48."""
  m = mt.load_model(models.APOLLO_NPZ, device=cuda)
  if cone == 'elliptic':
    m = mt.override_model(m, ELLIPTIC)
  d = chip_smoke._apollo_rich(m, 512, torch.Generator(
      device=cuda).manual_seed(0))
  sm = ks.smooth(m, d.qpos, d.qvel)
  c_in = (sm['qpos'], d.qvel, sm['geom_xpos'], sm['geom_xmat'],
          sm['subtree_com'], sm['cdof'])
  out, ref = _contact_matches_plain(m, c_in, nconmax)
  assert kc.entry(m) == ('box_ell_' if cone == 'elliptic' else 'box_')
  counts = chip_smoke._pair_counts(m, ref)
  assert counts['capsule-box'] > 0 and counts['box-box'] > 0, counts
  assert bool((ref['nf'] == 19).all())


@pytest.mark.cuda
@pytest.mark.parametrize('model', sorted(CONTACT_MODELS))
def test_contact_kernel_is_deterministic_and_fits_its_design(cuda, model):
  """Both entries of B2 give the same bits in two launches; they launch 4
  worlds (warps) a block with 17 nconmax + 33 stride words of shared
  memory a world (the launch shape recorded in _build.shapes), and ptxas
  gives them no spill stores and at most 1 KB of stack."""
  for cone, entry in zip(CONES, ('', 'ell_')):
    m, c_in, nconmax = _contact_inputs(cuda, model, cone)
    a, b = kc.contact(m, *c_in, nconmax), kc.contact(m, *c_in, nconmax)
    for name in a:
      assert torch.equal(a[name], b[name]), (cone, name)
    stride = mt.efc_layout(m, nconmax)[3]
    grid, block, smem, per_sm = _build.shapes[('contact', entry)]
    assert (grid, block) == (256 // 4, 128), (grid, block)
    assert smem == 4 * 4 * (17 * nconmax + 33 * stride) and per_sm >= 1
  for kernel in ('contact_kernel', 'contact_ell_kernel',
                 'contact_eqbox_kernel', 'contact_eqbox_ell_kernel',
                 'contact_box_kernel', 'contact_box_ell_kernel'):
    info, = [v for k, v in _build.ptxas_info('contact').items()
             if k.startswith(f'_Z{len(kernel)}{kernel}')]
    assert info['spill_stores'] == 0 and info['stack'] <= 1024, info


@pytest.mark.cuda
def test_glue_kernel_matches_plain(cuda):
  # The solve fixes qacc only as far as its stopping rule (the objective
  # within tolerance * meaninertia * nv): with the same niter, one world's
  # qacc may still differ by ~5e-5 of this batch's scale, as it does 100
  # steps in. So the elementwise bounds hold at this state, and the
  # objective below is what decides in general.
  m, d = _state(cuda, 256, 60)
  _, _, _, g_in = _stages(m, d)
  kg.launches = 0
  out = kg.glue(*g_in)
  torch.cuda.synchronize()
  assert kg.launches == 1
  ref = forward.glue(*g_in)
  # the step tolerances of tests/test_glue_kernel.py:52-66
  for name in ('qacc', 'qacc_euler', 'qacc_smooth', 'qLD', 'actuator_force',
               'qfrc_actuator', 'qfrc_spring', 'qfrc_damper',
               'qfrc_passive', 'qfrc_smooth', 'qvel'):
    _close(out[name], ref[name], name, 5e-5)
  for name in ('qfrc_constraint', 'efc_force'):
    _close(out[name], ref[name], name, 5e-4)
  _close(out['qpos'], ref['qpos'], 'qpos', 5e-6)
  dn = (out['solver_niter'] - ref['solver_niter']).abs()
  assert int(dn.max()) <= 4, dn.bincount().tolist()
  # the solve is held to its objective: within one unit of the stopping
  # rule's tolerance * meaninertia * nv (see chip_smoke.py)
  f64 = [x.double() for x in g_in[1:6]]
  qfs = ref['qfrc_smooth'].double()
  qsm = solver.cho_solve(solver.cholesky(f64[0]), qfs)
  obj = lambda qa: solver.objective(*f64, qfs, qsm, qa.double(), 0, 0)
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * m.nv
  assert float((obj(out['qacc']) - obj(ref['qacc'])).abs().max()) <= unit


@pytest.mark.cuda
def test_step_batched_launches_each_kernel_once(cuda):
  m, d = _state(cuda, 256, 20)
  for mod in (ks, kc, kg):
    mod.launches = 0
  d = mt.step_batched(m, d)
  torch.cuda.synchronize()
  assert (ks.launches, kc.launches, kg.launches) == (1, 1, 1)
  assert bool(torch.isfinite(d.qpos).all())


def _residual(a, x, b):
  """Per-world |a x - b|inf / (|a|inf |x|inf + |b|inf), in float64."""
  a, x, b = a.double(), x.double(), b.double()
  r = (torch.einsum('wij,wj->wi', a, x) - b).abs().amax(1)
  return r / (a.abs().sum(2).amax(1) * x.abs().amax(1) + b.abs().amax(1))


@pytest.mark.cuda
def test_three_humanoids_kernels_match_plain(cuda):
  """B1, B2, B7 and B5 at three_humanoids shapes (nv 81, nconmax 100)."""
  m, d = _state(cuda, 256, 20, models.THREE_HUMANOIDS_NPZ, 100)
  sm = ks.smooth(m, d.qpos, d.qvel)
  for name, ref in smooth.smooth(m, d.qpos, d.qvel).items():
    _close(sm[name], ref, name, 2e-5)
  c_in = (m, sm['qpos'], d.qvel, sm['geom_xpos'], sm['geom_xmat'],
          sm['subtree_com'], sm['cdof'], 100)
  con, ref = kc.contact(*c_in), kc.plain(*c_in)
  assert int(ref['ncon'].sum()) > 0
  for name in ref:
    _close(con[name], ref[name], name, 2e-3 if name == 'efc_aref' else 2e-5)
  qM, b = sm['qM'], d.qfrc_applied - sm['qfrc_bias']
  diag = m.opt.timestep * m.dof_damping
  kb.launches.update(dict.fromkeys(kb.launches, 0))
  for dg in (None, diag):
    x, ld = kb.tree_ldl(qM, b, m.dof_parentid, diag=dg, return_factor=True)
    xr, ldr = batch_linalg.tree_ldl_solve_batched(
        qM, b, m.dof_parentid, diag=dg, return_factor=True)
    _close(x, xr, 'tree_ldl x', 2e-5)
    _close(ld, ldr, 'tree_ldl LD', 2e-5)
    a = qM + (torch.diag(dg) if dg is not None else 0)
    assert float(_residual(a, x, b).max()) <= 1e-5
  # a Newton Hessian: qM + Jᵀ D J over the rows that act
  J, D = con['efc_J'], con['efc_D']
  H = qM + torch.bmm((J * D[..., None]).transpose(1, 2), J)
  x = kb.spd_solve(H, b)
  xr = batch_linalg.spd_solve_batched(H, b)
  torch.cuda.synchronize()
  assert kb.launches == {'tree_ldl': 2, 'spd_solve': 1, 'cho_solve': 0,
                         'tree_solve': 0}
  assert float(_residual(H, x, b).max()) <= 1e-5
  x64 = batch_linalg.spd_solve_batched(H.double(), b.double())
  scale = float(x64.abs().max())
  err = float((x.double() - x64).abs().max()) / scale
  err_plain = float((xr.double() - x64).abs().max()) / scale
  assert err <= 4 * err_plain + 1e-6, (err, err_plain)


@pytest.mark.cuda
def test_three_humanoids_step_launches(cuda):
  m, d = _state(cuda, 256, 5, models.THREE_HUMANOIDS_NPZ, 100)
  for mod in (ks, kc, kg):
    mod.launches = 0
  kb.launches.update(dict.fromkeys(kb.launches, 0))
  solver.counts.update(dict.fromkeys(solver.counts, 0))
  d = mt.step_batched(m, d)
  torch.cuda.synchronize()
  assert (ks.launches, kc.launches, kg.launches) == (1, 1, 0)
  assert kb.launches == {'tree_ldl': 2,
                         'spd_solve': 1 + solver.counts['passes'],
                         'cho_solve': 0, 'tree_solve': 0}
  assert solver.counts['passes'] == int(d.solver_niter.max())
  assert bool(torch.isfinite(d.qpos).all())


# ---- B4 newton, B6 cho_solve, B8 tree_solve and the paths they serve ----


def _reset():
  for mod in (ks, kc, kg, kn):
    mod.launches = 0
  kg.launches_ell = kn.launches_ell = 0
  kb.launches.update(dict.fromkeys(kb.launches, 0))
  solver.counts.update(dict.fromkeys(solver.counts, 0))


def _with(m, **opt):
  return m.replace(opt=m.opt.replace(**opt))


def _newton_inputs(m, d):
  """B4's inputs at the state d: the stages of forward_batched before the
  solve."""
  stages = forward.forward_stages(m, d)
  assert stages[-1][0] == 'solve[cuda]'
  for _, fn in stages[:-1]:
    d = fn(d)
  return (m, d.qM, d.efc_J, d.efc_D, d.efc_aref, d.efc_frictionloss,
          d.qfrc_smooth, d.qacc_warmstart)


def _factor_inputs(kernel, device):
  """(launch path, wrapper, plain version, arguments) of B6 or B8 on a
  factor its producer's plain version wrote."""
  m, d = _state(device, 3, 5)
  sm = smooth.smooth(m, d.qpos, d.qvel)
  b = d.qfrc_applied - sm['qfrc_bias']
  if kernel == 'cho_solve':
    _, fac = batch_linalg.spd_solve_batched(sm['qM'], b, return_factor=True)
    return (kb._launch_cho_solve, kb.cho_solve,
            batch_linalg.cho_solve_batched, (fac, b))
  _, fac = batch_linalg.tree_ldl_solve_batched(sm['qM'], b, m.dof_parentid,
                                               return_factor=True)
  return (kb._launch_tree_solve, kb.tree_solve,
          batch_linalg.tree_solve_from_factor_batched,
          (fac, b, tuple(m.dof_parentid)))


@pytest.mark.parametrize('kernel', ['newton', 'cho_solve', 'tree_solve'])
def test_new_wrappers_run_plain_on_cpu_and_refuse_to_launch(kernel):
  """A CPU tensor runs the plain version and counts no launch; the launch
  path itself raises on it."""
  _reset()
  if kernel == 'newton':
    m, d = _state('cpu', 3, 10)
    args = _newton_inputs(m, d)
    launch, wrapper, plain = kn._launch, kn.newton_solve, solver.newton_solve
  else:
    launch, wrapper, plain, args = _factor_inputs(kernel, 'cpu')
  out, ref = wrapper(*args), plain(*args)
  if kernel == 'newton':
    for name in kn.OUTPUTS:
      torch.testing.assert_close(out[name], ref[name], rtol=0, atol=0)
  else:
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
  with pytest.raises(ValueError, match='expected a tensor on'):
    launch(*args)
  assert kn.launches == 0 and kb.launches == dict.fromkeys(kb.launches, 0)


def test_cpu_paths_dispatch_and_count_nothing():
  """forward_batched, an RK4 step and CG steps on the CPU: the stage lists
  of the card, every wrapper on its plain version."""
  m, d = _state('cpu', 2, 5)
  _reset()
  out = mt.forward_batched(m, d)
  rk4 = mt.step_batched(_with(m, integrator=int(IntegratorType.RK4)), d)
  assert solver.counts == {'solve': 0, 'passes': 0, 'linesearch': 0}
  cg = mt.step_batched(_with(m, solver=int(SolverType.CG)), d)
  assert solver.counts['solve'] == 1
  assert solver.counts['passes'] == int(cg.solver_niter.max()) > 0
  for dd in (out, rk4, cg):
    assert bool(torch.isfinite(dd.qacc).all())
  # no integration; B1 only normalizes qpos's quaternions again
  torch.testing.assert_close(out.qpos, d.qpos, rtol=0, atol=1e-6)
  torch.testing.assert_close(out.qvel, d.qvel, rtol=0, atol=0)
  assert (ks.launches, kc.launches, kg.launches, kn.launches) == (0,) * 4
  assert kb.launches == dict.fromkeys(kb.launches, 0)


@pytest.mark.cuda
@pytest.mark.parametrize('euler_damp', [False, True])
def test_newton_kernel_matches_plain(cuda, euler_damp):
  m, d = _state(cuda, 256, 60)
  args = _newton_inputs(m, d)
  # the diagonal eulerdamp would add, had the humanoid not disabled it
  hb = m.opt.timestep * m.dof_damping if euler_damp else None
  _reset()
  out = kn.newton_solve(*args, hb=hb)
  torch.cuda.synchronize()
  assert kn.launches == 1 and kg.launches == 0
  ref = solver.newton_solve(*args, hb=hb)
  for name in ('qacc', 'qacc_smooth', 'qLD'):
    _close(out[name], ref[name], name, 5e-5)
  for name in ('qfrc_constraint', 'efc_force'):
    _close(out[name], ref[name], name, 5e-4)
  # with hb, qacc_euler is a linear image of qfrc_constraint through the
  # ill-conditioned (qM + diag(hb))^-1: held at its tolerance, and by the
  # residual of that system with the kernel's own qfrc_constraint
  _close(out['qacc_euler'], ref['qacc_euler'], 'qacc_euler',
         5e-4 if euler_damp else 5e-5)
  if euler_damp:
    a = args[1] + torch.diag(hb)
    rhs = args[6] + out['qfrc_constraint']
    assert float(_residual(a, out['qacc_euler'], rhs).max()) <= 1e-5
  dn = (out['solver_niter'] - ref['solver_niter']).abs()
  assert int(dn.max()) <= 4, dn.bincount().tolist()
  if euler_damp:
    assert float((out['qacc_euler'] - out['qacc']).abs().max()) > 0
  else:
    assert torch.equal(out['qacc_euler'], out['qacc'])
  f64 = [x.double() for x in args[1:6]]
  qfs = args[6].double()
  qsm = solver.cho_solve(solver.cholesky(f64[0]), qfs)
  obj = lambda qa: solver.objective(*f64, qfs, qsm, qa.double(), 0, 0)
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * m.nv
  assert float((obj(out['qacc']) - obj(ref['qacc'])).abs().max()) <= unit


@pytest.mark.cuda
def test_newton_kernel_equals_the_glue_kernels_solve(cuda):
  """B3 and B4 run the same device code on the same qfrc_smooth."""
  m, d = _state(cuda, 256, 60)
  _, _, _, g_in = _stages(m, d)
  glue = kg.glue(*g_in)
  out = kn.newton_solve(m, *g_in[1:6], glue['qfrc_smooth'], g_in[10])
  for name in kn.OUTPUTS:
    assert torch.equal(out[name], glue[name]), name


def _eulerdamp_on(m):
  """The model with eulerdamp on: glue mode 1, the re-solve with
  h * dof_damping."""
  return _with(m, disableflags=int(m.opt.disableflags) &
               ~int(DisableBit.EULERDAMP))


@pytest.mark.cuda
def test_glue_kernel_mode_1_matches_plain(cuda):
  """B3 in mode 1, held as B4's hb case: qacc_euler, a linear image of
  qfrc_constraint through the ill-conditioned (qM + diag)^-1, at its
  tolerance and by the residual of that system; the advance from the
  kernel's own qacc_euler."""
  m, d = _state(cuda, 256, 60)
  _, _, _, g_in = _stages(m, d)
  m1 = _eulerdamp_on(m)
  assert forward.glue_mode(m1) == 1
  out, ref = kg.glue(m1, *g_in[1:]), forward.glue(m1, *g_in[1:])
  for name in ('qacc', 'qacc_smooth', 'qLD', 'qfrc_smooth'):
    _close(out[name], ref[name], name, 5e-5)
  for name in ('qfrc_constraint', 'efc_force', 'qacc_euler'):
    _close(out[name], ref[name], name, 5e-4)
  hb = m.opt.timestep * m.dof_damping
  rhs = out['qfrc_smooth'] + out['qfrc_constraint']
  assert float(_residual(g_in[1] + torch.diag(hb), out['qacc_euler'],
                         rhs).max()) <= 1e-5
  h = float(m.opt.timestep)
  qvel = g_in[7] + h * out['qacc_euler']
  _close(out['qvel'], qvel, 'qvel', 5e-5)
  _close(out['qpos'], forward.integrate_pos(m1, g_in[6], qvel, h), 'qpos',
         5e-6)
  dn = (out['solver_niter'] - ref['solver_niter']).abs()
  assert int(dn.max()) <= 4, dn.bincount().tolist()


@pytest.mark.cuda
@pytest.mark.parametrize('servo', [False, True], ids=['humanoid', 'servo'])
def test_glue_kernel_mode_2_matches_plain(cuda, servo):
  """B3 in mode 2 (implicitfast), each world's diagonal built in the
  kernel from its raw ctrl (on the servo variant, chip_smoke's `_servo`,
  ctrl uniform in [-1.5, 1.5], some outside its range): held as mode 1,
  qacc_euler at 5e-4 and by the residual of (qM + diag) qacc_euler =
  qfrc_smooth + qfrc_constraint with the plain version's per-world
  diagonal; the solve bit-equal to mode 0's on the same inputs."""
  m, d = _state(cuda, 256, 60)
  _, _, _, g_in = _stages(m, d)
  m2 = _with(m, integrator=int(IntegratorType.IMPLICITFAST))
  if servo:
    m2 = chip_smoke._servo(m2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    ctrl = 1.5 * (2 * torch.rand(d.ctrl.shape, generator=gen,
                                 device=cuda) - 1)
    g_in = g_in[:8] + (ctrl,) + g_in[9:]
  assert forward.glue_mode(m2) == 2
  kg.launches = 0
  out, ref = kg.glue(m2, *g_in[1:]), forward.glue(m2, *g_in[1:])
  assert kg.launches == 1
  for name in ('qacc', 'qacc_smooth', 'qLD', 'qfrc_smooth',
               'actuator_force', 'qfrc_actuator'):
    _close(out[name], ref[name], name, 5e-5)
  for name in ('qfrc_constraint', 'efc_force', 'qacc_euler'):
    _close(out[name], ref[name], name, 5e-4)
  hd = forward.integration_diag(m2, g_in[8])
  rhs = out['qfrc_smooth'] + out['qfrc_constraint']
  assert float(_residual(g_in[1] + torch.diag_embed(hd), out['qacc_euler'],
                         rhs).max()) <= 1e-5
  h = float(m.opt.timestep)
  qvel = g_in[7] + h * out['qacc_euler']
  _close(out['qvel'], qvel, 'qvel', 5e-5)
  _close(out['qpos'], forward.integrate_pos(m2, g_in[6], qvel, h), 'qpos',
         5e-6)
  dn = (out['solver_niter'] - ref['solver_niter']).abs()
  assert int(dn.max()) <= 4, dn.bincount().tolist()
  m0 = _with(m2, integrator=int(IntegratorType.EULER))
  base = kg.glue(m0, *g_in[1:])
  assert forward.glue_mode(m0) == 0
  for name in kn.OUTPUTS:
    if name != 'qacc_euler':
      assert torch.equal(out[name], base[name]), name


@pytest.mark.cuda
def test_warp_kernels_are_deterministic_and_fit_their_design(cuda):
  """B3 (modes 0 and 1), B4 (with hb), B3e and B4-elliptic give the same
  bits in two launches; they launch 4 worlds (warps) a block, and ptxas
  gives them no spill stores and at most 1 KB of stack."""
  m, d = _state(cuda, 256, 60)
  _, _, _, g_in = _stages(m, d)
  hb = m.opt.timestep * m.dof_damping
  n_in = _newton_inputs(m, d)
  me, de = _state(cuda, 256, 60, elliptic=True)
  _, _, con, ge_in = _stages(me, de)
  cone = _cone(me, con)
  ne_in = ge_in[:6] + (kg.glue(*ge_in, cone=cone)['qfrc_smooth'], ge_in[10])
  for fn in (lambda: kg.glue(*g_in), lambda: kg.glue(_eulerdamp_on(m),
                                                      *g_in[1:]),
             lambda: kn.newton_solve(*n_in, hb=hb),
             lambda: kg.glue(*ge_in, cone=cone),
             lambda: kn.newton_solve(*ne_in, hb=hb, cone=cone)):
    a, b = fn(), fn()
    for name in a:
      assert torch.equal(a[name], b[name]), name
  for source, kernel, entry in (('glue', 'glue_kernel', ''),
                                ('newton', 'newton_kernel', ''),
                                ('glue', 'glue_ell_kernel', 'ell_'),
                                ('newton', 'newton_ell_kernel', 'ell_')):
    grid, block, smem, per_sm = _build.shapes[(source, entry)]
    assert (grid, block) == (256 // 4, 128) and smem > 0 and per_sm >= 1
    info, = [v for k, v in _build.ptxas_info(source).items()
             if k.startswith(f'_Z{len(kernel)}{kernel}')]
    assert info['spill_stores'] == 0 and info['stack'] <= 1024, info


# B1's five entries: C entry, stages (the template argument)
SMOOTH_KERNELS = (('', 63), ('kin_', 2), ('com_', 8), ('crb_', 16),
                  ('front_', 26))


@pytest.mark.cuda
@pytest.mark.parametrize('model', ['humanoid', 'three_humanoids'])
def test_smooth_and_dense_solves_are_deterministic_and_fit_their_design(
    cuda, model):
  """B1 and its four entries run one group of 8, 16 or 32 lanes per
  world (ks.lanes: the fewest that keep ks.MIN_WARPS warps resident per
  SM), B5 and B6 one warp, 4 worlds a block: two launches give the same
  bits, the launch shape is 4 worlds a block, and ptxas gives them no
  spill stores and at most 1 KB of stack."""
  npz, nconmax = ((models.HUMANOID_NPZ, NCONMAX) if model == 'humanoid'
                  else (models.THREE_HUMANOIDS_NPZ, 100))
  m, d = _state(cuda, 256, 10, npz, nconmax)
  sm = ks.smooth(m, d.qpos, d.qvel)
  calls = {name: (lambda fn=fn, args=args, names=names:
                  _named(fn(*args), names))
           for name, (fn, _, _, _, names, args) in
           _smooth_entries(m, sm).items()}
  calls['smooth'] = lambda: ks.smooth(m, d.qpos, d.qvel)
  b = d.qfrc_applied - sm['qfrc_bias']
  calls['spd_solve'] = lambda: dict(zip(
      'xl', kb.spd_solve(sm['qM'], b, return_factor=True)))
  fac = kb.spd_solve(sm['qM'], b, return_factor=True)[1]
  calls['cho_solve'] = lambda: dict(x=kb.cho_solve(fac, b))
  for name, fn in calls.items():
    a, c = fn(), fn()
    for k in a:
      assert torch.equal(a[k], c[k]), (name, k)
  shapes = [(('smooth', entry), f'smooth_stages<{stages}>',
             ks.lanes(m, entry)) for entry, stages in SMOOTH_KERNELS]
  shapes += [(('batch_linalg', 'spd_solve_'), 'spd_solve_kernel', 32),
             (('batch_linalg', 'cho_solve_'), 'cho_solve_kernel', 32)]
  for (source, entry), kernel, lanes in shapes:
    grid, block, smem, per_sm = _build.shapes[(source, entry)]
    assert (grid, block) == (256 // 4, 4 * lanes), (kernel, grid, block)
    assert smem > 0 and per_sm >= 1, (kernel, smem, per_sm)
    if source == 'smooth':
      assert lanes == 32 or per_sm * block // 32 >= ks.MIN_WARPS, kernel
    info = _build.kernel_report(source, kernel)
    assert info['spill_stores'] == 0 and info['stack'] <= 1024, (kernel,
                                                                 info)


@pytest.mark.cuda
def test_tree_solves_are_deterministic_and_fit_their_design(cuda):
  """B7 (with and without the factor) and B8 on three_humanoids run one
  warp per world, kb.TREE_WARPS (at least 4) worlds a block, each world's
  packed rows and x in shared memory: two launches give the same bits,
  B7 without the factor gives the x it gives with it, B8 on B7's LD gives
  B7's x, and ptxas gives them no spill stores and at most 1 KB of
  stack."""
  m, d = _state(cuda, 256, 10, models.THREE_HUMANOIDS_NPZ, 100)
  sm = ks.smooth(m, d.qpos, d.qvel)
  qM, b, parent = sm['qM'], d.qfrc_applied - sm['qfrc_bias'], m.dof_parentid
  diag = m.opt.timestep * m.dof_damping
  x, ld = kb.tree_ldl(qM, b, parent, return_factor=True)
  calls = dict(
      factor=lambda: dict(zip('xl', kb.tree_ldl(qM, b, parent,
                                                 return_factor=True))),
      factor_diag=lambda: dict(zip('xl', kb.tree_ldl(
          qM, b, parent, diag=diag, return_factor=True))),
      no_factor=lambda: dict(x=kb.tree_ldl(qM, b, parent)),
      no_factor_diag=lambda: dict(x=kb.tree_ldl(qM, b, parent, diag=diag)),
      tree_solve=lambda: dict(x=kb.tree_solve(ld, b, parent)))
  outs = {}
  for name, fn in calls.items():
    outs[name], again = fn(), fn()
    for k in again:
      assert torch.equal(outs[name][k], again[k]), (name, k)
  assert torch.equal(outs['no_factor']['x'], x)
  assert torch.equal(outs['no_factor_diag']['x'], outs['factor_diag']['x'])
  assert torch.equal(outs['tree_solve']['x'], x)
  assert kb.TREE_WARPS >= 4
  nnz = sum(len(r) for r in m.dof_ancestor_rows)
  for entry, kernel in (('tree_ldl_', 'tree_ldl_kernel'),
                        ('tree_solve_', 'tree_solve_kernel')):
    grid, block, smem, per_sm = _build.shapes[('batch_linalg', entry)]
    assert (grid, block) == (256 // kb.TREE_WARPS, 32 * kb.TREE_WARPS)
    assert smem == kb.TREE_WARPS * 4 * (nnz + m.nv) and per_sm >= 1
    info = _build.kernel_report('batch_linalg', kernel)
    assert info['spill_stores'] == 0 and info['stack'] <= 1024, (kernel,
                                                                 info)


@pytest.mark.cuda
@pytest.mark.parametrize('kernel', ['cho_solve', 'cho_solve_81', 'tree_solve'])
def test_factor_solve_kernels_match_plain(cuda, kernel):
  """B6 on B5's factor of the humanoid's qM (n 27, the CG step's) and of
  three_humanoids' (n 81, B5's widest shape on the step), B8 on B7's."""
  npz, nconmax = ((models.HUMANOID_NPZ, NCONMAX) if kernel == 'cho_solve'
                  else (models.THREE_HUMANOIDS_NPZ, 100))
  m, d = _state(cuda, 256, 10, npz, nconmax)
  sm = ks.smooth(m, d.qpos, d.qvel)
  qM, b = sm['qM'], d.qfrc_applied - sm['qfrc_bias']
  _reset()
  if kernel.startswith('cho_solve'):
    x0, fac = kb.spd_solve(qM, b, return_factor=True)
    _close(fac, batch_linalg.spd_solve_batched(qM, b, return_factor=True)[1],
           'spd_solve factor', 2e-5)
    x, xr = kb.cho_solve(fac, b), batch_linalg.cho_solve_batched(fac, b)
    kernel = 'cho_solve'
  else:
    x0, fac = kb.tree_ldl(qM, b, m.dof_parentid, return_factor=True)
    x = kb.tree_solve(fac, b, m.dof_parentid)
    xr = batch_linalg.tree_solve_from_factor_batched(fac, b, m.dof_parentid)
  torch.cuda.synchronize()
  assert kb.launches[kernel] == 1
  _close(x, xr, kernel, 2e-5)
  assert torch.equal(x, x0)       # the producer's own sweeps
  assert float(_residual(qM, x, b).max()) <= 1e-5
  if kernel == 'tree_solve' or m.nv <= 32:
    assert torch.equal(kb.m_cho_solve(fac, b, m.dof_parentid), x)


@pytest.mark.cuda
def test_forward_and_rk4_launch_the_newton_kernel(cuda):
  m, d = _state(cuda, 256, 20)
  _reset()
  out = mt.forward_batched(m, d)
  torch.cuda.synchronize()
  assert (ks.launches, kc.launches, kn.launches, kg.launches) == (1, 1, 1, 0)
  assert torch.equal(out.qvel, d.qvel)
  _close(out.qpos, d.qpos, 'qpos', 1e-6)
  _reset()
  out = mt.step_batched(_with(m, integrator=int(IntegratorType.RK4)), d)
  torch.cuda.synchronize()
  assert (ks.launches, kc.launches, kn.launches, kg.launches) == (4, 4, 4, 0)
  assert bool(torch.isfinite(out.qpos).all())


@pytest.mark.cuda
@pytest.mark.parametrize('model', ['humanoid', 'three_humanoids'])
def test_cg_step_launches(cuda, model):
  npz, nconmax = ((models.HUMANOID_NPZ, NCONMAX) if model == 'humanoid'
                  else (models.THREE_HUMANOIDS_NPZ, 100))
  m, d = _state(cuda, 256, 5, npz, nconmax)
  m = _with(m, solver=int(SolverType.CG))
  _reset()
  d = mt.step_batched(m, d)
  torch.cuda.synchronize()
  assert (ks.launches, kc.launches, kg.launches, kn.launches) == (1, 1, 0, 0)
  solves = 1 + solver.counts['passes']
  assert solver.counts['passes'] == int(d.solver_niter.max()) > 0
  if model == 'humanoid':     # eulerdamp is disabled: B5 once
    assert kb.launches == {'tree_ldl': 0, 'spd_solve': 1,
                           'cho_solve': solves, 'tree_solve': 0}
  else:
    assert kb.launches == {'tree_ldl': 2, 'spd_solve': 0, 'cho_solve': 0,
                           'tree_solve': solves}
  assert bool(torch.isfinite(d.qpos).all())


# ---- the elliptic cone: B2's elliptic rows, B3e and B4-elliptic ----


def _cone(m, con):
  return solver.cone_inputs(m, mt.Contact(**{k: con[k]
                                            for k in kc.CONTACT_FIELDS}))


def test_elliptic_wrappers_run_plain_on_cpu_and_refuse_to_launch():
  m, d = _state('cpu', 3, 10, elliptic=True)
  _reset()
  sm, c_in, con, g_in = _stages(m, d)
  assert bool((con['efc_type'] == 7).any())        # elliptic rows
  for name, ref in kc.plain(*c_in).items():
    torch.testing.assert_close(con[name], ref, rtol=0, atol=0)
  cone = _cone(m, con)
  out = kg.glue(*g_in, cone=cone)
  for name, ref in forward.glue(*g_in, cone=cone).items():
    torch.testing.assert_close(out[name], ref, rtol=0, atol=0)
  n_in = g_in[:6] + (out['qfrc_smooth'], g_in[10])
  nout = kn.newton_solve(*n_in, cone=cone)
  for name, ref in solver.newton_solve(*n_in, cone=cone).items():
    torch.testing.assert_close(nout[name], ref, rtol=0, atol=0)
  with pytest.raises(ValueError, match='expected a tensor on'):
    kc._launch(*c_in)
  for launch, args in ((kg._launch, g_in), (kn._launch, n_in)):
    with pytest.raises(ValueError, match='expected a tensor on'):
      launch(*args, cone=cone)
  assert (kc.launches, kg.launches, kg.launches_ell, kn.launches,
          kn.launches_ell) == (0,) * 5


def _objective(m, args, cone, qacc):
  """The elliptic problem's cost (W,) at qacc, in float64."""
  f64 = [x.double() for x in args[1:6]]
  qfs = args[6].double()
  qsm = solver.cho_solve(solver.cholesky(f64[0]), qfs)
  K = solver.Cone(m, f64[2], (cone[0].double(), cone[1], cone[2].double()))
  ne, nf, _, _, _ = mt.efc_layout(m, 0)
  return solver.objective(*f64, qfs, qsm, qacc.double(), ne, nf, cone=K)


def _check_elliptic_solve(m, out, ref, args, cone):
  """B3's criteria: qacc 5e-5 and forces 5e-4 of scale, solver_niter
  within 4, the objective within one unit of tolerance · meaninertia ·
  nv; a world over the elementwise tolerances must reach an objective no
  higher than the plain solve's plus one unit, or have stopped earlier
  (chip_smoke.py, _check_excused)."""
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * m.nv
  gap = (_objective(m, args, cone, out['qacc']) -
         _objective(m, args, cone, ref['qacc'])) / unit
  over = torch.zeros_like(gap, dtype=torch.bool)
  for name, tol in (('qacc', 5e-5), ('qacc_smooth', 5e-5), ('qLD', 5e-5),
                    ('qfrc_constraint', 5e-4), ('efc_force', 5e-4)):
    a, b = out[name].cpu(), ref[name].cpu()
    scale = max(1.0, float(b.abs().max()))
    over |= ((a - b).abs().reshape(a.shape[0], -1).amax(1) > tol * scale
             ).to(over.device)
  dn = (out['solver_niter'] - ref['solver_niter'])
  assert int(dn.abs().max()) <= 4, dn.abs().bincount().tolist()
  assert int(over.sum()) <= max(2, gap.shape[0] // 100), int(over.sum())
  assert bool((~over | (gap <= 1.0) | (dn < 0)).all())
  assert float(gap[~over].abs().max()) <= 1.0


@pytest.mark.cuda
def test_elliptic_kernels_match_plain(cuda):
  m, d = _state(cuda, 256, 60, elliptic=True)
  _reset()
  sm, c_in, con, g_in = _stages(m, d)
  torch.cuda.synchronize()
  assert kc.launches == 1
  ref = kc.plain(*c_in)
  assert bool((ref['efc_type'][ref['efc_active']] == 7).any())
  for name in ref:
    _close(con[name], ref[name], name, 2e-3 if name == 'efc_aref' else 2e-5)
  cone = _cone(m, ref)
  out = kg.glue(*g_in, cone=cone)
  torch.cuda.synchronize()
  assert (kg.launches, kg.launches_ell) == (0, 1)
  gref = forward.glue(*g_in, cone=cone)
  n_args = g_in[:6] + (gref['qfrc_smooth'], g_in[10])
  _check_elliptic_solve(m, out, gref, n_args, cone)
  _close(out['qpos'], gref['qpos'], 'qpos', 5e-6)
  nout = kn.newton_solve(*n_args, cone=cone)
  torch.cuda.synchronize()
  assert (kn.launches, kn.launches_ell) == (0, 1)
  _check_elliptic_solve(m, nout, solver.newton_solve(*n_args, cone=cone),
                        n_args, cone)


@pytest.mark.cuda
def test_newton_ell_kernel_equals_the_glue_ell_kernels_solve(cuda):
  """B3e and B4-elliptic run the same device code on the same
  qfrc_smooth."""
  m, d = _state(cuda, 256, 60, elliptic=True)
  _, _, con, g_in = _stages(m, d)
  cone = _cone(m, con)
  glue = kg.glue(*g_in, cone=cone)
  out = kn.newton_solve(*g_in[:6], glue['qfrc_smooth'], g_in[10], cone=cone)
  for name in kn.OUTPUTS:
    assert torch.equal(out[name], glue[name]), name


@pytest.mark.cuda
def test_elliptic_paths_launch_the_elliptic_kernels(cuda):
  m, d = _state(cuda, 256, 20, elliptic=True)
  _reset()
  out = mt.step_batched(m, d)
  torch.cuda.synchronize()
  assert (ks.launches, kc.launches, kg.launches, kg.launches_ell) == (
      1, 1, 0, 1)
  assert bool(torch.isfinite(out.qpos).all())
  _reset()
  mt.forward_batched(m, d)
  out = mt.step_batched(_with(m, integrator=int(IntegratorType.RK4)), d)
  torch.cuda.synchronize()
  assert (kn.launches, kn.launches_ell, kg.launches_ell) == (0, 5, 0)
  assert bool(torch.isfinite(out.qpos).all())


@pytest.mark.cuda
@pytest.mark.parametrize('variant', ['glue', 'elliptic', 'rk4'])
def test_replayed_steps_equal_eager_steps(cuda, variant):
  """10 steps replayed as one CUDA graph give every Data tensor the bits
  of 10 eager steps with the same step indices; the benchmark replays."""
  m, d = _state(cuda, 256, 20, elliptic=variant == 'elliptic')
  if variant == 'rk4':
    m = _with(m, integrator=int(IntegratorType.RK4))
  assert forward.replays(m, d)
  eager = benchmark.rollout(m, d, 10, start=20)
  replayed = benchmark.replayed(m, d, 10, start=20)
  torch.cuda.synchronize()
  bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
  for k in mt.types.DATA_TENSORS:
    assert torch.equal(bits(getattr(replayed, k)), bits(getattr(eager, k))), k
  for k in mt.types.CONTACT_TENSORS:
    assert torch.equal(bits(getattr(replayed.contact, k)),
                       bits(getattr(eager.contact, k))), k
  _, res = benchmark.benchmark(m, d, nstep=3)
  assert res['dispatch'] == 'graph' and res['converged_worlds'] == 256
