"""The port's kernels B9-B12 on the CPU (their plain versions, reached
through the public wrappers of `kernels/smooth.py`) against the JAX
package's TPU kernels `smooth_kernels.kinematics_batched` (B10),
`com_pos_batched` (B11), `crb_batched` (B12) and `smooth_front_batched`
(B9), run in Pallas interpret mode: these functions take no `interpret`
argument, so the module passes it to `pallas_call` while its tests run.

Inputs, made from a seed with numpy: C MuJoCo states (`torch_parity`),
their qpos normalized by the JAX `smooth._normalize_qpos` for B10 and
B9; the JAX B10's outputs for B11; the JAX B11's outputs plus seeded
noise for B12, so that B12 also sees inputs no B11 made. Tolerance 2e-5
of max(1, max |jax|) for every field (`test_torch_smooth.py`'s TOL).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from mujoco_warp_tpu import smooth as jsmooth
from mujoco_warp_tpu.pallas import smooth_kernels as jsk
from mujoco_warp_tpu_torch.kernels import smooth as ks

from torch_parity import assert_close, build, states

TOL = 2e-5
NWORLD = 6
KERNELS = ('B9', 'B10', 'B11', 'B12')
# the JAX test's fixtures (tests/test_pallas_kernels.py), and the humanoid
# for B10 and B9 (B9 runs B11 and B12 on it too), whose interpret-mode
# compiles take 13-17 s each on the CPU
CASES = [(s, k) for s in ('pendulum', 'ball_chain', 'hopper')
         for k in KERNELS] + [('humanoid', 'B10'), ('humanoid', 'B9')]


@pytest.fixture(scope='module', autouse=True)
def interpret():
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jsk.pl, 'pallas_call', functools.partial(
        jsk.pl.pallas_call, interpret=True))
    yield


@functools.cache
def _scene(scene):
  """(JAX Model, port Model, normalized qpos) of C MuJoCo states."""
  mjm, jm, m = build(scene)
  q, _ = states(mjm, NWORLD, nstep=60)
  qn = jax.jit(jax.vmap(lambda x: jsmooth._normalize_qpos(jm, x)))(q)
  return jm, m, np.asarray(qn)


@functools.cache
def _jax(scene, kernel):
  """(inputs, outputs by name) of a JAX kernel as numpy, one compile."""
  jm, _, qn = _scene(scene)
  if kernel in ('B9', 'B10'):
    args = [qn]
  elif kernel == 'B11':
    args = list(_jax(scene, 'B10')[1].values())
  else:
    rng = np.random.default_rng(3)
    args = [x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
            for x in list(_jax(scene, 'B11')[1].values())[1:]]
  fn = dict(B9=jsk.smooth_front_batched, B10=jsk.kinematics_batched,
            B11=jsk.com_pos_batched, B12=jsk.crb_batched)[kernel]
  out = fn(jm, *args)
  if not isinstance(out, dict):
    out = dict(zip(dict(B10=ks.KINEMATICS, B11=ks.COM_POS,
                        B12=ks.CRB)[kernel], out))
  return args, {n: np.asarray(v) for n, v in out.items()}


@pytest.mark.parametrize('scene,kernel', CASES)
def test_kernel_plain_version_matches_jax_kernel(scene, kernel):
  m = _scene(scene)[1]
  args, ref = _jax(scene, kernel)
  fn = dict(B9=ks.smooth_front, B10=ks.kinematics, B11=ks.com_pos,
            B12=ks.crb)[kernel]
  counts = (ks.launches_front, ks.launches_kin, ks.launches_com,
            ks.launches_crb)
  out = fn(m, *[torch.tensor(a) for a in args])
  if not isinstance(out, dict):
    out = dict(zip(ref, out))
  assert set(out) == set(ref)
  for name, want in ref.items():
    assert out[name].shape == want.shape, name
    assert_close(out[name].numpy(), want, f'{kernel} {name}', TOL)
  assert (ks.launches_front, ks.launches_kin, ks.launches_com,
          ks.launches_crb) == counts
