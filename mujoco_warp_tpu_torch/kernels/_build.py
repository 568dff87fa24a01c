"""Build and load the CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into a shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds). Libraries go to `build/kernels/` at the root
of the checkout, named by a hash of their sources and flags, and build
on first use; `build_all` starts one nvcc per source, all at once.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
import weakref

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'kernels')
SOURCES = ('smooth', 'contact', 'glue')
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_loaded: dict = {}
_tables: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _nvcc() -> str:
  found = shutil.which('nvcc')
  if found:
    return found
  cuda = os.environ.get('CUDA_HOME', '/usr/local/cuda')
  path = os.path.join(cuda, 'bin', 'nvcc')
  if not os.path.exists(path):
    raise RuntimeError('nvcc not found: the CUDA kernels need the toolkit')
  return path


def _target(name: str) -> str:
  h = hashlib.sha256(' '.join(FLAGS).encode())
  for path in [os.path.join(CSRC, name + '.cu')] + sorted(
      glob.glob(os.path.join(CSRC, '*.cuh'))):
    with open(path, 'rb') as f:
      h.update(f.read())
  return os.path.join(BUILD_DIR, f'{name}_{h.hexdigest()[:16]}.so')


def build_all(names=SOURCES) -> float:
  """Compile every missing library, one nvcc process per source, all
  started together. Returns the wall seconds; raises with the compiler's
  output if a build fails."""
  t0 = time.perf_counter()
  os.makedirs(BUILD_DIR, exist_ok=True)
  procs = []
  for name in names:
    out = _target(name)
    if os.path.exists(out):
      continue
    log = open(out + '.log', 'w')
    cmd = [_nvcc(), *FLAGS, '-o', out + '.tmp',
           os.path.join(CSRC, name + '.cu')]
    procs.append((name, out, log, subprocess.Popen(
        cmd, stdout=log, stderr=subprocess.STDOUT)))
  failed = []
  for name, out, log, proc in procs:
    rc = proc.wait()
    log.close()
    if rc == 0:
      os.replace(out + '.tmp', out)
    else:
      with open(out + '.log') as f:
        failed.append(f'{name}.cu (nvcc rc={rc}):\n{f.read()}')
  if failed:
    raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
  return time.perf_counter() - t0


def build_log(name: str) -> str:
  """nvcc's output (with ptxas register/spill counts) of the last build."""
  path = _target(name) + '.log'
  if not os.path.exists(path):
    return ''
  with open(path) as f:
    return f.read()


def library(name: str) -> ctypes.CDLL:
  """The loaded library of csrc/<name>.cu, built first if missing."""
  lib = _loaded.get(name)
  if lib is None:
    build_all()
    lib = ctypes.CDLL(_target(name))
    lib.launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.launch.restype = ctypes.c_int
    lib.params_size.argtypes = []
    lib.params_size.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
  return lib


def struct(name: str, ptrs, floats, ints):
  """ctypes mirror of a kernel's parameter struct: pointers first, then
  float scalars, then int scalars, in the order of the .cu file."""
  return type(name, (ctypes.Structure,), {'_fields_': (
      [(p, ctypes.c_void_p) for p in ptrs] +
      [(f, ctypes.c_float) for f in floats] +
      [(i, ctypes.c_int) for i in ints])})


def launch(name: str, params_type, values: dict, device) -> None:
  """Fill the parameter struct from `values` (tensors become device
  pointers) and launch the kernel on the current stream of `device`;
  raise on a launch error."""
  lib = library(name)
  if lib.params_size() != ctypes.sizeof(params_type):
    raise RuntimeError(f'{name}: parameter struct mismatch '
                       f'({lib.params_size()} vs '
                       f'{ctypes.sizeof(params_type)} bytes)')
  params = params_type()
  for field, _ in params_type._fields_:
    v = values[field]
    setattr(params, field, v.data_ptr() if hasattr(v, 'data_ptr') else v)
  stream = torch.cuda.current_stream(device).cuda_stream
  err = lib.launch(ctypes.byref(params), ctypes.c_void_p(stream))
  if err:
    raise RuntimeError(f'{name} kernel launch failed: '
                       f'{lib.error_string(err).decode()}')


def model_tables(m, name: str, make):
  """make(m) -> dict of device tensors, built once per model."""
  per_model = _tables.setdefault(m, {})
  if name not in per_model:
    per_model[name] = make(m)
  return per_model[name]


def check(name: str, t: torch.Tensor, shape, dtype=torch.float32,
          device=None):
  """Raise unless t is a contiguous CUDA tensor of this shape and dtype
  (on `device` when given)."""
  if not t.is_cuda or (device is not None and t.device != device):
    raise ValueError(f'{name}: expected a tensor on {device or "cuda"}, '
                     f'got {t.device}')
  if t.dtype != dtype:
    raise ValueError(f'{name}: expected {dtype}, got {t.dtype}')
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f'{name}: expected shape {tuple(shape)}, '
                     f'got {tuple(t.shape)}')
  if not t.is_contiguous():
    raise ValueError(f'{name}: expected a contiguous tensor')
