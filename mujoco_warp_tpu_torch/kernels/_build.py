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
SOURCES = ('smooth', 'contact', 'glue', 'newton', 'batch_linalg')
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_loaded: dict = {}
_tables: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
# (source, entry) -> (grid, block, shared bytes, blocks resident per SM)
# of the last launch of a kernel that reports its shape (`launch_shape`:
# the warp-per-world ones)
shapes: dict = {}
# (library, entry) -> its C functions; (library, entry, scalar parameters)
# -> launch shape
_entries: dict = {}
_shapes_seen: dict = {}


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


def ptxas_info(name: str) -> dict:
  """Per kernel of csrc/<name>.cu (its mangled name), what ptxas reported
  in the last build: registers, stack, spill_stores, spill_loads (bytes)
  and smem (static shared bytes)."""
  out, current = {}, None
  for line in build_log(name).splitlines():
    if 'Function properties for' in line:
      current = out.setdefault(line.split('for')[-1].strip(), {})
    elif current is not None and 'stack frame' in line:
      nums = [int(t) for t in line.replace(',', ' ').split() if t.isdigit()]
      current.update(stack=nums[0], spill_stores=nums[1],
                     spill_loads=nums[2])
    elif current is not None and 'Used' in line and 'registers' in line:
      words = line.replace(',', ' ').split()
      current['registers'] = int(words[words.index('Used') + 1])
      current['smem'] = sum(int(words[i - 2]) for i, w in enumerate(words)
                            if w == 'smem' and words[i - 2].isdigit())
  return out


def kernel_report(name: str, kernel: str) -> dict:
  """ptxas_info's report of one kernel of csrc/<name>.cu, by its name or,
  for a template instantiation, its name with the argument
  (`smooth_stages<63>`); raises unless exactly one kernel matches."""
  base, _, arg = kernel.partition('<')
  prefix = f'_Z{len(base)}{base}' + (f'ILi{arg[:-1]}EE' if arg else '')
  found = [v for k, v in ptxas_info(name).items() if k.startswith(prefix)]
  if len(found) != 1:
    raise RuntimeError(f'{kernel}: {len(found)} ptxas reports in {name}')
  return found[0]


def library(name: str) -> ctypes.CDLL:
  """The loaded library of csrc/<name>.cu, built first if missing."""
  lib = _loaded.get(name)
  if lib is None:
    build_all()
    lib = ctypes.CDLL(_target(name))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
  return lib


def struct(name: str, ptrs, floats, ints, base=None):
  """ctypes mirror of a kernel's parameter struct: pointers first, then
  float scalars, then int scalars, in the order of the .cu file. With
  `base`, a struct whose first member `base` is that struct (an entry
  that takes another kernel's parameters and more)."""
  return type(name, (ctypes.Structure,), {'_fields_': (
      ([('base', base)] if base is not None else []) +
      [(p, ctypes.c_void_p) for p in ptrs] +
      [(f, ctypes.c_float) for f in floats] +
      [(i, ctypes.c_int) for i in ints])})


def _fill(params, values: dict) -> None:
  """Set every field of a parameter struct from `values` (tensors become
  device pointers, None a null pointer; a nested struct from the same
  values)."""
  for field, ftype in params._fields_:
    if isinstance(ftype, type) and issubclass(ftype, ctypes.Structure):
      _fill(getattr(params, field), values)
      continue
    v = values[field]
    setattr(params, field, v.data_ptr() if hasattr(v, 'data_ptr') else v)


def _entry(lib, name: str, entry: str, params_type):
  """(launch, launch_shape or None) of a kernel's C entry, looked up and
  its parameter struct's size checked once per library and entry."""
  fns = _entries.get((lib, entry))
  if fns is None:
    size_fn = getattr(lib, entry + 'params_size')
    size_fn.argtypes, size_fn.restype = [], ctypes.c_int
    if size_fn() != ctypes.sizeof(params_type):
      raise RuntimeError(f'{name}: parameter struct mismatch '
                         f'({size_fn()} vs {ctypes.sizeof(params_type)} '
                         f'bytes)')
    launch_fn = getattr(lib, entry + 'launch')
    launch_fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    launch_fn.restype = ctypes.c_int
    shape_fn = getattr(lib, entry + 'launch_shape', None)
    if shape_fn is not None:
      shape_fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
      shape_fn.restype = ctypes.c_int
    fns = _entries[(lib, entry)] = (launch_fn, shape_fn)
  return fns


def _scalars(params) -> tuple:
  """The int and float fields of a parameter struct (nested ones too):
  with the kernel, they fix its launch shape."""
  out = []
  for field, ftype in params._fields_:
    if isinstance(ftype, type) and issubclass(ftype, ctypes.Structure):
      out.extend(_scalars(getattr(params, field)))
    elif ftype is not ctypes.c_void_p:
      out.append(getattr(params, field))
  return tuple(out)


def _shape(lib, name: str, entry: str, shape_fn, params) -> tuple:
  """(grid, block, shared bytes, blocks resident per SM) of a launch with
  these parameters, queried once per set of scalar parameters."""
  key = (lib, entry, _scalars(params))
  shape = _shapes_seen.get(key)
  if shape is None:
    buf = (ctypes.c_int * 4)()
    if shape_fn(ctypes.byref(params), buf):
      raise RuntimeError(f'{name}: launch_shape failed')
    shape = _shapes_seen[key] = tuple(buf)
  return shape


def launch_shape(name: str, params_type, values: dict,
                 entry: str = '') -> tuple:
  """The launch shape of a kernel with `<entry>launch_shape` on these
  values (as `launch` fills them), without launching it."""
  lib = library(name)
  _, shape_fn = _entry(lib, name, entry, params_type)
  params = params_type()
  _fill(params, values)
  return _shape(lib, name, entry, shape_fn, params)


def launch(name: str, params_type, values: dict, device,
           entry: str = '') -> None:
  """Fill the parameter struct from `values` (tensors become device
  pointers, None a null pointer) and launch the kernel on the current
  stream of `device`; raise on a launch error. A source with several
  kernels names each one's C functions `<entry>launch` and
  `<entry>params_size`. A kernel with `<entry>launch_shape` has its shape
  recorded in `shapes`, queried once per set of scalar parameters."""
  lib = library(name)
  launch_fn, shape_fn = _entry(lib, name, entry, params_type)
  params = params_type()
  _fill(params, values)
  stream = torch.cuda.current_stream(device).cuda_stream
  err = launch_fn(ctypes.byref(params), ctypes.c_void_p(stream))
  if err:
    raise RuntimeError(f'{name} kernel launch failed: '
                       f'{lib.error_string(err).decode()}')
  if shape_fn is not None:
    shapes[(name, entry)] = _shape(lib, name, entry, shape_fn, params)


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
