"""Build and load the port's native libraries from ``csrc/``.

Two libraries, each with a plain C interface and loaded with ``ctypes``:

  glimpse    ``csrc/glimpse.cu``, the hand-written CUDA kernels, compiled by
             ``nvcc`` for ``sm_90a``;
  hungarian  ``csrc/hungarian.cc``, the host Hungarian solver, compiled by
             the C++ compiler (``g++``, or ``$CXX``).

Each is built under ``rec_attend_tpu_torch/_build/`` (listed in
``.gitignore``) at first use, and built again when its source changes (the
file name carries a hash of the source).  ``build()`` starts every compile
at once and waits for all of them.  Nothing of ``torch.utils.cpp_extension``
is used: a source that includes PyTorch's headers takes minutes to compile,
these take seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCES = {
    'glimpse': os.path.join(_PKG_DIR, 'csrc', 'glimpse.cu'),
    'hungarian': os.path.join(_PKG_DIR, 'csrc', 'hungarian.cc'),
}
BUILD_DIR = os.path.join(_PKG_DIR, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')
CXX_FLAGS = ('-O2', '-fPIC', '-shared', '-std=c++17')

# Signature shared by both glimpse entry points: four float pointers, six
# ints (B, H, W, D, FH, FW) and the stream; the return value is a cudaError_t.
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
KERNELS = ('glimpse_extract', 'glimpse_paste')

_lock = threading.Lock()
_libs = {}


def find_nvcc():
  """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
  found = shutil.which('nvcc')
  if found:
    return found
  home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
  candidate = os.path.join(home, 'bin', 'nvcc')
  if os.path.exists(candidate):
    return candidate
  raise RuntimeError('nvcc not found on PATH, under $CUDA_HOME or '
                     '/usr/local/cuda: the glimpse kernels cannot be built')


def library_path(name='glimpse'):
  with open(SOURCES[name], 'rb') as f:
    digest = hashlib.sha256(f.read()).hexdigest()[:16]
  return os.path.join(BUILD_DIR, f'{name}-{digest}.so')


def _command(name, out, verbose):
  if name == 'glimpse':
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
      cmd += ['-Xptxas', '-v']
  else:
    cmd = [os.environ.get('CXX', 'g++'), *CXX_FLAGS]
  return cmd + ['-o', out, SOURCES[name]]


def build(names=tuple(SOURCES), verbose=False):
  """Compile every library of ``names`` whose current source has none yet,
  all compiles at once.

  Returns {name: library path}.  Raises RuntimeError with the compiler's
  output if a compile fails."""
  paths = {name: library_path(name) for name in names}
  os.makedirs(BUILD_DIR, exist_ok=True)
  running = {}
  for name, path in paths.items():
    if os.path.exists(path):
      continue
    # Compile to a private name and rename, so that a concurrent builder
    # never loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = _command(name, tmp, verbose)
    running[name] = (cmd, tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  failed = []
  for name, (cmd, tmp, proc) in running.items():
    out, _ = proc.communicate()
    if proc.returncode != 0:
      os.unlink(tmp)
      failed.append(f'{name}: {" ".join(cmd)} exited {proc.returncode}\n'
                    f'{out}')
      continue
    if verbose and out:
      print(out, file=sys.stderr, flush=True)
    os.replace(tmp, paths[name])
  if failed:
    raise RuntimeError('build failed:\n' + '\n'.join(failed))
  return paths


def _load(name, bind):
  with _lock:
    if name not in _libs:
      lib = ctypes.CDLL(build((name,))[name])
      bind(lib)
      _libs[name] = lib
    return _libs[name]


def _bind_glimpse(lib):
  for name in KERNELS:
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
  lib.glimpse_error_string.argtypes = [ctypes.c_int]
  lib.glimpse_error_string.restype = ctypes.c_char_p


def _bind_hungarian(lib):
  lib.hungarian_solve.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                                  + [ctypes.c_void_p] * 3)
  lib.hungarian_solve.restype = ctypes.c_int


def load():
  """The loaded glimpse kernel library, built first if needed."""
  return _load('glimpse', _bind_glimpse)


def load_hungarian():
  """The loaded host Hungarian library, built first if needed."""
  return _load('hungarian', _bind_hungarian)
