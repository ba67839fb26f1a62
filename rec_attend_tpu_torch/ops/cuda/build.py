"""Build and load the port's native libraries from ``csrc/``.

Three libraries, each with a plain C interface and loaded with ``ctypes``:

  glimpse     ``csrc/glimpse.cu``, the hand-written CUDA kernels, compiled
              by ``nvcc`` for ``sm_90a``;
  hungarian   ``csrc/hungarian.cc``, the host Hungarian solver, and
  png_filter  ``csrc/png_filter.cc``, the PNG decoder's row unfiltering,
              both compiled by the C++ compiler (``g++``, or ``$CXX``).

Each is built under ``rec_attend_tpu_torch/_build/`` (listed in
``.gitignore``) at first use, and built again when its source changes (the
file name carries a hash of the source).  ``build()`` starts every compile
at once and waits for all of them, and keeps each compiler's output beside
its library (``glimpse-<hash>.log``): nvcc's holds the ``-Xptxas -v``
report of each kernel's registers, spills and static shared memory.
Nothing of ``torch.utils.cpp_extension`` is used: a source that includes
PyTorch's headers takes minutes to compile, these take seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCES = {
    'glimpse': os.path.join(_PKG_DIR, 'csrc', 'glimpse.cu'),
    'hungarian': os.path.join(_PKG_DIR, 'csrc', 'hungarian.cc'),
    'png_filter': os.path.join(_PKG_DIR, 'csrc', 'png_filter.cc'),
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


def log_path(name='glimpse'):
  """The compiler output kept beside the library of ``name``."""
  return library_path(name)[:-len('.so')] + '.log'


def compile_log(name='glimpse'):
  """The compiler's output for the current source of ``name``."""
  with open(log_path(name)) as f:
    return f.read()


def _command(name, out):
  if name == 'glimpse':
    cmd = [find_nvcc(), *NVCC_FLAGS, '-Xptxas', '-v']
  else:
    cmd = [os.environ.get('CXX', 'g++'), *CXX_FLAGS]
  return cmd + ['-o', out, SOURCES[name]]


def _replace_with(path, text):
  fd, tmp = tempfile.mkstemp(dir=BUILD_DIR)
  with os.fdopen(fd, 'w') as f:
    f.write(text)
  os.replace(tmp, path)


def build(names=tuple(SOURCES)):
  """Compile every library of ``names`` whose current source has none yet
  (or no log beside it), all compiles at once.

  Returns {name: library path}.  Raises RuntimeError with the compiler's
  output if a compile fails."""
  paths = {name: library_path(name) for name in names}
  os.makedirs(BUILD_DIR, exist_ok=True)
  running = {}
  for name, path in paths.items():
    if os.path.exists(path) and os.path.exists(log_path(name)):
      continue
    # Compile to a private name and rename, so that a concurrent builder
    # never loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = _command(name, tmp)
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
    # The log lands first: a library with no log beside it is built again.
    _replace_with(log_path(name), out)
    os.replace(tmp, paths[name])
  if failed:
    raise RuntimeError('build failed:\n' + '\n'.join(failed))
  return paths


def _kernel_name(mangled):
  """``paste_kernel<7,1>`` from an Itanium-mangled kernel name: the last
  length-prefixed name of its nesting, with its integer template arguments;
  the name itself where it is not mangled."""
  m = re.match(r'_ZN?', mangled)
  if not m:
    return mangled
  pos, name = m.end(), mangled
  while (d := re.match(r'\d+', mangled[pos:])):
    start = pos + d.end()
    name, pos = mangled[start:start + int(d.group())], start + int(d.group())
  args = re.match(r'I((?:Li-?\d+E)+)E', mangled[pos:])
  if args:
    name += '<' + ','.join(re.findall(r'Li(-?\d+)E', args.group(1))) + '>'
  return name


def kernel_resources(log):
  """{kernel: {'registers', 'spill_store_bytes', 'spill_load_bytes',
  'static_smem_bytes'}} from the ``-Xptxas -v`` lines of an nvcc log;
  a template instance is named as ``paste_kernel<7,1>``."""
  usage, name = {}, None
  for line in log.splitlines():
    m = re.search(r"(?:Compiling entry function|Function properties for) "
                  r"'?(\w+)", line)
    if m:
      name = _kernel_name(m.group(1))
      usage.setdefault(name, {})
      continue
    if name is None:
      continue
    m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
    if m:
      usage[name]['spill_store_bytes'] = int(m.group(1))
      usage[name]['spill_load_bytes'] = int(m.group(2))
    m = re.search(r'Used (\d+) registers', line)
    if m:
      usage[name]['registers'] = int(m.group(1))
      m = re.search(r'(\d+) bytes smem', line)
      usage[name]['static_smem_bytes'] = int(m.group(1)) if m else 0
  return usage


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
  lib.glimpse_extract_route.argtypes = ([ctypes.c_int] * 7
                                        + [ctypes.POINTER(ctypes.c_int)])
  lib.glimpse_extract_route.restype = ctypes.c_int
  lib.glimpse_error_string.argtypes = [ctypes.c_int]
  lib.glimpse_error_string.restype = ctypes.c_char_p


def _bind_hungarian(lib):
  lib.hungarian_solve.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                                  + [ctypes.c_void_p] * 3)
  lib.hungarian_solve.restype = ctypes.c_int


def _bind_png_filter(lib):
  lib.png_unfilter.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                               + [ctypes.c_void_p])
  lib.png_unfilter.restype = ctypes.c_int


def load():
  """The loaded glimpse kernel library, built first if needed."""
  return _load('glimpse', _bind_glimpse)


def load_hungarian():
  """The loaded host Hungarian library, built first if needed."""
  return _load('hungarian', _bind_hungarian)


def load_png_filter():
  """The loaded host PNG unfiltering library, built first if needed."""
  return _load('png_filter', _bind_png_filter)
