"""The native-library builder of the port (``ops/cuda/build.py``): its
reading of nvcc's ``-Xptxas -v`` report, and the compile log it keeps
beside a library, on the host library that builds here (``g++``; nvcc runs
only on the card's machine)."""

import os

import pytest

from rec_attend_tpu_torch.ops.cuda import build

# The shape of nvcc 12.8's report for two kernels of csrc/glimpse.cu.
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__1972d66e_10_glimpse_cu_4dc74d0312paste_kernelILi7ELi1EEEvPKfS2_S2_Pfiiiiiiiiiibb' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__1972d66e_10_glimpse_cu_4dc74d0312paste_kernelILi7ELi1EEEvPKfS2_S2_Pfiiiiiiiiiibb
    0 bytes stack frame, 32 bytes spill stores, 72 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compile time = 218.636 ms
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__1972d66e_10_glimpse_cu_4dc74d0314extract_kernelEPKfS1_S1_Pfiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__1972d66e_10_glimpse_cu_4dc74d0314extract_kernelEPKfS1_S1_Pfiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, 16 bytes smem, used 1 barriers
"""


def test_kernel_resources_reads_each_kernel():
  assert build.kernel_resources(PTXAS_LOG) == {
      'paste_kernel<7,1>': {'registers': 128, 'spill_store_bytes': 32,
                            'spill_load_bytes': 72, 'static_smem_bytes': 0},
      'extract_kernel': {'registers': 96, 'spill_store_bytes': 0,
                         'spill_load_bytes': 0, 'static_smem_bytes': 16},
  }
  assert build.kernel_resources('nvcc: no ptxas lines\n') == {}


# nvcc's report for the three extract kernels: a name with "_kernel" inside
# it, and two template instances.
EXTRACT_LOG = """\
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__1972d66e_10_glimpse_cu_4dc74d0322extract_kernel_generalEPKfS1_S1_Pfiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__1972d66e_10_glimpse_cu_4dc74d0322extract_kernel_generalEPKfS1_S1_Pfiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__1972d66e_10_glimpse_cu_4dc74d0320extract_tiled_kernelILi48ELi12ELi4ELi32EEEvPKfS2_S2_Pfi' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__1972d66e_10_glimpse_cu_4dc74d0320extract_tiled_kernelILi48ELi12ELi4ELi32EEEvPKfS2_S2_Pfi
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__1972d66e_10_glimpse_cu_4dc74d0320extract_strip_kernelILi12ELi4ELi4ELi2EEEvPKfS2_S2_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__1972d66e_10_glimpse_cu_4dc74d0320extract_strip_kernelILi12ELi4ELi4ELi2EEEvPKfS2_S2_Pfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers
"""


def test_kernel_resources_names_the_extract_kernels():
  assert build.kernel_resources(EXTRACT_LOG) == {
      'extract_kernel_general': {'registers': 96, 'spill_store_bytes': 0,
                                 'spill_load_bytes': 0,
                                 'static_smem_bytes': 0},
      'extract_tiled_kernel<48,12,4,32>': {'registers': 168,
                                           'spill_store_bytes': 8,
                                           'spill_load_bytes': 8,
                                           'static_smem_bytes': 0},
      'extract_strip_kernel<12,4,4,2>': {'registers': 154,
                                         'spill_store_bytes': 0,
                                         'spill_load_bytes': 0,
                                         'static_smem_bytes': 0},
  }


class _Compiled(Exception):
  pass


def _refuse_compiles(monkeypatch):
  def compile_again(*args, **kwargs):
    raise _Compiled
  monkeypatch.setattr(build.subprocess, 'Popen', compile_again)


def test_build_keeps_its_compile_log_beside_the_library(monkeypatch,
                                                         tmp_path):
  monkeypatch.setattr(build, 'BUILD_DIR', str(tmp_path))
  path = build.build(('hungarian',))['hungarian']
  log = build.log_path('hungarian')
  assert os.path.dirname(path) == os.path.dirname(log) == str(tmp_path)
  assert os.path.basename(log) == os.path.basename(path)[:-3] + '.log'
  assert os.path.exists(path) and os.path.exists(log)
  assert isinstance(build.compile_log('hungarian'), str)
  # A library whose log is there is not built again.
  _refuse_compiles(monkeypatch)
  assert build.build(('hungarian',))['hungarian'] == path


def test_a_library_without_its_log_is_built_again(monkeypatch, tmp_path):
  monkeypatch.setattr(build, 'BUILD_DIR', str(tmp_path))
  build.build(('hungarian',))
  os.unlink(build.log_path('hungarian'))
  _refuse_compiles(monkeypatch)
  with pytest.raises(_Compiled):
    build.build(('hungarian',))
