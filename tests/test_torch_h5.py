"""The port's HDF5 codec (``rec_attend_tpu_torch/utils/h5.py``) against
h5py, which is here only the reference.

1. The codec reads the four committed box ``weights.h5`` files to h5py's
   names, shapes, dtypes and bits.
2. Round trips, bit for bit (the arrays' bytes, NaN payloads and -0.0
   included): what the port writes h5py reads, and what h5py writes with
   ``libver='earliest'`` the port reads, over names, ranks 0-4 (empty
   dimensions too) and float32, float64, int32 and uint8 (hypothesis);
   root B-trees of more than one level (h5py's of two at 5,000 names; the
   port's of one over two nodes at 300); object header continuations.
3. What the codec does not read raises, naming the file and the feature:
   chunked and compressed datasets, asked-for attributes, nested groups,
   strings, big-endian data, a file that is no HDF5.
4. ``chip_smoke.py``'s committed-file gates (phase weights_h5 (a)) on the
   CPU: each passes and each control fails.
"""

import os
import sys
import tempfile

import h5py
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck
from hypothesis import given
from hypothesis import settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from rec_attend_tpu_torch.utils import h5

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

COMMITTED = sorted(
    os.path.join('results', d, 'weights.h5')
    for d in ('box_model_synth-20260816104712',
              'box_model_synth3-20260816192111',
              'box_model_synth3-20260818a', 'box_model_synthcs-20260818a'))


def _h5py_read(path):
  with h5py.File(path, 'r') as f:
    return {k: np.asarray(f[k][()]) for k in f.keys()}


def _assert_same(got, want):
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
    assert got[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize('rel', COMMITTED)
def test_committed_files_read_as_h5py_reads_them(rel):
  path = os.path.join(REPO, rel)
  got = h5.read(path)
  _assert_same(got, _h5py_read(path))
  assert len(got) in (676, 708)
  assert {v.dtype for v in got.values()} == {np.dtype('<f4')}
  with h5.File(path) as f:
    assert f.keys() == sorted(got)
    assert 'ctrl_cnn_w_0' in f and 'nothing' not in f
    assert f['ctrl_lstm_w_xi'].tobytes() == got['ctrl_lstm_w_xi'].tobytes()
    assert f.attrs('ctrl_cnn_w_0') == {}
    with pytest.raises(KeyError):
      f['nothing']


NAMES = st.text('abcdefghijklmnopqrstuvwxyzABC0123456789_', min_size=1,
                max_size=24)
ARRAYS = st.sampled_from(['<f4', '<f8', '<i4', '|u1']).flatmap(
    lambda dt: hnp.arrays(dt, hnp.array_shapes(min_dims=0, max_dims=4,
                                               min_side=0, max_side=3)))
FILES = st.dictionaries(NAMES, ARRAYS, min_size=0, max_size=40)
SETTINGS = settings(max_examples=25, deadline=None, database=None,
                    suppress_health_check=[HealthCheck.too_slow])


@SETTINGS
@given(FILES)
def test_the_port_writes_what_h5py_reads(arrays):
  with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, 'w.h5')
    h5.write(path, arrays)
    _assert_same(_h5py_read(path), arrays)
    _assert_same(h5.read(path), arrays)


@SETTINGS
@given(FILES)
def test_the_port_reads_what_h5py_writes(arrays):
  with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, 'w.h5')
    with h5py.File(path, 'w', libver='earliest') as f:
      for k, v in arrays.items():
        f[k] = v
    _assert_same(h5.read(path), arrays)


def _root_btree_level(path):
  with h5.File(path) as f:
    root = f._off(f._read(56, 40), 8)
    stab = [b for t, _, b in f._messages(root) if t == h5.SYMBOL_TABLE][0]
    return f._read(f._off(stab, 0), 8)[5]


def test_btrees_of_more_levels(tmp_path):
  """h5py's root B-tree reaches level 2 at 5,000 names; the port's level 1
  at 300 (38 symbol table nodes of 8 names, two B-tree nodes of 32)."""
  arrays = {f'k{i}': np.float32(i) for i in range(5000)}
  path = str(tmp_path / 'h5py.h5')
  with h5py.File(path, 'w', libver='earliest') as f:
    for k, v in arrays.items():
      f[k] = v
  assert _root_btree_level(path) == 2
  _assert_same(h5.read(path), {k: np.asarray(v) for k, v in arrays.items()})
  small = {f'n{i}': np.full((2, i % 3), i, np.float64) for i in range(300)}
  path = str(tmp_path / 'port.h5')
  h5.write(path, small)
  assert _root_btree_level(path) == 1
  _assert_same(_h5py_read(path), small)
  _assert_same(h5.read(path), small)


def test_continuation_messages_and_deleted_attributes(tmp_path):
  """Attributes added, and half of them deleted, leave the dataset's
  header in three blocks (two continuation messages) with a NIL message;
  the data reads the same, the attributes are not read."""
  path = str(tmp_path / 'cont.h5')
  data = np.arange(12, dtype='<f4').reshape(3, 4)
  with h5py.File(path, 'w', libver='earliest') as f:
    f['a'] = data
    for i in range(12):
      f['a'].attrs[f'attr{i}'] = np.zeros(40)
    for i in range(6):
      del f['a'].attrs[f'attr{i}']
  with h5.File(path) as f:
    raw = [t for t, _ in _raw_messages(f, 'a')]
    assert raw.count(h5.CONTINUATION) == 2 and h5.NIL in raw
    np.testing.assert_array_equal(f['a'], data)
    with pytest.raises(h5.H5FormatError, match='attributes'):
      f.attrs('a')


def _raw_messages(f, name):
  """(type, size) of every message of the first header block, NIL and
  continuation included."""
  addr = f._entries[name]
  head = f._read(addr, 16)
  size = int.from_bytes(head[8:12], 'little')
  b = f._read(addr + 16, size)
  out, p = [], 0
  while p + 8 <= size:
    t, n = int.from_bytes(b[p:p + 2], 'little'), int.from_bytes(
        b[p + 2:p + 4], 'little')
    out.append((t, n))
    p += 8 + n
  return out


def _raises(path, feature, read=h5.read):
  with pytest.raises(h5.H5FormatError) as e:
    read(path)
  assert path in str(e.value) and feature in str(e.value)


def test_what_the_codec_does_not_read_raises(tmp_path):
  p = str(tmp_path / 'chunked.h5')
  with h5py.File(p, 'w', libver='earliest') as f:
    f.create_dataset('a', data=np.zeros((4, 4), 'f4'), chunks=(2, 2))
  _raises(p, 'chunked')
  p = str(tmp_path / 'gzip.h5')
  with h5py.File(p, 'w', libver='earliest') as f:
    f.create_dataset('a', data=np.zeros((4, 4), 'f4'), compression='gzip')
  _raises(p, 'filtered')
  p = str(tmp_path / 'group.h5')
  with h5py.File(p, 'w', libver='earliest') as f:
    f['g/a'] = np.zeros(3, 'f4')
  _raises(p, 'nested group')
  p = str(tmp_path / 'string.h5')
  with h5py.File(p, 'w', libver='earliest') as f:
    f['s'] = np.bytes_('text')
  _raises(p, 'string')
  p = str(tmp_path / 'big.h5')
  with h5py.File(p, 'w', libver='earliest') as f:
    f['a'] = np.arange(3, dtype='>f4')
  _raises(p, 'big-endian')
  p = str(tmp_path / 'attrs.h5')
  with h5py.File(p, 'w', libver='earliest') as f:
    f['a'] = np.zeros(3, 'f4')
    f['a'].attrs['unit'] = 1.0
  np.testing.assert_array_equal(h5.read(p)['a'], np.zeros(3, 'f4'))
  _raises(p, 'attributes', lambda path: h5.File(path).attrs('a'))
  p = str(tmp_path / 'latest.h5')
  with h5py.File(p, 'w', libver='latest') as f:
    f['a'] = np.zeros(3, 'f4')
  _raises(p, 'superblock version')
  p = str(tmp_path / 'ckpt.npz')
  np.savez(p, a=np.zeros(3))
  _raises(p, 'HDF5 signature')
  with pytest.raises(h5.H5FormatError, match='bool'):
    h5.write(str(tmp_path / 'bool.h5'), {'a': np.zeros(3, bool)})
  with pytest.raises(h5.H5FormatError, match='name'):
    h5.write(str(tmp_path / 'slash.h5'), {'a/b': np.zeros(3, 'f4')})


def test_chip_smoke_committed_weights_gates_on_cpu(tmp_path):
  failures = []
  out = cs.committed_weights_gates(failures, str(tmp_path))
  assert failures == []
  assert out['flagship_box_keys'] == 708
  assert out['synth3_box']['keys'] == out['synthcs_box']['keys'] == 676
  for name in ('flagship_box', 'synth3_box', 'synthcs_box'):
    assert out[name]['failures'] == [] and out[name]['control_failures']
  assert out['flagship_box']['control_failures'] == ['ctrl_cnn_w_0']
