"""The port's HDF5 codec (``rec_attend_tpu_torch/utils/h5.py``) on the
datasets' files: nested old-style groups, fixed-length strings, int64 and
uint8 datasets, against h5py, which is here only the reference.

1. What h5py writes with ``libver='earliest'`` (groups nested to depth 4,
   names sorted and not, thousands of members, ``|S`` strings, empty
   arrays) reads to h5py's objects, dtypes and bytes; so does the
   JAX-written synthetic split of ``tests/fixtures`` and a JAX
   ``make_synthetic_h5`` file of two classes.
2. What the port writes, and what ``h5.update`` rewrites (datasets added,
   replaced, in new and existing groups), h5py reads to the port's tree;
   h5py then appends to the port's file in mode 'a' (as the JAX package's
   ``pack_predictions`` does) and the port reads h5py's additions.
3. The rewrite is one file replaced whole: the old file's inode is never
   written, and a failed write leaves the old file as it was.
4. Chunked and filtered datasets, new-style groups and variable-length
   strings still raise ``H5FormatError``.
"""

import os
import tempfile

import h5py
import numpy as np
import pytest
from hypothesis import given
from hypothesis import settings
from hypothesis import strategies as st

from rec_attend_tpu.data.synthetic import make_synthetic_h5
from rec_attend_tpu_torch.utils import h5

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
JAX_FILE = os.path.join(REPO, 'tests', 'fixtures', 'synth_valid_64x64.h5')


def _h5py_tree(group):
  return {k: (_h5py_tree(v) if isinstance(v, h5py.Group)
              else np.asarray(v[()])) for k, v in group.items()}


def _assert_same(got, want, where='/'):
  assert sorted(got) == sorted(want), where
  for k, v in want.items():
    if isinstance(v, dict):
      assert isinstance(got[k], dict), (where, k)
      _assert_same(got[k], v, f'{where}{k}/')
    else:
      assert got[k].dtype == v.dtype and got[k].shape == v.shape, (where, k)
      assert got[k].tobytes() == v.tobytes(), (where, k)


def _h5py_write(path, tree, mode='w'):
  def put(group, sub):
    for k, v in sub.items():
      if isinstance(v, dict):
        put(group.require_group(k), v)
      else:
        group[k] = v
  with h5py.File(path, mode, libver='earliest') as f:
    put(f, tree)


def _tree(rng, depth, n):
  out = {}
  for i in range(n):
    kind = rng.randint(4)
    name = f'{rng.randint(1000):03d}_{i}'
    if kind == 0 and depth > 0:
      out[name] = _tree(rng, depth - 1, rng.randint(0, 6))
    elif kind == 1:
      out[name] = np.array([b'synth%04d' % rng.randint(10000)
                            for _ in range(rng.randint(1, 5))])
    elif kind == 2:
      out[name] = rng.randint(0, 256, rng.randint(0, 300)).astype(np.uint8)
    else:
      out[name] = rng.randint(-9, 9, rng.randint(0, 4)).astype(np.int64)
  return out


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), depth=st.integers(1, 4))
def test_nested_trees_round_trip_both_ways(seed, depth):
  rng = np.random.RandomState(seed)
  tree = _tree(rng, depth, rng.randint(1, 12))
  with tempfile.TemporaryDirectory() as root:
    a, b = os.path.join(root, 'a.h5'), os.path.join(root, 'b.h5')
    _h5py_write(a, tree)
    _assert_same(h5.read(a), tree)
    h5.write(b, tree)
    with h5py.File(b, 'r') as f:
      _assert_same(_h5py_tree(f), tree)


def test_large_groups_and_deep_paths(tmp_path):
  """3,000 members (a B-tree of two levels in h5py's file, of one over two
  nodes in the port's) and a path four groups deep."""
  tree = {'many': {f'{i:05d}': np.array([i], np.int64) for i in range(3000)},
          'a': {'b': {'c': {'d': np.arange(5, dtype=np.uint8)}}}}
  p = str(tmp_path / 'h5py.h5')
  _h5py_write(p, tree)
  with h5.File(p) as f:
    assert f['a/b/c/d'].tolist() == list(range(5))
    assert 'a/b/c/d' in f and 'a/b/x' not in f and 'a/b/c/d/e' not in f
    assert len(f['many']) == 3000 and f['many/02999'].tolist() == [2999]
    assert f['a/b'].name == '/a/b'
  q = str(tmp_path / 'port.h5')
  h5.write(q, tree)
  with h5py.File(q, 'r') as f:
    _assert_same(_h5py_tree(f), tree)


def test_jax_written_files_read_as_h5py_reads_them(tmp_path):
  with h5py.File(JAX_FILE, 'r') as f:
    want = _h5py_tree(f)
  got = h5.read(JAX_FILE)
  _assert_same(got, want)
  assert got['index_map'].dtype == np.dtype('S9')
  assert got['synth0000']['orig_size'].dtype == np.int64
  p = str(tmp_path / 'two_classes.h5')
  make_synthetic_h5(p, height=32, width=48, num_examples=4, seed=7,
                    num_semantic_classes=2)
  with h5py.File(p, 'r') as f:
    _assert_same(h5.read(p), _h5py_tree(f))


def test_updates_and_h5py_appends(tmp_path):
  p = str(tmp_path / 'f.h5')
  h5.write(p, h5.read(JAX_FILE))
  changes = {'synth0001': {'foreground_pred': {'00': np.arange(4, dtype='u1')},
                           'input': np.zeros(3, np.uint8),
                           'score_pred': np.ones(6, np.float32)},
             'new': {'deep': {'x': np.array([b'ab', b'c'])}}}
  h5.update(p, changes)
  want = h5.read(JAX_FILE)
  want['synth0001'].update(changes['synth0001'])
  want['new'] = changes['new']
  with h5py.File(p, 'r') as f:
    _assert_same(_h5py_tree(f), want)
  # h5py appends to the port's file as JAX's pack_predictions does: deletes
  # and adds datasets in mode 'a'; the port reads what it wrote.
  with h5py.File(p, 'a') as f:
    group = f['synth0002']
    for i in range(12):
      group[f'instance_pred/{i:02d}'] = np.full(5, i, np.uint8)
    del group['input']
    group['input'] = np.arange(9, dtype=np.uint8)
    want = _h5py_tree(f)
  _assert_same(h5.read(p), want)
  # And the port rewrites h5py's edit.
  h5.update(p, {'synth0002': {'instance_pred': {'00': np.zeros(1, 'u1')}}})
  want['synth0002']['instance_pred']['00'] = np.zeros(1, 'u1')
  with h5py.File(p, 'r') as f:
    _assert_same(_h5py_tree(f), want)


def test_rewrites_replace_the_file_whole(tmp_path):
  p = str(tmp_path / 'f.h5')
  h5.write(p, {'a': np.arange(3)})
  inode = os.stat(p).st_ino
  with h5.File(p) as reader:                # a reader of the old file
    h5.update(p, {'b': np.arange(4)})
    assert reader['a'].tolist() == [0, 1, 2] and 'b' not in reader
  assert os.stat(p).st_ino != inode
  assert sorted(h5.read(p)) == ['a', 'b']
  with pytest.raises(h5.H5FormatError, match='bool'):
    h5.update(p, {'c': np.zeros(2, bool)})
  assert sorted(h5.read(p)) == ['a', 'b']
  assert sorted(os.listdir(tmp_path)) == ['f.h5']


def _raises(path, feature):
  with pytest.raises(h5.H5FormatError) as e:
    h5.read(path)
  assert path in str(e.value) and feature in str(e.value)


def test_what_the_codec_still_does_not_read_raises(tmp_path):
  p = str(tmp_path / 'chunked.h5')
  with h5py.File(p, 'w', libver='earliest') as f:
    f.create_dataset('g/a', data=np.zeros((4, 4), 'u1'), chunks=(2, 2))
  _raises(p, 'chunked')
  p = str(tmp_path / 'gzip.h5')
  with h5py.File(p, 'w', libver='earliest') as f:
    f.create_dataset('g/h/a', data=np.zeros(40, 'u1'), compression='gzip')
  _raises(p, 'filtered')
  p = str(tmp_path / 'vlen.h5')
  with h5py.File(p, 'w', libver='earliest') as f:
    f['g/s'] = ['a', 'bc']
  _raises(p, 'variable-length')
  # A group that tracks creation order is a new-style group, its object
  # header of version 2.
  p = str(tmp_path / 'new_style.h5')
  with h5py.File(p, 'w', libver='earliest') as f:
    f.create_group('g', track_order=True)['a'] = np.zeros(2, 'u1')
  _raises(p, 'object header version 2')
