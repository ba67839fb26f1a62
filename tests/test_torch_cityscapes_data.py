"""The port's Cityscapes assembler and reader (``data/cityscapes.py``, no cv2
or h5py) against the JAX package's (``rec_attend_tpu/data/cityscapes.py``)
on chip_smoke.py's layout fixture, prepared by the port's
``cityscapes_prep``:

- the files both assemble, read with h5py and decoded: the same tree,
  labels, orientation, semantic masks and ``instance_semantic_classes``
  bit for bit, the cubic input within C.16's one level; ``gtFine`` and
  ``gtCoarse`` (``--coarse_label``), the ``train_extra`` split's folders,
  and an image whose ground-truth file is missing (a warning, no
  instances);
- ``Cityscapes.get_batch`` against JAX's on a JAX-written file whose
  examples carry a 'source' (the loss weights of train_extra), and each
  package reading the other's file;
- ``cli.setup_dataset --dataset cityscapes`` and ``data.provider``;
- the digest of the files of the full-size fixture (2048x1024, 8, 4 and 4
  images) that chip_smoke.py's cityscapes_pipeline phase gates on
  (CITYSCAPES_H5_DIGEST), for JAX's assembler and the port's, and the AP
  of the valid split's ground-truth pack it gates on (CITYSCAPES_GT_AP,
  the port's command lines on the CPU).
"""

import glob
import os
import shutil
import sys

import h5py
import numpy as np
import pytest
import torch

from rec_attend_tpu.data.cityscapes import Cityscapes as JCityscapes
from rec_attend_tpu.data.cityscapes import CityscapesAssembler as JAssembler
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.cli import setup_dataset
from rec_attend_tpu_torch.data import cityscapes_prep as prep
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.data.cityscapes import Cityscapes
from rec_attend_tpu_torch.data.cityscapes import CityscapesAssembler
from rec_attend_tpu_torch.utils import h5
from rec_attend_tpu_torch.utils import png

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
import chip_smoke as cs  # noqa: E402

OPT = {'height': 32, 'width': 64}
VARIABLES = {'x', 'y_gt', 'c_gt', 'd_gt', 's_gt', 'c_gt_idx', 'orig_size',
             'idx_map'}


def _coarse_and_extra(root):
  """gtCoarse for every train image, and a train_extra split of two of
  them (leftImg8bit_trainextra and gtCoarse/train_extra)."""
  for path in glob.glob(os.path.join(root, 'gtFine', 'train', '*', '*.json')):
    rel = os.path.relpath(path, os.path.join(root, 'gtFine'))
    for split_dir in ('train', 'train_extra'):
      dst = os.path.join(root, 'gtCoarse', rel.replace(
          'train', split_dir, 1).replace('gtFine', 'gtCoarse'))
      os.makedirs(os.path.dirname(dst), exist_ok=True)
      shutil.copyfile(path, dst)
  for path in glob.glob(os.path.join(root, 'leftImg8bit', 'train', '*',
                                     '*.png')):
    rel = os.path.relpath(path, os.path.join(root, 'leftImg8bit', 'train'))
    dst = os.path.join(root, 'leftImg8bit_trainextra', 'leftImg8bit',
                       'train_extra', rel)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copyfile(path, dst)


@pytest.fixture(scope='module')
def roots(tmp_path_factory):
  root = str(tmp_path_factory.mktemp('cs') / 'port')
  cs.cityscapes_fixture(root, {'train': 3, 'valid': 2, 'test': 2}, 128, 256,
                        7)
  _coarse_and_extra(root)
  prep.main(['--dataset', root])
  # One valid image without its ground truth.
  os.remove(sorted(glob.glob(os.path.join(
      root, 'gtFine', 'val', '*', '*_instanceIds.png')))[0])
  jroot = root[:-len('port')] + 'jax'
  shutil.copytree(root, jroot)
  return root, jroot


CASES = [('train', False), ('valid', False), ('test', False),
         ('train', True), ('train_extra', True)]


def _walk(g, out, prefix=''):
  for k in g:
    if isinstance(g[k], h5py.Group):
      _walk(g[k], out, f'{prefix}{k}/')
    else:
      out[f'{prefix}{k}'] = g[k][()]
  return out


def _decode(v):
  if isinstance(v, np.ndarray) and v.dtype == np.uint8 and v.ndim == 1 and \
      v[:4].tobytes() == b'\x89PNG':
    return png.decode(v, png.IMREAD_UNCHANGED)
  return v


@pytest.mark.parametrize('split,coarse', CASES)
def test_both_assemble_the_same_files(roots, split, coarse):
  root, jroot = roots
  name = f'{split}_{"coarse" if coarse else "fine"}.h5'
  CityscapesAssembler(root, OPT, split=split, coarse_label=coarse,
                      output_fname=os.path.join(root, name)).assemble()
  JAssembler(jroot, OPT, split=split, coarse_label=coarse,
             output_fname=os.path.join(jroot, name)).assemble()
  with h5py.File(os.path.join(root, name), 'r') as f, \
      h5py.File(os.path.join(jroot, name), 'r') as g:
    got, want = _walk(f, {}), _walk(g, {})
  assert sorted(got) == sorted(want)
  differ, classes = 0, 0
  for k, v in want.items():
    a, b = _decode(got[k]), _decode(v)
    if k.endswith('/input'):
      d = np.abs(a.astype(int) - b.astype(int))
      assert d.max() <= 1, k
      differ += int((d > 0).sum())
    elif k.endswith('instance_semantic_classes'):
      assert np.array_equal(np.asarray(a, np.int64), np.asarray(b, np.int64))
      classes += len(b)
    else:
      assert a.dtype == b.dtype and np.array_equal(a, b), k
  assert differ <= 2
  if split == 'valid':
    # The image without its ground-truth file: no instances.
    assert any(k.endswith('instance_semantic_classes') and not len(v)
               for k, v in want.items())
  if split != 'test':
    assert classes > 0
  else:
    assert classes == 0


def test_the_reader_is_jaxs_with_a_source(roots, tmp_path):
  """A JAX-written valid file whose examples carry a 'source': the port's
  batch and its loss weights are JAX's; an unknown source raises in
  both."""
  root, jroot = roots
  path = str(tmp_path / 'valid.h5')
  JAssembler(jroot, OPT, split='train', output_fname=path).assemble()
  with h5py.File(path, 'a') as f:
    ids = [i.decode() for i in f['index_map'][()]]
    for sid, src in zip(ids, ('train', 'train_extra', 'valid')):
      f[sid]['source'] = np.array([src.encode()])
  pds, jds = Cityscapes(path), JCityscapes(path)
  idx = np.arange(len(ids))
  got = pds.get_batch(idx, timespan=20, variables=VARIABLES)
  want = jds.get_batch(idx, timespan=20, variables=VARIABLES)
  assert sorted(got) == sorted(want)
  for k in want:
    if k in ('source', 'idx_map'):
      assert list(got[k]) == list(want[k])
    else:
      assert np.array_equal(got[k], want[k]), k
  assert got['sem_weights'].tolist() == [1.0, 0.1, 1.0]
  assert got['ori_weights'].tolist() == [1.0, 0.0, 1.0]
  assert pds.get_fname(ids[0]) == jds.get_fname(ids[0]) == (
      f'{ids[0]}_gtFine_instanceIds.png')
  assert (pds.get_num_semantic_classes(), pds.get_default_timespan()) == (
      8, 20)
  full = pds.get_full_size_labels(ids, timespan=20)
  for a, b in zip(full, jds.get_full_size_labels(ids, timespan=20)):
    assert np.array_equal(a, b)
  with h5py.File(path, 'a') as f:
    del f[ids[0]]['source']
    f[ids[0]]['source'] = np.array([b'coarse'])
  for ds in (Cityscapes(path), JCityscapes(path)):
    with pytest.raises(ValueError, match='coarse'):
      ds.get_batch(idx, timespan=20, variables=VARIABLES)


def test_setup_dataset_and_the_provider(roots, tmp_path):
  """The command line writes {split}_{H}x{W}.h5 that JAX reads to the
  port's batches; the provider finds it."""
  root = str(tmp_path / 'data')
  shutil.copytree(roots[0], root)
  out = setup_dataset.main(['--dataset', 'cityscapes', '--folder', root,
                            '--splits', 'train,valid,test', '--height', '32',
                            '--width', '64'])
  assert sorted(out) == ['test', 'train', 'valid']
  assert out['valid']['examples'] == 2 and out['test']['max_num_obj'] == 0
  cfg = C.data_config_for('cityscapes', root).replace(height=32, width=64)
  for split in out:
    ds = provider.get('cityscapes', cfg, split=split)
    assert isinstance(ds, Cityscapes) and ds.h5_fname == out[split]['path']
    idx = np.arange(ds.get_dataset_size())
    got = ds.get_batch(idx, timespan=20, variables=VARIABLES)
    want = JCityscapes(ds.h5_fname).get_batch(idx, timespan=20,
                                              variables=VARIABLES)
    for k in want:
      assert np.array_equal(got[k], want[k]) if k != 'idx_map' else (
          list(got[k]) == list(want[k])), k
  coarse = setup_dataset.main(['--dataset', 'cityscapes', '--folder', root,
                               '--splits', 'train_extra', '--coarse_label',
                               '--height', '32', '--width', '64'])
  assert coarse['train_extra']['examples'] == 3
  with h5py.File(coarse['train_extra']['path'], 'r') as f:
    assert len(f['index_map']) == 3


@pytest.fixture(scope='module')
def full_size(tmp_path_factory):
  """The fixture of chip_smoke.py's phase at 2048x1024, prepared and
  assembled by the port (cli.setup_dataset, 256x512) and by JAX's
  assembler."""
  base = tmp_path_factory.mktemp('cs_full')
  root = str(base / 'port')
  cs.cityscapes_fixture(root, **cs.CITYSCAPES_FIXTURE)
  prep.main(['--dataset', root])
  out = setup_dataset.main(['--dataset', 'cityscapes', '--folder', root,
                            '--splits', 'train,valid,test'])
  jroot = str(base / 'jax')
  os.makedirs(jroot)
  opt = {'height': 256, 'width': 512}
  jpaths = []
  for split in ('train', 'valid', 'test'):
    jpaths.append(os.path.join(jroot, f'{split}_256x512.h5'))
    JAssembler(root, opt, split=split, output_fname=jpaths[-1]).assemble()
  return root, [out[s]['path'] for s in ('train', 'valid', 'test')], jpaths


def test_the_full_size_files_have_the_pinned_digest(full_size):
  root, paths, jpaths = full_size
  assert cs.cityscapes_h5_digest(jpaths) == cs.CITYSCAPES_H5_DIGEST
  assert cs.cityscapes_h5_digest(paths) == cs.CITYSCAPES_H5_DIGEST
  assert cs.cityscapes_h5_digest(paths, permuted=True) != (
      cs.CITYSCAPES_H5_DIGEST)
  # The cubic input: C.16's one level, at this downscale (2048x1024 ->
  # 512x256, BGR noise) none.
  differ = 0
  for p, q in zip(paths, jpaths):
    got, want = h5.read(p), h5.read(q)
    for sid in want:
      if sid == 'index_map':
        continue
      a = png.decode(got[sid]['input'], png.IMREAD_UNCHANGED).astype(int)
      b = png.decode(want[sid]['input'], png.IMREAD_UNCHANGED).astype(int)
      assert np.abs(a - b).max() <= 1
      differ += int((a != b).sum())
  assert differ == 0


def test_the_ground_truth_packs_ap_is_pinned(full_size, tmp_path):
  """chip_smoke.py's AP gate: the valid split's ground truth packed as the
  full model's predictions, cli.cityscapes_eval.main at its defaults and
  instance_eval.main on the files, on the CPU."""
  root, paths, _ = full_size
  avg, _, timings = cs.cityscapes_gt_ap(torch, torch.device('cpu'),
                                        paths[1], root, str(tmp_path), 20)
  assert {k: avg[k] for k in cs.CITYSCAPES_GT_AP} == cs.CITYSCAPES_GT_AP
  assert len(timings['postprocess']) == 2
