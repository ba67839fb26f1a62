"""The port's Cityscapes eval command line (``cli/cityscapes_eval.main``) and
the official AP on files (``eval_cityscapes/instance_eval``: the file
finders and ``main``) against the JAX package's, on one packed H5 file, as
``tests/test_cityscapes_eval_cli.py`` builds it: chip_smoke.py's
Cityscapes fixture (four valid images at 128x256), assembled by the JAX
package at 32x64 and packed by its ``pack_predictions`` with the ground
truth's instances, semantic maps and seeded scores, so that both read the
same bytes.  Each command line writes its own folder; compared:

- the analyzers' CSVs to 1e-6, ``count.csv`` equal;
- each submission text file's lines: file and label equal, score to 1e-5;
- every mask, instance render and ground-truth render PNG decoded equal;
- one threshold and a sweep (``{name}_NN.csv``, ``cityscapes/NN/``),
  ``--split_id``/``--num_split`` shards, ``--no_iou``, ``--render_gt``,
  and ``--lrr_seg`` with ``.mat`` files written by ``scipy.io.savemat``;
- ``instance_eval.main`` on both submissions against the fixture's gtFine,
  with and without ``--use_distance`` (disparity and camera files written
  beside them).
"""

import csv
import glob
import json
import os
import sys

import cv2
import h5py
import numpy as np
import pytest
import torch
import yaml

from rec_attend_tpu import config as JC
from rec_attend_tpu.cli import cityscapes_eval as jcs
from rec_attend_tpu.data.cityscapes import Cityscapes as JCityscapes
from rec_attend_tpu.data.cityscapes import CityscapesAssembler as JAssembler
from rec_attend_tpu.data.dataset import pack_predictions
from rec_attend_tpu.eval_cityscapes import instance_eval as jie
from rec_attend_tpu_torch.cli import cityscapes_eval as pcs
from rec_attend_tpu_torch.data import cityscapes_prep as prep
from rec_attend_tpu_torch.eval_cityscapes import instance_eval as pie

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
import chip_smoke as cs  # noqa: E402

T = 20
H, W = 32, 64


@pytest.fixture(scope='module')
def packed(tmp_path_factory):
  tmp = tmp_path_factory.mktemp('cseval_cli')
  root = str(tmp / 'cityscapes')
  cs.cityscapes_fixture(root, {'valid': 4}, 128, 256, 11)
  prep.main(['--dataset', root])
  folder = str(tmp / 'data')
  os.makedirs(folder)
  path = os.path.join(folder, f'valid_{H}x{W}.h5')
  JAssembler(root, {'height': H, 'width': W}, split='valid',
             output_fname=path).assemble()
  ds = JCityscapes(path)
  rng = np.random.RandomState(0)
  for pos in range(ds.get_dataset_size()):
    b = ds.get_batch([pos], timespan=T, variables={'y_gt', 'c_gt', 's_gt',
                                                   'idx_map'})
    ori = np.zeros((H, W, 8), 'float32')
    ori[..., 0] = 1.0
    inst = np.clip(b['y_gt'][0] * 0.9 + rng.uniform(0, 0.2, (T, H, W)), 0, 1)
    pack_predictions(path, ds.get_str_id(b['idx_map'][0]),
                     foreground=b['c_gt'][0], orientation=ori,
                     instance=inst,
                     score=b['s_gt'][0] * rng.uniform(0.3, 1.0, T))
  results = str(tmp / 'results')
  os.makedirs(os.path.join(results, 'packed_model'))
  cfg = JC.DataConfig(dataset='cityscapes', folder=folder, height=H,
                      width=W, timespan=T)
  with open(os.path.join(results, 'packed_model', 'data_opt.yaml'),
            'w') as f:
    yaml.safe_dump(cfg.to_dict(), f)
  return {'tmp': str(tmp), 'root': root, 'results': results, 'h5': path,
          'ids': [i.decode() if isinstance(i, bytes) else str(i)
                  for i in ds.img_ids]}


def _run(packed, name, *extra):
  """Both command lines with the same flags, each into its own folder."""
  out = {}
  for who, main in (('port', lambda a: pcs.main(a, device='cpu')),
                    ('jax', jcs.main)):
    out[who] = os.path.join(packed['tmp'], f'{name}_{who}')
    main(['--model_id', 'packed_model', '--results', packed['results'],
          '--split', 'valid', '--output', out[who], '--remove_tiny', '20']
         + list(extra))
  return out['port'], out['jax']


def _files(folder):
  return sorted(os.path.relpath(p, folder) for p in glob.glob(
      os.path.join(folder, '**', '*'), recursive=True) if os.path.isfile(p))


def _csv_rows(path):
  with open(path) as f:
    return list(csv.reader(f))


def _same_outputs(got, want):
  """The same files; CSV numbers to 1e-6, count.csv equal, text lines'
  file and label equal and score to 1e-5, PNGs decoded equal.  Returns
  the submission's lines."""
  assert _files(got) == _files(want) and _files(want)
  lines = 0
  for rel in _files(want):
    a, b = os.path.join(got, rel), os.path.join(want, rel)
    if rel.endswith('.png'):
      x, y = cv2.imread(a, -1), cv2.imread(b, -1)
      assert x.dtype == y.dtype and np.array_equal(x, y), rel
    elif rel.endswith('count.csv'):
      assert _csv_rows(a) == _csv_rows(b), rel
    elif rel.endswith('.csv'):
      ra, rb = _csv_rows(a), _csv_rows(b)
      assert len(ra) == len(rb) and ra[0] == rb[0], rel
      for u, v in zip(ra[1:], rb[1:]):
        assert u[0] == v[0]
        np.testing.assert_allclose([float(t) for t in u[1:]],
                                   [float(t) for t in v[1:]], atol=1e-6)
    else:
      with open(a) as f, open(b) as g:
        la, lb = f.read().splitlines(), g.read().splitlines()
      assert len(la) == len(lb), rel
      for u, v in zip(la, lb):
        u, v = u.split(), v.split()
        assert u[:2] == v[:2]
        assert abs(float(u[2]) - float(v[2])) <= 1e-5
      lines += len(la)
  return lines


def test_one_threshold_writes_jaxs_files(packed):
  got, want = _run(packed, 'one')
  assert _same_outputs(got, want) > 0
  assert os.path.exists(os.path.join(got, 'sbd.csv'))
  assert os.path.exists(os.path.join(got, '60', 'count.csv'))
  txts = glob.glob(os.path.join(got, 'cityscapes', '*', '*.txt'))
  assert len(txts) == len(packed['ids'])
  labels = {int(line.split()[1]) for t in txts for line in open(t)}
  assert labels <= {24, 25, 26, 27, 28, 31, 32, 33} and len(labels) > 1
  for t in txts:
    for line in open(t):
      mask = cv2.imread(os.path.join(os.path.dirname(t), line.split()[0]),
                        -1)
      assert mask.shape == (128, 256) and set(np.unique(mask)) <= {0, 255}


def test_a_sweep_and_the_ground_truth_render(packed):
  got, want = _run(packed, 'sweep', '--threshold_list', '0.5,0.7',
                   '--analyzers', 'sbd,wt_cov,unwt_cov,count',
                   '--render_gt')
  _same_outputs(got, want)
  for rel in ('sbd_50.csv', 'unwt_cov_70.csv', 'cityscapes/50',
              'cityscapes/70', '50/count.csv', 'gt'):
    assert os.path.exists(os.path.join(got, rel)), rel
  assert len(glob.glob(os.path.join(got, 'gt', '*.png'))) == len(
      packed['ids'])


def test_shards_and_no_iou(packed):
  seen = []
  for split_id in (0, 1, 2):
    got, want = _run(packed, f'shard{split_id}', '--split_id', str(split_id),
                     '--num_split', '3', '--no_iou', '--analyzers', '')
    _same_outputs(got, want)
    seen += [os.path.basename(p) for p in glob.glob(
        os.path.join(got, 'cityscapes', '*', '*.txt'))]
  assert sorted(seen) == sorted(f'{i}_gtFine_instanceIds.txt'
                                for i in packed['ids'])


def test_the_lrr_foreground(packed):
  """External LRR segmentations, one .mat an image, from the fixture's
  labelIds: person and car as LRR's ids."""
  import scipy.io
  lrr = os.path.join(packed['tmp'], 'lrr')
  to_lrr = {24: pcs.LRR_SEM_IDS[0], 26: pcs.LRR_SEM_IDS[2]}
  for p in glob.glob(os.path.join(packed['root'], 'gtFine', 'val', '*',
                                  '*_labelIds.png')):
    labels = cv2.imread(p, -1)
    sem = np.zeros(labels.shape, np.uint8)
    for k, v in to_lrr.items():
      sem[labels == k] = v
    idx = os.path.basename(p)[:-len('_gtFine_labelIds.png')]
    out = os.path.join(lrr, 'val', idx.split('_')[0])
    os.makedirs(out, exist_ok=True)
    scipy.io.savemat(os.path.join(out, f'{idx}_ss.mat'),
                     {'semanticPrediction': sem})
  got, want = _run(packed, 'lrr', '--lrr_seg', '--lrr_folder', lrr)
  assert _same_outputs(got, want) > 0
  fg = pcs.read_foreground_lrr(lrr, 'valid', packed['ids'][0])
  assert np.array_equal(fg, jcs.read_foreground_lrr(lrr, 'valid',
                                                    packed['ids'][0]))
  assert fg.shape == (128, 256, 9)


def _disparity_and_camera(root):
  rng = np.random.RandomState(1)
  for p in glob.glob(os.path.join(root, 'gtFine', 'val', '*',
                                  '*_instanceIds.png')):
    stem = '_'.join(os.path.basename(p).split('_')[:3])
    city = stem.split('_')[0]
    for kind in ('disparity', 'camera'):
      os.makedirs(os.path.join(root, kind, 'val', city), exist_ok=True)
    disp = rng.randint(0, 30000, (128, 256)).astype(np.uint16)
    disp[:, :40] = 0
    cv2.imwrite(os.path.join(root, 'disparity', 'val', city,
                             f'{stem}_disparity.png'), disp)
    with open(os.path.join(root, 'camera', 'val', city,
                           f'{stem}_camera.json'), 'w') as f:
      json.dump({'extrinsic': {'baseline': 0.2 + rng.rand() * 0.02},
                 'intrinsic': {'fx': 2200.0 + rng.rand() * 100}}, f)


@pytest.mark.parametrize('distance', [False, True])
def test_the_ap_on_files_is_jaxs(packed, distance, tmp_path):
  got, want = _run(packed, f'ap{int(distance)}')
  root = packed['root']
  if distance:
    _disparity_and_camera(root)
  flags = ['--dataset', root, '--split', 'val'] + (
      ['--use_distance'] if distance else [])
  for sub in (got, want):
    pred = os.path.join(sub, 'cityscapes')
    export = str(tmp_path / f'{os.path.basename(sub)}.json')
    p = pie.main(['--predictions', pred, '--export', export] + flags)
    j = jie.main(['--predictions', pred] + flags)
    np.testing.assert_equal(p, j)    # NaN where a class has no instance
    assert ('allAp100m' in p) == distance
    with open(export) as f:
      np.testing.assert_equal(json.load(f)['averages'], p)
    assert p['allAp'] > 0
  gt = pie.find_gt_files(root, 'val')
  assert gt == jie.find_gt_files(root, 'val') and len(gt) == 4
  assert [pie.find_side_file(g, root, 'val', 'camera', 'json')
          for g in gt] == [jie.find_side_file(g, root, 'val', 'camera',
                                              'json') for g in gt]
  with pytest.raises(FileNotFoundError, match='no prediction'):
    pie.find_prediction_file(gt[0], str(tmp_path))
  bad = tmp_path / 'bad.txt'
  bad.write_text('a.png 26\n')
  with pytest.raises(ValueError, match='Invalid prediction line'):
    pie.read_pred_info(str(bad))


def test_the_command_line_takes_the_packed_h5_of_the_model(packed):
  """Without --output: {results}/{model_id}/output_{split}, from the
  model's data_opt.yaml; the returned summary holds the analyzers'
  means."""
  out = pcs.main(['--model_id', 'packed_model', '--results',
                  packed['results'], '--split', 'valid', '--remove_tiny',
                  '20', '--batch_size', '3'], device='cpu')
  summary, folder = out['valid']
  assert folder == os.path.join(packed['results'], 'packed_model',
                                'output_valid')
  assert sorted(summary[0.6]) == ['sbd 0.60', 'unwt_cov 0.60',
                                  'wt_cov 0.60']
  with h5py.File(packed['h5'], 'r') as f:
    assert 'instance_pred' in f[packed['ids'][0]]
