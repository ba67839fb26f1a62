"""The port's numeric analyzers against the JAX package's.

Both do the same numpy arithmetic in the same dtypes on the same host
arrays, so every per-example value must be equal (not merely close), and
the CSV files that StatsAnalyzer and CountAnalyzer write must be equal byte
for byte.  The inputs are seeded random masks of per-image sizes, with an
image whose predictions are all empty, one whose ground truth is empty and
s_gt all zero, and one with more predictions than ground truth.
"""

import logging

import numpy as np
import pytest
import torch

from rec_attend_tpu import analysis as janalysis
from rec_attend_tpu_torch import analysis

torch.set_num_threads(1)

T = 6
SIZES = [(20, 24), (31, 17), (16, 16), (25, 30), (12, 40)]


def _blobs(rng, n, h, w):
  """[T, h, w] float32 masks: n random rectangles, the rest empty."""
  y = np.zeros((T, h, w), np.float32)
  for k in range(n):
    y0, x0 = rng.randint(0, h - 2), rng.randint(0, w - 2)
    y[k, y0:y0 + rng.randint(2, h // 2 + 2), x0:x0 + rng.randint(2, w // 2 + 2)] = 1
  return y


def _results(seed):
  rng = np.random.RandomState(seed)
  y_out, y_gt, s_gt = [], [], np.zeros((len(SIZES), T), np.float32)
  for i, (h, w) in enumerate(SIZES):
    n_gt = [3, 2, 0, 4, 1][i]
    n_out = [3, 0, 2, 5, 1][i]
    gt = _blobs(rng, n_gt, h, w).astype(np.float64)
    out = _blobs(rng, n_out, h, w)
    if i == 4:       # a prediction that overlaps its ground truth exactly
      out[0] = gt[0]
    y_gt.append(gt)
    y_out.append(out)
    s_gt[i, :n_gt] = 1
  return {'y_out': y_out, 'y_gt': y_gt,
          's_out': (rng.rand(len(SIZES), T) > 0.5).astype(np.float32),
          's_gt': s_gt,
          'iou_pairwise': [janalysis.f_iou_pairwise(a, b)
                           for a, b in zip(y_out, y_gt)],
          'indices': [f'img{i}' for i in range(len(SIZES))]}


def test_there_are_sixteen_metrics():
  assert sorted(analysis._ANALYZERS) == sorted(janalysis._ANALYZERS)
  assert len(analysis._ANALYZERS) == 16


@pytest.mark.parametrize('name', sorted(janalysis._ANALYZERS))
def test_metric_matches_jax(name):
  for seed in range(3):
    results = _results(seed)
    want = janalysis._ANALYZERS[name](results)
    got = analysis._ANALYZERS[name](results)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_iou_pairwise_matches_jax():
  results = _results(0)
  for a, b in zip(results['y_out'], results['y_gt']):
    np.testing.assert_array_equal(analysis.f_iou_pairwise(a, b),
                                  janalysis.f_iou_pairwise(a, b))


@pytest.mark.parametrize('background', [False, True])
def test_foreground_iou_analyzer_matches_jax(background):
  name = 'bg_iou_all' if background else 'fg_iou_all'
  got, want = analysis.create_analyzer(name), janalysis.create_analyzer(name)
  for seed in range(3):
    got.stage(_results(seed))
    want.stage(_results(seed))
  assert got.finalize() == want.finalize()


@pytest.mark.parametrize('name', ['sbd', 'count_acc', 'avg_pr', 'count'])
def test_csv_files_equal_jax(tmp_path, name):
  """StatsAnalyzer's ID,Score lines with Mean and Std, and CountAnalyzer's
  lines, over two staged batches."""
  files = {}
  for key, lib in (('port', analysis), ('jax', janalysis)):
    fname = str(tmp_path / key / f'{name}.csv')
    a = lib.create_analyzer(name, display_name=f'{name} 0.40', fname=fname)
    for seed in (0, 1):
      a.stage(_results(seed))
    a.finalize()
    with open(fname) as f:
      files[key] = f.read()
  assert files['port'] == files['jax']
  assert len(files['port'].splitlines()) > 2 * len(SIZES)


def test_stats_analyzer_logs_its_mean(caplog):
  a = analysis.create_analyzer('count_acc', display_name='count_acc 0.40')
  a.stage(_results(0))
  with caplog.at_level(logging.INFO, logger=analysis.__name__):
    mean, std = a.finalize()
  assert (a.mean, a.std) == (mean, std)
  assert 'count_acc 0.40' in caplog.text


def test_unknown_analyzer_raises():
  with pytest.raises(ValueError, match='not found'):
    analysis.create_analyzer('nope')


@pytest.mark.parametrize('dtypes', [(np.uint8, np.uint8),
                                    (np.float32, np.float32),
                                    (np.float32, np.float64)])
def test_overlaps_of_large_masks_match_jax_in_every_dtype(dtypes):
  """Areas past 255 and past 2^16: the matrix product's sums take the
  dtype of JAX's (uint64 for uint8 masks), so none wraps around."""
  rng = np.random.RandomState(7)
  a = (rng.rand(T, 300, 260) > 0.3).astype(dtypes[0])
  b = (rng.rand(T - 2, 300, 260) > 0.6).astype(dtypes[1])
  a[1] = 0
  got, want = analysis.f_iou_pairwise(a, b), janalysis.f_iou_pairwise(a, b)
  assert got.dtype == want.dtype
  np.testing.assert_array_equal(got, want)
  res = {'y_out': [a], 'y_gt': [b], 's_gt': np.ones((1, T - 2))}
  np.testing.assert_array_equal(analysis.f_symmetric_best_dice(res),
                                janalysis.f_symmetric_best_dice(res))
