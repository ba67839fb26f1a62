"""Streaming metric analyzers of instance segmentation, numpy only.

Counterpart of ``rec_attend_tpu/analysis.py:34-410``: the scoring
primitives, the 16 per-example metrics of ``_ANALYZERS`` and the analyzers
that stream them, ``create_analyzer`` included, over a results dict with
keys

  y_out, y_gt  - lists of [T, H, W] binary masks (sizes vary per image)
  s_out, s_gt  - [B, T] scores
  iou_pairwise - list of [T, T] prediction x GT IoU matrices
  indices      - image ids

They read host arrays and do the JAX package's numpy arithmetic in the same
dtypes, so their per-example values, and the ``%.4f`` CSVs that
``StatsAnalyzer`` and ``CountAnalyzer`` write, are the JAX package's on the
same inputs.  The renderers (``analysis.py:413-546``) write PNGs with cv2
and are not ported.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from rec_attend_tpu_torch.ops.hungarian import hungarian


# ---------------------------------------------------------------------------
# Numpy scoring primitives (ref analysis.py:300-388)
# ---------------------------------------------------------------------------

def f_iou(a, b):
  inter = (a * b).sum(axis=-1).sum(axis=-1)
  union = (a + b).sum(axis=-1).sum(axis=-1) - inter
  return inter / (union + np.equal(union, 0).astype('float32'))


def f_iou_pairwise(a, b):
  """[T, H, W] x [T', H, W] -> [T, T']."""
  return f_iou(np.expand_dims(a, 1), np.expand_dims(b, 0))


def _f_pr(a, b):
  inter = (a * b).sum(axis=-1).sum(axis=-1)
  asum = a.sum(axis=-1).sum(axis=-1)
  return inter / (asum + np.equal(asum, 0).astype('float32'))


def _f_dice(a, b):
  card_a = a.sum(axis=-1).sum(axis=-1)
  card_b = b.sum(axis=-1).sum(axis=-1)
  card_ab = (a * b).sum(axis=-1).sum(axis=-1)
  card_sum = card_a + card_b
  return 2 * card_ab / (card_sum + np.equal(card_sum, 0).astype('float32'))


def _f_best_dice(a, b):
  bd = np.zeros([a.shape[0]])
  for ii in range(a.shape[0]):
    bd[ii] = _f_dice(a[ii:ii + 1], b).max(axis=0)
  return bd


def f_count_out(y_out):
  return np.array([(_y.sum(axis=-1).sum(axis=-1) > 0).astype('float32')
                   for _y in y_out])


def _f_num_obj(s_gt):
  return np.maximum(s_gt.sum(axis=1), 1)


# ---------------------------------------------------------------------------
# Metric functions over the results dict (ref analysis.py:404-787)
# ---------------------------------------------------------------------------

def f_symmetric_best_dice(results):
  """SBD = min(BestDice(pred->gt), BestDice(gt->pred)), averaged over the
  first num_obj GT slots (ref analysis.py:434-460)."""
  y_out, y_gt = results['y_out'], results['y_gt']
  num_obj = _f_num_obj(results['s_gt'])

  def f_bd(a, b):
    num_ex = len(a)
    bd_mean = np.zeros([num_ex])
    for ii in range(num_ex):
      bd = _f_best_dice(a[ii], b[ii])
      bd_mean[ii] = bd[:int(num_obj[ii])].mean()
    return bd_mean

  return np.minimum(f_bd(y_out, y_gt), f_bd(y_gt, y_out))


def f_ins_iou(results):
  """Average instance IoU under Hungarian matching (ref analysis.py:404-431),
  solved by the port's host solver, which picks the JAX package's native
  solver's matching, ties included."""
  y_gt = results['y_gt']
  num_obj = _f_num_obj(results['s_gt'])
  num_ex = len(y_gt)
  out = np.zeros([num_ex])
  for ii in range(num_ex):
    iou_pw = results['iou_pairwise'][ii]
    iou_pw = np.maximum(1e-4, iou_pw)
    iou_pw = np.round(iou_pw * 1e4) / 1e4
    match, _, _, _ = hungarian(iou_pw.astype('float32'))
    n = int(num_obj[ii])
    match[n:, :] = 0.0
    match[:, n:] = 0.0
    out[ii] = (iou_pw * match).sum() / n
  return out


def _f_coverage(results, weighted=False):
  y_gt = results['y_gt']
  num_obj = _f_num_obj(results['s_gt'])
  num_ex = len(y_gt)
  cov = np.array([iou_.max(axis=0) for iou_ in results['iou_pairwise']])
  timespan = y_gt[0].shape[0]
  weights = np.zeros([num_ex, timespan])
  for ii in range(num_ex):
    if weighted:
      y_gt_sum = y_gt[ii].sum()
      weights[ii] = (y_gt[ii].sum(axis=-1).sum(axis=-1) /
                     (y_gt_sum + np.equal(y_gt_sum, 0).astype('float32')))
    else:
      weights[ii] = 1 / num_obj[ii]
  cov = cov * weights
  return np.array([cov[ii, :int(num_obj[ii])].sum() for ii in range(num_ex)])


def f_wt_coverage(results):
  return _f_coverage(results, weighted=True)


def f_unwt_coverage(results):
  return _f_coverage(results, weighted=False)


def f_fg_iou(results):
  y_out, y_gt = results['y_out'], results['y_gt']
  out = np.zeros([len(y_gt)])
  for ii in range(len(y_gt)):
    a, b = y_out[ii], y_gt[ii]
    if a.ndim == 3:
      a, b = a.max(axis=0), b.max(axis=0)
    out[ii] = f_iou(a, b)
  return out


def f_fg_dice(results):
  y_out, y_gt = results['y_out'], results['y_gt']
  out = np.zeros([len(y_gt)])
  for ii in range(len(y_gt)):
    a, b = y_out[ii], y_gt[ii]
    if a.ndim == 3:
      a, b = a.max(axis=0), b.max(axis=0)
    out[ii] = _f_dice(a, b)
  return out


def f_fp(results):
  """False positives: nonempty predictions with zero IoU against all GT."""
  y_out = results['y_out']
  num_ex = len(y_out)
  fp = np.zeros([num_ex])
  for ii in range(num_ex):
    y_out_sum = (y_out[ii].sum(axis=-1).sum(axis=-1) > 0).astype('float32')
    unmatch = np.equal(results['iou_pairwise'][ii].sum(axis=1),
                       0).astype('float32')
    fp[ii] = (y_out_sum * unmatch).sum()
  return fp


def f_fn(results):
  """False negatives: GT instances with zero IoU against all predictions."""
  s_gt = results['s_gt']
  num_ex = s_gt.shape[0]
  fn = np.zeros([num_ex])
  for ii in range(num_ex):
    unmatch = np.equal(results['iou_pairwise'][ii].sum(axis=0),
                       0).astype('float32')
    fn[ii] = (s_gt[ii] * unmatch).sum()
  return fn


def f_pixel_pr(results):
  y_out, y_gt = results['y_out'], results['y_gt']
  count_out = f_count_out(y_out)
  vals = []
  for ii in range(len(y_gt)):
    y_gt_sum = y_gt[ii].max(axis=0, keepdims=True)
    pr = _f_pr(y_out[ii], y_gt_sum)
    for jj in range(y_gt[ii].shape[0]):
      if count_out[ii, jj] > 0:
        vals.append(pr[jj])
  return np.array(vals) if vals else np.zeros([0])


def f_pixel_re(results):
  y_out, y_gt = results['y_out'], results['y_gt']
  count_gt = results['s_gt'].sum(axis=1)
  vals = []
  for ii in range(len(y_gt)):
    y_out_sum = y_out[ii].max(axis=0, keepdims=True)
    re = _f_pr(y_gt[ii], y_out_sum)
    for jj in range(int(count_gt[ii])):
      vals.append(re[jj])
  return np.array(vals) if vals else np.zeros([0])


def f_obj_pr(results):
  y_out = results['y_out']
  count_out = f_count_out(y_out)
  vals = []
  for ii in range(len(y_out)):
    matched = (results['iou_pairwise'][ii].max(axis=1) >=
               0.5).astype('float32')
    for jj in range(y_out[ii].shape[0]):
      if count_out[ii, jj] > 0:
        vals.append(matched[jj])
  return np.array(vals) if vals else np.zeros([0])


def f_obj_re(results):
  count_gt = results['s_gt'].sum(axis=1)
  vals = []
  for ii in range(len(results['y_gt'])):
    matched = (results['iou_pairwise'][ii].max(axis=0) >=
               0.5).astype('float32')
    for jj in range(int(count_gt[ii])):
      vals.append(matched[jj])
  return np.array(vals) if vals else np.zeros([0])


def f_count_acc(results):
  count_out = f_count_out(results['y_out']).sum(axis=1)
  count_gt = results['s_gt'].sum(axis=1)
  return (count_out == count_gt).astype('float')


def f_count_mse(results):
  count_out = f_count_out(results['y_out']).sum(axis=1)
  count_gt = results['s_gt'].sum(axis=1)
  return (count_out - count_gt).astype('float') ** 2


def f_dic(results):
  count_out = f_count_out(results['y_out']).sum(axis=1)
  count_gt = results['s_gt'].sum(axis=1)
  return count_out - count_gt


def f_dic_abs(results):
  return np.abs(f_dic(results))


# ---------------------------------------------------------------------------
# Analyzer framework (ref analysis.py:52-64, 790-906)
# ---------------------------------------------------------------------------

class AnalyzerBase:

  def __init__(self, name):
    self.name = name
    self.log = logging.getLogger(__name__)

  def stage(self, results):
    pass

  def finalize(self):
    pass


class StatsAnalyzer(AnalyzerBase):
  """Streaming mean/std with a per-example CSV."""

  def __init__(self, name, func, fname=None):
    super().__init__(name)
    self.sum = 0.0
    self.sum2 = 0.0
    self.num_ex = 0
    self.func = func
    self.fname = fname
    self.mean = None
    self.std = None
    if fname:
      os.makedirs(os.path.dirname(fname) or '.', exist_ok=True)
      with open(fname, 'w') as f:
        f.write('ID,Score\n')

  def stage(self, results):
    start = time.time()
    vals = self.func(results)
    n = vals.shape[0]
    self.num_ex += n
    self.sum += vals.sum()
    self.sum2 += (vals ** 2).sum()
    if self.fname:
      ids = results.get('indices', [0] * n)
      with open(self.fname, 'a') as f:
        for ii in range(n):
          idx = ids[ii] if ii < len(ids) else 0
          f.write(f'{idx},{vals[ii]:.4f}\n')
    self.log.debug(
        f'{self.name} finished in {(time.time() - start) * 1000:.2f}ms')

  def finalize(self):
    mean = self.sum / max(self.num_ex, 1)
    std = np.sqrt(max(0.0, self.sum2 / max(self.num_ex, 1) - mean ** 2))
    self.mean, self.std = mean, std
    self.log.info(f'{self.name:17s}{mean:7.4f} ({std:6.4f})')
    if self.fname:
      with open(self.fname, 'a') as f:
        f.write(f'Mean,{mean:.4f}\nStd,{std:.4f}\n')
    return mean, std


class ForegroundIOUAnalyzer(AnalyzerBase):
  """Dataset-level FG IoU (single accumulated inter/union)."""

  def __init__(self, name='FG IOU ALL', fname=None, background=False):
    super().__init__(name)
    self.inter = 0.0
    self.union = 0.0
    self.background = background
    self.mean = None

  def stage(self, results):
    for a, b in zip(results['y_out'], results['y_gt']):
      if a.ndim == 3:
        a, b = a.max(axis=0), b.max(axis=0)
      if self.background:
        a, b = 1 - a, 1 - b
      inter = (a * b).sum()
      self.inter += inter
      self.union += a.sum() + b.sum() - inter

  def finalize(self):
    iou = self.inter / max(self.union, 1e-7)
    self.mean = iou
    self.log.info(f'{self.name:17s}{iou:7.4f}')
    return iou, 0.0


class CountAnalyzer(AnalyzerBase):

  def __init__(self, fname, name='count_rec'):
    super().__init__(name)
    self.fname = fname
    os.makedirs(os.path.dirname(fname) or '.', exist_ok=True)
    with open(fname, 'w') as f:
      f.write('Image ID,Count Out,Count GT\n')

  def stage(self, results):
    count_out = f_count_out(results['y_out']).sum(axis=1)
    count_gt = results['s_gt'].sum(axis=1)
    with open(self.fname, 'a') as f:
      for ii, idx in enumerate(results['indices']):
        f.write(f'{idx},{int(count_out[ii]):d},{int(count_gt[ii]):d}\n')


_ANALYZERS = {
    'sbd': f_symmetric_best_dice,
    'ins_iou': f_ins_iou,
    'wt_cov': f_wt_coverage,
    'unwt_cov': f_unwt_coverage,
    'fg_dice': f_fg_dice,
    'fg_iou': f_fg_iou,
    'avg_fp': f_fp,
    'avg_fn': f_fn,
    'avg_pr': f_pixel_pr,
    'avg_re': f_pixel_re,
    'obj_pr': f_obj_pr,
    'obj_re': f_obj_re,
    'count_acc': f_count_acc,
    'count_mse': f_count_mse,
    'dic': f_dic,
    'dic_abs': f_dic_abs,
}


def create_analyzer(name, display_name=None, fname=None):
  if display_name is None:
    display_name = name
  name = name.lower()
  if name == 'fg_iou_all':
    return ForegroundIOUAnalyzer(display_name, fname=fname)
  if name == 'bg_iou_all':
    return ForegroundIOUAnalyzer(display_name, fname=fname, background=True)
  if name == 'count':
    return CountAnalyzer(fname=fname)
  if name in _ANALYZERS:
    return StatsAnalyzer(display_name, _ANALYZERS[name], fname=fname)
  raise ValueError(f'Analyzer not found: {name}')
