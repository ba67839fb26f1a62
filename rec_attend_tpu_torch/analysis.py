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
same inputs.  The pairwise overlaps (the IoU matrix and the best Dice of
SBD) are taken as one matrix product of the flattened masks instead of
JAX's [T, T, H, W] broadcast, at a small part of the cost (PERF.md §5).
The masks are the eval commands' thresholded ones, zeros and ones in a
numeric dtype: the sums are integers, exact in any order, so the values
are the same bits as JAX's.

The renderers that the Cityscapes command line runs (``analysis.py:
413-519``) write their PNGs through ``utils/png.py`` as cv2 writes them:
``RenderInstanceAnalyzer`` the instances in the colours of ``_CMAP`` (an
RGB table, written BGR), ``RenderGroundtruthInstanceAnalyzer`` the ground
truth's instances, each in the colour of its best-matching prediction,
and ``RenderCityScapesOutputAnalyzer`` the submission, ``{run}/{stem}.txt``
with a line ``{png} {label id} {score}`` and a 0/255 mask PNG for each
instance submitted, its rows those of ``cityscapes_submission``.  The fg
eval's (``:522-546``) write through the same path:
``RenderOrientationAnalyzer`` the colour wheel of the orientation maps
under the foreground mask, ``RenderForegroundAnalyzer`` a map in [0, 1]
as a grey PNG.
"""

from __future__ import annotations

import collections
import logging
import os
import time

import numpy as np

from rec_attend_tpu_torch.data import orientation
from rec_attend_tpu_torch.ops.hungarian import hungarian
from rec_attend_tpu_torch.utils import png


# ---------------------------------------------------------------------------
# Numpy scoring primitives (ref analysis.py:300-388)
# ---------------------------------------------------------------------------

def f_iou(a, b):
  inter = (a * b).sum(axis=-1).sum(axis=-1)
  union = (a + b).sum(axis=-1).sum(axis=-1) - inter
  return inter / (union + np.equal(union, 0).astype('float32'))


def _overlaps(a, b):
  """[T, H, W] x [T', H, W] masks of zeros and ones -> the [T, T']
  intersections and the [T] and [T'] areas, in the dtype that JAX's sums
  of ``a * b`` take (float32 for float32 masks, uint64 for uint8 ones)."""
  fa = a.reshape(a.shape[0], a.shape[1] * a.shape[2])
  fb = b.reshape(b.shape[0], b.shape[1] * b.shape[2])
  # float32 holds every integer up to 2^24: the largest sum is the area.
  exact = np.float32 if fa.shape[1] < 1 << 24 else np.float64
  fa, fb = fa.astype(exact, copy=False), fb.astype(exact, copy=False)
  dtype = np.zeros(1, np.result_type(a, b)).sum().dtype
  return ((fa @ fb.T).astype(dtype), fa.sum(axis=1).astype(dtype),
          fb.sum(axis=1).astype(dtype))


def f_iou_pairwise(a, b):
  """[T, H, W] x [T', H, W] masks of zeros and ones -> [T, T']."""
  inter, area_a, area_b = _overlaps(a, b)
  union = (area_a[:, None] + area_b[None, :]) - inter
  return inter / (union + np.equal(union, 0).astype('float32'))


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
  card_ab, card_a, card_b = _overlaps(a, b)
  card_sum = card_a[:, None] + card_b[None, :]
  bd = 2 * card_ab / (card_sum + np.equal(card_sum, 0).astype('float32'))
  return bd.max(axis=1).astype(np.float64)


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


# ---------------------------------------------------------------------------
# The Cityscapes submission (ref analysis.py:477-519)
# ---------------------------------------------------------------------------

# Semantic channel c + 1 of the fg maps -> (Cityscapes name, label id).
CITYSCAPES_LABELS = [('person', 24), ('rider', 25), ('car', 26),
                     ('truck', 27), ('bus', 28), ('train', 31),
                     ('motorcycle', 32), ('bicycle', 33)]
# A slot is submitted where its score is over this, its mask is not empty
# and the mean background channel under it is at most BACKGROUND_MAX.
SUBMIT_SCORE, BACKGROUND_MAX = 0.5, 0.7

SubmissionRow = collections.namedtuple('SubmissionRow',
                                       ['mask', 'label_id', 'score', 'slot'])


def cityscapes_submission(y_out, fg, conf):
  """The Cityscapes submission's rows of each image, as the JAX package's
  writer decides them, in memory.

  Args:
    y_out: one [T, H, W] binary mask stack (numpy) per image;
    fg: one [H, W, C] semantic map per image, channel 0 the background;
    conf: [B, T] scores.
  Returns: per image a list of ``SubmissionRow``s in slot order: the mask
  as the writer's PNG holds it, ``(seg * 255)`` as uint8; the label id of
  the argmax of the mean of mask * fg over the image in channels 1..C-1;
  the score as the writer's text holds it (``%f``, six decimals); the
  slot.  The instance AP (``eval_cityscapes.instance_eval``) reads the
  first three.
  """
  rows = []
  for ii in range(len(y_out)):
    image_rows = []
    for jj in range(y_out[ii].shape[0]):
      if not conf[ii][jj] > SUBMIT_SCORE:
        continue
      seg = y_out[ii][jj]
      if seg.sum() == 0:
        continue
      channel_vec = (np.expand_dims(seg, -1) * fg[ii]).mean(axis=0).mean(
          axis=0)
      if channel_vec[0] <= BACKGROUND_MAX:
        sem_idx = int(np.argmax(channel_vec[1:]))
        image_rows.append(SubmissionRow(
            (seg * 255).astype('uint8'), CITYSCAPES_LABELS[sem_idx][1],
            float(f'{conf[ii, jj]:f}'), jj))
    rows.append(image_rows)
  return rows



# ---------------------------------------------------------------------------
# Renderers (ref analysis.py:413-519)
# ---------------------------------------------------------------------------

_CMAP = np.array(
    [[192, 57, 43], [243, 156, 18], [26, 188, 156], [41, 128, 185],
     [142, 68, 173], [44, 62, 80], [127, 140, 141], [17, 75, 95],
     [2, 128, 144], [228, 253, 225], [69, 105, 144], [244, 91, 105],
     [91, 192, 235], [253, 231, 76], [155, 197, 61], [229, 89, 52],
     [250, 121, 33], [124, 82, 47], [86, 15, 94], [38, 63, 77], [1, 52, 55],
     [63, 29, 82]], dtype='uint8')


def _write_png(path, img):
  with open(path, 'wb') as f:
    f.write(png.encode(img).tobytes())


class RenderInstanceAnalyzer(AnalyzerBase):
  """An image's instances, slot jj in colour ``_CMAP[jj % 22]`` (summed
  in uint8 where they overlap), one PNG an image named by the dataset's
  ``get_fname``."""

  def __init__(self, folder, dataset):
    super().__init__('render_ins')
    self.folder = folder
    self.dataset = dataset
    self.cmap = _CMAP
    os.makedirs(folder, exist_ok=True)

  def _fname(self, idx):
    get_fname = getattr(self.dataset, 'get_fname', None)
    if get_fname is not None:
      try:
        return get_fname(idx)
      except Exception:
        pass
    return f'{idx}.png'

  def _write(self, idx, rgb):
    _write_png(os.path.join(self.folder, self._fname(idx)), rgb[:, :, ::-1])

  def stage(self, results):
    for ii in range(len(results['y_out'])):
      y = results['y_out'][ii]
      total = np.zeros([y.shape[1], y.shape[2], 3], dtype='uint8')
      for jj in range(y.shape[0]):
        y_jj = y[jj].astype('uint8')
        if y_jj.sum() > 0:
          total += np.expand_dims(y_jj, 2) * self.cmap[jj % len(self.cmap)]
      self._write(results['indices'][ii], total)


class RenderGroundtruthInstanceAnalyzer(RenderInstanceAnalyzer):
  """The ground truth's instances, each in the colour of the prediction of
  best IoU with it, or, where that colour is taken, in the last free one;
  an earlier instance keeps its pixels."""

  def stage(self, results):
    num_color = len(self.cmap)
    for ii in range(len(results['y_gt'])):
      y_gt = results['y_gt'][ii]
      iou_pw = results['iou_pairwise'][ii]
      total = np.zeros([y_gt.shape[1], y_gt.shape[2], 3], dtype='uint8')
      flag = np.zeros(num_color)
      for jj in range(y_gt.shape[0]):
        y_jj = y_gt[jj].astype('uint8')
        max_idx = int(np.argmax(iou_pw[:, jj]))
        if flag[max_idx] == 0:
          color = self.cmap[max_idx]
          flag[max_idx] = 1
        else:
          color = self.cmap[-1]
          for kk in range(num_color):
            idx = num_color - kk - 1
            if flag[idx] == 0:
              color = self.cmap[idx]
              flag[idx] = 1
              break
        total += ((total == 0).astype('uint8') * np.expand_dims(y_jj, 2)
                  * color)
      self._write(results['indices'][ii], total)


class RenderCityScapesOutputAnalyzer(AnalyzerBase):
  """The Cityscapes submission: for each image ``{folder}/{run}/{stem}.txt``
  (``stem`` the dataset's ``get_fname`` without '.png', ``run`` its part
  before the first '_') with one line ``{stem}_{slot:03d}.png {label id}
  {score:f}`` a row of ``cityscapes_submission``, and that mask PNG
  beside it.  Reads 'y_out', 'y_in' (the [H, W, C] semantic maps) and
  'conf' of the results."""

  def __init__(self, folder, dataset):
    super().__init__('render_cs')
    self.folder = folder
    self.dataset = dataset
    os.makedirs(folder, exist_ok=True)

  def stage(self, results):
    decided = cityscapes_submission(results['y_out'], results['y_in'],
                                    results['conf'])
    for idx, image_rows in zip(results['indices'], decided):
      self.write(self.dataset.get_fname(idx), image_rows)

  def write(self, fname, image_rows):
    """Write one image's rows; returns its text file."""
    stem = fname[:-len('.png')]
    runfolder = os.path.join(self.folder, fname.split('_')[0])
    os.makedirs(runfolder, exist_ok=True)
    text_fn = os.path.join(runfolder, stem + '.txt')
    with open(text_fn, 'w') as text_file:
      for row in image_rows:
        img_file = f'{stem}_{row.slot:03d}.png'
        _write_png(os.path.join(runfolder, img_file), row.mask)
        text_file.write(f'{img_file} {row.label_id:d} {row.score:f}\n')
    return text_fn


class RenderOrientationAnalyzer(RenderInstanceAnalyzer):
  """Each image's orientation colour wheel (``orientation.
  build_orientation_img`` of 'd_out' [H, W, 8] under 'mask' [H, W]),
  written as cv2.imwrite writes the array."""

  def stage(self, results):
    for ii in range(len(results['mask'])):
      img = orientation.build_orientation_img(results['d_out'][ii],
                                              results['mask'][ii])
      _write_png(os.path.join(self.folder,
                              self._fname(results['indices'][ii])), img)


class RenderForegroundAnalyzer(RenderInstanceAnalyzer):
  """Each image's map 'y_out' [H, W] in [0, 1], times 255 truncated to
  uint8, as a grey PNG."""

  def __init__(self, folder, dataset):
    super().__init__(folder, dataset)
    self.name = 'render_fg'

  def stage(self, results):
    for ii in range(len(results['y_out'])):
      y = (results['y_out'][ii] * 255).astype('uint8')
      _write_png(os.path.join(self.folder,
                              self._fname(results['indices'][ii])), y)
