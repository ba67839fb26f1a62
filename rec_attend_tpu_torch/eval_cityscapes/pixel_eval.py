"""The official Cityscapes pixel-level semantic evaluation.

Counterpart of ``PixelEvaluator`` (``rec_attend_tpu/eval_cityscapes/
pixel_eval.py:66-194``), the official ``evalPixelLevelSemanticLabeling.py``:

- a [256, 256] uint64 confusion matrix of (ground truth, prediction) label
  pairs, rows the ground truth; the JAX package adds to it in host C++
  (``native/confusion_matrix.cc``), here ``np.bincount`` gives the same
  counts;
- per class IoU and the instance-weighted iIoU (ref :215-266, :575-616);
- per category IoU and iIoU (ref :285-340);
- their four averages (ref :342-365).

The iIoU needs the ground-truth instance-id image of each pair (ids over
1000 are label id * 1000 + instance).  Beside it, the labels of the
synthetic Cityscapes-shaped chain (``pipelines/run_pipeline.py:523-541``):
``prediction_labels`` of the fg model's packed maps, ``groundtruth_labels``
of an instance-id image (``data/synthetic.instance_id_image``).  The file
readers and the command line wait.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from rec_attend_tpu_torch.data.cityscapes_labels import labels
from rec_attend_tpu_torch.data.synthetic import CS_BACKGROUND_LABEL_ID
from rec_attend_tpu_torch.data.synthetic import CS_INSTANCE_LABEL_IDS

NUM_LABELS = 256   # label ids are uint8

# The official average instance sizes (pixels) that weigh the instances
# (ref evalPixelLevelSemanticLabeling.py:135-146).
AVG_CLASS_SIZE = {
    'bicycle': 4672.3249222261,
    'caravan': 36771.8241758242,
    'motorcycle': 6298.7200839748,
    'rider': 3930.4788056518,
    'bus': 35732.1511111111,
    'train': 67583.7075812274,
    'car': 12794.0202738185,
    'person': 3462.4756337644,
    'truck': 27855.1264367816,
    'trailer': 16926.9763313609,
}

_ID2LABEL = {l.id: l for l in labels}


def eval_labels():
  return [l for l in labels if not l.ignoreInEval]


def _category2labels():
  cats = {}
  for l in labels:
    cats.setdefault(l.category, []).append(l)
  return cats


def instance_categories():
  """The categories all of whose labels have instances (ref :183-200)."""
  result = {}
  for cat, ls in _category2labels().items():
    if all(l.hasInstances for l in ls):
      result[cat] = [l.id for l in ls]
  return result


def add_to_confusion_matrix(prediction, groundtruth, conf):
  """Add the (ground truth, prediction) pairs of two uint8 label images to
  the [256, 256] uint64 matrix ``conf``, in place."""
  pairs = (np.asarray(groundtruth, np.uint8).ravel().astype(np.int64)
           * NUM_LABELS + np.asarray(prediction, np.uint8).ravel())
  conf += np.bincount(pairs, minlength=NUM_LABELS * NUM_LABELS).reshape(
      NUM_LABELS, NUM_LABELS).astype(np.uint64)
  return conf


def prediction_labels(fg):
  """The uint8 label image of the fg model's packed maps [..., H, W, C]
  (uint8, as packed; a numpy array, or a tensor, labelled where it lies):
  with one channel, the first instance class where it is over 127; else
  the argmax over the channels (the first on ties), channel 0 the
  background and channel c the class c - 1.  Background is
  ``CS_BACKGROUND_LABEL_ID``."""
  lib = torch if torch.is_tensor(fg) else np
  ids = lib.asarray(CS_INSTANCE_LABEL_IDS)
  if torch.is_tensor(fg):
    ids = ids.to(fg.device)
  if fg.shape[-1] == 1:
    pred = lib.where(fg[..., 0] > 127, ids[0], CS_BACKGROUND_LABEL_ID)
  else:
    am = fg.argmax(-1)
    pred = lib.where(am == 0, CS_BACKGROUND_LABEL_ID, ids[(am - 1) % len(ids)])
  return pred.to(torch.uint8) if torch.is_tensor(pred) else pred.astype(
      np.uint8)


def groundtruth_labels(instance_ids):
  """(label image uint8, instance-id image int64) of an instance-id image:
  an id of 1000 or more is its label * 1000 + instance."""
  inst = np.asarray(instance_ids).astype(np.int64)
  return np.where(inst >= 1000, inst // 1000, inst).astype(np.uint8), inst


class PixelEvaluator:
  """A streaming confusion matrix and instance statistics."""

  def __init__(self):
    self.conf = np.zeros((NUM_LABELS, NUM_LABELS), dtype=np.uint64)
    # Per class and per category instance-weighted tp/fn (ref :171-202).
    self.inst_classes = {
        l.name: dict(tp=0.0, fn=0.0, tp_weighted=0.0, fn_weighted=0.0)
        for l in labels if l.hasInstances and not l.ignoreInEval}
    self.inst_categories = {
        cat: dict(tp=0.0, fn=0.0, tp_weighted=0.0, fn_weighted=0.0,
                  label_ids=ids)
        for cat, ids in instance_categories().items()}

  def add_pair(self, prediction, groundtruth, instance_img=None):
    """prediction, groundtruth: [H, W] uint8 label images; instance_img:
    the optional [H, W] ground-truth instance ids, for the iIoU."""
    if prediction.shape != groundtruth.shape:
      raise ValueError('prediction/groundtruth shape mismatch')
    add_to_confusion_matrix(prediction, groundtruth, self.conf)
    if instance_img is None:
      return

    category_masks = {
        cat: np.isin(prediction, stats['label_ids'])
        for cat, stats in self.inst_categories.items()}
    for inst_id in np.unique(instance_img[instance_img > 1000]):
      label_id = int(inst_id) // 1000
      label = _ID2LABEL.get(label_id)
      if label is None or label.ignoreInEval:
        continue
      mask = instance_img == inst_id
      inst_size = float(mask.sum())
      tp = float((prediction[mask] == label_id).sum())
      fn = inst_size - tp
      weight = AVG_CLASS_SIZE[label.name] / inst_size
      st = self.inst_classes[label.name]
      st['tp'] += tp
      st['fn'] += fn
      st['tp_weighted'] += tp * weight
      st['fn_weighted'] += fn * weight
      cat = label.category
      if cat in self.inst_categories:
        cat_tp = float(np.logical_and(mask, category_masks[cat]).sum())
        cat_fn = inst_size - cat_tp
        cst = self.inst_categories[cat]
        cst['tp'] += cat_tp
        cst['fn'] += cat_fn
        cst['tp_weighted'] += cat_tp * weight
        cst['fn_weighted'] += cat_fn * weight

  def _fp(self, label_id):
    """False positives over the evaluated ground-truth rows but the
    label's own (ref :232-238)."""
    rows = [l.id for l in eval_labels() if l.id != label_id]
    return float(self.conf[rows, label_id].sum())

  def class_iou(self, label_id):
    tp = float(self.conf[label_id, label_id])
    fn = float(self.conf[label_id, :].sum()) - tp
    denom = tp + fn + self._fp(label_id)
    return tp / denom if denom > 0 else float('nan')

  def class_inst_iou(self, label_id):
    """Instance-weighted iIoU (ref getInstanceIouScoreForLabel
    :245-266)."""
    label = _ID2LABEL[label_id]
    if label.name not in self.inst_classes:
      return float('nan')
    st = self.inst_classes[label.name]
    denom = st['tp_weighted'] + st['fn_weighted'] + self._fp(label_id)
    return st['tp_weighted'] / denom if denom > 0 else float('nan')

  def category_iou(self, category):
    """ref getIouScoreForCategory :285-317."""
    ids = [l.id for l in _category2labels().get(category, ())
           if not l.ignoreInEval]
    if not ids:
      return float('nan')
    sub = self.conf[np.ix_(ids, ids)]
    tp = float(sub.sum())
    fn = float(self.conf[ids, :].sum()) - tp
    rows = [l.id for l in eval_labels() if l.category != category]
    fp = float(self.conf[np.ix_(rows, ids)].sum())
    denom = tp + fn + fp
    return tp / denom if denom > 0 else float('nan')

  def category_inst_iou(self, category):
    """ref getInstanceIouScoreForCategory :319-340."""
    if category not in self.inst_categories:
      return float('nan')
    st = self.inst_categories[category]
    ids = st['label_ids']
    rows = [l.id for l in eval_labels() if l.category != category]
    fp = float(self.conf[np.ix_(rows, ids)].sum())
    denom = st['tp_weighted'] + st['fn_weighted'] + fp
    return st['tp_weighted'] / denom if denom > 0 else float('nan')

  @staticmethod
  def _avg(scores):
    vals = [v for v in scores.values() if not np.isnan(v)]
    return float(np.mean(vals)) if vals else float('nan')

  def finalize(self):
    """The four score families and their averages (ref writeJSONFile
    :342-365)."""
    result = {'classes': {}, 'classesInst': {},
              'categories': {}, 'categoriesInst': {}}
    for l in eval_labels():
      result['classes'][l.name] = self.class_iou(l.id)
      result['classesInst'][l.name] = self.class_inst_iou(l.id)
    for cat in sorted({l.category for l in eval_labels()}):
      result['categories'][cat] = self.category_iou(cat)
      result['categoriesInst'][cat] = self.category_inst_iou(cat)
    result['meanIoU'] = self._avg(result['classes'])
    result['meanInstIoU'] = self._avg(result['classesInst'])
    result['meanCategoryIoU'] = self._avg(result['categories'])
    result['meanCategoryInstIoU'] = self._avg(result['categoriesInst'])
    logging.getLogger(__name__).info(
        f"mean IoU: {result['meanIoU']:.4f}  "
        f"iIoU: {result['meanInstIoU']:.4f}  "
        f"category IoU: {result['meanCategoryIoU']:.4f}  "
        f"category iIoU: {result['meanCategoryInstIoU']:.4f}")
    return result
