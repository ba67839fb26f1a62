"""Seeded images and instance masks of the synthetic-shapes dataset,
without cv2.

Counterpart of ``rec_attend_tpu/data/synthetic.py:44-77``
(``SyntheticAssembler._generate``): a noisy dark background with up to
``max_objects`` filled ellipses and rectangles of bright random colours, at
the same size and colour ranges; a later shape occludes the earlier ones
in their masks, and instances left empty are dropped.  Beside the
instances, each image has the fg model's targets as the JAX dataset reads
them from its H5 file (``rec_attend_tpu/data/dataset.py:202-229``): the
foreground, the union of the instances (one semantic class), and the
orientation map of ``data/orientation.py`` one-hot, its background in bin
0.  Both are taken over every instance drawn, also those beyond
``timespan``, as the JAX assembler writes them.  The draws come from
a torch generator, so the images are not those of the JAX package's files;
they are of the same kind, which is what a model trained on that dataset
needs to stay in its working range.  ``SyntheticDataset`` holds such a
split in memory for the eval path.

With ``num_semantic_classes`` > 1 (``data/synthetic.py:44-89`` of the JAX
package) each instance has a class, its shape drawn from
``max(2, num_semantic_classes)`` choices and its class the shape modulo the
class count, and the foreground target becomes the semantic one: a channel
a class, each the union of that class's instances, after a background
channel of 1 minus their largest (``data/dataset.py:202-211``).  The
Cityscapes evaluators read an instance-id image
(``instance_id_image``), which the JAX package writes as
``*_gtFine_instanceIds.png`` (``write_instance_id_gt``).
"""

from __future__ import annotations

import numpy as np
import torch

from rec_attend_tpu_torch.data.dataset import InsSegDataset
from rec_attend_tpu_torch.data.orientation import get_orientation

# Synthetic class c -> Cityscapes label id, as the submission writer maps
# its classes (``analysis.CITYSCAPES_LABELS``): class 0 is a person (24),
# class 1 a rider (25), ...  Background is road (7), a label that the
# evaluators count, so false positives on it count too.
CS_INSTANCE_LABEL_IDS = (24, 25, 26, 27, 28, 31, 32, 33)
CS_BACKGROUND_LABEL_ID = 7


def get_fname(idx):
  """The Cityscapes-style ``{run}_{seq}_{frame}.png`` name of the example
  with id ``idx`` (``synth0012`` -> ``synth_000012_000000.png``)."""
  num = str(idx).replace('synth', '') or '0'
  return f'synth_{int(num):06d}_000000.png'


def semantic_maps(masks, classes, num_semantic_classes):
  """The fg model's foreground target of one image [H, W, C], float32:
  with one class, the union of the instances ``masks`` [k, H, W]; else a
  background channel, 1 minus the largest of the others, then a channel a
  class, the union of its instances (``classes`` [k])."""
  masks = np.asarray(masks).astype(np.float32)
  if num_semantic_classes == 1:
    return masks.max(axis=0)[..., None]
  out = np.zeros(masks.shape[1:] + (num_semantic_classes + 1,), np.float32)
  for m, c in zip(masks, classes):
    out[..., c + 1] = np.maximum(out[..., c + 1], m)
  out[..., 0] = 1 - out.max(axis=2)
  return out


def instance_id_image(masks, classes):
  """[H, W] uint16 instance ids of one image in the Cityscapes convention:
  instance k of class c is ``CS_INSTANCE_LABEL_IDS[c] * 1000 + k``, the
  rest ``CS_BACKGROUND_LABEL_ID``; a later instance overwrites an earlier
  one."""
  masks = np.asarray(masks)
  out = np.full(masks.shape[1:], CS_BACKGROUND_LABEL_ID, np.uint16)
  for k, (m, c) in enumerate(zip(masks, classes)):
    label = CS_INSTANCE_LABEL_IDS[int(c) % len(CS_INSTANCE_LABEL_IDS)]
    out[m > 0] = label * 1000 + k
  return out


def instance_targets(masks, classes, timespan, num_semantic_classes=1):
  """The targets of one image from its instances: ``masks`` [k, H, W]
  (none empty, in drawing order) and their ``classes`` [k].  Returns
  'y_gt' [timespan, H, W] (the first ``timespan`` masks), 's_gt'
  [timespan], 'classes' [timespan] (-1 where a slot is empty), 'c_gt'
  (``semantic_maps``), 'd_gt' [H, W, 8] (the one-hot orientation) and
  'instance_ids' (``instance_id_image``); the last three of every
  instance."""
  masks = np.asarray(masks, bool)
  k = min(len(masks), timespan)
  y_gt = np.zeros((timespan,) + masks.shape[1:], np.float32)
  y_gt[:k] = masks[:k]
  s_gt = np.zeros(timespan, np.float32)
  s_gt[:k] = 1.0
  slot_classes = np.full(timespan, -1, np.int64)
  slot_classes[:k] = classes[:k]
  ori = get_orientation(masks[None])[0]
  return {'y_gt': y_gt, 's_gt': s_gt, 'classes': slot_classes,
          'c_gt': semantic_maps(masks, classes, num_semantic_classes),
          'd_gt': (ori[..., None] == np.arange(8)).astype(np.float32),
          'instance_ids': instance_id_image(masks, classes)}


def synthetic_instances(n, height, width, timespan=None, seed=0,
                        max_objects=9, num_semantic_classes=1):
  """Seeded images with their instances, on the CPU.

  Returns a dict: 'x' [n, height, width, 3] float32 images in [0, 1];
  with ``timespan``, also 'y_gt' [n, timespan, height, width] binary masks
  (at most ``timespan`` instances, in drawing order), 's_gt'
  [n, timespan] (1 for each instance present), the foreground 'c_gt'
  [n, height, width, C] (``semantic_maps``: C is 1, or
  ``num_semantic_classes`` + 1), the one-hot orientation 'd_gt'
  [n, height, width, 8], each slot's class 'classes' [n, timespan] (-1
  where it is empty) and the instance ids 'instance_ids' [n, height,
  width] (``instance_id_image``, as int32).
  """
  g = torch.Generator().manual_seed(seed)

  def randint(lo, hi):
    return int(torch.randint(lo, hi, (1,), generator=g))

  imgs = torch.rand((n, height, width, 3), generator=g) * 40 + 20
  yy = torch.arange(height, dtype=torch.float32).view(-1, 1)
  xx = torch.arange(width, dtype=torch.float32).view(1, -1)
  n_shapes = max(2, num_semantic_classes)
  per_image = []
  for img in imgs:
    masks, classes = [], []
    for _ in range(randint(1, max_objects + 1)):
      cy = randint(height // 6, 5 * height // 6)
      cx = randint(width // 6, 5 * width // 6)
      ry = randint(height // 12, height // 5)
      rx = randint(width // 12, width // 5)
      colour = torch.randint(90, 255, (3,), generator=g).float()
      shape = randint(0, n_shapes)
      if shape % 2 == 0:
        mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
      else:
        mask = ((yy - cy).abs() <= ry) & ((xx - cx).abs() <= rx)
      img[mask] = colour
      for m in masks:       # the new shape occludes the earlier ones
        m &= ~mask
      masks.append(mask)
      classes.append(shape % num_semantic_classes)
    if timespan is not None:
      kept = [k for k, m in enumerate(masks) if m.any()]
      per_image.append(instance_targets(
          torch.stack([masks[k] for k in kept]).numpy(),
          [classes[k] for k in kept], timespan, num_semantic_classes))
  out = {'x': imgs.floor() / 255.0}
  if timespan is not None:
    out.update({k: torch.from_numpy(np.stack([t[k] for t in per_image]))
                for k in ('y_gt', 's_gt', 'c_gt', 'd_gt', 'classes')})
    out['instance_ids'] = torch.from_numpy(np.stack(
        [t['instance_ids'] for t in per_image]).astype(np.int32))
  return out


def synthetic_images(n, height, width, seed=0, max_objects=9):
  """[n, height, width, 3] float32 images in [0, 1] on the CPU."""
  return synthetic_instances(n, height, width, seed=seed,
                             max_objects=max_objects)['x']


class SyntheticDataset:
  """An in-memory split of ``synthetic_instances``, with the interface the
  eval path reads from the JAX package's datasets
  (``rec_attend_tpu/data/dataset.py``): ``get_dataset_size``,
  ``get_batch(idx, timespan)`` and ``get_full_size_labels(ids, timespan)``.

  Its images are of the model's size, so the full-size labels are the
  labels themselves, as in the JAX package's synthetic H5 files.  Image
  ``i`` has the id ``synth{i:04d}``.  It holds ``timespan`` instance slots
  and is read at that timespan.  Its batches also carry the fg model's
  targets 'c_gt' and 'd_gt'; ``get_instance_id_images`` gives what the
  Cityscapes evaluators read."""

  def __init__(self, n, height, width, timespan, seed=0, max_objects=9,
               num_semantic_classes=1):
    data = synthetic_instances(n, height, width, timespan, seed=seed,
                               max_objects=max_objects,
                               num_semantic_classes=num_semantic_classes)
    self.x = data['x'].numpy()
    self.y_gt = data['y_gt'].numpy()
    self.s_gt = data['s_gt'].numpy()
    self.c_gt = data['c_gt'].numpy()
    self.d_gt = data['d_gt'].numpy()
    self.classes = data['classes'].numpy()
    self.instance_ids = data['instance_ids'].numpy().astype(np.uint16)
    self.timespan = timespan
    self.img_ids = np.array([f'synth{i:04d}' for i in range(n)])
    self._pos = {name: i for i, name in enumerate(self.img_ids)}

  def get_dataset_size(self):
    return len(self.img_ids)

  def _check_timespan(self, timespan):
    if timespan not in (None, self.timespan):
      raise ValueError(f'timespan {timespan}: this split holds '
                       f'{self.timespan} instance slots')

  def get_batch(self, idx, timespan=None, variables=None):
    """'x' [b,H,W,3], 'y_gt' [b,T,H,W], 's_gt' [b,T], 'c_gt' [b,H,W,C],
    'd_gt' [b,H,W,8] and 'idx_map' (the ids) of the examples at positions
    ``idx``; only those named in ``variables`` where it is given."""
    self._check_timespan(timespan)
    idx = np.asarray(idx)
    arrays = {'x': self.x, 'y_gt': self.y_gt, 's_gt': self.s_gt,
              'c_gt': self.c_gt, 'd_gt': self.d_gt, 'idx_map': self.img_ids}
    return {k: v[idx] for k, v in arrays.items()
            if variables is None or k in variables}

  def get_full_size_labels(self, ids, timespan=None):
    """A list of [T, H, W] label arrays, one per id."""
    self._check_timespan(timespan)
    return [self.y_gt[self._pos[i]] for i in ids]

  def get_instance_id_images(self, ids):
    """A list of [H, W] uint16 instance-id images, one per id."""
    return [self.instance_ids[self._pos[i]] for i in ids]




class SyntheticH5(InsSegDataset):
  """A synthetic split as the JAX package writes it into an H5 file
  (``rec_attend_tpu/data/synthetic.py:92-113``, ``Synthetic``), read
  with ``data/dataset.py``: timespan 6 by default, the Cityscapes-style
  file names.  Its images are JAX's draws."""

  def __init__(self, h5_fname, num_semantic_classes=1, **kw):
    super().__init__(h5_fname, **kw)
    self._num_semantic_classes = num_semantic_classes

  def get_name(self):
    return 'synth'

  def get_fname(self, idx):
    return get_fname(idx)

  def get_default_timespan(self):
    return 6

  def get_num_semantic_classes(self):
    return self._num_semantic_classes
