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
"""

from __future__ import annotations

import numpy as np
import torch

from rec_attend_tpu_torch.data.orientation import get_orientation


def synthetic_instances(n, height, width, timespan=None, seed=0,
                        max_objects=9):
  """Seeded images with their instances, on the CPU.

  Returns a dict: 'x' [n, height, width, 3] float32 images in [0, 1];
  with ``timespan``, also 'y_gt' [n, timespan, height, width] binary masks
  (at most ``timespan`` instances, in drawing order), 's_gt'
  [n, timespan] (1 for each instance present), the foreground 'c_gt'
  [n, height, width, 1] and the one-hot orientation 'd_gt'
  [n, height, width, 8].
  """
  g = torch.Generator().manual_seed(seed)

  def randint(lo, hi):
    return int(torch.randint(lo, hi, (1,), generator=g))

  imgs = torch.rand((n, height, width, 3), generator=g) * 40 + 20
  yy = torch.arange(height, dtype=torch.float32).view(-1, 1)
  xx = torch.arange(width, dtype=torch.float32).view(1, -1)
  if timespan is not None:
    y_gt = torch.zeros((n, timespan, height, width))
    s_gt = torch.zeros((n, timespan))
    c_gt = torch.zeros((n, height, width, 1))
    d_gt = np.zeros((n, height, width, 8), np.float32)
  for i, img in enumerate(imgs):
    masks = []
    for _ in range(randint(1, max_objects + 1)):
      cy = randint(height // 6, 5 * height // 6)
      cx = randint(width // 6, 5 * width // 6)
      ry = randint(height // 12, height // 5)
      rx = randint(width // 12, width // 5)
      colour = torch.randint(90, 255, (3,), generator=g).float()
      if randint(0, 2) == 0:
        mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
      else:
        mask = ((yy - cy).abs() <= ry) & ((xx - cx).abs() <= rx)
      img[mask] = colour
      for m in masks:       # the new shape occludes the earlier ones
        m &= ~mask
      masks.append(mask)
    if timespan is not None:
      kept = [m for m in masks if m.any()]
      for t, m in enumerate(kept[:timespan]):
        y_gt[i, t] = m.float()
        s_gt[i, t] = 1.0
      every = torch.stack(kept).numpy()
      c_gt[i, :, :, 0] = torch.from_numpy(every.any(axis=0))
      ori = get_orientation(every[None])[0]
      d_gt[i] = ori[..., None] == np.arange(8)
  out = {'x': imgs.floor() / 255.0}
  if timespan is not None:
    out.update(y_gt=y_gt, s_gt=s_gt, c_gt=c_gt, d_gt=torch.from_numpy(d_gt))
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
  targets 'c_gt' and 'd_gt'."""

  def __init__(self, n, height, width, timespan, seed=0, max_objects=9):
    data = synthetic_instances(n, height, width, timespan, seed=seed,
                               max_objects=max_objects)
    self.x = data['x'].numpy()
    self.y_gt = data['y_gt'].numpy()
    self.s_gt = data['s_gt'].numpy()
    self.c_gt = data['c_gt'].numpy()
    self.d_gt = data['d_gt'].numpy()
    self.timespan = timespan
    self.img_ids = np.array([f'synth{i:04d}' for i in range(n)])
    self._pos = {name: i for i, name in enumerate(self.img_ids)}

  def get_dataset_size(self):
    return len(self.img_ids)

  def _check_timespan(self, timespan):
    if timespan not in (None, self.timespan):
      raise ValueError(f'timespan {timespan}: this split holds '
                       f'{self.timespan} instance slots')

  def get_batch(self, idx, timespan=None):
    """'x' [b,H,W,3], 'y_gt' [b,T,H,W], 's_gt' [b,T], 'c_gt' [b,H,W,1],
    'd_gt' [b,H,W,8] and 'idx_map' (the ids) of the examples at positions
    ``idx``."""
    self._check_timespan(timespan)
    idx = np.asarray(idx)
    return {'x': self.x[idx], 'y_gt': self.y_gt[idx], 's_gt': self.s_gt[idx],
            'c_gt': self.c_gt[idx], 'd_gt': self.d_gt[idx],
            'idx_map': self.img_ids[idx]}

  def get_full_size_labels(self, ids, timespan=None):
    """A list of [T, H, W] label arrays, one per id."""
    self._check_timespan(timespan)
    return [self.y_gt[self._pos[i]] for i in ids]
