"""Seeded images and instance masks of the synthetic-shapes dataset,
without cv2.

Counterpart of ``rec_attend_tpu/data/synthetic.py:44-77``
(``SyntheticAssembler._generate``): a noisy dark background with up to
``max_objects`` filled ellipses and rectangles of bright random colours, at
the same size and colour ranges; a later shape occludes the earlier ones
in their masks, and instances left empty are dropped.  The draws come from
a torch generator, so the images are not those of the JAX package's files;
they are of the same kind, which is what a model trained on that dataset
needs to stay in its working range.
"""

from __future__ import annotations

import torch


def synthetic_instances(n, height, width, timespan=None, seed=0,
                        max_objects=9):
  """Seeded images with their instances, on the CPU.

  Returns a dict: 'x' [n, height, width, 3] float32 images in [0, 1];
  with ``timespan``, also 'y_gt' [n, timespan, height, width] binary masks
  (at most ``timespan`` instances, in drawing order) and 's_gt'
  [n, timespan] (1 for each instance present).
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
      kept = [m for m in masks if m.any()][:timespan]
      for t, m in enumerate(kept):
        y_gt[i, t] = m.float()
        s_gt[i, t] = 1.0
  out = {'x': imgs.floor() / 255.0}
  if timespan is not None:
    out.update(y_gt=y_gt, s_gt=s_gt)
  return out


def synthetic_images(n, height, width, seed=0, max_objects=9):
  """[n, height, width, 3] float32 images in [0, 1] on the CPU."""
  return synthetic_instances(n, height, width, seed=seed,
                             max_objects=max_objects)['x']
