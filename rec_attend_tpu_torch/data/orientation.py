"""Instance masks -> 8-bin angle-to-centroid orientation maps.

A copy of ``rec_attend_tpu/data/orientation.py:37-71`` (``get_orientation``)
in its 'class' encoding, numpy only: each pixel of an instance takes the bin of the direction from
the instance's centroid to the pixel, 8 angular bins with edges offset by
pi/8; pixels outside every instance take bin 0.  The fg model learns these
bins as its orientation head's target ('d_gt').  ``build_orientation_img``
is ``:17-30``, the colour wheel that the fg eval renders the predicted
bins with.
"""

from __future__ import annotations

import numpy as np

# One colour per bin, in the order JAX lists them; the renders write them
# as cv2.imwrite does, the array's channels taken as B, G, R.
color_wheel = np.array(
    [[255, 17, 0], [255, 137, 0], [230, 255, 0], [34, 255, 0],
     [0, 255, 213], [0, 154, 255], [9, 0, 255], [255, 0, 255]], dtype='uint8')


def build_orientation_img(d, mask):
  """The colour of each pixel's most likely bin, zero off the mask.

  Args:
    d: [..., H, W, 8] orientation scores.
    mask: [..., H, W] in {0, 1}.
  Returns:
    [..., H, W, 3] uint8.
  """
  y = np.expand_dims(mask, -1)
  did = np.argmax(d, -1)
  c2 = color_wheel[did.reshape([-1])].reshape(list(y.shape[:-1]) + [3])
  return (c2 * y).astype('uint8')


def get_orientation(y, num_classes=8):
  """Per-pixel angle-to-instance-centroid classes (JAX's
  ``encoding='class'``, the one its datasets store).

  Args:
    y: [B, T, H, W] binary instance masks (disjoint).
    num_classes: number of angular bins.
  Returns:
    [B, H, W] uint8 bin indices.
  """
  _, _, h, w = y.shape
  yf = y.astype('float32')

  # Masked centroid of each instance: [B, T] each.
  row = np.arange(h, dtype='float32')[:, None]
  col = np.arange(w, dtype='float32')[None, :]
  area = yf.sum(axis=(2, 3)) + 1e-7
  ctr_row = (yf * row).sum(axis=(2, 3)) / area
  ctr_col = (yf * col).sum(axis=(2, 3)) / area

  # Pixel -> centroid offsets, zero off-mask, unit-normalised (offsets +
  # 1e-8 over the joint norm + 1e-7).
  d_row = (row - ctr_row[:, :, None, None]) * yf
  d_col = (col - ctr_col[:, :, None, None]) * yf
  norm = np.sqrt(d_row * d_row + d_col * d_col) + 1e-7
  u_row = (d_row + 1e-8) / norm
  u_col = (d_col + 1e-8) / norm

  # Angle -> bin, with bin edges rotated by half a bin width.
  angle = np.arctan2(u_row, u_col) + np.pi / num_classes
  bins = np.mod(np.floor((angle + np.pi) * num_classes / (2 * np.pi)),
                num_classes)

  return (bins * yf).max(axis=1).astype('uint8')
