"""Instance masks -> 8-bin angle-to-centroid orientation maps.

A copy of ``rec_attend_tpu/data/orientation.py:37-71`` (``get_orientation``)
in its 'class' encoding, numpy only: each pixel of an instance takes the bin of the direction from
the instance's centroid to the pixel, 8 angular bins with edges offset by
pi/8; pixels outside every instance take bin 0.  The fg model learns these
bins as its orientation head's target ('d_gt').
"""

from __future__ import annotations

import numpy as np


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
