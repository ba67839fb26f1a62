"""Resize uint8 images as ``cv2.resize`` does, without cv2.

The port's stand-in for the three ``cv2.resize`` calls of the JAX
package's assembler (``rec_attend_tpu/data/assembler.py:91,98,110``): the
input image with ``INTER_CUBIC``, the instance and semantic masks with
``INTER_NEAREST``, to ``(width, height)``.  Bit for bit with the cv2 the
JAX package's files were written with (OpenCV 5.0 on x86-64), whose
arithmetic ``tests/test_torch_png.py`` holds this module to:

  nearest  source index ``floor(dst * (1 / (dst_size / src_size)))`` in
           double precision, capped at the last pixel;
  cubic    Keys' kernel (A = -0.75) at the source position
           ``(dst + 0.5) * scale - 0.5``, its four weights and the sums in
           double precision, the taps at the border clamped to the edge,
           along the rows first and then the columns, rounded half to even
           and saturated to uint8 once at the end.  (OpenCV 4's generic
           path rounds the weights to 11-bit fixed point and sums in
           integers: that is one level off on about 1 % of the pixels of a
           530x500 -> 224x224 resize of noise, and is not what the files
           hold.)

    small = resize_u8(img, (448, 128), 'cubic')     # [128, 448, 3]
    mask = resize_u8(seg, (448, 128), 'nearest')
"""

from __future__ import annotations

import numpy as np


def _nearest_index(dst, src):
  inv = 1.0 / (dst / src)
  return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64), src - 1)


def _cubic_taps(dst, src):
  """[dst, 4] source indices (clamped) and [dst, 4] float64 weights of the
  cubic resize along one axis."""
  scale = 1.0 / (dst / src)
  f = (np.arange(dst) + 0.5) * scale - 0.5
  s = np.floor(f)
  x = f - s
  a = -0.75
  c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
  c1 = ((a + 2) * x - (a + 3)) * x * x + 1
  c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
  c3 = 1 - c0 - c1 - c2
  idx = np.clip(s.astype(np.int64)[:, None] - 1 + np.arange(4)[None, :], 0,
                src - 1)
  return idx, np.stack([c0, c1, c2, c3], axis=1)


def resize_u8(img, size, interpolation):
  """``cv2.resize(img, size, interpolation=...)`` for a uint8 [H,W] or
  [H,W,C] ``img``; ``size`` is (width, height) as cv2 takes it and
  ``interpolation`` 'cubic' or 'nearest'.  'nearest' takes any dtype."""
  img = np.asarray(img)
  w_out, h_out = int(size[0]), int(size[1])
  h_in, w_in = img.shape[:2]
  if interpolation == 'nearest':
    return np.ascontiguousarray(
        img[_nearest_index(h_out, h_in)][:, _nearest_index(w_out, w_in)])
  if interpolation != 'cubic':
    raise ValueError(f'interpolation must be cubic or nearest, got '
                     f'{interpolation!r}')
  if img.dtype != np.uint8:
    raise TypeError(f'cubic resize takes uint8 images, got {img.dtype}')
  if (h_out, w_out) == (h_in, w_in):
    return img.copy()
  x = img.reshape(h_in, w_in, -1).astype(np.float64)
  xi, xw = _cubic_taps(w_out, w_in)
  yi, yw = _cubic_taps(h_out, h_in)
  rows = x[:, xi[:, 0]] * xw[None, :, 0, None]
  for k in (1, 2, 3):
    rows += x[:, xi[:, k]] * xw[None, :, k, None]
  out = rows[yi[:, 0]] * yw[:, 0, None, None]
  for k in (1, 2, 3):
    out += rows[yi[:, k]] * yw[:, k, None, None]
  out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
  return out.reshape((h_out, w_out) + img.shape[2:])
