"""Batch augmentation of training: pad, random crop, flips, transpose.

Counterpart of the train branch of ``rec_attend_tpu/ops/image_ops.py:80-184``:
the batch is zero-padded by ``padding`` on each side, cropped back to its
size at one offset drawn in [0, 2 * padding) per axis, then flipped left-
right, flipped up-down and transposed, each on one draw for the whole batch
(``:141-146``).  The instance masks move with the image.  The eval branch
(a centre crop of the padded image) is the identity and is not needed.

The draws are explicit inputs (``draw_transformation`` makes them from a
``torch.Generator``), so a test can hand both packages the same ones.  The
colour jitter (an HSV round trip, ``:23-78``) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def draw_transformation(padding, generator):
  """One batch's draws: crop offset (y, x) in [0, 2 * padding) and the
  three flip coins, as Python values."""
  dev = generator.device
  off = torch.randint(0, max(2 * padding, 1), (2,), generator=generator,
                      device=dev).tolist()
  coins = (torch.rand(3, generator=generator, device=dev) < 0.5).tolist()
  return {'offset': (off[0], off[1]), 'hflip': coins[0], 'vflip': coins[1],
          'transpose': coins[2]}


def random_transformation(x, padding, draws, rnd_hflip=True, rnd_vflip=True,
                          rnd_transpose=True, rnd_colour=False, y=None):
  """Crop/flip/transpose augmentation of a batch.

  Args:
    x: [B, H, W, C] images.
    padding: pad on each side before the crop.
    draws: dict from ``draw_transformation``: 'offset' (y, x) and the
      booleans 'hflip', 'vflip', 'transpose'; a flip whose ``rnd_*`` flag is
      off is not applied whatever its draw.
    y: optional [B, T, H, W] instance masks, transformed alike.
  Returns:
    dict with 'x' (and 'y' when given).
  """
  if rnd_colour:
    raise NotImplementedError('rnd_colour (the HSV jitter) is not ported '
                              'yet')
  h, w = x.shape[1], x.shape[2]
  if rnd_transpose and h != w:
    raise ValueError('rnd_transpose needs a square image')
  oy, ox = draws['offset']
  if not (0 <= oy <= 2 * padding and 0 <= ox <= 2 * padding):
    raise ValueError(f'crop offset {draws["offset"]} outside the padding')
  pad = (padding, padding, padding, padding)
  x_out = F.pad(x, (0, 0) + pad)[:, oy:oy + h, ox:ox + w, :]
  y_out = None if y is None else F.pad(y, pad)[:, :, oy:oy + h, ox:ox + w]
  if rnd_hflip and draws['hflip']:
    x_out = torch.flip(x_out, dims=(2,))
    y_out = None if y_out is None else torch.flip(y_out, dims=(3,))
  if rnd_vflip and draws['vflip']:
    x_out = torch.flip(x_out, dims=(1,))
    y_out = None if y_out is None else torch.flip(y_out, dims=(2,))
  if rnd_transpose and draws['transpose']:
    x_out = x_out.transpose(1, 2)
    y_out = None if y_out is None else y_out.transpose(2, 3)
  out = {'x': x_out.contiguous()}
  if y is not None:
    out['y'] = y_out.contiguous()
  return out
