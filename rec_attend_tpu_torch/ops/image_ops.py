"""Batch augmentation of training: pad, random crop, flips, transpose and
the colour jitter.

Counterpart of the train branch of ``rec_attend_tpu/ops/image_ops.py:23-184``:
the batch is zero-padded by ``padding`` on each side, cropped back to its
size at one offset drawn in [0, 2 * padding) per axis, then flipped left-
right, flipped up-down and transposed, each on one draw for the whole batch
(``:141-146``).  The instance masks move with the image, and so do the
packed orientation and foreground maps, which take the crop only: with them
there are no flips or transpose.  With ``rnd_colour`` the image's hue,
saturation, brightness and contrast then move by one draw each for the
whole batch (``:167-174``; hue and saturation through an RGB-HSV round
trip, ``:23-66``).  The eval branch (a centre crop of the padded image) is
the identity and is not needed.

The draws are explicit inputs (``draw_transformation`` makes them from a
``torch.Generator``), so a test can hand both packages the same ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


# The colour jitter's draws and their ranges (JAX image_ops.py:167-174).
COLOUR_RANGES = (('hue', -0.1, 0.1), ('saturation', 0.9, 1.1),
                 ('brightness', -0.1, 0.1), ('contrast', 0.9, 1.1))


def draw_transformation(padding, generator, colour=False):
  """One batch's draws: crop offset (y, x) in [0, 2 * padding) and the
  three flip coins, as Python values; with ``colour`` also 'colour', the
  four jitter values of ``COLOUR_RANGES``, drawn after the others and only
  then."""
  dev = generator.device
  off = torch.randint(0, max(2 * padding, 1), (2,), generator=generator,
                      device=dev).tolist()
  coins = (torch.rand(3, generator=generator, device=dev) < 0.5).tolist()
  draws = {'offset': (off[0], off[1]), 'hflip': coins[0],
           'vflip': coins[1], 'transpose': coins[2]}
  if colour:
    u = torch.rand(len(COLOUR_RANGES), generator=generator,
                   device=dev).tolist()
    draws['colour'] = {name: lo + (hi - lo) * v for (name, lo, hi), v in
                       zip(COLOUR_RANGES, u)}
  return draws


def rgb_to_hsv(rgb):
  """[..., 3] RGB in [0, 1] -> HSV in [0, 1] (JAX image_ops.py:23-39: where
  r and g tie for the maximum, the hue is r's)."""
  r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
  maxc = torch.maximum(torch.maximum(r, g), b)
  minc = torch.minimum(torch.minimum(r, g), b)
  delta = maxc - minc
  one = torch.ones_like(delta)
  safe_delta = torch.where(delta > 0, delta, one)
  s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, one),
                  torch.zeros_like(delta))
  rc = (maxc - r) / safe_delta
  gc = (maxc - g) / safe_delta
  bc = (maxc - b) / safe_delta
  h = torch.where(r == maxc, bc - gc,
                  torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
  h = torch.remainder(h / 6.0, 1.0)       # a floor modulo, as JAX's %
  h = torch.where(delta > 0, h, torch.zeros_like(h))
  return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv):
  """Inverse of ``rgb_to_hsv`` (JAX :42-56); a hue of exactly 1 is sector
  6, which is 0."""
  h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
  i = torch.floor(h * 6.0)
  f = h * 6.0 - i
  p = v * (1.0 - s)
  q = v * (1.0 - s * f)
  t = v * (1.0 - s * (1.0 - f))
  i = torch.remainder(i.to(torch.int32), 6).long()[..., None]

  def pick(*sectors):
    return torch.gather(torch.stack(sectors, dim=-1), -1, i)[..., 0]
  return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                      pick(p, p, t, v, v, q)], dim=-1)


def adjust_hue(image, delta):
  hsv = rgb_to_hsv(image)
  h = torch.remainder(hsv[..., 0] + delta, 1.0)
  return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def adjust_saturation(image, factor):
  hsv = rgb_to_hsv(image)
  s = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
  return hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


def adjust_brightness(image, delta):
  return image + delta


def adjust_contrast(image, factor):
  """Scale [B,H,W,C] images about their per-image, per-channel mean."""
  mean = torch.mean(image, dim=(-3, -2), keepdim=True)
  return (image - mean) * factor + mean


def adjust_colour(image, colour):
  """The colour jitter of ``draw_transformation``'s 'colour' draws (JAX
  :167-174): hue, saturation, brightness, contrast, in that order, each
  draw a float32 scalar as JAX's."""
  def scalar(name):
    return torch.tensor(colour[name], dtype=torch.float32,
                        device=image.device)
  image = adjust_hue(image, scalar('hue'))
  image = adjust_saturation(image, scalar('saturation'))
  image = adjust_brightness(image, scalar('brightness'))
  return adjust_contrast(image, scalar('contrast'))


def random_transformation(x, padding, draws, rnd_hflip=True, rnd_vflip=True,
                          rnd_transpose=True, rnd_colour=False, y=None,
                          d=None, c=None):
  """Crop/flip/transpose augmentation of a batch.

  Args:
    x: [B, H, W, C] images.
    padding: pad on each side before the crop.
    draws: dict from ``draw_transformation``: 'offset' (y, x) and the
      booleans 'hflip', 'vflip', 'transpose'; a flip whose ``rnd_*`` flag is
      off is not applied whatever its draw; with ``rnd_colour`` also
      'colour' (``draw_transformation(..., colour=True)``).
    y: optional [B, T, H, W] instance masks, transformed alike.
    d: optional [B, H, W, 8] orientation maps, cropped alike; with them no
      ``rnd_*`` flip or transpose may be on (JAX image_ops.py:98-101).
    c: optional [B, H, W, C] semantic (foreground) maps, cropped alike.
  Returns:
    dict with 'x' (and 'y', 'd', 'c' when given).
  """
  if rnd_colour and 'colour' not in draws:
    raise ValueError("rnd_colour needs the draws' 'colour' "
                     '(draw_transformation(..., colour=True))')
  if d is not None and (rnd_hflip or rnd_vflip or rnd_transpose):
    raise ValueError('orientation maps take no random flips or transpose')
  h, w = x.shape[1], x.shape[2]
  if rnd_transpose and h != w:
    raise ValueError('rnd_transpose needs a square image')
  oy, ox = draws['offset']
  if not (0 <= oy <= 2 * padding and 0 <= ox <= 2 * padding):
    raise ValueError(f'crop offset {draws["offset"]} outside the padding')
  pad = (padding, padding, padding, padding)

  def crop(a):
    return F.pad(a, (0, 0) + pad)[:, oy:oy + h, ox:ox + w, :].contiguous()

  x_out = crop(x)
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
  if rnd_colour:
    x_out = adjust_colour(x_out, draws['colour'])
  out = {'x': x_out.contiguous()}
  if y is not None:
    out['y'] = y_out.contiguous()
  for key, a in (('d', d), ('c', c)):
    if a is not None:
      out[key] = crop(a)
  return out
