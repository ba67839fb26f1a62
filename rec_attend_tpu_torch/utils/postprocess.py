"""Eval-time postprocess chain, on tensors where the forward left them.

Counterpart of ``rec_attend_tpu/utils/postprocess.py:27-94``: confidence
weighting -> upsample to each image's full size (bilinear resize, then a
5x10x10 bilateral filter) -> optional 5x5 dilation -> per-pixel
single-label argmax -> threshold -> tiny-region removal -> foreground
masking.  The JAX package runs the chain in numpy and cv2 on per-image
lists; here it runs in torch on the forward's device, without cv2.

Maps are either a batch tensor [B, T, H, W] or, where the images of a batch
have different full sizes, a per-image list of [T, H_i, W_i] tensors; every
function below takes both and returns the form it was given (``upsample``
returns a batch tensor where all its targets share one size).  ``resize``
and ``bilateral_filter`` follow the arithmetic of cv2's float32
``resize(INTER_LINEAR)`` and ``bilateralFilter`` (OpenCV's
``resize.cpp`` and ``bilateral_filter.simd.hpp``), so their results agree
with cv2's to float32 rounding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

TINY_REGION_PIXELS = 200
DILATE_SIZE = 5                 # cv2.dilate with np.ones((5, 5))
BILATERAL_ARGS = (5, 10, 10)    # diameter, sigma colour, sigma space
# cv2's bilateral filter weighs value differences through a table of this
# many bins over the image's value range, linearly interpolated.
_EXP_BINS = 1 << 12


def _each(fn, y, *rest):
  """fn over a batch tensor, or over each image of a list (with the matching
  entries of the per-image arguments ``rest``)."""
  if torch.is_tensor(y):
    return fn(y, *rest)
  return [fn(yi[None], *(r[i:i + 1] for r in rest))[0]
          for i, yi in enumerate(y)]


def apply_confidence(y_out, s_out, threshold=0.5):
  """Scale each instance map by its confidence; harden the scores.

  y_out [B,T,H,W], s_out [B,T] -> (weighted maps, 0/1 float scores)."""
  return y_out * s_out[:, :, None, None], (s_out > threshold).float()


def apply_threshold(y, thresh):
  """Binarise soft maps at ``thresh``."""
  return _each(lambda t: (t > thresh).float(), y)


def _one_label(y):
  winner = torch.argmax(y, dim=1, keepdim=True)
  channel = torch.arange(y.shape[1], device=y.device).view(1, -1, 1, 1)
  return y * (winner == channel)


def apply_one_label(y):
  """Resolve overlaps: each pixel keeps only its argmax instance (the first
  one on ties, as numpy's argmax)."""
  return _each(_one_label, y)


def _remove_tiny(y, conf, threshold):
  keep = (y.flatten(2).sum(dim=2) > threshold).float()
  return y * keep[:, :, None, None], conf * keep


def remove_tiny(y, conf, threshold=TINY_REGION_PIXELS):
  """Zero instances of at most ``threshold`` pixels, and their scores.

  y maps, conf [B,T] -> (y, conf)."""
  if threshold == 0:
    return y, conf
  if torch.is_tensor(y):
    return _remove_tiny(y, conf, threshold)
  pairs = [_remove_tiny(yi[None], conf[i:i + 1], threshold)
           for i, yi in enumerate(y)]
  return [m[0] for m, _ in pairs], torch.cat([c for _, c in pairs])


def _dilate(y):
  r = DILATE_SIZE // 2
  shape = y.shape
  # max_pool2d pads with -inf: the border never wins, as in cv2.dilate.
  out = F.max_pool2d(y.reshape(-1, 1, *shape[-2:]), DILATE_SIZE, stride=1,
                     padding=r)
  return out.reshape(shape)


def morph(y):
  """5x5 dilation of every instance channel."""
  return _each(_dilate, y)


def mask_foreground(y, fg):
  """Intersect instance maps with a per-image foreground map [H, W] (a
  [B,H,W] tensor or a list of [H,W] tensors)."""
  if torch.is_tensor(y):
    if not torch.is_tensor(fg):
      fg = torch.stack(list(fg))
    return y * fg.to(y.device)[:, None]
  return [yi * fi.to(yi.device) for yi, fi in zip(y, fg)]


def _linear_taps(n_in, n_out, device):
  """Source indices and weights of cv2's INTER_LINEAR along one axis:
  output i reads (lo[i], hi[i]) with weights (w_lo[i], w_hi[i])."""
  scale = 1.0 / (n_out / n_in)
  pos = (torch.arange(n_out, dtype=torch.float64) + 0.5) * scale - 0.5
  lo = torch.floor(pos)
  frac = (pos - lo).float()
  lo = lo.long()
  edge = (lo < 0) | (lo >= n_in - 1)
  frac = torch.where(edge, torch.zeros_like(frac), frac)
  lo = lo.clamp(0, n_in - 1)
  hi = (lo + 1).clamp(max=n_in - 1)
  return (lo.to(device), hi.to(device), (1 - frac).to(device),
          frac.to(device))


def resize(x, size):
  """Bilinear resize of the last two dims of ``x`` to ``size`` (H, W), as
  cv2.resize(INTER_LINEAR) on float32: along each row first, then along
  each column, with the source positions' fractions taken in float64; the
  same size returns ``x`` itself."""
  h, w = x.shape[-2:]
  if (h, w) == tuple(size):
    return x
  x = x.float()
  lo, hi, w_lo, w_hi = _linear_taps(w, size[1], x.device)
  x = x.index_select(-1, lo) * w_lo + x.index_select(-1, hi) * w_hi
  lo, hi, w_lo, w_hi = _linear_taps(h, size[0], x.device)
  return (x.index_select(-2, lo) * w_lo[:, None]
          + x.index_select(-2, hi) * w_hi[:, None])


def _bilateral_taps():
  """(dy, dx, space weight) of every neighbour in cv2's circular window,
  centre excluded, in cv2's order."""
  d, _, sigma_space = BILATERAL_ARGS
  radius = d // 2
  coeff = -0.5 / (sigma_space * sigma_space)
  taps = []
  for i in range(-radius, radius + 1):
    for j in range(-radius, radius + 1):
      r = math.sqrt(i * i + j * j)
      if r > radius or (i == 0 and j == 0):
        continue
      taps.append((i, j, float(torch.tensor(math.exp(r * r * coeff),
                                            dtype=torch.float32))))
  return taps


def _bilateral(img, lo, hi):
  """cv2.bilateralFilter(img, *BILATERAL_ARGS) of each [H,W] image of img
  [N,H,W], none of them constant; lo, hi [N] their least and largest
  values."""
  _, sigma_color, _ = BILATERAL_ARGS
  radius = BILATERAL_ARGS[0] // 2
  n, h, w = img.shape
  # The value weight exp(-d^2 / 2 sigma^2) from a table of _EXP_BINS bins
  # over the image's range, as cv2 builds it (float32 bin positions, the
  # exponential in float64).
  scale = _EXP_BINS / (hi.double() - lo.double()).float()
  bins = torch.arange(_EXP_BINS + 2, device=img.device,
                      dtype=torch.float32)
  val = (bins[None] / scale[:, None]).double()
  table = torch.exp(val * val * (-0.5 / (sigma_color * sigma_color)))
  table = table.float()
  pad = F.pad(img[:, None], (radius,) * 4, mode='reflect')[:, 0]
  scale = scale[:, None, None]
  wsum = torch.zeros_like(img)
  vsum = torch.zeros_like(img)
  taps = _bilateral_taps()
  # cv2 adds the neighbours four at a time into its running sums.
  for g in range(0, len(taps), 4):
    gw = gv = None
    for dy, dx, space in taps[g:g + 4]:
      v = pad[:, radius + dy:radius + dy + h, radius + dx:radius + dx + w]
      alpha = (v - img).abs() * scale
      idx = torch.floor(alpha)
      alpha = alpha - idx
      idx = idx.long().clamp(0, _EXP_BINS).flatten(1)
      e0 = torch.gather(table, 1, idx).view(n, h, w)
      e1 = torch.gather(table, 1, idx + 1).view(n, h, w)
      wt = space * (e0 + alpha * (e1 - e0))
      gw = wt if gw is None else gw + wt
      gv = v * wt if gv is None else gv + v * wt
    wsum = wsum + gw
    vsum = vsum + gv
  # The centre pixel weighs 1.
  return (vsum + img) / (wsum + 1.0)


def bilateral_filter(img):
  """cv2.bilateralFilter(img, 5, 10, 10) of each [H,W] image of img
  [..., H, W], float32, borders reflected (reflect-101); a constant image
  comes back unchanged, as from cv2."""
  shape = img.shape
  flat = img.float().reshape(-1, *shape[-2:])
  lo, hi = flat.flatten(1).aminmax(dim=1)
  eps = torch.finfo(torch.float32).eps
  live = ((hi.double() - lo.double()).abs() >= eps).nonzero()[:, 0]
  out = flat.clone()
  if live.numel():
    out[live] = _bilateral(flat[live], lo[live], hi[live])
  return out.reshape(shape)


def _resize_smooth(y, size):
  return bilateral_filter(resize(y, size))


def upsample(y, sizes):
  """Resize each image's [T, h, w] maps to its size (H_i, W_i): bilinear
  resize, then the bilateral filter, as the JAX package's ``upsample``.

  y: maps; sizes: one (H, W) per image.  Returns a [B,T,H,W] tensor where
  every size is the same, else a per-image list."""
  sizes = [tuple(int(v) for v in s) for s in sizes]
  if torch.is_tensor(y) and len(set(sizes)) == 1:
    return _resize_smooth(y, sizes[0])
  out = [_resize_smooth(yi, s) for yi, s in zip(y, sizes)]
  if len(set(sizes)) == 1:
    return torch.stack(out)
  return out
