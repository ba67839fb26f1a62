"""Groundtruth attention boxes from instance masks.

Counterpart of ``rec_attend_tpu/ops/boxes.py:16-91``: each instance's
bounding box from index-map min/max reductions, padded (by a ratio of its
size, at least ``min_padding`` pixels) and shifted, then rasterised; empty
instances collapse to top_left 0, bot_right 2 * min_padding.  The boxes feed
the scheduled-sampling knob and the box loss of training.
"""

from __future__ import annotations

import torch

from rec_attend_tpu_torch.ops import attention


def get_idx_map(height, width, device=None):
  """Pixel coordinate map [H, W, 2] with (y, x) in the last dim."""
  idx_y = torch.arange(height, dtype=torch.float32,
                       device=device)[:, None].expand(height, width)
  idx_x = torch.arange(width, dtype=torch.float32,
                       device=device)[None, :].expand(height, width)
  return torch.stack([idx_y, idx_x], dim=-1)


def get_filled_box_idx(idx, top_left, bot_right):
  """[..., H, W] with 1 inside the inclusive box [top_left, bot_right]
  ([..., 2] each), over the index map ``idx`` [H, W, 2]."""
  tl = top_left[..., None, None, :]
  br = bot_right[..., None, None, :]
  lower = torch.prod((idx >= tl).float(), dim=-1)
  upper = torch.prod((idx <= br).float(), dim=-1)
  return lower * upper


def get_gt_box(y_gt, padding_ratio=0.0, center_shift_ratio=0.0,
               min_padding=10.0):
  """Groundtruth bounding boxes of masks y_gt [B, T, H, W].

  padding_ratio: scalar or [B, T, 1]/[B, T, 2]; center_shift_ratio: scalar
  or [B, T, 2].  Returns (top_left [B,T,2], bot_right [B,T,2],
  box [B,T,H,W]).
  """
  _, _, h, w = y_gt.shape
  idx = get_idx_map(h, w, y_gt.device)
  not_zero = (torch.sum(y_gt, dim=(2, 3)) > 0).float()[:, :, None]
  # Background pixels go to +h*w for the min and to 0 for the max.  One
  # coordinate at a time: the same elementwise values as the [...,2] form,
  # at half the memory.
  big = float(h * w)
  background = (1.0 - y_gt) * big
  top_left, bot_right = [], []
  for c in range(2):
    coord = idx[..., c]
    top_left.append(torch.amin(coord + background, dim=(2, 3)))
    bot_right.append(torch.amax(coord * y_gt, dim=(2, 3)))
  top_left = torch.stack(top_left, dim=-1)
  bot_right = torch.stack(bot_right, dim=-1)

  size = bot_right - top_left
  pad = torch.clamp_min(padding_ratio * size, min_padding)
  top_left = top_left + center_shift_ratio * size - pad
  bot_right = bot_right + center_shift_ratio * size + pad
  box = get_filled_box_idx(idx, top_left, bot_right)

  top_left = top_left * not_zero
  bot_right = not_zero * bot_right + (1 - not_zero) * (2 * min_padding)
  return top_left, bot_right, box


def get_gt_attn(y_gt, filter_height, filter_width, padding_ratio=0.0,
                center_shift_ratio=0.0, min_padding=10.0):
  """Groundtruth attention parameters of masks y_gt [B, T, H, W].

  Returns (ctr, size, lg_var, lg_gamma, box, top_left, bot_right)."""
  top_left, bot_right, box = get_gt_box(
      y_gt, padding_ratio=padding_ratio,
      center_shift_ratio=center_shift_ratio, min_padding=min_padding)
  ctr, size = attention.get_box_ctr_size(top_left, bot_right)
  lg_var = attention.get_normalized_var(size, filter_height, filter_width)
  lg_gamma = attention.get_normalized_gamma(size, filter_height, filter_width)
  return ctr, size, lg_var, lg_gamma, box, top_left, bot_right
