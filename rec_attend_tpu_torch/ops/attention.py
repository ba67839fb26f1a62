"""Gaussian attention geometry: separable filter banks, the plain glimpse
extract and mask paste, and attention-parameter (un)normalisation.

Counterpart of ``rec_attend_tpu/ops/attention.py:19-130``.  ``extract_patch``
and ``paste_patch`` here are the plain two-einsum forms; they are what the
CUDA kernels of ``ops/cuda/glimpse.py`` are held against, and what those
wrappers compute for tensors on the CPU.
"""

from __future__ import annotations

import math

import torch


def get_gaussian_filter(center, size, lg_var, image_size, filter_size):
  """1-D Gaussian attention filter bank [B, L, F].

  center, size, lg_var: [B]; tap means are
  ``center + (size+1)/F * (i - (F-1)/2)`` and the taps are unnormalised
  Gaussian densities (no sum-to-one normalisation).
  """
  dev = center.device
  span_filter = torch.arange(filter_size, dtype=torch.float32,
                             device=dev).reshape(1, 1, -1)
  center = center.reshape(-1, 1, 1)
  size = size.reshape(-1, 1, 1)
  mu = center + (size + 1) / filter_size * (
      span_filter - (filter_size - 1) / 2.0)
  var = torch.exp(lg_var.reshape(-1, 1, 1))
  span = torch.arange(image_size, dtype=torch.float32,
                      device=dev).reshape(1, -1, 1)
  return (1.0 / torch.sqrt(var) / math.sqrt(2 * math.pi)
          * torch.exp(-0.5 * (span - mu) ** 2 / var))


def extract_patch(x, f_y, f_x):
  """patch[b,f,g,d] = sum_hw f_y[b,h,f] x[b,h,w,d] f_x[b,w,g].

  x [B, H, W, D], f_y [B, H, FH], f_x [B, W, FW] -> [B, FH, FW, D]."""
  tmp = torch.einsum('bhf,bhwd->bfwd', f_y, x)
  return torch.einsum('bfwd,bwg->bfgd', tmp, f_x)


def paste_patch(patch, f_y, f_x):
  """out[b,h,w,d] = sum_fg f_y[b,h,f] patch[b,f,g,d] f_x[b,w,g].

  patch [B, FH, FW, D], f_y [B, H, FH], f_x [B, W, FW] -> [B, H, W, D]."""
  tmp = torch.einsum('bhf,bfgd->bhgd', f_y, patch)
  return torch.einsum('bhgd,bwg->bhwd', tmp, f_x)


# ---------------------------------------------------------------------------
# Attention parameter (un)normalisation
# ---------------------------------------------------------------------------

def _img_size(inp_height, inp_width, like):
  return torch.tensor([inp_height, inp_width], dtype=torch.float32,
                      device=like.device)


def get_normalized_center(ctr, inp_height, inp_width):
  """Pixels -> [-1, 1] centre."""
  return ctr / (_img_size(inp_height, inp_width, ctr) / 2.0) - 1.0


def get_normalized_size(size, inp_height, inp_width):
  """Pixels -> log-fraction size."""
  return torch.log(size / _img_size(inp_height, inp_width, size))


def get_normalized_gamma(size, filter_height, filter_width):
  """lg_gamma = log(F_area) - log(box area)."""
  return (math.log(float(filter_height * filter_width))
          - torch.log(torch.prod(size, dim=-1)))


def get_unnormalized_attn(ctr_norm, lg_size, inp_height, inp_width):
  """[-1, 1] centre and log-fraction size -> pixels."""
  img = _img_size(inp_height, inp_width, ctr_norm)
  return (ctr_norm + 1.0) * (img / 2.0), torch.exp(lg_size) * img


def get_normalized_var(size, filter_height, filter_width):
  """lg_var = log(size) - log(filter_size), per (y, x) dim."""
  fsize = _img_size(filter_height, filter_width, size)
  return torch.log(size) - torch.log(fsize)


def get_box_coord(ctr, size):
  return ctr - size / 2.0, ctr + size / 2.0


def get_box_ctr_size(top_left, bot_right):
  return (top_left + bot_right) / 2.0, bot_right - top_left
