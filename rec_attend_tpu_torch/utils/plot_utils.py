"""Matplotlib renders of a training run's samples, for the dashboard.

Counterpart of ``rec_attend_tpu/utils/plot_utils.py``: grids of the input
images under their ground-truth masks, the output masks with their
attention boxes and scores, the count of instances at each pixel, glimpse
thumbnails and the controller's glimpse maps, written as PNGs and
registered in the run's catalog (``utils/log_manager.py``).  This is the
only module of the package that imports matplotlib, and only when it
plots; a training run on a machine without it logs a warning and trains
on, as in JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rec_attend_tpu_torch import train_step as ts
from rec_attend_tpu_torch.models import full_model

_CMAP = np.array(
    [[192, 57, 43], [243, 156, 18], [26, 188, 156], [41, 128, 185],
     [142, 68, 173], [44, 62, 80], [127, 140, 141], [17, 75, 95],
     [2, 128, 144], [228, 253, 225], [69, 105, 144], [244, 91, 105],
     [91, 192, 235], [253, 231, 76], [155, 197, 61], [229, 89, 52],
     [250, 121, 33], [124, 82, 47], [86, 15, 94], [38, 63, 77],
     [1, 52, 55], [63, 29, 82]], dtype='float32') / 255.0


def _pyplot():
  # matplotlib (with the PIL it imports) only where a plot is made: the
  # package imports without it.
  import matplotlib
  matplotlib.use('Agg')
  import matplotlib.pyplot as plt
  return plt


def _grid(n):
  cols = int(np.ceil(np.sqrt(n)))
  rows = int(np.ceil(n / cols))
  return rows, cols


def plot_input(fname, x, y_gt=None, s_gt=None, max_items=8):
  """Input images overlaid with GT masks (ref plot_utils.py:47-90)."""
  plt = _pyplot()
  n = min(len(x), max_items)
  rows, cols = _grid(n)
  fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                           squeeze=False)
  for ii in range(rows * cols):
    ax = axes[ii // cols][ii % cols]
    ax.axis('off')
    if ii >= n:
      continue
    img = np.clip(x[ii], 0, 1).copy()
    if y_gt is not None:
      for jj in range(y_gt.shape[1]):
        mask = y_gt[ii, jj]
        if mask.sum() == 0:
          continue
        colour = _CMAP[jj % len(_CMAP)]
        img = img * (1 - 0.5 * mask[..., None]) + \
            0.5 * mask[..., None] * colour
    ax.imshow(np.clip(img, 0, 1))
  fig.tight_layout()
  fig.savefig(fname, dpi=80)
  plt.close(fig)


def plot_output(fname, y_out, s_out=None, attn=None, max_items=8):
  """Instance masks + attention boxes + confidence (ref
  plot_utils.py:93-180).  attn: optional (top_left, bot_right) [B, T, 2]."""
  plt = _pyplot()
  n = min(len(y_out), max_items)
  rows, cols = _grid(n)
  fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                           squeeze=False)
  for ii in range(rows * cols):
    ax = axes[ii // cols][ii % cols]
    ax.axis('off')
    if ii >= n:
      continue
    t, h, w = y_out[ii].shape
    comp = np.zeros([h, w, 3])
    for jj in range(t):
      comp += y_out[ii][jj][..., None] * _CMAP[jj % len(_CMAP)]
    ax.imshow(np.clip(comp, 0, 1))
    if attn is not None:
      tl, br = attn
      for jj in range(t):
        if s_out is not None and s_out[ii][jj] < 0.5:
          continue
        y0, x0 = tl[ii, jj]
        y1, x1 = br[ii, jj]
        ax.add_patch(plt.Rectangle(
            (x0, y0), x1 - x0, y1 - y0, fill=False,
            edgecolor=_CMAP[jj % len(_CMAP)], linewidth=1))
    if s_out is not None:
      ax.set_title(' '.join(f'{s:.2f}' for s in s_out[ii][:6]), fontsize=6)
  fig.tight_layout()
  fig.savefig(fname, dpi=80)
  plt.close(fig)


def plot_total_instances(fname, y_out, max_items=8):
  """Cumulative instance count composite (ref plot_utils.py:183-212)."""
  plt = _pyplot()
  n = min(len(y_out), max_items)
  rows, cols = _grid(n)
  fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                           squeeze=False)
  for ii in range(rows * cols):
    ax = axes[ii // cols][ii % cols]
    ax.axis('off')
    if ii >= n:
      continue
    total = (y_out[ii] > 0.5).sum(axis=0)
    ax.imshow(total, cmap='viridis')
  fig.tight_layout()
  fig.savefig(fname, dpi=80)
  plt.close(fig)


def plot_thumbnails(fname, patches, max_items=16):
  """Glimpse patch thumbnails (ref plot_utils.py:215-246)."""
  plt = _pyplot()
  imgs = patches.reshape(-1, *patches.shape[-3:])[:max_items]
  n = len(imgs)
  rows, cols = _grid(n)
  fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows),
                           squeeze=False)
  for ii in range(rows * cols):
    ax = axes[ii // cols][ii % cols]
    ax.axis('off')
    if ii >= n:
      continue
    img = imgs[ii]
    if img.shape[-1] == 1:
      ax.imshow(img[..., 0], cmap='gray')
    else:
      ax.imshow(np.clip(img[..., :3], 0, 1))
  fig.tight_layout()
  fig.savefig(fname, dpi=80)
  plt.close(fig)


def plot_double_attention(fname, x, glimpse_map, max_items=4):
  """Glimpse heatmaps over the input (ref plot_utils.py:249-315).

  glimpse_map: [B, T, G, H', W']."""
  plt = _pyplot()
  n = min(len(x), max_items)
  t = min(glimpse_map.shape[1], 4)
  g = glimpse_map.shape[2]
  fig, axes = plt.subplots(n * t, g, figsize=(2 * g, 2 * n * t),
                           squeeze=False)
  for ii in range(n):
    for jj in range(t):
      for kk in range(g):
        ax = axes[ii * t + jj][kk]
        ax.axis('off')
        ax.imshow(glimpse_map[ii, jj, kk], cmap='inferno')
  fig.tight_layout()
  fig.savefig(fname, dpi=60)
  plt.close(fig)


def plot_experiment_samples(exp, spec):
  """The train command line's plot hook: renders the outputs of the
  model's eval forward on the experiment's device, over the first
  ``num_samples_plot`` examples of the next train batch, and registers the
  PNGs in the catalog, the names and order of the JAX package's."""
  # Without matplotlib no batch is drawn, no forward runs and nothing is
  # registered, as in JAX, whose module imports it.
  _pyplot()
  folder = exp.logs_folder
  batch = next(exp.train_iter)
  n = min(len(next(iter(batch.values()))), exp.train_cfg.num_samples_plot)
  batch = {k: v[:n] for k, v in batch.items()}
  trainer = exp.trainer
  device_batch = ts.decode_batch({
      k: torch.as_tensor(np.asarray(v)).to(exp.device)
      for k, v in batch.items() if k in trainer.family.batch_keys})
  # The draws are taken as JAX takes a key, though the eval forward reads
  # none.
  draws = trainer.draws(n)
  with torch.no_grad():
    if spec == 'full':
      # The forward alone, with what the plots read (JAX's forward_fn).
      outputs, _ = full_model.full_model_train_forward(
          trainer.model, device_batch['x'], device_batch['y_gt'],
          device_batch['s_gt'], draws, exp.step, 'kernel',
          d_in=device_batch.get('d_in'), y_in=device_batch.get('y_in'),
          train=False, plot=True)
    else:
      outputs = trainer.family.loss(trainer.model, device_batch, draws,
                                    exp.step, 'kernel',
                                    train=False)[1]['outputs']
  outputs = {k: v.float().cpu().numpy() for k, v in outputs.items()
             if torch.is_tensor(v)}

  def reg(name):
    fname = os.path.join(folder, f'{name}.png')
    exp.log_manager.register(fname, 'image', name)
    return fname

  if spec == 'fg':
    plot_input(reg('input'), outputs['x_trans'])
    y = outputs['y_out']
    y = y[..., 0] if y.shape[-1] == 1 else y.max(axis=-1)
    plot_total_instances(reg('output'), y[:, None])
    return
  plot_input(reg('input'), outputs['x_trans'], outputs['y_gt_trans'],
             batch.get('s_gt'))
  attn = (outputs['attn_top_left'], outputs['attn_bot_right'])
  if spec == 'full':
    plot_output(reg('output'), outputs['y_out'], outputs['s_out'], attn)
    plot_total_instances(reg('total_instances'), outputs['y_out'])
    plot_thumbnails(reg('patch'), outputs['x_patch'][:, :4, :, :, :3])
  else:
    plot_output(reg('output'), outputs['attn_box'], outputs['s_out'], attn)
  if 'glimpse_map' in outputs:
    plot_double_attention(reg('glimpse'), outputs['x_trans'],
                          outputs['glimpse_map'])
