"""The fully-convolutional foreground and orientation model, eval forward.

Counterpart of ``rec_attend_tpu/models/fg_model.py:24-118``: a CNN of
``cnn_depth`` layers down to 1/32 of the image, then a transposed-conv net
back up, whose layers concatenate ``[h, skip]`` with an earlier CNN feature
map (or the image itself) where the skip masks say (``_dcnn_skip_plan``).
The last layer's channels are the foreground logits (a sigmoid for one
semantic class, else a softmax) and, with ``add_orientation``, the
orientation logits under an 8-bin softmax.  BatchNorm keeps one copy of its
parameters, not one per timestep as in the full model.  The JAX eval
augmentation is a centre crop of the padded image, the identity, and is not
ported.  The loss (``:126-182``) comes with the fg model's training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rec_attend_tpu_torch.config import FGModelConfig
from rec_attend_tpu_torch.device import resolve_device
from rec_attend_tpu_torch.nn import layers as L


def _dcnn_skip_plan(cfg: FGModelConfig):
  """Which CNN feature feeds each DCNN layer (JAX fg_model.py:24-51).

  Returns (skip_src, skip_ch): per DCNN layer the index of its skip source
  in ``[x] + h_cnn[:-1]`` (or None) and its channel count (0 without), or
  (all None, None) without skip connections.  The sources marked by the CNN
  skip mask are taken deepest first, one for each DCNN layer that its own
  mask marks; layer 0 never takes one."""
  cnn_ch = (cfg.inp_depth,) + tuple(cfg.cnn_depth)
  n = len(cfg.dcnn_filter_size)
  if not cfg.add_skip_conn:
    return [None] * n, None
  src_idx = [i for i, sk in enumerate(cfg.resolved_cnn_skip_mask()) if sk]
  counter = len(src_idx) - 1
  skip_src, skip_ch = [None], [0]
  for sk in cfg.resolved_dcnn_skip_mask():
    if sk:
      skip_src.append(src_idx[counter])
      skip_ch.append(cnn_ch[src_idx[counter]])
      counter -= 1
    else:
      skip_src.append(None)
      skip_ch.append(0)
  return (skip_src + [None] * n)[:n], (skip_ch + [0] * n)[:n]


class FGModel(nn.Module):
  """Parameters of the fg model, named as the JAX parameter tree
  (``cnn.0.w``, ``cnn.0.bn.ema_mean`` [C], ``dcnn.10.b``, ...), initialised
  from ``seed`` (truncated normal, stddev 0.01) and placed on ``device``
  (default ``cuda``)."""

  def __init__(self, cfg: FGModelConfig, seed=0, device=None):
    super().__init__()
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    n_c, n_d = len(cfg.cnn_filter_size), len(cfg.dcnn_filter_size)
    want = cfg.num_semantic_classes + (
        cfg.num_orientation_classes if cfg.add_orientation else 0)
    if cfg.dcnn_depth[-1] != want:
      raise ValueError(f'last dcnn depth {cfg.dcnn_depth[-1]}, the heads '
                       f'take {want}')
    self.cfg = cfg
    self.cnn = L.init_cnn(cfg.cnn_filter_size,
                          (cfg.inp_depth,) + tuple(cfg.cnn_depth),
                          [cfg.use_bn] * n_c, None, g)
    self.dcnn = L.init_dcnn(cfg.dcnn_filter_size,
                            (cfg.cnn_depth[-1],) + tuple(cfg.dcnn_depth),
                            [cfg.use_bn] * (n_d - 1) + [False],
                            _dcnn_skip_plan(cfg)[1], None, g)
    self.to(device)
    self.device = self.cnn[0].w.device

  def forward(self, x):
    return fg_model_forward(self, x)


@torch.no_grad()
def fg_model_forward(model: FGModel, x):
  """The eval forward (JAX ``fg_model_forward(train=False)``).

  Args:
    x: [B,H,W,inp_depth] images on the model's device.
  Returns:
    dict: 'y_out' [B,H,W,num_semantic_classes] (sigmoid of one class, else
    softmax over the classes) and, with ``add_orientation``, 'd_out'
    [B,H,W,num_orientation_classes] (softmax).
  """
  cfg = model.cfg
  b = x.shape[0]
  if tuple(x.shape) != (b, cfg.inp_height, cfg.inp_width, cfg.inp_depth):
    raise ValueError(f'x is {tuple(x.shape)}, the model takes '
                     f'[B,{cfg.inp_height},{cfg.inp_width},{cfg.inp_depth}]')
  if x.device != model.device:
    raise ValueError(f'x is on {x.device}, the model on {model.device}')
  n_c, n_d = len(cfg.cnn_filter_size), len(cfg.dcnn_filter_size)
  x = L.nchw(x.float())
  h_cnn = L.apply_cnn(model.cnn, x, cfg.cnn_pool, [F.relu] * n_c, None)
  feats = [x] + h_cnn[:-1]
  skips = [None if i is None else feats[i]
           for i in _dcnn_skip_plan(cfg)[0]]
  head = L.nhwc(L.apply_dcnn(model.dcnn, h_cnn[-1], cfg.dcnn_pool,
                             [F.relu] * (n_d - 1) + [None], None,
                             skip=skips)[-1])
  n_sem = cfg.num_semantic_classes
  y_logits = head[..., :n_sem]
  out = {}
  if cfg.add_orientation:
    out['d_out'] = torch.softmax(head[..., n_sem:], dim=-1).contiguous()
  out['y_out'] = (torch.sigmoid(y_logits) if n_sem == 1
                  else torch.softmax(y_logits, dim=-1)).contiguous()
  return out
