"""The fully-convolutional foreground and orientation model: its eval and
train forwards and its loss.

Counterpart of ``rec_attend_tpu/models/fg_model.py``: a CNN of
``cnn_depth`` layers down to 1/32 of the image, then a transposed-conv net
back up, whose layers concatenate ``[h, skip]`` with an earlier CNN feature
map (or the image itself) where the skip masks say (``_dcnn_skip_plan``).
The last layer's channels are the foreground logits (a sigmoid for one
semantic class, else a softmax) and, with ``add_orientation``, the
orientation logits under an 8-bin softmax.  BatchNorm keeps one copy of its
parameters, not one per timestep as in the full model.  The JAX eval
augmentation is a centre crop of the padded image, the identity, and is not
ported.

Training (``fg_model_loss``, JAX ``:121-182``) crops the foreground and
orientation targets with the image (``ops/image_ops``), runs BatchNorm on
the batch statistics and returns their new EMA, and takes BCE (one class)
or CE (a softmax over several) of the foreground plus the orientation CE
over the foreground pixels.  The augmentation's draws are an input
(``draw_fg_randoms``), as the full model's are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rec_attend_tpu_torch.config import FGModelConfig
from rec_attend_tpu_torch.device import resolve_device
from rec_attend_tpu_torch.models.family import Family
from rec_attend_tpu_torch.nn import layers as L
from rec_attend_tpu_torch.ops import image_ops, losses

# Batch keys the train step reads: the image, the foreground (C channels)
# and the one-hot orientation.
BATCH_KEYS = ('x', 'c_gt', 'd_gt')
METRIC_KEYS = ('loss', 'foreground_loss', 'iou_soft', 'iou_hard', 'wd_loss',
               'learn_rate')
ORIENTATION_METRIC_KEYS = ('orientation_ce', 'orientation_acc')


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


def _check_x(model, x):
  cfg = model.cfg
  b = x.shape[0]
  if tuple(x.shape) != (b, cfg.inp_height, cfg.inp_width, cfg.inp_depth):
    raise ValueError(f'x is {tuple(x.shape)}, the model takes '
                     f'[B,{cfg.inp_height},{cfg.inp_width},{cfg.inp_depth}]')
  if x.device != model.device:
    raise ValueError(f'x is on {x.device}, the model on {model.device}')


def _head(model, x, stats=None):
  """The CNN and DCNN on NHWC x; returns the last layer's NHWC logits.
  With ``stats`` a list, BatchNorm runs on the batch statistics and
  appends each layer's new EMA (``L.apply_cnn``)."""
  cfg = model.cfg
  n_c, n_d = len(cfg.cnn_filter_size), len(cfg.dcnn_filter_size)
  x = L.nchw(x)
  h_cnn = L.apply_cnn(model.cnn, x, cfg.cnn_pool, [F.relu] * n_c, None,
                      stats)
  feats = [x] + h_cnn[:-1]
  skips = [None if i is None else feats[i]
           for i in _dcnn_skip_plan(cfg)[0]]
  return L.nhwc(L.apply_dcnn(model.dcnn, h_cnn[-1], cfg.dcnn_pool,
                             [F.relu] * (n_d - 1) + [None], None,
                             skip=skips, stats=stats)[-1])


def _maps(cfg, head):
  """{'y_out', 'd_out'}: the heads' sigmoid or softmax maps."""
  n_sem = cfg.num_semantic_classes
  y_logits = head[..., :n_sem]
  out = {}
  if cfg.add_orientation:
    out['d_out'] = torch.softmax(head[..., n_sem:], dim=-1).contiguous()
  out['y_out'] = (torch.sigmoid(y_logits) if n_sem == 1
                  else torch.softmax(y_logits, dim=-1)).contiguous()
  return out


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
  _check_x(model, x)
  return _maps(model.cfg, _head(model, x.float()))


def draw_fg_randoms(cfg: FGModelConfig, generator):
  """The draws of one training forward: 'aug', the crop offset and flip
  coins (``image_ops.draw_transformation``)."""
  return {'aug': image_ops.draw_transformation(cfg.padding, generator,
                                               colour=cfg.rnd_colour)}


def fg_model_train_forward(model: FGModel, x, c_gt, d_gt, draws,
                           train=True):
  """The forward with the targets (JAX ``fg_model_forward(train=True)``,
  or with ``train=False`` its eval branch: no crop, BatchNorm on its EMA
  statistics, no draws, which may then be None).

  Args:
    x: [B,H,W,inp_depth] images; c_gt: [B,H,W,num_semantic_classes]
      foreground; d_gt: [B,H,W,num_orientation_classes] one-hot
      orientation (not read without the orientation head, and then it
      does not keep the flips off); float, on the model's device.
    draws: ``draw_fg_randoms``.
  Returns:
    (outputs, new_bn): outputs holds the maps of ``fg_model_forward`` and
    the cropped 'x_trans', 'y_gt_trans' (the foreground) and, with the
    orientation head, 'd_gt_trans'; new_bn maps each EMA buffer name
    ('cnn.0.bn.ema_mean', ...) to its new [C] value (empty in eval).
  """
  cfg = model.cfg
  _check_x(model, x)
  if not cfg.add_orientation:
    d_gt = None
  elif d_gt is None:
    raise ValueError('the orientation head needs d_gt')
  d_gt = None if d_gt is None else d_gt.float()
  aug = {'x': x.float(), 'c': c_gt.float(), 'd': d_gt}
  if train:
    aug = image_ops.random_transformation(
        aug['x'], cfg.padding, draws['aug'], rnd_hflip=cfg.rnd_hflip,
        rnd_vflip=cfg.rnd_vflip, rnd_transpose=cfg.rnd_transpose,
        rnd_colour=cfg.rnd_colour, y=None, d=d_gt, c=aug['c'])
  stats = [] if train else None
  outputs = _maps(cfg, _head(model, aug['x'], stats))
  outputs.update(x_trans=aug['x'], y_gt_trans=aug['c'])
  if cfg.add_orientation:
    outputs['d_gt_trans'] = aug['d']
  new_bn = {}
  layers = [f'cnn.{i}' for i in range(len(model.cnn))] + [
      f'dcnn.{i}' for i in range(len(model.dcnn))]
  for name, pair in zip(layers, stats or ()):
    if pair is not None:
      new_bn[f'{name}.bn.ema_mean'], new_bn[f'{name}.bn.ema_var'] = pair
  return outputs, new_bn


def fg_model_loss(model: FGModel, batch, draws, step, train=True):
  """Total loss and metrics of one batch, in training or, with
  ``train=False``, in eval (JAX ``fg_model_loss``).

  Args:
    batch: dict 'x' [B,H,W,D], 'c_gt' [B,H,W,C] and, with the orientation
      head, 'd_gt' [B,H,W,8], float, on the model's device.
    draws: ``draw_fg_randoms``; step: the global step (for the reported
      learning rate); train: as in ``fg_model_train_forward``.
  Returns:
    (loss, aux): aux holds ``METRIC_KEYS`` (and, with the orientation
    head, ``ORIENTATION_METRIC_KEYS``) as 0-d tensors, 'outputs' and
    'new_bn'.
  """
  from rec_attend_tpu_torch.models.full_model import learn_rate
  cfg = model.cfg
  outputs, new_bn = fg_model_train_forward(
      model, batch['x'], batch['c_gt'], batch.get('d_gt'), draws,
      train)
  y_out, y_gt = outputs['y_out'], outputs['y_gt_trans']
  num_pixel = y_out.shape[0] * y_out.shape[1] * y_out.shape[2]
  if cfg.num_semantic_classes > 1:
    y_gt_mask = torch.amax(y_gt[..., 1:], dim=-1, keepdim=True)
    y_out_hard = (y_out == torch.amax(y_out, dim=-1,
                                      keepdim=True)).float()
    iou_soft = losses.f_iou_all(y_out[..., 1:], y_gt[..., 1:])
    iou_hard = losses.f_iou_all(y_out_hard[..., 1:], y_gt[..., 1:])
    segloss = torch.sum(losses.f_ce(y_out, y_gt)) / num_pixel
  else:
    y_gt_mask = y_gt
    y_out_hard = (y_out > 0.5).float()
    iou_soft = losses.f_iou_all(y_out, y_gt)
    iou_hard = losses.f_iou_all(y_out_hard, y_gt)
    segloss = torch.sum(losses.f_bce(y_out, y_gt)) / num_pixel
  if cfg.segm_loss_fn == 'iou':
    loss = -iou_soft
  elif cfg.segm_loss_fn == 'bce':
    loss = segloss
  else:
    raise ValueError(f'Unknown segm_loss_fn: {cfg.segm_loss_fn}')
  scalars = {'foreground_loss': loss, 'iou_soft': iou_soft,
             'iou_hard': iou_hard}
  if cfg.add_orientation:
    # The orientation CE over the foreground pixels; JAX divides by their
    # count without a guard, and so does this.
    d_out, d_gt = outputs['d_out'], outputs['d_gt_trans']
    ori_ce = torch.sum(losses.f_ce(d_out, d_gt) * y_gt_mask) / torch.sum(
        y_gt_mask)
    loss = loss + ori_ce
    with torch.no_grad():
      correct = (torch.argmax(d_out, dim=-1)
                 == torch.argmax(d_gt, dim=-1)).float()
      mask = y_gt_mask[..., 0]
      scalars['orientation_acc'] = torch.sum(correct * mask) / torch.sum(mask)
    scalars['orientation_ce'] = ori_ce
  wd_loss = L.weight_decay_loss(model, cfg.weight_decay)
  total = loss + wd_loss
  scalars.update(loss=total,
                 wd_loss=torch.as_tensor(wd_loss, device=total.device))
  aux = {k: v.detach() for k, v in scalars.items()}
  aux.update(learn_rate=torch.tensor(learn_rate(cfg, step),
                                     device=total.device),
             outputs=outputs, new_bn=new_bn)
  return total, aux


def metric_keys(cfg: FGModelConfig):
  """The metrics of a train step: the orientation's with its head."""
  return METRIC_KEYS + (ORIENTATION_METRIC_KEYS if cfg.add_orientation
                        else ())


# The fg model has no glimpse, its draws do not depend on the batch size,
# and it freezes nothing.
FAMILY = Family(
    name='fg', model=FGModel,
    loss=lambda model, batch, draws, step, glimpse, train=True: fg_model_loss(
        model, batch, draws, step, train),
    draws=lambda cfg, batch_size, generator: draw_fg_randoms(cfg, generator),
    batch_keys=BATCH_KEYS, metric_keys=metric_keys,
    frozen_nets=lambda cfg: frozenset(), optimizer=lambda cfg: cfg.optimizer,
    batch_variables=BATCH_KEYS,
    batch_map={'x': 'x', 'c_gt': 'c_gt', 'd_gt': 'd_gt'},
    eval_metrics=('loss', 'iou_soft', 'iou_hard', 'foreground_loss',
                  'orientation_ce', 'orientation_acc', 'learn_rate'))
