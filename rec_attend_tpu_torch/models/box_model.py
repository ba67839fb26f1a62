"""The box model: the full model's controller trained alone.

Counterpart of ``rec_attend_tpu/models/box_model.py``.  ``BoxModel`` holds
the parameters of ``init_box_model`` (``:24-40``) under the same names: the
controller CNN with one BatchNorm copy per timestep, its LSTM, the glimpse
and controller MLPs, and a score MLP on the LSTM state alone.  At each of T
timesteps the controller (``full_model.controller``, the same computation)
looks at image (+) canvas (+) the packed orientation and foreground maps
and emits an attention box, rendered by pasting a constant patch of ones
through the box's Gaussian filters (``glimpse_paste``: the hand-written
kernel on the card).  There is no mask decoder: in training and in eval
alike the canvas takes the ground-truth instance that the box matches
greedily, degraded by a uniform noise (``:184-203``).  The loss
(``box_model_loss``, ``:257-335``) is the box loss plus the confidence loss
under the Hungarian matching of the boxes.

As in the full model, the ``lax.scan`` over T is a Python loop, with
``cfg.remat`` under ``torch.utils.checkpoint`` per timestep, and the random
draws (the augmentation's and the per-timestep canvas noise) are inputs
made before the loop (``draw_box_randoms``).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from rec_attend_tpu_torch.config import BoxModelConfig
from rec_attend_tpu_torch.device import resolve_device
from rec_attend_tpu_torch.nn import layers as L
from rec_attend_tpu_torch.nn import params as P
from rec_attend_tpu_torch.ops import attention, boxes, image_ops, losses
from rec_attend_tpu_torch.ops import matching
from rec_attend_tpu_torch.models.family import Family
from rec_attend_tpu_torch.models.full_model import ATTN_BOX_BETA
from rec_attend_tpu_torch.models.full_model import BATCH_KEYS
from rec_attend_tpu_torch.models.full_model import BATCH_MAP
from rec_attend_tpu_torch.models.full_model import BATCH_VARIABLES
from rec_attend_tpu_torch.models.full_model import _glimpse_fns
from rec_attend_tpu_torch.models.full_model import _stack_steps
from rec_attend_tpu_torch.models.full_model import attention_params
from rec_attend_tpu_torch.models.full_model import controller
from rec_attend_tpu_torch.models.full_model import gaussian_filters
from rec_attend_tpu_torch.models.full_model import learn_rate

METRIC_KEYS = ('loss', 'box_loss', 'conf_loss', 'wd_loss', 'iou_soft_box',
               'learn_rate')


class BoxModel(nn.Module):
  """Parameters of the box model, named as the JAX parameter tree
  (``ctrl_cnn.0.w``, ``ctrl_cnn.0.bn.ema_mean`` [T,C], ``ctrl_lstm.w_xi``,
  ``glimpse_mlp.0.w``, ``ctrl_mlp.0.w``, ``score_mlp.0.w``), initialised
  from ``seed`` (truncated normal, stddev 0.01) and placed on ``device``
  (default ``cuda``).  ``load_pretrained`` starts nets from the config's
  ``weights.h5`` files."""

  def __init__(self, cfg: BoxModelConfig, seed=0, device=None):
    super().__init__()
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    gmlp_dims = ([cfg.ctrl_rnn_hid_dim] * cfg.num_glimpse_mlp_layers
                 + [cfg.glimpse_map_dim])
    cmlp_dims = ([cfg.ctrl_rnn_hid_dim]
                 + [cfg.ctrl_mlp_dim] * (cfg.num_ctrl_mlp_layers - 1) + [9])
    self.cfg = cfg
    self.ctrl_cnn = L.init_cnn(
        cfg.ctrl_cnn_filter_size,
        (cfg.ccnn_inp_depth,) + tuple(cfg.ctrl_cnn_depth),
        [cfg.use_bn] * len(cfg.ctrl_cnn_filter_size), cfg.timespan, g)
    self.ctrl_lstm = L.LSTM(cfg.glimpse_feat_dim, cfg.ctrl_rnn_hid_dim, g)
    self.glimpse_mlp = L.init_mlp(gmlp_dims, g)
    self.ctrl_mlp = L.init_mlp(cmlp_dims, g)
    self.score_mlp = L.init_mlp(
        [cfg.ctrl_rnn_hid_dim, cfg.num_semantic_classes], g)
    self.to(device)
    self.device = self.ctrl_lstm.b_f.device


def draw_box_randoms(cfg: BoxModelConfig, batch_size, generator):
  """Every random draw of one box forward, made before the T loop:
  'aug' (``image_ops.draw_transformation``, read in training only) and
  'segm_noise' [T,B,H,W,1], uniform in [0, gt_segm_noise), on the
  generator's device."""
  dev = generator.device
  aug = image_ops.draw_transformation(cfg.padding, generator,
                                     colour=cfg.rnd_colour)
  noise = torch.rand((cfg.timespan, batch_size, cfg.inp_height,
                      cfg.inp_width, 1), generator=generator, device=dev)
  return {'aug': aug, 'segm_noise': noise * cfg.gt_segm_noise}


def _check_input(model, x, d_in, y_in):
  cfg = model.cfg
  b, h, w = x.shape[0], cfg.inp_height, cfg.inp_width
  if tuple(x.shape) != (b, h, w, cfg.inp_depth):
    raise ValueError(f'x is {tuple(x.shape)}, the model takes '
                     f'[B,{h},{w},{cfg.inp_depth}]')
  for name, a, depth, wanted in (
      ('d_in', d_in, 8, cfg.add_d_out),
      ('y_in', y_in, cfg.num_semantic_classes, cfg.add_y_out)):
    if wanted != (a is not None):
      raise ValueError(f'{name} is {"missing" if wanted else "given"}: the '
                       f'config {"asks" if wanted else "does not ask"} for '
                       'it')
    if a is not None and (tuple(a.shape) != (b, h, w, depth)
                          or a.device != model.device):
      raise ValueError(f'{name} is {tuple(a.shape)} on {a.device}, the '
                       f'model takes [{b},{h},{w},{depth}] on {model.device}')
  if x.device != model.device:
    raise ValueError(f'x is on {x.device}, the model on {model.device}')


def _timestep(model, x, packed, canvas, grd_cum, t, gt, segm_noise,
              paste_fn, stats):
  """One timestep (JAX box_model.py:130-242).

  Args:
    x: [B,H,W,D]; packed: [B,H,W,8+C] (or fewer channels, or None), the
      packed maps in the order d_in, y_in; canvas [B,H,W,1]; grd_cum [B,T],
      the greedy-match mask; gt: the ground truth ('y_gt' [B,T,H,W],
      'attn_box_gt' [B,T,H,W], 'attn_top_left_gt'/'attn_bot_right_gt'
      [B,T,2]); segm_noise [B,H,W,1]; stats: None in eval, else a list
      that gains the controller CNN's new BatchNorm statistics.
  Returns:
    (canvas, grd_cum, step outputs, stats).
  """
  cfg = model.cfg
  B = x.shape[0]
  FH, FW = cfg.filter_height, cfg.filter_width
  parts = [x, canvas] + ([] if packed is None else [packed])
  h_crnn, ctrl_out, glimpse_maps = controller(model, torch.cat(parts, dim=3),
                                              t, stats)
  (attn_ctr_norm, attn_lg_size, attn_ctr, attn_size,
   attn_lg_var) = attention_params(cfg, ctrl_out)
  attn_box_lg_gamma = ctrl_out[:, 7:8]
  attn_top_left, attn_bot_right = attention.get_box_coord(attn_ctr,
                                                          attn_size)
  # The box: the gain times the paste of a patch of ones (JAX :177-180).
  f_y, f_x = gaussian_filters(cfg, attn_ctr, attn_size, attn_lg_var)
  ones = torch.ones((B, FH, FW, 1), device=x.device)
  attn_box = torch.exp(attn_box_lg_gamma).view(B, 1, 1, 1) * paste_fn(
      ones, f_y, f_x)
  attn_box = torch.sigmoid(attn_box + ATTN_BOX_BETA)[..., 0]     # [B,H,W]

  # The canvas takes the ground truth the box matches (JAX :184-203).
  step_out = {}
  if cfg.fixed_order:
    y_sel = gt['y_gt'][:, t, :, :, None]
  else:
    if cfg.use_iou_box:
      iou_soft_box_t = losses.f_iou_box(
          attn_top_left[:, None, :], attn_bot_right[:, None, :],
          gt['attn_top_left_gt'], gt['attn_bot_right_gt'])       # [B,T]
    else:
      iou_soft_box_t = (losses.f_inter(attn_box[:, None], gt['attn_box_gt'])
                        / losses.f_union(attn_box[:, None],
                                         gt['attn_box_gt']))
    step_out['iou_soft_box_t'] = iou_soft_box_t
    grd_match = losses.f_greedy_match(iou_soft_box_t, grd_cum)
    if cfg.accumulate_greedy_match:
      grd_cum = torch.clamp_max(grd_cum + grd_match, 1.0)
    y_sel = torch.einsum('bt,bthw->bhw', grd_match, gt['y_gt'])[..., None]
  y_sel = y_sel - y_sel * segm_noise
  canvas = torch.maximum(y_sel, canvas).detach()

  s_logits = L.apply_mlp(model.score_mlp, h_crnn, [None])[-1]
  s_out = (torch.sigmoid(s_logits) if cfg.num_semantic_classes == 1
           else torch.softmax(s_logits, dim=-1))
  step_out.update(
      s_out=s_out, attn_box=attn_box, attn_ctr=attn_ctr, attn_size=attn_size,
      attn_top_left=attn_top_left, attn_bot_right=attn_bot_right,
      attn_ctr_norm=attn_ctr_norm, attn_lg_size=attn_lg_size,
      glimpse_map=torch.stack(glimpse_maps, dim=1)[..., 0].reshape(
          B, cfg.num_ctrl_rnn_iter, cfg.crnn_h, cfg.crnn_w))
  return canvas, grd_cum, step_out, stats


def box_model_forward(model: BoxModel, batch, draws, train=True,
                      glimpse='kernel'):
  """Run the T-step box forward (JAX ``box_model_forward``).

  Args:
    batch: 'x' [B,H,W,D], 'y_gt' [B,T,H,W], 's_gt' [B,T] and, where the
      config reads them, the packed 'd_in' [B,H,W,8] and 'y_in'
      [B,H,W,C], float, on the model's device.
    draws: ``draw_box_randoms``; eval reads only 'segm_noise' (its
      augmentation is the centre crop, the identity).
    train: BatchNorm on the batch statistics and the augmentation's crop,
      or eval (the EMA statistics, no crop).
    glimpse: 'kernel' (the paste kernel; its plain version on the CPU),
      'plain' or a pair of functions, as in ``full_model_forward``.
  Returns:
    (outputs, new_bn): outputs holds per timestep (dim 1) 's_out' [B,T]
    ([B,T,C] for several classes), 'attn_box' [B,T,H,W], 'attn_ctr',
    'attn_size', 'attn_top_left', 'attn_bot_right', 'attn_ctr_norm',
    'attn_lg_size' [B,T,2], 'glimpse_map' [B,T,iters,h,w],
    'iou_soft_box_t' [B,T,T] (without ``fixed_order``), and the cropped
    'x_trans', 'y_gt_trans', 's_gt' and the ground-truth boxes; new_bn
    maps each EMA buffer name to its new [T,C] value (empty in eval).
  """
  _, paste_fn = _glimpse_fns(glimpse)
  cfg = model.cfg
  x, y_gt, s_gt = batch['x'], batch['y_gt'], batch['s_gt']
  d_in, y_in = batch.get('d_in'), batch.get('y_in')
  _check_input(model, x, d_in, y_in)
  B, T = x.shape[0], cfg.timespan
  H, W = cfg.inp_height, cfg.inp_width
  x, y_gt = x.float(), y_gt.float()
  d_in = None if d_in is None else d_in.float()
  y_in = None if y_in is None else y_in.float()
  if train:
    aug = image_ops.random_transformation(
        x, cfg.padding, draws['aug'], rnd_hflip=cfg.rnd_hflip,
        rnd_vflip=cfg.rnd_vflip, rnd_transpose=cfg.rnd_transpose,
        rnd_colour=cfg.rnd_colour, y=y_gt, d=d_in, c=y_in)
    x, y_gt = aug['x'], aug['y']
    d_in, y_in = aug.get('d'), aug.get('c')
  packed = [a for a in (d_in, y_in) if a is not None]
  packed = torch.cat(packed, dim=3) if packed else None

  # Ground-truth boxes (JAX :104-111).
  attn_top_left_gt, attn_bot_right_gt, attn_box_gt = boxes.get_gt_box(
      y_gt, padding_ratio=cfg.attn_box_padding_ratio, center_shift_ratio=0.0)
  attn_ctr_gt, attn_size_gt = attention.get_box_ctr_size(attn_top_left_gt,
                                                         attn_bot_right_gt)
  gt = {'y_gt': y_gt, 'attn_box_gt': attn_box_gt,
        'attn_top_left_gt': attn_top_left_gt,
        'attn_bot_right_gt': attn_bot_right_gt}

  def body(canvas, grd_cum, t):
    return _timestep(model, x, packed, canvas, grd_cum, t, gt,
                     draws['segm_noise'][t], paste_fn,
                     [] if train else None)

  canvas = torch.zeros((B, H, W, 1), device=x.device)
  grd_cum = torch.zeros((B, T), device=x.device)
  steps, bn_steps = [], []
  for t in range(T):
    if cfg.remat and train:
      canvas, grd_cum, step_out, stats = torch.utils.checkpoint.checkpoint(
          body, canvas, grd_cum, t, use_reentrant=False,
          preserve_rng_state=False)
    else:
      canvas, grd_cum, step_out, stats = body(canvas, grd_cum, t)
    steps.append(step_out)
    bn_steps.append(stats)

  outputs = _stack_steps(steps)
  if cfg.num_semantic_classes == 1:
    outputs['s_out'] = outputs['s_out'][:, :, 0]
  outputs.update(
      x_trans=x, y_gt_trans=y_gt, s_gt=s_gt, attn_ctr_gt=attn_ctr_gt,
      attn_size_gt=attn_size_gt, attn_top_left_gt=attn_top_left_gt,
      attn_bot_right_gt=attn_bot_right_gt, attn_box_gt=attn_box_gt,
      attn_ctr_norm_gt=attention.get_normalized_center(attn_ctr_gt, H, W),
      attn_lg_size_gt=attention.get_normalized_size(attn_size_gt, H, W))
  new_bn = {}
  if train:
    for i, pair in enumerate(bn_steps[0]):
      if pair is None:
        continue
      for k, key in enumerate(('ema_mean', 'ema_var')):
        new_bn[f'ctrl_cnn.{i}.bn.{key}'] = torch.stack(
            [s[i][k] for s in bn_steps])
  return outputs, new_bn


def box_model_loss(model: BoxModel, batch, draws, step, glimpse='kernel',
                   train=True, matcher='jax'):
  """Box and confidence loss of one batch (JAX ``box_model_loss``).

  Args: as ``box_model_forward``; step: the global step (for the reported
  learning rate); matcher: the Hungarian solver, 'jax' (JAX's default) or
  'native' (``ops/matching.f_segm_match``).
  Returns:
    (loss, aux): aux holds ``METRIC_KEYS`` as 0-d tensors, 'outputs',
    'new_bn' and the boxes' Hungarian matching 'match_box' [B,T,T].
  """
  cfg = model.cfg
  outputs, new_bn = box_model_forward(model, batch, draws, train, glimpse)
  s_gt, s_out = outputs['s_gt'], outputs['s_out']
  attn_box, attn_box_gt = outputs['attn_box'], outputs['attn_box_gt']
  B = attn_box.shape[0]

  if cfg.fixed_order:
    iou_soft_box = losses.f_iou(attn_box, attn_box_gt)             # [B,T]
    match_box = matching.get_identity_match(cfg.timespan, s_gt)
    iou_soft_box_mask = iou_soft_box
  else:
    iou_soft_box = outputs['iou_soft_box_t']                      # [B,T,T]
    match_box = matching.f_segm_match(iou_soft_box, s_gt, matcher=matcher)
    iou_soft_box_mask = torch.sum(iou_soft_box * match_box, dim=1)
  match_count_box = torch.clamp_min(torch.sum(match_box, dim=(1, 2)), 1.0)
  iou_soft_box_scalar = torch.sum(
      torch.sum(iou_soft_box_mask, dim=1) / match_count_box) / B

  attn_params = torch.cat([outputs['attn_ctr_norm'],
                           outputs['attn_lg_size']], dim=2)
  attn_params_gt = torch.cat([outputs['attn_ctr_norm_gt'],
                              outputs['attn_lg_size_gt']], dim=2)
  if cfg.box_loss_fn == 'mse':
    box_loss = losses.f_match_loss(attn_params, attn_params_gt, match_box,
                                   losses.f_squared_err)
  elif cfg.box_loss_fn == 'huber':
    box_loss = losses.f_match_loss(attn_params, attn_params_gt, match_box,
                                   losses.f_huber)
  elif cfg.box_loss_fn == 'iou':
    box_loss = -iou_soft_box_scalar
  elif cfg.box_loss_fn == 'wt_cov':
    box_loss = -losses.f_weighted_coverage(iou_soft_box, attn_box_gt)
  elif cfg.box_loss_fn == 'wt_iou':
    # The matched soft IoU weighted by the ground-truth box's area (JAX
    # :305-311).
    wt = losses.f_coverage_weight(attn_box_gt)
    box_loss = -torch.sum(torch.sum(iou_soft_box_mask * wt, dim=1)) / B
  elif cfg.box_loss_fn == 'bce':
    box_loss = losses.f_match_loss(attn_box, attn_box_gt, match_box,
                                   losses.f_bce)
  else:
    raise ValueError(f'Unknown box_loss_fn: {cfg.box_loss_fn}')

  if cfg.num_semantic_classes == 1:
    conf_loss = losses.f_conf_loss(s_out, match_box, use_cum_min=True)
  else:
    conf_loss = losses.f_conf_loss(1 - s_out[:, :, 0], match_box,
                                   use_cum_min=True)
  wd_loss = L.weight_decay_loss(model, cfg.weight_decay)
  total = box_loss + conf_loss + wd_loss
  scalars = {'loss': total, 'box_loss': box_loss, 'conf_loss': conf_loss,
             'wd_loss': torch.as_tensor(wd_loss, device=total.device),
             'iou_soft_box': iou_soft_box_scalar}
  aux = {k: v.detach() for k, v in scalars.items()}
  aux.update(learn_rate=torch.tensor(learn_rate(cfg, step),
                                     device=total.device),
             outputs=outputs, new_bn=new_bn, match_box=match_box)
  return total, aux


def load_pretrained(model: BoxModel, cfg: BoxModelConfig):
  """Start nets of ``model`` from the config's ``weights.h5`` files, in
  place (JAX ``load_pretrained``, ``:46-62``): ``pretrain_net`` or else
  ``pretrain_cnn`` gives the controller CNN (its keys looked for under
  ``attn_cnn``, ``cnn`` and ``ctrl_cnn``), and ``pretrain_net`` also the
  controller and glimpse MLPs, the score MLP and the LSTM (whole)."""
  src = cfg.pretrain_net or cfg.pretrain_cnn
  nets = []
  if src:
    nets.append(('ctrl_cnn', P.load_net_h5(src, 'ctrl_cnn',
                                           cnn_prefix_sniff=True),
                 cfg.timespan))
  if cfg.pretrain_net:
    nets += [(net, P.load_net_h5(cfg.pretrain_net, net), None)
             for net in ('ctrl_mlp', 'glimpse_mlp', 'score_mlp', 'ctrl_lstm')]
  return P.load_nets(model, nets)


def _frozen_nets(cfg: BoxModelConfig):
  """With ``freeze_pretrain_cnn``, a pretrained controller CNN is frozen,
  every layer of it (JAX ``freeze_mask``, ``:65-77``: its files hold the
  whole CNN)."""
  if (cfg.pretrain_net or cfg.pretrain_cnn) and cfg.freeze_pretrain_cnn:
    return frozenset({'ctrl_cnn'})
  return frozenset()


# The box model reads the full model's batch keys.
FAMILY = Family(
    name='box', model=BoxModel, loss=box_model_loss, draws=draw_box_randoms,
    batch_keys=BATCH_KEYS, metric_keys=lambda cfg: METRIC_KEYS,
    frozen_nets=_frozen_nets, optimizer=lambda cfg: 'adam',
    batch_variables=BATCH_VARIABLES, batch_map=BATCH_MAP,
    eval_metrics=('loss', 'box_loss', 'conf_loss', 'iou_soft_box',
                  'learn_rate'),
    load_pretrained=load_pretrained)
