"""The flagship recurrent-attention instance segmentation model.

Counterpart of ``rec_attend_tpu/models/full_model.py``: ``FullModel`` holds
the parameters of ``init_full_model`` (``:44-76``) under the same names;
``full_model_forward`` is ``full_model_forward(train=False)`` (``:198-568``),
``full_model_train_forward`` the forward with the ground truth, its
train=True branch and, with ``train=False``, the eval forward that the loss
in eval mode reads, and ``full_model_loss`` the loss (``:575-722``).  At each of T timesteps a CNN+LSTM controller looks
at image (+) canvas and emits an attention box; a Gaussian glimpse is
cropped (``glimpse_extract``), a CNN/D-CNN segments one instance inside it,
the mask is pasted back (``glimpse_paste``, also used to render the box) and
max-accumulated into the canvas, and a score MLP emits a stop confidence.
Where the config asks for them (the KITTI and Cityscapes presets), the
packed predictions of the fg model, orientation ``d_in`` [B,H,W,8] and
foreground ``y_in`` [B,H,W,C], join the image and the canvas as input
channels of the controller and attention CNNs, in the order x, canvas,
d_in, y_in (JAX ``:303-324``).

With ``dtype: bfloat16`` the controller's and attention's CNNs run in
bfloat16 (JAX :288, :324, :434, :440, :451) with the roundings that XLA
keeps when it compiles them (``nn/layers.py``); the glimpses, the LSTM's
input, the MLPs, the canvas and the losses stay float32.  With
``fixed_order`` timestep t is held to instance t (JAX :398-401, :468-469,
:597-600, :643-658).

The JAX ``lax.scan`` over T is a Python loop carrying the canvas; with
``cfg.remat`` each timestep of training runs under
``torch.utils.checkpoint`` and is recomputed in the backward, as
``jax.checkpoint`` does.  Where the timesteps are independent (no CNN
reads the canvas, no overwrite mask, no knob in training) the JAX
``vmap`` over them is one pass over T·B rows, BatchNorm copy t for the
rows of timestep t (``parallel_decode``, ``_decode``): one extract and two
pastes a forward in place of T and 2T.  Training's random draws
(augmentation, box noise, knob uniforms, segmentation noise) are inputs,
drawn before the loop by
``draw_train_randoms``: a recomputed timestep must see the draws of its
first run, and ``torch.utils.checkpoint`` restores only the global random
state, not an explicit generator's.  The eval centre crop of the JAX
augmentation is the identity and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from rec_attend_tpu_torch.config import FullModelConfig
from rec_attend_tpu_torch.device import resolve_device
from rec_attend_tpu_torch.models.family import Family
from rec_attend_tpu_torch.nn import layers as L
from rec_attend_tpu_torch.nn import params as P
from rec_attend_tpu_torch.ops import attention, boxes, image_ops, losses
from rec_attend_tpu_torch.ops import matching
from rec_attend_tpu_torch.ops.cuda import glimpse as gk

ATTN_BOX_BETA = -5.0
Y_OUT_BETA = -5.0
# Batch keys a train step reads; 'd_in' and 'y_in' where the config reads
# the packed maps (the box model's too).
BATCH_KEYS = ('x', 'y_gt', 's_gt', 'd_in', 'y_in')
# The dataset's variables, and the batch key each becomes (the packed
# predictions of the fg model, 'd_out' and 'y_out', are read as 'd_in' and
# 'y_in' where the config reads them; JAX experiment.py:60-66).
BATCH_VARIABLES = ('x', 'y_gt', 's_gt')
BATCH_MAP = {'x': 'x', 'y_gt': 'y_gt', 's_gt': 's_gt', 'd_out': 'd_in',
             'y_out': 'y_in'}
# The metrics that the eval passes of a training run log (JAX :67-70).
EVAL_METRICS = ('loss', 'segm_loss', 'conf_loss', 'box_loss', 'iou_soft',
                'iou_hard', 'dice', 'count_acc', 'dic', 'dic_abs',
                'wt_cov_soft', 'wt_cov_hard', 'learn_rate')
METRIC_KEYS = ('loss', 'box_loss', 'segm_loss', 'conf_loss', 'wd_loss',
               'iou_soft', 'iou_soft_box', 'iou_hard', 'dice', 'wt_cov_soft',
               'unwt_cov_soft', 'wt_cov_hard', 'unwt_cov_hard', 'count_acc',
               'dic', 'dic_abs', 'learn_rate')


def _adcnn_skip_channels(cfg: FullModelConfig):
  """Skip channel counts feeding each DCNN layer (JAX full_model.py:56-76):
  layer 0 gets none; layer i>=1 concatenates the reversed attention-CNN
  feature map (the glimpse itself for the last) where the skip mask
  allows."""
  if not cfg.add_skip_conn:
    return None
  acnn_ch = (cfg.acnn_inp_depth,) + tuple(cfg.attn_cnn_depth)
  channels_rev = list(acnn_ch[::-1][1:]) + [cfg.acnn_inp_depth]
  skip_rev = list(cfg.resolved_attn_cnn_skip())[::-1]
  skip_ch = [0] + [ch if sk else 0 for sk, ch in zip(skip_rev, channels_rev)]
  n = len(cfg.attn_dcnn_filter_size)
  return (skip_ch + [0] * n)[:n]


class FullModel(nn.Module):
  """Parameters of the full model, named as the JAX parameter tree
  (``ctrl_cnn.0.w``, ``ctrl_cnn.0.bn.ema_mean`` [T,C], ``ctrl_lstm.w_xi``,
  ...), initialised from ``seed`` as JAX ``init_full_model`` does (truncated
  normal, stddev 0.01) and placed on ``device`` (default ``cuda``)."""

  def __init__(self, cfg: FullModelConfig, seed=0, device=None):
    super().__init__()
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    t = cfg.timespan
    n_cc = len(cfg.ctrl_cnn_filter_size)
    n_ac = len(cfg.attn_cnn_filter_size)
    n_adc = len(cfg.attn_dcnn_filter_size)
    gmlp_dims = ([cfg.ctrl_rnn_hid_dim] * cfg.num_glimpse_mlp_layers
                 + [cfg.glimpse_map_dim])
    cmlp_dims = ([cfg.ctrl_rnn_hid_dim]
                 + [cfg.ctrl_mlp_dim] * (cfg.num_ctrl_mlp_layers - 1) + [9])
    self.cfg = cfg
    self.ctrl_cnn = L.init_cnn(
        cfg.ctrl_cnn_filter_size,
        (cfg.ccnn_inp_depth,) + tuple(cfg.ctrl_cnn_depth),
        [cfg.use_bn] * n_cc, t, g)
    self.ctrl_lstm = L.LSTM(cfg.glimpse_feat_dim, cfg.ctrl_rnn_hid_dim, g)
    self.glimpse_mlp = L.init_mlp(gmlp_dims, g)
    self.ctrl_mlp = L.init_mlp(cmlp_dims, g)
    self.attn_cnn = L.init_cnn(
        cfg.attn_cnn_filter_size,
        (cfg.acnn_inp_depth,) + tuple(cfg.attn_cnn_depth),
        [cfg.use_bn] * n_ac, t, g)
    self.score_mlp = L.init_mlp([cfg.ctrl_rnn_hid_dim + cfg.core_dim, 1], g)
    self.attn_dcnn = L.init_dcnn(
        cfg.attn_dcnn_filter_size,
        (cfg.core_depth,) + tuple(cfg.attn_dcnn_depth),
        [cfg.use_bn] * n_adc, _adcnn_skip_channels(cfg), t, g)
    self.to(device)
    self.device = self.ctrl_lstm.b_f.device   # with its index: cuda:0

  def forward(self, x, d_in=None, y_in=None, glimpse='kernel'):
    return full_model_forward(self, x, d_in, y_in, glimpse=glimpse)


# ---------------------------------------------------------------------------
# Schedules (JAX full_model.py:142-165)
# ---------------------------------------------------------------------------

def knob_probs(cfg: FullModelConfig, step, device=None):
  """Scheduled-sampling probabilities (box, segm) of the ground-truth mix
  at global step ``step``, each [1, T, 1] float32."""
  t = cfg.timespan
  if cfg.knob_use_timescale:
    time_scale = 1.0 + torch.log(
        1.0 + torch.arange(t, dtype=torch.float32, device=device) * 3.0)
  else:
    time_scale = torch.ones(t, device=device)
  step = torch.tensor(float(step), dtype=torch.float32, device=device)

  def expdecay(offset):
    s = torch.clamp_min(step - offset, 0.0)
    return cfg.knob_base * cfg.knob_decay ** (s / cfg.steps_per_knob_decay)

  p_box = torch.clamp_max(expdecay(cfg.knob_box_offset) * time_scale, 1.0)
  p_segm = torch.clamp_max(expdecay(cfg.knob_segm_offset) * time_scale, 1.0)
  return p_box.view(1, t, 1), p_segm.view(1, t, 1)


def learn_rate(cfg: FullModelConfig, count):
  """Staircase exponential decay at optimizer update ``count``, float32."""
  step = np.float32(count)
  return float(np.float32(cfg.base_learn_rate) * np.float32(
      cfg.learn_rate_decay) ** np.floor(
          step / np.float32(cfg.steps_per_learn_rate_decay)))


def draw_train_randoms(cfg: FullModelConfig, batch_size, generator):
  """Every random draw of one training forward, made before the T loop.

  Returns a dict: 'aug' (``image_ops.draw_transformation``: crop offset and
  flip coins), 'pad_noise' [B,T,1] and 'ctr_noise' [B,T,2] (the box noise),
  'knob_box' and 'knob_segm' [B,T,1] (uniforms compared with the knob
  probabilities), 'segm_noise' [T,B,H,W,1] (the noise of the ground-truth
  segmentation mix), on the generator's device."""
  b, t = batch_size, cfg.timespan
  dev = generator.device

  def uniform(shape, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=generator, device=dev)
    return u * (hi - lo) + lo

  aug = image_ops.draw_transformation(cfg.padding, generator,
                                     colour=cfg.rnd_colour)
  pad = cfg.attn_box_padding_ratio
  return {
      'aug': aug,
      'pad_noise': uniform((b, t, 1), pad - cfg.gt_box_pad_noise,
                           pad + cfg.gt_box_pad_noise),
      'ctr_noise': uniform((b, t, 2), -cfg.gt_box_ctr_noise,
                           cfg.gt_box_ctr_noise),
      'knob_box': uniform((b, t, 1)),
      'knob_segm': uniform((b, t, 1)),
      'segm_noise': uniform((t, b, cfg.inp_height, cfg.inp_width, 1), 0.0,
                            cfg.gt_segm_noise),
  }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _glimpse_fns(glimpse):
  """(extract, paste) of a glimpse mode: 'kernel' (the CUDA kernels, their
  plain version on the CPU), 'plain' (the einsum forms), or a pair of
  functions of the same signature."""
  if glimpse == 'kernel':
    return gk.glimpse_extract, gk.glimpse_paste
  if glimpse == 'plain':
    return attention.extract_patch, attention.paste_patch
  if isinstance(glimpse, tuple) and len(glimpse) == 2:
    return glimpse
  raise ValueError(f"glimpse must be 'kernel', 'plain' or a pair of "
                   f"functions, got {glimpse!r}")


def packed_inputs(cfg: FullModelConfig):
  """(takes d_in, takes y_in): whether either CNN reads the packed
  orientation and foreground maps."""
  flags = cfg.resolved_input_flags()
  return tuple(any(flags[f'{net}_add_{key}'] for net in ('ctrl', 'attn'))
               for key in ('d_out', 'y_out'))


def _check_input(model, x, d_in, y_in):
  cfg = model.cfg
  b, h, w = x.shape[0], cfg.inp_height, cfg.inp_width
  if tuple(x.shape) != (b, h, w, cfg.inp_depth):
    raise ValueError(f'x is {tuple(x.shape)}, the model takes '
                     f'[B,{h},{w},{cfg.inp_depth}]')
  for name, a, depth, wanted in zip(
      ('d_in', 'y_in'), (d_in, y_in), (8, cfg.num_semantic_classes),
      packed_inputs(cfg)):
    if wanted != (a is not None):
      raise ValueError(f'{name} is {"missing" if wanted else "given"}: the '
                       f'config {"asks" if wanted else "does not ask"} for '
                       'it')
    if a is not None:
      if tuple(a.shape) != (b, h, w, depth):
        raise ValueError(f'{name} is {tuple(a.shape)}, the model takes '
                         f'[{b},{h},{w},{depth}]')
      if a.device != model.device:
        raise ValueError(f'{name} is on {a.device}, the model on '
                         f'{model.device}')
  if x.device != model.device:
    raise ValueError(f'x is on {x.device}, the model on {model.device}')


def controller(model, ccnn_inp, t, stats=None, dtype=torch.float32):
  """The controller of timestep t, shared by the full and box models (JAX
  full_model.py:326-353, box_model.py:140-162): the controller CNN with
  BatchNorm copy t over ``ccnn_inp`` [B,H,W,C], then ``num_ctrl_rnn_iter``
  steps of the glimpse LSTM over its feature map, each reading the map
  through the previous step's glimpse-MLP softmax (uniform at first), then
  the controller MLP.  ``stats`` and ``dtype`` (the CNN's) as in
  ``L.apply_cnn``.

  Returns (h_crnn [B,hid], ctrl_out [B,9] float32, the glimpse maps read,
  a list of [B,glimpse_map_dim,1])."""
  cfg = model.cfg
  B = ccnn_inp.shape[0]
  hid = cfg.ctrl_rnn_hid_dim
  relu = F.relu
  gmlp_act = ([relu] * (cfg.num_glimpse_mlp_layers - 1)
              + [lambda z: torch.softmax(z, dim=-1)])
  cmlp_act = [relu] * (cfg.num_ctrl_mlp_layers - 1) + [None]
  h_ccnn = L.apply_cnn(model.ctrl_cnn, L.nchw(ccnn_inp), cfg.ctrl_cnn_pool,
                       [relu] * len(cfg.ctrl_cnn_filter_size), t, stats,
                       dtype=dtype)
  crnn_inp = L.nhwc(h_ccnn[-1]).reshape(B, cfg.glimpse_map_dim,
                                        cfg.glimpse_feat_dim)
  crnn_state = torch.zeros((B, 2 * hid), device=ccnn_inp.device)
  glimpse_map = torch.ones((B, cfg.glimpse_map_dim, 1),
                           device=ccnn_inp.device) / cfg.glimpse_map_dim
  glimpse_maps = []
  for it in range(cfg.num_ctrl_rnn_iter):
    glimpse_maps.append(glimpse_map)
    crnn_glimpse = torch.sum(crnn_inp * glimpse_map, dim=1)
    crnn_state = model.ctrl_lstm(crnn_glimpse, crnn_state)
    h_crnn = crnn_state[:, hid:]
    if it < cfg.num_ctrl_rnn_iter - 1:
      glimpse_map = L.apply_mlp(model.glimpse_mlp, h_crnn,
                                gmlp_act)[-1][:, :, None]
  ctrl_out = L.apply_mlp(model.ctrl_mlp, h_crnn, cmlp_act)[-1].float()
  return h_crnn, ctrl_out, glimpse_maps


def attention_params(cfg, ctrl_out):
  """The attention box of the controller's output (JAX
  full_model.py:354-372): (ctr_norm, lg_size, ctr, size, lg_var), each
  [B,2]."""
  H, W = cfg.inp_height, cfg.inp_width
  attn_ctr_norm = ctrl_out[:, 0:2]
  attn_lg_size = ctrl_out[:, 2:4]
  if cfg.squash_ctrl_params:
    attn_ctr_norm = torch.tanh(attn_ctr_norm)
    attn_lg_size = -F.softplus(attn_lg_size)
  attn_ctr, attn_size = attention.get_unnormalized_attn(
      attn_ctr_norm, attn_lg_size, H, W)
  if cfg.dynamic_var:
    attn_lg_var = ctrl_out[:, 4:6]
  elif cfg.fixed_var:
    attn_lg_var = torch.zeros((ctrl_out.shape[0], 2), device=ctrl_out.device)
  else:
    attn_lg_var = attention.get_normalized_var(attn_size, cfg.filter_height,
                                               cfg.filter_width)
  return attn_ctr_norm, attn_lg_size, attn_ctr, attn_size, attn_lg_var


def gaussian_filters(cfg, ctr, size, lg_var):
  """(f_y [B,H,FH], f_x [B,W,FW]) of boxes ctr, size, lg_var [B,2]."""
  return (attention.get_gaussian_filter(ctr[:, 0], size[:, 0], lg_var[:, 0],
                                        cfg.inp_height, cfg.filter_height),
          attention.get_gaussian_filter(ctr[:, 1], size[:, 1], lg_var[:, 1],
                                        cfg.inp_width, cfg.filter_width))


def _timestep(model, x, packed, canvas, t, extract_fn, paste_fn,
              train=None):
  """One timestep of the model (JAX full_model.py:287-508), or several
  as one batch.

  Args:
    x: [B,H,W,D] image; packed: {'d_out': d_in, 'y_out': y_in}, either
      None where the config does not read it; canvas: [B,H,W,1]; t:
      timestep index, or a list of n timesteps whose rows the batch holds
      in groups (``_decode``'s parallel pass: x, the packed maps and the
      canvas hold n·B rows, the ground truth stays [B,...]; BatchNorm
      uses copy t[i] for group i, and its statistics come back one dict
      a timestep).
    train: None for the serving forward; with the ground truth a dict of
      this step's inputs: 'train' (True: BatchNorm on the batch and the
      knob's mixes; False: the eval forward of the loss in eval mode),
      'plot' (True: also the outputs that the plots read), ground truth
      ('y_gt' [B,T,H,W], 'attn_box_gt' [B,T,H,W],
      'attn_top_left_gt'/'attn_bot_right_gt' [B,T,2]), the greedy-match
      mask 'grd_cum' [B,T] and, in training, 'attn_ctr_gtn'/'attn_size_gtn'
      [B,T,2], the knob draws 'knob_box'/'knob_segm' [B,1] and
      'segm_noise' [B,H,W,1].
  Returns:
    (canvas, grd_cum or None, step outputs, {net: new BN statistics} or
    None).
  """
  cfg = model.cfg
  flags = cfg.resolved_input_flags()
  B = x.shape[0]
  FH, FW = cfg.filter_height, cfg.filter_width
  dev = x.device
  cdt = torch.bfloat16 if cfg.dtype == 'bfloat16' else torch.float32
  n_adc = len(cfg.attn_dcnn_filter_size)
  relu = F.relu
  training = train is not None and train['train']
  n = len(t) if L.folded(t) else None
  stats = None
  if training:
    stats = {net: [] if n is None else [[] for _ in range(n)]
             for net in ('ctrl_cnn', 'attn_cnn', 'attn_dcnn')}

  def inputs(prefix):
    parts = [v for key, v in (('inp', x), ('canvas', canvas),
                              ('d_out', packed['d_out']),
                              ('y_out', packed['y_out']))
             if flags[f'{prefix}_add_{key}']]
    return torch.cat(parts, dim=3)

  def net_stats(net):
    return None if stats is None else stats[net]

  h_crnn, ctrl_out, glimpse_maps = controller(model, inputs('ctrl'), t,
                                              net_stats('ctrl_cnn'), cdt)
  (attn_ctr_norm, attn_lg_size, attn_ctr, attn_size,
   attn_lg_var) = attention_params(cfg, ctrl_out)
  if cfg.fixed_gamma:
    attn_lg_gamma = torch.zeros((B, 1), device=dev)
    y_out_lg_gamma = torch.full((B, 1), 2.0, device=dev)
  else:
    attn_lg_gamma = ctrl_out[:, 6:7]
    y_out_lg_gamma = ctrl_out[:, 8:9]
  attn_box_lg_gamma = ctrl_out[:, 7:8]

  def filters(ctr, size):
    return gaussian_filters(cfg, ctr, size, attn_lg_var)

  # Render the attention box from the predicted parameters.
  f_y, f_x = filters(attn_ctr, attn_size)
  box_patch = torch.exp(attn_box_lg_gamma).view(B, 1, 1, 1).expand(
      B, FH, FW, 1).contiguous()
  attn_box = paste_fn(box_patch, f_y, f_x)
  attn_box = torch.sigmoid(attn_box + ATTN_BOX_BETA)[..., 0]     # [B,H,W]

  def against_gt(a):
    """a [rows,...] as [rows,1,...], or folded as [n,B,1,...]: each row
    broadcast against its example's ground truth [B,T,...]."""
    if n is None:
      return a[:, None]
    return a.view((n, -1, 1) + tuple(a.shape[1:]))

  step_out = {}
  grd_cum = grd_match = None
  if train is not None:
    # Soft box IoU against every ground-truth box (JAX :386-395).
    if cfg.use_iou_box:
      tl, br = attention.get_box_coord(attn_ctr, attn_size)
      iou_soft_box_t = losses.f_iou_box(
          against_gt(tl), against_gt(br), train['attn_top_left_gt'],
          train['attn_bot_right_gt'])                              # [B,T]
    else:
      iou_soft_box_t = (
          losses.f_inter(against_gt(attn_box), train['attn_box_gt'])
          / losses.f_union(against_gt(attn_box), train['attn_box_gt']))
    step_out['iou_soft_box_t'] = iou_soft_box_t.reshape(B, -1)
    grd_cum = train['grd_cum']
    if cfg.use_knob and training:
      # Mix in the noisy ground-truth box (JAX :396-415): with fixed_order
      # timestep t's, else the greedily matched one; the match does not
      # accumulate unless accumulate_greedy_match.
      if cfg.fixed_order:
        ctr_gtm = train['attn_ctr_gtn'][:, t]
        size_gtm = train['attn_size_gtn'][:, t]
      else:
        grd_match = losses.f_greedy_match(iou_soft_box_t, grd_cum)
        step_out['grd_match'] = grd_match
        if cfg.accumulate_greedy_match:
          grd_cum = torch.clamp_max(grd_cum + grd_match, 1.0)
        ctr_gtm = torch.sum(grd_match[:, :, None] * train['attn_ctr_gtn'], 1)
        size_gtm = torch.sum(grd_match[:, :, None] * train['attn_size_gtn'],
                             1)
      kb = train['knob_box']
      attn_ctr = kb * ctr_gtm + (1 - kb) * attn_ctr
      attn_size = kb * size_gtm + (1 - kb) * attn_size
      # Final filters from the mixed box (JAX :420-425).
      f_y, f_x = filters(attn_ctr, attn_size)

  # Glimpse crop and attention CNN (compute dtype).
  x_patch = torch.exp(attn_lg_gamma).view(B, 1, 1, 1) * extract_fn(
      inputs('attn'), f_y, f_x)
  h_acnn = L.apply_cnn(model.attn_cnn, L.nchw(x_patch), cfg.attn_cnn_pool,
                       [relu] * len(cfg.attn_cnn_filter_size), t,
                       net_stats('attn_cnn'), dtype=cdt)
  h_core = L.nhwc(h_acnn[-1]).reshape(B, cfg.core_dim)

  # D-CNN with skip connections (JAX full_model.py:439-452).
  adcnn_skip = None
  if cfg.add_skip_conn:
    skip_rev = list(cfg.resolved_attn_cnn_skip())[::-1]
    h_rev = h_acnn[::-1][1:] + [L.nchw(x_patch)]
    adcnn_skip = [None] + [hc if sk else None
                           for sk, hc in zip(skip_rev, h_rev)]
    adcnn_skip = (adcnn_skip + [None] * n_adc)[:n_adc]
  h_adcnn = L.apply_dcnn(model.attn_dcnn, h_acnn[-1], cfg.attn_dcnn_pool,
                         [relu] * n_adc, t, skip=adcnn_skip,
                         stats=net_stats('attn_dcnn'), dtype=cdt)
  y_out_patch = L.nhwc(h_adcnn[-1]).float().contiguous()     # [B,FH,FW,1]

  # Paste the mask back to full resolution (JAX full_model.py:454-460).
  y_out = paste_fn(y_out_patch, f_y, f_x)
  y_out = torch.sigmoid(torch.exp(y_out_lg_gamma).view(B, 1, 1, 1) * y_out
                        + Y_OUT_BETA)
  if cfg.disable_overwrite:
    y_out = (1.0 - canvas) * y_out

  # Score (JAX full_model.py:462-465).
  smlp_inp = torch.cat([h_crnn, h_core.float()], dim=1)
  s_out = L.apply_mlp(model.score_mlp, smlp_inp,
                      [torch.sigmoid])[-1][:, 0].float()

  # Knob: mix the ground-truth segmentation into the canvas (JAX :466-479),
  # with fixed_order timestep t's, else the greedily matched one.
  y_canvas = y_out
  if training and cfg.use_knob:
    if cfg.fixed_order:
      y_mix = train['y_gt'][:, t, :, :, None]
    else:
      y_mix = torch.einsum('bt,bthw->bhw', grd_match,
                           train['y_gt'])[..., None]
    y_mix = y_mix - y_mix * train['segm_noise']
    ks = train['knob_segm'][:, :, None, None]                  # [B,1,1,1]
    y_canvas = ks * y_mix + (1 - ks) * y_out
  canvas = torch.maximum(y_canvas, canvas)
  if cfg.stop_canvas_grad:
    canvas = canvas.detach()

  step_out.update(
      y_out=y_out[..., 0], s_out=s_out, attn_box=attn_box,
      y_out_patch=y_out_patch[..., 0], attn_ctr=attn_ctr,
      attn_size=attn_size, attn_lg_var=attn_lg_var,
      attn_ctr_norm=attn_ctr_norm, attn_lg_size=attn_lg_size,
      attn_lg_gamma=attn_lg_gamma, attn_box_lg_gamma=attn_box_lg_gamma,
      y_out_lg_gamma=y_out_lg_gamma)
  if train is not None and train['plot']:
    # What the plots read (JAX :488-501), asked for by the plot hook's eval
    # forward only: in training they would be kept across the remat
    # segments.
    attn_top_left, attn_bot_right = attention.get_box_coord(attn_ctr,
                                                            attn_size)
    step_out.update(
        x_patch=x_patch.float(), attn_top_left=attn_top_left,
        attn_bot_right=attn_bot_right,
        glimpse_map=torch.stack(glimpse_maps, dim=1)[..., 0].reshape(
            B, cfg.num_ctrl_rnn_iter, cfg.crnn_h, cfg.crnn_w))
  if stats is not None and n is not None:
    stats = [{net: v[i] for net, v in stats.items()} for i in range(n)]
  return canvas, grd_cum, step_out, stats


def _stack_steps(steps):
  return {k: torch.stack([s[k] for s in steps], dim=1) for k in steps[0]}


def parallel_decode(cfg: FullModelConfig, train=False):
  """Whether the forward runs its T timesteps as one batch (JAX
  full_model.py:524-541): where neither CNN reads the canvas, the masks
  are not masked by it and the knob does not train, the timesteps are
  independent, and ``cfg.parallel_decode`` (None: wherever they are)
  picks the batched pass; elsewhere the serial loop runs, whatever it
  says."""
  flags = cfg.resolved_input_flags()
  independent = (not flags['ctrl_add_canvas'] and not flags['attn_add_canvas']
                 and not cfg.disable_overwrite
                 and not (cfg.use_knob and train))
  use = (cfg.parallel_decode if cfg.parallel_decode is not None
         else independent)
  return bool(use and independent)


def timestep_groups(timespan, batch):
  """The timesteps of each pass of the parallel decode: all T in one,
  unless T·B rows pass the glimpse kernels' batch limit
  (``gk.MAX_BATCH``); then as many whole timesteps a pass as fit."""
  per = max(1, gk.MAX_BATCH // batch)
  return [list(range(i, min(i + per, timespan)))
          for i in range(0, timespan, per)]


def _decode(model, x, packed, extract_fn, paste_fn, gt=None, knob=None,
            remat=False):
  """The T timesteps: a serial loop carrying the canvas (JAX's
  ``lax.scan``), or, where ``parallel_decode`` says so, the batched pass
  (JAX's ``vmap``): x and the packed maps repeated once a timestep, one
  controller and one ``_timestep`` over the T·B rows from a zero canvas,
  the canvas the max over T.  ``gt`` and ``knob`` as in
  ``full_model_train_forward``'s loop (None when serving); ``remat`` runs
  each timestep, or each pass, under ``torch.utils.checkpoint``.

  Returns (canvas [B,H,W,1], outputs stacked [B,T,...], the BatchNorm
  statistics of each timestep in training, else [])."""
  cfg = model.cfg
  B, T = x.shape[0], cfg.timespan
  H, W = cfg.inp_height, cfg.inp_width

  def run(fn, *args):
    if not remat:
      return fn(*args)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)

  if parallel_decode(cfg, gt is not None and gt['train']):
    def group(ts):
      n = len(ts)
      rows = {k: None if v is None else v.repeat(n, 1, 1, 1)
              for k, v in packed.items()}
      canvas = torch.zeros((n * B, H, W, 1), device=x.device)
      canvas, _, out, stats = _timestep(
          model, x.repeat(n, 1, 1, 1), rows, canvas, ts, extract_fn,
          paste_fn, None if gt is None else dict(gt, grd_cum=None))
      return (canvas.view(n, B, H, W, 1).amax(dim=0),
              {k: v.view((n, B) + tuple(v.shape[1:])) for k, v in
               out.items()}, stats or [])

    canvas, groups, bn_steps = None, [], []
    for ts in timestep_groups(T, B):
      c, out, stats = run(group, ts)
      canvas = c if canvas is None else torch.maximum(canvas, c)
      groups.append(out)
      bn_steps += stats
    outputs = {k: torch.cat([g[k] for g in groups]).transpose(0, 1)
               .contiguous() for k in groups[0]}
    return canvas, outputs, bn_steps

  def step(canvas, grd_cum, t):
    inputs = None
    if gt is not None:
      inputs = dict(gt, grd_cum=grd_cum, **{
          k: v[:, t] if k != 'segm_noise' else v[t] for k, v in knob.items()})
    return _timestep(model, x, packed, canvas, t, extract_fn, paste_fn,
                     inputs)

  canvas = torch.zeros((B, H, W, 1), device=x.device)
  grd_cum = torch.zeros((B, T), device=x.device)
  steps, bn_steps = [], []
  for t in range(T):
    canvas, grd_cum, step_out, stats = run(step, canvas, grd_cum, t)
    steps.append(step_out)
    if stats is not None:
      bn_steps.append(stats)
  return canvas, _stack_steps(steps), bn_steps


@torch.no_grad()
def full_model_forward(model: FullModel, x, d_in=None, y_in=None,
                       glimpse='kernel'):
  """Run the T-step eval forward (no gradients: this is the serving path).

  Args:
    model: FullModel.
    x: [B,H,W,inp_depth] image on the model's device.
    d_in, y_in: the packed orientation [B,H,W,8] and foreground
      [B,H,W,num_semantic_classes] maps on the model's device, given
      exactly when the config reads them (``packed_inputs``).
    glimpse: 'kernel' runs extract/paste through the CUDA kernel wrappers
      (their plain version for CPU tensors); 'plain' runs the plain einsum
      forms, the reference the kernels are compared with.
  Returns:
    dict: 'y_out' [B,T,H,W], 's_out' [B,T], 'canvas' [B,H,W],
    'attn_box' [B,T,H,W], 'y_out_patch' [B,T,FH,FW] and the per-step
    attention parameters 'attn_ctr', 'attn_size', 'attn_lg_var',
    'attn_ctr_norm', 'attn_lg_size' [B,T,2], 'attn_lg_gamma',
    'attn_box_lg_gamma', 'y_out_lg_gamma' [B,T,1].
  """
  extract_fn, paste_fn = _glimpse_fns(glimpse)
  _check_input(model, x, d_in, y_in)
  cfg = model.cfg
  x = x.float()
  packed = {'d_out': None if d_in is None else d_in.float(),
            'y_out': None if y_in is None else y_in.float()}
  canvas, out, _ = _decode(model, x, packed, extract_fn, paste_fn)
  out['canvas'] = canvas[..., 0]
  return out


def full_model_train_forward(model: FullModel, x, y_gt, s_gt, draws, step,
                             glimpse='kernel', d_in=None, y_in=None,
                             train=True, plot=False):
  """Run the T-step forward with the ground truth (JAX
  full_model_forward(train=True), or with ``train=False`` its eval branch:
  no crop, BatchNorm on its EMA statistics, no knob and no draws, which
  may then be None).

  Args:
    model: FullModel; x [B,H,W,inp_depth], y_gt [B,T,H,W], s_gt [B,T] on
      its device, float.
    d_in, y_in: the packed maps, as in ``full_model_forward``; they take
      the augmentation's crop.
    draws: dict of ``draw_train_randoms`` (or the same draws from
      elsewhere), on the model's device.
    step: global step, for the knob schedule.
    glimpse: as in ``full_model_forward``.
    plot: in eval, also return what the plots read.
  Returns:
    (outputs, new_bn): outputs holds the stacked per-step outputs of
    ``full_model_forward`` plus 'iou_soft_box_t' [B,T,T], in training
    with the knob (without ``fixed_order``) the greedy matches
    'grd_match' [B,T,T], the transformed
    'x_trans'/'y_gt_trans', 's_gt', and the ground truth 'attn_box_gt',
    'attn_ctr_norm_gt', 'attn_lg_size_gt' and friends, and with ``plot``
    what the plots read, 'x_patch' [B,T,FH,FW,D], 'attn_top_left' and
    'attn_bot_right' [B,T,2] and 'glimpse_map' [B,T,iters,h,w]; new_bn
    maps each EMA buffer name ('ctrl_cnn.0.bn.ema_mean', ...) to its new
    [T,C] value (empty in eval).
  """
  extract_fn, paste_fn = _glimpse_fns(glimpse)
  _check_input(model, x, d_in, y_in)
  cfg = model.cfg
  H, W = cfg.inp_height, cfg.inp_width
  FH, FW = cfg.filter_height, cfg.filter_width
  x, y_gt = x.float(), y_gt.float()
  packed = {'d_out': None if d_in is None else d_in.float(),
            'y_out': None if y_in is None else y_in.float()}

  if train:
    # Augmentation (JAX full_model.py:218-232); in eval the centre crop is
    # the identity.
    aug = image_ops.random_transformation(
        x, cfg.padding, draws['aug'], rnd_hflip=cfg.rnd_hflip,
        rnd_vflip=cfg.rnd_vflip, rnd_transpose=cfg.rnd_transpose,
        rnd_colour=cfg.rnd_colour, y=y_gt, d=packed['d_out'],
        c=packed['y_out'])
    x, y_gt = aug['x'], aug['y']
    packed = {'d_out': aug.get('d'), 'y_out': aug.get('c')}

  # Ground-truth attention boxes, clean and noisy (JAX :230-250).
  min_pad = cfg.padding + 4.0
  (attn_ctr_gt, attn_size_gt, _, _, attn_box_gt, attn_top_left_gt,
   attn_bot_right_gt) = boxes.get_gt_attn(
       y_gt, FH, FW, padding_ratio=cfg.attn_box_padding_ratio,
       center_shift_ratio=0.0, min_padding=min_pad)
  gt = {'train': train, 'plot': plot and not train, 'y_gt': y_gt,
        'attn_box_gt': attn_box_gt,
        'attn_top_left_gt': attn_top_left_gt,
        'attn_bot_right_gt': attn_bot_right_gt}
  knob = {}
  if train:
    gt['attn_ctr_gtn'], gt['attn_size_gtn'] = boxes.get_gt_attn(
        y_gt, FH, FW, padding_ratio=draws['pad_noise'],
        center_shift_ratio=draws['ctr_noise'], min_padding=min_pad)[:2]
    # Knob draws (JAX :255-262).
    p_box, p_segm = knob_probs(cfg, step, x.device)
    knob = {'knob_box': (draws['knob_box'] <= p_box).float(),
            'knob_segm': (draws['knob_segm'] <= p_segm).float(),
            'segm_noise': draws['segm_noise']}

  canvas, outputs, bn_steps = _decode(model, x, packed, extract_fn, paste_fn,
                                      gt, knob, remat=cfg.remat and train)
  outputs.update(
      canvas=canvas[..., 0], x_trans=x, y_gt_trans=y_gt, s_gt=s_gt,
      attn_ctr_gt=attn_ctr_gt, attn_size_gt=attn_size_gt,
      attn_top_left_gt=attn_top_left_gt,
      attn_bot_right_gt=attn_bot_right_gt, attn_box_gt=attn_box_gt,
      attn_ctr_norm_gt=attention.get_normalized_center(attn_ctr_gt, H, W),
      attn_lg_size_gt=attention.get_normalized_size(attn_size_gt, H, W))
  if not train:
    return outputs, {}
  outputs.update(gt_knob_prob_box=p_box[0, 0, 0],
                 gt_knob_prob_segm=p_segm[0, 0, 0])
  new_bn = {}
  for net in ('ctrl_cnn', 'attn_cnn', 'attn_dcnn'):
    for i, pair in enumerate(bn_steps[0][net]):
      if pair is None:
        continue
      for k, key in enumerate(('ema_mean', 'ema_var')):
        new_bn[f'{net}.{i}.bn.{key}'] = torch.stack(
            [s[net][i][k] for s in bn_steps])
  return outputs, new_bn


# ---------------------------------------------------------------------------
# Loss (JAX full_model.py:575-722)
# ---------------------------------------------------------------------------

def full_model_loss(model: FullModel, batch, draws, step, glimpse='kernel',
                    train=True, matcher='jax'):
  """Total loss and metrics of one batch, in training or, with
  ``train=False``, in eval (JAX ``full_model_loss(train=False)``, as
  ``make_eval_step`` calls it: the eval forward, then the same matching and
  losses).

  Args:
    batch: dict 'x' [B,H,W,D], 'y_gt' [B,T,H,W], 's_gt' [B,T], float, on
      the model's device, and 'd_in' and 'y_in' where the config reads them
      (as in ``full_model_forward``).
    draws, step, glimpse, train: as in ``full_model_train_forward``.
    matcher: the Hungarian solver of the matchings, 'jax' (JAX's default)
      or 'native' (``ops/matching.f_segm_match``).
  Returns:
    (loss, aux): aux holds the scalar terms and metrics as 0-d tensors,
    'outputs', 'new_bn' (the new BN statistics), 'match' and 'match_box'.
  """
  cfg = model.cfg
  outputs, new_bn = full_model_train_forward(
      model, batch['x'], batch['y_gt'], batch['s_gt'], draws, step, glimpse,
      d_in=batch.get('d_in'), y_in=batch.get('y_in'), train=train)
  y_out = outputs['y_out']
  y_gt = outputs['y_gt_trans']
  s_gt = outputs['s_gt']
  s_out = outputs['s_out']
  B = y_out.shape[0]

  # The matchings (JAX :596-612): with fixed_order the identity for the
  # boxes and the segmentation losses and a Hungarian solve of the masks
  # for the hard metrics; else both Hungarian, in one solve over [2B,T,T].
  iou_soft_pairwise = losses.f_iou(y_out, y_gt, pairwise=True)
  if cfg.fixed_order:
    iou_soft_box = losses.f_iou(outputs['attn_box'],
                                outputs['attn_box_gt'])            # [B,T]
    match_box = matching.get_identity_match(cfg.timespan, s_gt)
    real_match = matching.f_segm_match(iou_soft_pairwise, s_gt,
                                       matcher=matcher)
  else:
    if cfg.use_knob:
      iou_soft_box = outputs['iou_soft_box_t']
    else:
      iou_soft_box = losses.f_iou(outputs['attn_box'],
                                  outputs['attn_box_gt'], pairwise=True)
    both = matching.f_segm_match(
        torch.cat([iou_soft_box, iou_soft_pairwise], dim=0),
        torch.cat([s_gt, s_gt], dim=0), matcher=matcher)
    match_box, real_match = both[:B], both[B:]

  # Box loss.
  match_count_box = torch.clamp_min(torch.sum(match_box, dim=(1, 2)), 1.0)
  iou_soft_box_mask = (iou_soft_box if cfg.fixed_order
                       else torch.sum(iou_soft_box * match_box, dim=1))
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
    box_loss = -losses.f_weighted_coverage(iou_soft_box,
                                           outputs['attn_box_gt'])
  elif cfg.box_loss_fn == 'bce':
    box_loss = losses.f_match_loss(outputs['attn_box'],
                                   outputs['attn_box_gt'], match_box,
                                   losses.f_bce)
  else:
    raise ValueError(f'Unknown box_loss_fn: {cfg.box_loss_fn}')

  # Segmentation loss (JAX :643-681): with fixed_order timestep t's mask
  # against instance t.
  if cfg.fixed_order:
    match = matching.get_identity_match(cfg.timespan, s_gt)
    iou_soft_mask = losses.f_iou(y_out, y_gt)                      # [B,T]
  else:
    match = real_match
    iou_soft_mask = torch.sum(iou_soft_pairwise * match, dim=1)
  match_count = torch.clamp_min(torch.sum(match, dim=(1, 2)), 1.0)
  wt_cov_soft = losses.f_weighted_coverage(iou_soft_pairwise, y_gt)
  unwt_cov_soft = losses.f_unweighted_coverage(iou_soft_pairwise,
                                               match_count)
  iou_soft_scalar = torch.sum(
      torch.sum(iou_soft_mask, dim=1) / match_count) / B
  if cfg.segm_loss_fn == 'iou':
    if cfg.segm_weight_alpha > 0.0:
      # Per matched instance weight area^(-alpha), renormalised to mean 1
      # over the example's matched instances.
      area = torch.sum(y_gt, dim=(2, 3))
      matched = torch.sum(match, dim=1)
      w = matched * torch.pow(area + 1.0, -cfg.segm_weight_alpha)
      w = w * match_count[:, None] / torch.clamp_min(
          torch.sum(w, dim=1, keepdim=True), 1e-6)
      segm_loss = -torch.sum(
          torch.sum(w * iou_soft_mask, dim=1) / match_count) / B
    else:
      segm_loss = -iou_soft_scalar
  elif cfg.segm_loss_fn == 'wt_cov':
    segm_loss = -wt_cov_soft
  elif cfg.segm_loss_fn == 'bce':
    segm_loss = losses.f_match_loss(y_out, y_gt, match, losses.f_bce)
  else:
    raise ValueError(f'Unknown segm_loss_fn: {cfg.segm_loss_fn}')

  conf_loss = losses.f_conf_loss(s_out, match, use_cum_min=True)
  wd_loss = L.weight_decay_loss(model, cfg.weight_decay)
  total = box_loss + segm_loss + cfg.loss_mix_ratio * conf_loss + wd_loss

  # Hard metrics (JAX :678-685).
  with torch.no_grad():
    y_out_hard = (y_out > 0.5).float()
    iou_hard_pair = losses.f_iou(y_out_hard, y_gt, pairwise=True)
    iou_hard_mask = torch.sum(iou_hard_pair * real_match, dim=1)
    iou_hard = torch.sum(torch.sum(iou_hard_mask, dim=1) / match_count) / B
    dice_pair = losses.f_dice(y_out_hard, y_gt, pairwise=True)
    dice = torch.sum(torch.sum(dice_pair * real_match, dim=(1, 2))
                     / match_count) / B
    metrics = {
        'wt_cov_soft': wt_cov_soft.detach(),
        'unwt_cov_soft': unwt_cov_soft.detach(),
        'iou_hard': iou_hard, 'dice': dice,
        'wt_cov_hard': losses.f_weighted_coverage(iou_hard_pair, y_gt),
        'unwt_cov_hard': losses.f_unweighted_coverage(iou_hard_pair,
                                                      match_count),
        'count_acc': losses.f_count_acc(s_out, s_gt),
        'dic': losses.f_dic(s_out, s_gt),
        'dic_abs': losses.f_dic(s_out, s_gt, abs=True),
    }
  scalars = {'loss': total, 'box_loss': box_loss, 'segm_loss': segm_loss,
             'conf_loss': conf_loss,
             'wd_loss': torch.as_tensor(wd_loss, device=total.device),
             'iou_soft': iou_soft_scalar, 'iou_soft_box': iou_soft_box_scalar}
  aux = {**{k: v.detach() for k, v in scalars.items()}, **metrics,
         'learn_rate': torch.tensor(learn_rate(cfg, step),
                                    device=total.device),
         'outputs': outputs, 'new_bn': new_bn, 'match': match,
         'match_box': match_box}
  return total, aux


def _frozen_nets(cfg: FullModelConfig):
  """The nets that the config's freeze_* flags keep as they are."""
  flags = {'ctrl_cnn': cfg.freeze_ctrl_cnn, 'ctrl_lstm': cfg.freeze_ctrl_rnn,
           'glimpse_mlp': cfg.freeze_ctrl_rnn,
           'ctrl_mlp': cfg.freeze_ctrl_mlp,
           'attn_cnn': cfg.freeze_attn_net, 'attn_dcnn': cfg.freeze_attn_net}
  return frozenset(net for net, frozen in flags.items() if frozen)


FAMILY = Family(
    name='full', model=FullModel, loss=full_model_loss,
    draws=draw_train_randoms, batch_keys=BATCH_KEYS,
    metric_keys=lambda cfg: METRIC_KEYS, frozen_nets=_frozen_nets,
    optimizer=lambda cfg: 'adam', batch_variables=BATCH_VARIABLES,
    batch_map=BATCH_MAP, eval_metrics=EVAL_METRICS,
    load_pretrained=lambda model, cfg: load_pretrained(model, cfg))


# ---------------------------------------------------------------------------
# Pretrained nets (JAX full_model.py:100-121)
# ---------------------------------------------------------------------------

CTRL_NETS = ('ctrl_cnn', 'ctrl_mlp', 'glimpse_mlp', 'ctrl_lstm')
ATTN_NETS = ('attn_cnn', 'attn_dcnn')


def pretrained_nets(cfg: FullModelConfig):
  """The nets that the config's ``weights.h5`` files give, as
  ``params.load_nets`` takes them, by JAX ``load_pretrained``'s rules:
  ``pretrain_net`` or else ``pretrain_ctrl_net`` gives the controller's
  nets (the LSTM whole), ``pretrain_net`` or else ``pretrain_attn_net``
  the attention CNN and DCNN, and ``pretrain_net`` the score MLP."""
  ctrl_src = cfg.pretrain_net or cfg.pretrain_ctrl_net
  attn_src = cfg.pretrain_net or cfg.pretrain_attn_net
  nets = []
  for src, names in ((ctrl_src, CTRL_NETS), (attn_src, ATTN_NETS)):
    if src:
      nets += [(net, P.load_net_h5(src, net), cfg.timespan) for net in names]
  if cfg.pretrain_net:
    nets.append(('score_mlp', P.load_net_h5(cfg.pretrain_net, 'score_mlp'),
                 None))
  return nets


def load_pretrained(model: FullModel, source):
  """Start nets of ``model`` from pretrained ones, in place.  ``source``
  is a ``FullModelConfig``, whose ``pretrain_*`` files give the nets of
  ``pretrained_nets``, or a module (a ``BoxModel``, say) or its state
  dict, whose controller (``CTRL_NETS``) starts this one's, by the rules
  of ``params.merge_pretrained``."""
  if isinstance(source, FullModelConfig):
    nets = pretrained_nets(source)
  else:
    state = source.state_dict() if isinstance(source, nn.Module) else source
    nets = [(net, P.net_from_state(state, net), model.cfg.timespan)
            for net in CTRL_NETS]
  return P.load_nets(model, nets)
