"""Command-line flags and the configs they make.

Counterpart of ``rec_attend_tpu/cli/args.py:18-374``: the same flags and
defaults (``--ctrl_cnn_depth 8,8,16,...`` comma lists, ``--use_knob``
switches), the dataset's size and augmentation from the dataset's name,
and the train, eval and data groups; ``make_*_config`` give the port's
configs, equal field for field to the JAX package's from the same argv.
The flags that set only an option the port does not read (``--use_pallas``,
``--mlp_dropout``) are not taken.  A flag whose
option the port does not run yet (``--fixed_order`` in training,
``rnd_colour``) parses, and the model refuses the config.
"""

from __future__ import annotations

import os

from rec_attend_tpu_torch import config as C


def _comma_ints(s):
  return tuple(int(v) for v in s.split(','))


def add_train_args(parser):
  """ref cmd_args_parser.py TrainArgsParser:91-138."""
  d = C.TrainConfig()
  parser.add_argument('--model_id', default=None)
  parser.add_argument('--num_steps', default=d.num_steps, type=int)
  parser.add_argument('--steps_per_ckpt', default=d.steps_per_ckpt, type=int)
  parser.add_argument('--steps_per_valid', default=d.steps_per_valid,
                      type=int)
  parser.add_argument('--steps_per_trainval', default=d.steps_per_trainval,
                      type=int)
  parser.add_argument('--steps_per_plot', default=d.steps_per_plot, type=int)
  parser.add_argument('--steps_per_log', default=d.steps_per_log, type=int)
  parser.add_argument('--batch_size', default=32, type=int)
  parser.add_argument('--results', default='results')
  parser.add_argument('--logs', default='logs')
  parser.add_argument('--localhost', default='localhost')
  parser.add_argument('--restore', default=None)
  parser.add_argument('--num_samples_plot', default=5, type=int)
  parser.add_argument('--save_ckpt', action='store_true')
  parser.add_argument('--no_valid', action='store_true')
  parser.add_argument('--num_batch_valid', default=10, type=int)
  parser.add_argument('--h5_fname_train', default=None)
  parser.add_argument('--h5_fname_valid', default=None)
  parser.add_argument('--prefetch', action='store_true')
  parser.add_argument('--queue_size', default=50, type=int)
  parser.add_argument('--num_worker', default=4, type=int)


def make_train_config(args) -> C.TrainConfig:
  return C.TrainConfig(
      model_id=args.model_id, num_steps=args.num_steps,
      steps_per_ckpt=args.steps_per_ckpt,
      steps_per_valid=args.steps_per_valid,
      steps_per_trainval=args.steps_per_trainval,
      steps_per_plot=args.steps_per_plot, steps_per_log=args.steps_per_log,
      batch_size=args.batch_size, results=args.results, logs=args.logs,
      localhost=args.localhost, restore=args.restore,
      num_samples_plot=args.num_samples_plot, save_ckpt=args.save_ckpt,
      has_valid=not args.no_valid, num_batch_valid=args.num_batch_valid,
      h5_fname_train=args.h5_fname_train, h5_fname_valid=args.h5_fname_valid,
      prefetch=args.prefetch, queue_size=args.queue_size,
      num_worker=args.num_worker)


def add_eval_args(parser):
  """ref cmd_args_parser.py EvalArgsParser:141-166, less the prefetch
  flags: the eval reads its batches in order on the main thread."""
  parser.add_argument('--model_id', default=None)
  parser.add_argument('--batch_size', default=32, type=int)
  parser.add_argument('--results', default='./results')
  parser.add_argument('--output', default=None)
  parser.add_argument('--split', default='valid')


def add_data_args(parser):
  parser.add_argument('--dataset', default='cvppp')
  parser.add_argument('--dataset_folder', default=None)
  parser.add_argument('--data_examples', default=None, type=int,
                      help='synth train-split size override (wins over a '
                           'restored data_opt.yaml snapshot — e.g. packing '
                           'a 256-example-trained fg model onto a larger '
                           'generated split)')


def make_data_config(args, restore=None) -> C.DataConfig:
  """Dataset config for a CLI invocation.

  When ``restore`` names a training results folder, its data_opt.yaml
  snapshot wins: eval sees the size and generation knobs the model was
  trained with, not the dataset's preset.  ``--dataset_folder`` and
  ``--data_examples`` still override the folder and the train split's
  size.
  """
  if restore is not None:
    snap = os.path.join(restore, 'data_opt.yaml')
    if os.path.exists(snap):
      cfg = C.DataConfig.from_yaml(snap)
      if getattr(args, 'dataset_folder', None):
        cfg = cfg.replace(folder=args.dataset_folder)
      if getattr(args, 'data_examples', None):
        cfg = cfg.replace(num_examples=args.data_examples)
      return cfg
  cfg = C.data_config_for(args.dataset, args.dataset_folder)
  if getattr(args, 'data_examples', None):
    cfg = cfg.replace(num_examples=args.data_examples)
  return cfg


def dataset_geometry(dataset):
  dims = C.DATASET_DIMS[dataset]
  trans = C.DATASET_TRANSFORMS[dataset]
  return dims, trans


def add_full_model_args(parser):
  """The full model's flags (ref full_model_train.py:458-659)."""
  parser.add_argument('--padding', default=16, type=int)
  parser.add_argument('--weight_decay', default=5e-5, type=float)
  parser.add_argument('--base_learn_rate', default=0.001, type=float)
  parser.add_argument('--learn_rate_decay', default=0.96, type=float)
  parser.add_argument('--steps_per_learn_rate_decay', default=5000, type=int)
  parser.add_argument('--loss_mix_ratio', default=1.0, type=float)
  parser.add_argument('--segm_loss_fn', default='iou')
  parser.add_argument('--fixed_order', action='store_true')
  parser.add_argument('--add_skip_conn', action='store_true')
  parser.add_argument('--filter_height', default=48, type=int)
  parser.add_argument('--filter_width', default=48, type=int)
  parser.add_argument('--ctrl_cnn_filter_size', default='3,3,3,3,3')
  parser.add_argument('--ctrl_cnn_depth', default='4,8,16,16,32')
  parser.add_argument('--ctrl_cnn_pool', default='2,2,2,2,2')
  parser.add_argument('--attn_cnn_filter_size', default='3,3,3')
  parser.add_argument('--attn_cnn_depth', default='4,8,16')
  parser.add_argument('--attn_cnn_pool', default='2,2,2')
  parser.add_argument('--attn_dcnn_filter_size', default='3,3,3,3')
  parser.add_argument('--attn_dcnn_depth', default='16,8,4,1')
  parser.add_argument('--attn_dcnn_pool', default='2,2,2,1')
  parser.add_argument('--attn_cnn_skip', default='1,1,1')
  parser.add_argument('--ctrl_rnn_hid_dim', default=256, type=int)
  parser.add_argument('--num_ctrl_mlp_layers', default=1, type=int)
  parser.add_argument('--ctrl_mlp_dim', default=256, type=int)
  parser.add_argument('--box_loss_fn', default='iou')
  parser.add_argument('--attn_box_padding_ratio', default=0.2, type=float)
  parser.add_argument('--use_knob', action='store_true')
  parser.add_argument('--knob_decay', default=0.9, type=float)
  parser.add_argument('--steps_per_knob_decay', default=300, type=int)
  parser.add_argument('--knob_base', default=1.0, type=float)
  parser.add_argument('--knob_box_offset', default=300, type=int)
  parser.add_argument('--knob_segm_offset', default=500, type=int)
  parser.add_argument('--knob_use_timescale', action='store_true')
  parser.add_argument('--gt_box_ctr_noise', default=0.05, type=float)
  parser.add_argument('--gt_box_pad_noise', default=0.1, type=float)
  parser.add_argument('--gt_segm_noise', default=0.3, type=float)
  parser.add_argument('--clip_gradient', default=1.0, type=float)
  parser.add_argument('--squash_ctrl_params', action='store_true')
  parser.add_argument('--fixed_gamma', action='store_true')
  parser.add_argument('--pretrain_ctrl_net', default=None)
  parser.add_argument('--pretrain_attn_net', default=None)
  parser.add_argument('--pretrain_net', default=None)
  parser.add_argument('--freeze_ctrl_cnn', action='store_true')
  parser.add_argument('--freeze_ctrl_rnn', action='store_true')
  parser.add_argument('--freeze_ctrl_mlp', action='store_true')
  parser.add_argument('--freeze_attn_net', action='store_true')
  parser.add_argument('--num_ctrl_rnn_iter', default=5, type=int)
  parser.add_argument('--num_glimpse_mlp_layers', default=2, type=int)
  parser.add_argument('--stop_canvas_grad', action='store_true')
  parser.add_argument('--fixed_var', action='store_true')
  parser.add_argument('--dynamic_var', action='store_true')
  parser.add_argument('--use_iou_box', action='store_true')
  parser.add_argument('--disable_overwrite', action='store_true')
  parser.add_argument('--add_d_out', action='store_true')
  parser.add_argument('--add_y_out', action='store_true')
  parser.add_argument('--num_semantic_classes', default=1, type=int)
  parser.add_argument('--ctrl_add_inp', action='store_true', default=None)
  parser.add_argument('--ctrl_add_canvas', action='store_true', default=None)
  parser.add_argument('--ctrl_add_d_out', action='store_true', default=None)
  parser.add_argument('--ctrl_add_y_out', action='store_true', default=None)
  parser.add_argument('--attn_add_inp', action='store_true', default=None)
  parser.add_argument('--attn_add_canvas', action='store_true', default=None)
  parser.add_argument('--attn_add_d_out', action='store_true', default=None)
  parser.add_argument('--attn_add_y_out', action='store_true', default=None)
  parser.add_argument('--finetune', action='store_true')
  # A JAX package extension (the JAX-only --use_pallas is not taken).
  parser.add_argument('--remat', action='store_true')


def make_full_model_config(args) -> C.FullModelConfig:
  dims, trans = dataset_geometry(args.dataset)
  return C.FullModelConfig(
      inp_height=dims['inp_height'], inp_width=dims['inp_width'],
      timespan=dims['timespan'], inp_depth=3, padding=args.padding,
      filter_height=args.filter_height, filter_width=args.filter_width,
      ctrl_cnn_filter_size=_comma_ints(args.ctrl_cnn_filter_size),
      ctrl_cnn_depth=_comma_ints(args.ctrl_cnn_depth),
      ctrl_cnn_pool=_comma_ints(args.ctrl_cnn_pool),
      ctrl_rnn_hid_dim=args.ctrl_rnn_hid_dim,
      attn_cnn_filter_size=_comma_ints(args.attn_cnn_filter_size),
      attn_cnn_depth=_comma_ints(args.attn_cnn_depth),
      attn_cnn_pool=_comma_ints(args.attn_cnn_pool),
      attn_dcnn_filter_size=_comma_ints(args.attn_dcnn_filter_size),
      attn_dcnn_depth=_comma_ints(args.attn_dcnn_depth),
      attn_dcnn_pool=_comma_ints(args.attn_dcnn_pool),
      attn_cnn_skip=_comma_ints(args.attn_cnn_skip),
      num_ctrl_mlp_layers=args.num_ctrl_mlp_layers,
      ctrl_mlp_dim=args.ctrl_mlp_dim,
      weight_decay=args.weight_decay, base_learn_rate=args.base_learn_rate,
      learn_rate_decay=args.learn_rate_decay,
      steps_per_learn_rate_decay=args.steps_per_learn_rate_decay,
      loss_mix_ratio=args.loss_mix_ratio, segm_loss_fn=args.segm_loss_fn,
      box_loss_fn=args.box_loss_fn,
      attn_box_padding_ratio=args.attn_box_padding_ratio,
      use_knob=args.use_knob, knob_decay=args.knob_decay,
      knob_base=args.knob_base,
      steps_per_knob_decay=args.steps_per_knob_decay,
      knob_box_offset=args.knob_box_offset,
      knob_segm_offset=args.knob_segm_offset,
      knob_use_timescale=args.knob_use_timescale,
      gt_box_ctr_noise=args.gt_box_ctr_noise,
      gt_box_pad_noise=args.gt_box_pad_noise,
      gt_segm_noise=args.gt_segm_noise,
      squash_ctrl_params=args.squash_ctrl_params,
      clip_gradient=args.clip_gradient, fixed_order=args.fixed_order,
      fixed_gamma=args.fixed_gamma, fixed_var=args.fixed_var,
      dynamic_var=args.dynamic_var,
      num_ctrl_rnn_iter=args.num_ctrl_rnn_iter,
      num_glimpse_mlp_layers=args.num_glimpse_mlp_layers,
      pretrain_ctrl_net=args.pretrain_ctrl_net,
      pretrain_attn_net=args.pretrain_attn_net,
      pretrain_net=args.pretrain_net,
      freeze_ctrl_cnn=args.freeze_ctrl_cnn,
      freeze_ctrl_rnn=args.freeze_ctrl_rnn,
      freeze_ctrl_mlp=args.freeze_ctrl_mlp,
      freeze_attn_net=args.freeze_attn_net,
      stop_canvas_grad=args.stop_canvas_grad,
      use_iou_box=args.use_iou_box, add_skip_conn=args.add_skip_conn,
      disable_overwrite=args.disable_overwrite,
      add_d_out=args.add_d_out, add_y_out=args.add_y_out,
      num_semantic_classes=args.num_semantic_classes,
      ctrl_add_inp=args.ctrl_add_inp, ctrl_add_canvas=args.ctrl_add_canvas,
      ctrl_add_d_out=args.ctrl_add_d_out, ctrl_add_y_out=args.ctrl_add_y_out,
      attn_add_inp=args.attn_add_inp, attn_add_canvas=args.attn_add_canvas,
      attn_add_d_out=args.attn_add_d_out, attn_add_y_out=args.attn_add_y_out,
      rnd_hflip=trans['rnd_hflip'], rnd_vflip=trans['rnd_vflip'],
      rnd_transpose=trans['rnd_transpose'], rnd_colour=trans['rnd_colour'],
      finetune=args.finetune, remat=args.remat)


def add_box_model_args(parser):
  """ref box_model_train.py flag subset."""
  parser.add_argument('--padding', default=16, type=int)
  parser.add_argument('--weight_decay', default=5e-5, type=float)
  parser.add_argument('--base_learn_rate', default=0.001, type=float)
  parser.add_argument('--learn_rate_decay', default=0.96, type=float)
  parser.add_argument('--steps_per_learn_rate_decay', default=5000, type=int)
  parser.add_argument('--filter_height', default=48, type=int)
  parser.add_argument('--filter_width', default=48, type=int)
  parser.add_argument('--ctrl_cnn_filter_size', default='3,3,3,3,3')
  parser.add_argument('--ctrl_cnn_depth', default='4,8,16,16,32')
  parser.add_argument('--ctrl_cnn_pool', default='2,2,2,2,2')
  parser.add_argument('--ctrl_rnn_hid_dim', default=256, type=int)
  parser.add_argument('--num_ctrl_mlp_layers', default=1, type=int)
  parser.add_argument('--ctrl_mlp_dim', default=256, type=int)
  parser.add_argument('--box_loss_fn', default='iou')
  parser.add_argument('--attn_box_padding_ratio', default=0.2, type=float)
  parser.add_argument('--gt_segm_noise', default=0.3, type=float)
  parser.add_argument('--clip_gradient', default=1.0, type=float)
  parser.add_argument('--squash_ctrl_params', action='store_true')
  parser.add_argument('--fixed_order', action='store_true')
  parser.add_argument('--fixed_var', action='store_true', default=True)
  parser.add_argument('--dynamic_var', action='store_true')
  parser.add_argument('--use_iou_box', action='store_true')
  parser.add_argument('--num_ctrl_rnn_iter', default=5, type=int)
  parser.add_argument('--num_glimpse_mlp_layers', default=2, type=int)
  parser.add_argument('--pretrain_cnn', default=None)
  parser.add_argument('--pretrain_net', default=None)
  parser.add_argument('--freeze_pretrain_cnn', action='store_true')
  parser.add_argument('--add_d_out', action='store_true')
  parser.add_argument('--add_y_out', action='store_true')
  parser.add_argument('--num_semantic_classes', default=1, type=int)
  parser.add_argument('--finetune', action='store_true')


def make_box_model_config(args) -> C.BoxModelConfig:
  dims, trans = dataset_geometry(args.dataset)
  return C.BoxModelConfig(
      inp_height=dims['inp_height'], inp_width=dims['inp_width'],
      timespan=dims['timespan'], padding=args.padding,
      filter_height=args.filter_height, filter_width=args.filter_width,
      ctrl_cnn_filter_size=_comma_ints(args.ctrl_cnn_filter_size),
      ctrl_cnn_depth=_comma_ints(args.ctrl_cnn_depth),
      ctrl_cnn_pool=_comma_ints(args.ctrl_cnn_pool),
      ctrl_rnn_hid_dim=args.ctrl_rnn_hid_dim,
      num_ctrl_mlp_layers=args.num_ctrl_mlp_layers,
      ctrl_mlp_dim=args.ctrl_mlp_dim,
      num_ctrl_rnn_iter=args.num_ctrl_rnn_iter,
      num_glimpse_mlp_layers=args.num_glimpse_mlp_layers,
      attn_box_padding_ratio=args.attn_box_padding_ratio,
      weight_decay=args.weight_decay, box_loss_fn=args.box_loss_fn,
      base_learn_rate=args.base_learn_rate,
      learn_rate_decay=args.learn_rate_decay,
      steps_per_learn_rate_decay=args.steps_per_learn_rate_decay,
      clip_gradient=args.clip_gradient,
      squash_ctrl_params=args.squash_ctrl_params,
      fixed_order=args.fixed_order, fixed_var=args.fixed_var,
      dynamic_var=args.dynamic_var, use_iou_box=args.use_iou_box,
      gt_segm_noise=args.gt_segm_noise,
      add_d_out=args.add_d_out, add_y_out=args.add_y_out,
      num_semantic_classes=args.num_semantic_classes,
      pretrain_cnn=args.pretrain_cnn, pretrain_net=args.pretrain_net,
      freeze_pretrain_cnn=args.freeze_pretrain_cnn,
      rnd_hflip=trans['rnd_hflip'], rnd_vflip=trans['rnd_vflip'],
      rnd_transpose=trans['rnd_transpose'], rnd_colour=trans['rnd_colour'],
      finetune=args.finetune)


def add_fg_model_args(parser):
  """ref fg_model_train.py flag subset."""
  parser.add_argument('--padding', default=16, type=int)
  parser.add_argument('--weight_decay', default=5e-5, type=float)
  parser.add_argument('--base_learn_rate', default=0.001, type=float)
  parser.add_argument('--learn_rate_decay', default=0.96, type=float)
  parser.add_argument('--steps_per_learn_rate_decay', default=5000, type=int)
  parser.add_argument('--cnn_filter_size', default=None)
  parser.add_argument('--cnn_depth', default='4,8,8,12,16')
  parser.add_argument('--cnn_pool', default='2,2,2,2,2')
  parser.add_argument('--cnn_skip', default=None)
  parser.add_argument('--dcnn_filter_size', default=None)
  parser.add_argument('--dcnn_depth', default='8,6,4,4,2,1')
  parser.add_argument('--dcnn_pool', default='2,2,2,2,2,1')
  parser.add_argument('--dcnn_skip', default=None)
  parser.add_argument('--add_skip_conn', action='store_true')
  parser.add_argument('--segm_loss_fn', default='iou')
  parser.add_argument('--add_orientation', action='store_true')
  parser.add_argument('--num_orientation_classes', default=8, type=int)
  parser.add_argument('--num_semantic_classes', default=1, type=int)
  parser.add_argument('--optimizer', default='adam')


def make_fg_model_config(args) -> C.FGModelConfig:
  dims, trans = dataset_geometry(args.dataset)
  cnn_depth = _comma_ints(args.cnn_depth)
  dcnn_depth = _comma_ints(args.dcnn_depth)
  cnn_fs = (_comma_ints(args.cnn_filter_size) if args.cnn_filter_size
            else (3,) * len(cnn_depth))
  dcnn_fs = (_comma_ints(args.dcnn_filter_size) if args.dcnn_filter_size
             else (3,) * len(dcnn_depth))
  return C.FGModelConfig(
      inp_height=dims['inp_height'], inp_width=dims['inp_width'],
      padding=args.padding, cnn_filter_size=cnn_fs, cnn_depth=cnn_depth,
      cnn_pool=_comma_ints(args.cnn_pool),
      cnn_skip_mask=(_comma_ints(args.cnn_skip) if args.cnn_skip else None),
      dcnn_filter_size=dcnn_fs, dcnn_depth=dcnn_depth,
      dcnn_pool=_comma_ints(args.dcnn_pool),
      dcnn_skip_mask=(_comma_ints(args.dcnn_skip)
                      if args.dcnn_skip else None),
      use_bn=True, weight_decay=args.weight_decay,
      base_learn_rate=args.base_learn_rate,
      learn_rate_decay=args.learn_rate_decay,
      steps_per_learn_rate_decay=args.steps_per_learn_rate_decay,
      add_skip_conn=args.add_skip_conn, segm_loss_fn=args.segm_loss_fn,
      add_orientation=args.add_orientation,
      num_orientation_classes=args.num_orientation_classes,
      num_semantic_classes=args.num_semantic_classes,
      optimizer=args.optimizer,
      rnd_hflip=False, rnd_vflip=False, rnd_transpose=False,
      rnd_colour=trans['rnd_colour'])
