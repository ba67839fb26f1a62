"""Resume the paper-scale synth pipeline from a box checkpoint.

Counterpart of ``pipelines/resume_synth_paper.py``: goes on training the
box model to ``--box_steps``, exports its ``weights.h5``
(``cli.read_weights.box_main``), trains the full model from it (or, with
``--finetune_from``, from a trained full model's export, its step reset to
0) with the counting levers asked for, and evaluates the valid split over
a sweep of thresholds, as ``run_pipeline``'s synth chain at the paper
scale would.  A full model folder that holds a checkpoint is resumed.

    python -m rec_attend_tpu_torch.pipelines.resume_synth_paper \\
        --box_id box_model_synth-XXXX [--results results] [--logs logs] \\
        [--dataset_folder data/synth224] [--skip_box]

Runs on the card; ``main(argv, device='cpu')`` on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os

from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.cli import eval as eval_cli
from rec_attend_tpu_torch.cli import read_weights
from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
from rec_attend_tpu_torch.utils import logger

THRESHOLDS = '0.2,0.3,0.35,0.4,0.45,0.5,0.6'


def parse_args(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--box_id', required=True)
  parser.add_argument('--results', default='results')
  parser.add_argument('--logs', default='logs')
  parser.add_argument('--dataset_folder', default='data/synth224')
  parser.add_argument('--box_steps', default=12000, type=int)
  parser.add_argument('--full_steps', default=20000, type=int)
  parser.add_argument('--skip_box', action='store_true')
  parser.add_argument('--data_examples', default=256, type=int,
                      help='train-split size (changing it regenerates the '
                           'synth splits; pick a fresh --full_id)')
  parser.add_argument('--full_id', default=None,
                      help='override the full-model id (default: derived '
                           'from --box_id); a fresh id trains from the box '
                           'weights.h5 instead of resuming')
  parser.add_argument('--loss_mix_ratio', default=None, type=float,
                      help='override the conf-loss weight (counting '
                           'experiments; default: preset 1.0)')
  parser.add_argument('--dtype', default=None,
                      choices=['float32', 'bfloat16'],
                      help='compute dtype of the full model\'s conv and '
                           'matmul stacks')
  parser.add_argument('--segm_weight_alpha', default=None, type=float,
                      help='small-instance segm-loss upweighting exponent '
                           '(counting lever a)')
  parser.add_argument('--dynamic_var', action='store_true',
                      help='predict the attention variance from the ctrl '
                           'net instead of deriving it from box size '
                           '(counting lever c)')
  parser.add_argument('--filter_size', default=None, type=int,
                      help='glimpse filter size override, e.g. 64 '
                           '(counting lever b; incompatible with '
                           '--finetune_from: changes no param shapes but '
                           'changes glimpse resolution)')
  parser.add_argument('--steps_per_knob_decay', default=None, type=int,
                      help='slow the scheduled-sampling knob decay '
                           '(counting lever d)')
  parser.add_argument('--knob_segm_offset', default=None, type=int,
                      help='delay the segm knob decay onset '
                           '(counting lever d)')
  parser.add_argument('--finetune_from', default=None,
                      help='initialise the full model from this trained '
                           'full-model id (read_weights full export) '
                           'instead of the box weights — step resets to 0')
  return parser.parse_args(argv)


def full_config(args, weights, device=None):
  """The full model's config: the CVPPP preset from the box's
  ``weights``, with the levers of ``args``; with ``--finetune_from`` from
  that model's export instead, the step and optimizer reset."""
  full_cfg = C.cvppp_full_config().replace(pretrain_ctrl_net=weights)
  if args.loss_mix_ratio is not None:
    full_cfg = full_cfg.replace(loss_mix_ratio=args.loss_mix_ratio)
  if args.dtype is not None:
    full_cfg = full_cfg.replace(dtype=args.dtype)
  if args.segm_weight_alpha is not None:
    full_cfg = full_cfg.replace(segm_weight_alpha=args.segm_weight_alpha)
  if args.dynamic_var:
    full_cfg = full_cfg.replace(dynamic_var=True)
  if args.filter_size is not None:
    full_cfg = full_cfg.replace(filter_height=args.filter_size,
                                filter_width=args.filter_size)
  if args.steps_per_knob_decay is not None:
    full_cfg = full_cfg.replace(
        steps_per_knob_decay=args.steps_per_knob_decay)
  if args.knob_segm_offset is not None:
    full_cfg = full_cfg.replace(knob_segm_offset=args.knob_segm_offset)
  if args.finetune_from:
    full_weights = read_weights.full_main(
        ['--model_id', args.finetune_from, '--results', args.results],
        device=device)
    full_cfg = full_cfg.replace(pretrain_ctrl_net=None,
                                pretrain_net=full_weights, finetune=True)
  return full_cfg


def main(argv=None, device=None):
  """Run the chain; returns the full model's id."""
  args = parse_args(argv)
  log = logger.get()

  data_cfg = C.DataConfig(dataset='synth', folder=args.dataset_folder,
                          height=224, width=224, timespan=21,
                          num_examples=args.data_examples, max_objects=9)
  cadence = dict(steps_per_valid=250, steps_per_trainval=250,
                 steps_per_plot=0, num_batch_valid=4, prefetch=True,
                 num_worker=2, device_data=True)
  full_id = args.full_id or args.box_id.replace('box_model', 'full_model')

  if not args.skip_box:
    train_cfg = C.TrainConfig(
        model_id=args.box_id, num_steps=args.box_steps, batch_size=8,
        save_ckpt=True, results=args.results, logs=args.logs,
        restore=os.path.join(args.results, args.box_id), **cadence)
    exp = TrainingExperiment('box', C.cvppp_box_config(), train_cfg,
                             data_cfg, device=device)
    log.info(f'Resumed box at step {exp.step}')
    exp.run()
    exp.close()

  weights = os.path.join(args.results, args.box_id, 'weights.h5')
  if not os.path.exists(weights):
    # Exported from the box's latest checkpoint; a kept weights.h5 stands
    # where the checkpoints are gone.
    weights = read_weights.box_main(
        ['--model_id', args.box_id, '--results', args.results],
        device=device)

  full_cfg = full_config(args, weights, device)
  full_folder = os.path.join(args.results, full_id)
  has_ckpt = bool(glob.glob(os.path.join(full_folder, 'ckpt-*.npz')))
  full_restore = full_folder if has_ckpt else None
  if full_restore and full_cfg.finetune:
    # A relaunch of a finetune goes on from its own checkpoint, which
    # holds the finetuned weights and the schedule's place: the finetune's
    # reset belongs to the first load of the pretrained weights only.
    full_cfg = full_cfg.replace(finetune=False, pretrain_net=None)
  train_cfg = C.TrainConfig(
      model_id=full_id, num_steps=args.full_steps, batch_size=8,
      save_ckpt=True, results=args.results, logs=args.logs,
      restore=full_restore, **cadence)
  exp = TrainingExperiment('full', full_cfg, train_cfg, data_cfg,
                           device=device)
  if full_restore:
    log.info(f'Resumed full at step {exp.step}')
  exp.run()
  exp.close()

  eval_cli.full_main(['--model_id', full_id, '--results', args.results,
                      '--dataset', 'synth', '--split', 'valid',
                      '--batch_size', '8', '--threshold_list', THRESHOLDS,
                      '--dataset_folder', args.dataset_folder],
                     device=device)
  log.info(f'Pipeline done: {full_id}')
  return full_id


if __name__ == '__main__':
  main()
