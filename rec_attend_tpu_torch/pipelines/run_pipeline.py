"""The synthetic datasets' training pipelines: box -> full -> eval, and
fg -> pack -> box -> full -> eval.

Counterpart of ``run_synth`` and ``run_synth3`` of
``pipelines/run_pipeline.py:198-372``.  ``--dataset synth``: the box model
trains on the synthetic split, the full model starts from the box's
controller and trains, and the eval command line scores the full model on
the valid split.  ``--scale paper`` is the CVPPP-shaped run (224x224, T=21,
up to 9 instances, the CVPPP presets, b8, 12,000 box and 20,000 full steps
on 256 generated examples); ``--scale tiny`` a 64x64 smoke run.

``--dataset synth3`` is the KITTI-shaped chain: the fg model with its
orientation head trains, the pack stage writes its maps into each split's
pack file (``cli.pack.fg_main``), the box model and then the full model
train on the packed channels, and the eval stage scores the fg model
(``pipelines.eval_fg_metrics``) and the full model over six thresholds.
``--scale paper`` is 128x448, T=20, up to 12 instances, the KITTI presets,
b8, 3,000 fg, 12,000 box and 16,000 full steps on 256 examples
(``--data_examples``), each split kept on the device; ``--scale tiny`` a
64x64 smoke run on 32 examples.  ``--stages`` picks stages and
``--model_id`` names the chain, so a chain can go on in another process:
no stage hands another anything in memory, each reads its split through
``data.provider``, as the JAX stages read the H5.  ``--fg_from`` and
``--box_from`` reuse a trained stage; ``--resume`` restores each trained
stage from its folder (its data snapshot must match), and skips fg, pack
and box once a full checkpoint and both pack files exist.

The full model starts from the box's last ``ckpt-*.npz``
(``pretrain_ctrl_net``), where the JAX pipeline exports and reads
``weights.h5``, which needs h5py (``cli/read_weights.py``, ROADMAP A.4).
The pipelines of the other datasets (``run_synth_cs``, CVPPP, KITTI,
Cityscapes) are not ported yet (ROADMAP A.3, A.5).  The command line runs
on the card; ``main(argv, device='cpu')`` runs on the host.

    python -m rec_attend_tpu_torch.pipelines.run_pipeline --dataset synth \\
        --scale tiny --num_steps 20
    python -m rec_attend_tpu_torch.pipelines.run_pipeline --dataset synth3 \\
        --scale tiny --stages fg,pack --model_id chain
    python -m rec_attend_tpu_torch.pipelines.run_pipeline --dataset synth3 \\
        --scale tiny --stages box,full,eval --model_id chain
"""

from __future__ import annotations

import argparse
import os
import sys

from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.cli import eval as eval_cli
from rec_attend_tpu_torch.cli import pack as pack_cli
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
from rec_attend_tpu_torch.engine.experiment import assign_model_id
from rec_attend_tpu_torch.pipelines import eval_fg_metrics
from rec_attend_tpu_torch.utils import logger

SYNTH3_STAGES = ('fg', 'pack', 'box', 'full', 'eval')
# The paper scale's cadence (JAX run_pipeline.py:222-224, :314-316).
PAPER_CADENCE = dict(steps_per_valid=250, steps_per_trainval=250,
                     steps_per_plot=0, num_batch_valid=4, prefetch=True,
                     num_worker=2, device_data=True)


def _tiny_cadence(steps):
  return dict(steps_per_valid=max(steps // 2, 1),
              steps_per_trainval=max(steps // 2, 1), steps_per_plot=0)


def synth_stages(scale, results='results', logs='logs', dataset_folder=None,
                 num_steps=None):
  """The configs of ``run_synth`` at ``scale``: (data config, box config,
  full config before its pretrained controller is named, the box stage's
  train config, the full stage's step count)."""
  if scale == 'paper':
    data_cfg = C.DataConfig(dataset='synth', folder=dataset_folder,
                            height=224, width=224, timespan=21,
                            num_examples=256, max_objects=9)
    box_cfg = C.cvppp_box_config()
    full_base = C.cvppp_full_config()
    bs = 8
    box_steps = num_steps or 12000
    full_steps = num_steps or 20000
    cadence = PAPER_CADENCE
  else:
    data_cfg = C.data_config_for('synth', dataset_folder)
    box_cfg = C.tiny_box_config(timespan=6)
    full_base = C.tiny_full_config(timespan=6, use_knob=True)
    bs = 4
    box_steps = full_steps = num_steps or 100
    cadence = _tiny_cadence(box_steps)
  train_cfg = C.TrainConfig(num_steps=box_steps, batch_size=bs,
                            save_ckpt=True, results=results, logs=logs,
                            **cadence)
  return data_cfg, box_cfg, full_base, train_cfg, full_steps


def synth3_stages(scale, results='results', logs='logs', dataset_folder=None,
                  num_steps=None, data_examples=None, fg_steps=None,
                  box_steps=None, full_steps=None):
  """The configs of ``run_synth3`` at ``scale`` (JAX
  ``run_pipeline.py:304-334``): (data config, fg config, box config, full
  config before its pretrained controller is named, the train config of
  the fg stage, {stage: its step count})."""
  if scale == 'paper':
    data_cfg = C.DataConfig(dataset='synth', folder=dataset_folder,
                            height=128, width=448, timespan=20,
                            num_examples=data_examples or 256,
                            max_objects=12)
    fg_cfg = C.kitti_fg_config()
    box_cfg = C.kitti_box_config()
    full_base = C.kitti_full_config()
    bs = 8
    steps = {'fg': fg_steps or 3000, 'box': box_steps or 12000,
             'full': full_steps or 16000}
    cadence = PAPER_CADENCE
  else:
    data_cfg = C.DataConfig(dataset='synth', folder=dataset_folder,
                            height=64, width=64, timespan=6,
                            num_examples=32, max_objects=4)
    fg_cfg = C.tiny_fg_config(add_orientation=True, dcnn_depth=(8, 4, 9))
    box_cfg = C.tiny_box_config(timespan=6, add_d_out=True, add_y_out=True)
    full_base = C.tiny_full_config(
        timespan=6, use_knob=True, add_d_out=True, add_y_out=True,
        ctrl_add_inp=True, ctrl_add_canvas=True,
        attn_add_inp=True, attn_add_canvas=True)
    bs = 4
    n = num_steps or 20
    steps = {'fg': fg_steps or n, 'box': box_steps or n,
             'full': full_steps or n}
    cadence = _tiny_cadence(steps['fg'])
  train_cfg = C.TrainConfig(num_steps=steps['fg'], batch_size=bs,
                            save_ckpt=True, results=results, logs=logs,
                            **cadence)
  return data_cfg, fg_cfg, box_cfg, full_base, train_cfg, steps


def _data_flags(args):
  """The data flags forwarded to the pack and eval command lines (they
  read the model's data_opt.yaml snapshot otherwise)."""
  return ((['--dataset_folder', args.dataset_folder]
           if args.dataset_folder else [])
          + (['--data_examples', str(args.data_examples)]
             if args.data_examples else []))


def _reuse_stages(args, stages, log):
  """--fg_from/--box_from reuse a trained stage: its train stage is
  dropped, so that a default --stages cannot train a fresh model into the
  reused folder."""
  for flag, stage in (('fg_from', 'fg'), ('box_from', 'box')):
    if getattr(args, flag) and stage in stages:
      log.warning(f'--{flag} given: skipping the {stage!r} train stage '
                  f'(reusing {getattr(args, flag)})')
      stages.discard(stage)
  return stages


def _restore_folder(args, model_id, data_cfg=None):
  """results/<id> where --resume was passed and a run exists there, else
  None (a fresh run).  A resumed run's data snapshot (data_opt.yaml) must
  match the data config, else the checkpoint would go on on another
  split: a mismatch raises."""
  folder = os.path.join(args.results, model_id)
  if not (args.resume and os.path.isdir(folder)):
    return None
  snap_path = os.path.join(folder, 'data_opt.yaml')
  if data_cfg is not None and os.path.exists(snap_path):
    snap = C.DataConfig.from_yaml(snap_path)
    for key in ('num_examples', 'height', 'width', 'timespan',
                'max_objects', 'num_semantic_classes'):
      cur, was = getattr(data_cfg, key), getattr(snap, key)
      if was != cur:
        raise ValueError(
            f'--resume {model_id}: DataConfig.{key}={cur} does not match '
            f'the run snapshot {snap_path} ({key}={was}); pass matching '
            'data flags to extend this run')
  return folder


def _skip_completed_prefix(args, stages, full_id, data_cfg, log):
  """On a --resume relaunch with a full-stage checkpoint, skip fg, pack and
  box: the checkpoint exists only if they completed.  Only where both
  splits' pack files hold the maps for these settings (a checkout may keep
  the checkpoint and lose the ignored data folder: then the prefix runs
  again)."""
  if not args.resume:
    return stages
  full_folder = os.path.join(args.results, full_id)
  if not (os.path.isdir(full_folder) and saver.list_checkpoints(full_folder)):
    return stages
  if all(provider.has_pack(data_cfg, split) for split in ('train', 'valid')):
    stages -= {'fg', 'pack', 'box'}
    log.info('--resume: full-stage ckpt + pack files present; skipping '
             'fg/pack/box')
  return stages


def _train(spec, cfg, train_cfg, data_cfg, device):
  exp = TrainingExperiment(spec, cfg, train_cfg, data_cfg, device=device)
  exp.run()
  exp.close()
  return exp


def run_synth(args, device=None):
  """Train the box and the full model and evaluate the full model on the
  valid split; returns the full model's id."""
  log = logger.get()
  model_id = assign_model_id()
  box_id = f'box_model_synth-{model_id}'
  full_id = f'full_model_synth-{model_id}'
  data_cfg, box_cfg, full_base, train_cfg, full_steps = synth_stages(
      args.scale, args.results, args.logs, args.dataset_folder,
      args.num_steps)

  train_cfg = train_cfg.replace(model_id=box_id)
  box = _train('box', box_cfg, train_cfg, data_cfg, device)
  _, box_ckpt = box.saver.get_latest_ckpt()

  full_cfg = full_base.replace(pretrain_ctrl_net=box_ckpt)
  train_cfg = train_cfg.replace(model_id=full_id, num_steps=full_steps)
  _train('full', full_cfg, train_cfg, data_cfg, device)
  eval_cli.full_main(['--model_id', full_id, '--results', args.results,
                      '--dataset', 'synth', '--split', 'valid',
                      '--batch_size', str(train_cfg.batch_size)]
                     + (['--dataset_folder', args.dataset_folder]
                        if args.dataset_folder else []), device=device)
  log.info(f'Pipeline done: {full_id}')
  return full_id


def run_synth3(args, device=None):
  """The KITTI-shaped chain's stages of ``--stages``; returns {'fg', 'box',
  'full': the model ids, 'stages': the stages that ran, in order}."""
  log = logger.get()
  stages = set(args.stages.split(','))
  unknown = stages - set(SYNTH3_STAGES)
  if unknown:
    raise ValueError(f'--stages: {sorted(unknown)} are not stages of the '
                     f'synth3 pipeline {SYNTH3_STAGES}')
  model_id = args.model_id or assign_model_id()
  fg_id = args.fg_from or f'fg_model_synth3-{model_id}'
  box_id = args.box_from or f'box_model_synth3-{model_id}'
  full_id = f'full_model_synth3-{model_id}'
  data_cfg, fg_cfg, box_cfg, full_base, train_cfg, steps = synth3_stages(
      args.scale, args.results, args.logs, args.dataset_folder,
      args.num_steps, args.data_examples, args.fg_steps, args.box_steps,
      args.full_steps)
  bs = str(train_cfg.batch_size)

  stages = _reuse_stages(args, stages, log)
  stages = _skip_completed_prefix(args, stages, full_id, data_cfg, log)
  if 'fg' in stages:
    # _restore_folder (and its data snapshot check) only for the stages
    # that train: a reused stage is not held to the current data flags.
    _train('fg', fg_cfg, train_cfg.replace(
        model_id=fg_id, num_steps=steps['fg'],
        restore=_restore_folder(args, fg_id, data_cfg)), data_cfg, device)
  if 'pack' in stages:
    pack_cli.fg_main(['--model_id', fg_id, '--results', args.results,
                      '--dataset', 'synth', '--split', 'train,valid',
                      '--batch_size', bs] + _data_flags(args), device=device)
  if 'box' in stages or 'full' in stages:
    missing = [s for s in ('train', 'valid')
               if not provider.has_pack(data_cfg, s)]
    if missing:
      raise FileNotFoundError(
          f'no pack file of the fg model for these settings of the '
          f'{missing} split(s) at {provider.pack_path(data_cfg, missing[0])}'
          ': run the pack stage first')
  if 'box' in stages:
    _train('box', box_cfg, train_cfg.replace(
        model_id=box_id, num_steps=steps['box'],
        restore=_restore_folder(args, box_id, data_cfg)), data_cfg, device)
  if 'full' in stages:
    box_ckpt = saver.latest_checkpoint(os.path.join(args.results, box_id))
    _train('full', full_base.replace(pretrain_ctrl_net=box_ckpt),
           train_cfg.replace(model_id=full_id, num_steps=steps['full'],
                             restore=_restore_folder(args, full_id,
                                                     data_cfg)),
           data_cfg, device)
  if 'eval' in stages:
    eval_fg_metrics.main(['--model_id', fg_id, '--results', args.results,
                          '--batch_size', bs] + _data_flags(args),
                         device=device)
    eval_cli.full_main(['--model_id', full_id, '--results', args.results,
                        '--dataset', 'synth', '--split', 'valid',
                        '--batch_size', bs,
                        '--threshold_list', '0.2,0.3,0.4,0.5,0.6,0.7']
                       + _data_flags(args), device=device)
  log.info(f'Pipeline done: {fg_id} -> {box_id} -> {full_id}')
  return {'fg': fg_id, 'box': box_id, 'full': full_id,
          'stages': [s for s in SYNTH3_STAGES if s in stages]}


def main(argv=None, device=None):
  """``device``: the card unless it names another."""
  parser = argparse.ArgumentParser()
  parser.add_argument('--dataset', default='synth',
                      choices=['synth', 'synth3'],
                      help='the synth and synth3 pipelines are ported '
                           '(ROADMAP A.3, A.5)')
  parser.add_argument('--dataset_folder', default=None)
  parser.add_argument('--results', default='results')
  parser.add_argument('--logs', default='logs')
  parser.add_argument('--scale', default='paper', choices=['paper', 'tiny'])
  parser.add_argument('--num_steps', default=None, type=int,
                      help='steps per stage (default: the scale\'s own)')
  synth3 = parser.add_argument_group('synth3')
  synth3.add_argument('--model_id', default=None,
                      help='reuse an id (go on with a chain)')
  synth3.add_argument('--stages', default=','.join(SYNTH3_STAGES))
  synth3.add_argument('--fg_steps', default=None, type=int)
  synth3.add_argument('--box_steps', default=None, type=int)
  synth3.add_argument('--full_steps', default=None, type=int)
  synth3.add_argument('--data_examples', default=None, type=int,
                      help='the train split\'s size (paper scale)')
  synth3.add_argument('--fg_from', default=None,
                      help='reuse this trained fg model id')
  synth3.add_argument('--box_from', default=None,
                      help='reuse this trained box model id (its last '
                           'checkpoint starts the full model)')
  synth3.add_argument('--resume', action='store_true',
                      help='restore each trained stage from its '
                           'results/<id> checkpoint')
  args = parser.parse_args(argv)
  if args.dataset == 'synth3':
    return run_synth3(args, device=device)
  return run_synth(args, device=device)


if __name__ == '__main__':
  main(sys.argv[1:])
