"""The synthetic dataset's training pipeline: box -> full -> eval.

Counterpart of ``run_synth`` of ``pipelines/run_pipeline.py:198-245``: the
box model trains on the synthetic split, the full model starts from the
box's controller and trains, and the eval command line scores the full
model on the valid split.  ``--scale paper`` is the CVPPP-shaped run
(224x224, T=21, up to 9 instances, the CVPPP presets, b8, 12,000 box and
20,000 full steps on 256 generated examples); ``--scale tiny`` a 64x64
smoke run.  The full model starts from the box's last ``ckpt-*.npz``
(``pretrain_ctrl_net``), where the JAX pipeline exports and reads
``weights.h5``, which needs h5py (``cli/read_weights.py``, ROADMAP A.4).
The pipelines of the other datasets (``run_synth3``, ``run_synth_cs``,
CVPPP, KITTI, Cityscapes) are not ported yet (ROADMAP A.4).

    python -m rec_attend_tpu_torch.pipelines.run_pipeline --dataset synth \\
        --scale tiny --num_steps 20
"""

from __future__ import annotations

import argparse

from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.cli import eval as eval_cli
from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
from rec_attend_tpu_torch.engine.experiment import assign_model_id
from rec_attend_tpu_torch.utils import logger


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
    cadence = dict(steps_per_valid=250, steps_per_trainval=250,
                   steps_per_plot=0, num_batch_valid=4, prefetch=True,
                   num_worker=2, device_data=True)
  else:
    data_cfg = C.data_config_for('synth', dataset_folder)
    box_cfg = C.tiny_box_config(timespan=6)
    full_base = C.tiny_full_config(timespan=6, use_knob=True)
    bs = 4
    box_steps = full_steps = num_steps or 100
    cadence = dict(steps_per_valid=max(box_steps // 2, 1),
                   steps_per_trainval=max(box_steps // 2, 1),
                   steps_per_plot=0)
  train_cfg = C.TrainConfig(num_steps=box_steps, batch_size=bs,
                            save_ckpt=True, results=results, logs=logs,
                            **cadence)
  return data_cfg, box_cfg, full_base, train_cfg, full_steps


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
  box = TrainingExperiment('box', box_cfg, train_cfg, data_cfg,
                           device=device)
  box.run()
  box.close()
  _, box_ckpt = box.saver.get_latest_ckpt()

  full_cfg = full_base.replace(pretrain_ctrl_net=box_ckpt)
  train_cfg = train_cfg.replace(model_id=full_id, num_steps=full_steps)
  full = TrainingExperiment('full', full_cfg, train_cfg, data_cfg,
                            device=device)
  full.run()
  full.close()
  eval_cli.full_main(['--model_id', full_id, '--results', args.results,
                      '--dataset', 'synth', '--split', 'valid',
                      '--batch_size', str(train_cfg.batch_size)]
                     + (['--dataset_folder', args.dataset_folder]
                        if args.dataset_folder else []), device=device)
  log.info(f'Pipeline done: {full_id}')
  return full_id


def main(argv=None, device=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--dataset', default='synth', choices=['synth'],
                      help='only the synth pipeline is ported (ROADMAP A.4)')
  parser.add_argument('--dataset_folder', default=None)
  parser.add_argument('--results', default='results')
  parser.add_argument('--logs', default='logs')
  parser.add_argument('--scale', default='paper', choices=['paper', 'tiny'])
  parser.add_argument('--num_steps', default=None, type=int,
                      help='steps per stage (default: the scale\'s own)')
  args = parser.parse_args(argv)
  return run_synth(args, device=device)


if __name__ == '__main__':
  main()
