"""Packed-channel ablation: does feeding the fg model's packed
``d_in``/``y_in`` channels into the box stage help?

Counterpart of ``pipelines/ablate_packed.py``: trains the
no-packed-channels twin of a box run (the same data, steps and batch size;
only ``add_d_out``/``add_y_out`` off) as ``box_model_nofg_<...>``, writes
the tail-5 means of both runs' logged box loss and box IoU curves to the
twin's ``ablation.json`` (which ``write_results`` renders) and prints
them.

    python -m rec_attend_tpu_torch.pipelines.ablate_packed \\
        --baseline_id box_model_synthcs-XXXX [--steps 6000] \\
        [--batch_size 4] [--resume]

Runs on the card; ``main(argv, device='cpu')`` on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
from rec_attend_tpu_torch.pipelines.write_results import read_loss_curve


def tail_mean(rows, n=5):
  """Mean of the last ``n`` values of a curve, to 4 places, or None."""
  vals = [v for _, v in rows[-n:]]
  return round(sum(vals) / len(vals), 4) if vals else None


def main(argv=None, device=None):
  """Train the twin and compare; returns the table."""
  p = argparse.ArgumentParser()
  p.add_argument('--baseline_id', required=True)
  p.add_argument('--results', default='results')
  p.add_argument('--logs', default='logs')
  p.add_argument('--steps', default=6000, type=int)
  p.add_argument('--batch_size', default=4, type=int)
  p.add_argument('--dataset_folder', default=None)
  p.add_argument('--resume', action='store_true',
                 help='continue the twin from its latest checkpoint '
                      '(a relaunch must not restart a long run from '
                      'scratch)')
  args = p.parse_args(argv)

  base_folder = os.path.join(args.results, args.baseline_id)
  data_cfg = C.DataConfig.from_yaml(os.path.join(base_folder,
                                                 'data_opt.yaml'))
  if args.dataset_folder:
    data_cfg = data_cfg.replace(folder=args.dataset_folder)
  box_cfg = C.BoxModelConfig.from_yaml(os.path.join(base_folder,
                                                    'model_opt.yaml'))
  if not (box_cfg.add_d_out and box_cfg.add_y_out):
    raise ValueError('baseline must be a packed-channel run')
  ablate_cfg = box_cfg.replace(add_d_out=False, add_y_out=False)

  ablate_id = args.baseline_id.replace('box_model_', 'box_model_nofg_')
  if ablate_id == args.baseline_id:
    raise ValueError(
        f'--baseline_id {args.baseline_id!r} must start with "box_model_" — '
        'otherwise the ablation twin would train INTO the baseline folder, '
        'clobbering the checkpoint being compared against')
  twin_folder = os.path.join(args.results, ablate_id)
  restore = (twin_folder if args.resume
             and glob.glob(os.path.join(twin_folder, 'ckpt-*.npz'))
             else None)
  train_cfg = C.TrainConfig(model_id=ablate_id, num_steps=args.steps,
                            batch_size=args.batch_size, save_ckpt=True,
                            results=args.results, logs=args.logs,
                            restore=restore,
                            steps_per_valid=250, steps_per_trainval=250,
                            steps_per_plot=0, num_batch_valid=4,
                            prefetch=True, num_worker=2, device_data=True)
  exp = TrainingExperiment('box', ablate_cfg, train_cfg, data_cfg,
                           device=device)
  exp.run()
  exp.close()

  table = {}
  for label, mid in (('with_packed', args.baseline_id),
                     ('no_packed', ablate_id)):
    loss = read_loss_curve(os.path.join(args.logs, mid, 'loss.csv'))
    iou_csv = os.path.join(args.logs, mid, 'iou_soft_box.csv')
    table[label] = {
        'final_loss_tail5': tail_mean(loss),
        'train_iou_soft_box_tail5': tail_mean(read_loss_curve(iou_csv,
                                                              field=2)),
        'valid_iou_soft_box_tail5': tail_mean(read_loss_curve(iou_csv,
                                                              field=3)),
        'steps': loss[-1][0] if loss else None,
    }
  os.makedirs(twin_folder, exist_ok=True)
  with open(os.path.join(twin_folder, 'ablation.json'), 'w') as f:
    json.dump(table, f, indent=2)
  print(json.dumps(table, indent=2))
  return table


if __name__ == '__main__':
  main()
