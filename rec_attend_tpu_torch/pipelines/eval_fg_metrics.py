"""The fg model's metrics over a split: foreground IoU (soft and hard) and
the orientation accuracy within the foreground.

Counterpart of ``pipelines/eval_fg_metrics.py:23-85``: the fg model of a
results folder runs over the split in index order, and each metric is the
mean of its batches' values weighted by their sizes.  A multiclass
foreground leaves its background channel 0 out of the IoU and of the
orientation mask (``:52-59``), as the model's own metrics do.  It prints
one JSON line and writes ``fg_metrics_{split}.json`` into the model's
folder.  The metrics are numpy on the host, as in the JAX script.

    python -m rec_attend_tpu_torch.pipelines.eval_fg_metrics \\
        --model_id fg_model_... [--results results] [--split valid]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from rec_attend_tpu_torch.cli import args as A
from rec_attend_tpu_torch.config import FGModelConfig
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.engine.experiment import EvalExperiment


def batch_metrics(y_out, y_gt, d_out=None, d_gt=None):
  """{'iou_soft', 'iou_hard'[, 'orientation_acc']} of one batch: the
  foreground [B,H,W,C] against its target, the orientation [B,H,W,8]
  against its one-hot target within the target's foreground."""
  if y_gt.shape[-1] > 1:
    y_out, y_gt = y_out[..., 1:], y_gt[..., 1:]
  inter = np.minimum(y_out, y_gt).sum()
  union = np.maximum(y_out, y_gt).sum() + 1e-5
  hard = (y_out > 0.5).astype('float32')
  inter_h = np.minimum(hard, y_gt).sum()
  union_h = np.maximum(hard, y_gt).sum() + 1e-5
  row = {'iou_soft': inter / union, 'iou_hard': inter_h / union_h}
  if d_out is not None:
    mask = y_gt.max(axis=-1)
    correct = (d_out.argmax(-1) == d_gt.argmax(-1)).astype('float32')
    row['orientation_acc'] = (correct * mask).sum() / max(mask.sum(), 1.0)
  return row


def main(argv=None, device=None):
  """Returns the metrics written; ``device`` as the port's other entry
  points take it."""
  p = argparse.ArgumentParser()
  p.add_argument('--model_id', required=True)
  p.add_argument('--results', default='results')
  p.add_argument('--split', default='valid')
  p.add_argument('--batch_size', default=8, type=int)
  p.add_argument('--dataset', default='synth')
  p.add_argument('--dataset_folder', default=None)
  p.add_argument('--data_examples', default=None, type=int)
  args = p.parse_args(argv)

  restore = os.path.join(args.results, args.model_id)
  model_cfg = FGModelConfig.from_yaml(os.path.join(restore,
                                                   'model_opt.yaml'))
  data_cfg = A.make_data_config(args, restore=restore)
  exp = EvalExperiment(restore, cfg=model_cfg, device=device, spec='fg')
  ds = provider.get(data_cfg.dataset, data_cfg, split=args.split)
  sums, count = {}, 0
  for _, raw, outputs in exp.iterate_split(ds, args.batch_size):
    d_out = outputs.get('d_out')
    row = batch_metrics(
        outputs['y_out'].float().cpu().numpy(), raw['c_gt'],
        None if d_out is None else d_out.float().cpu().numpy(), raw['d_gt'])
    n = len(raw['c_gt'])
    for k, v in row.items():
      sums[k] = sums.get(k, 0.0) + float(v) * n
    count += n
  avg = {k: round(v / count, 4) for k, v in sums.items()}
  avg.update(model_id=args.model_id, split=args.split, n=count,
             step=exp.step)
  print(json.dumps(avg))
  with open(os.path.join(restore, f'fg_metrics_{args.split}.json'),
            'w') as f:
    json.dump(avg, f, indent=2)
  return avg


if __name__ == '__main__':
  main(sys.argv[1:])
