#!/usr/bin/env python3
"""The float32 noise floor of chip_smoke.py's train-step gates, over several
batches.

    python3 step_noise.py [--batches 5] [--step 30000] [--batch 32]

Restores the flagship CVPPP checkpoint with its Adam state on one CUDA card
and, for each of several seeded synthetic batches and draws, runs
``chip_smoke.step_gates`` at the given global step: the plain-glimpse step,
the plain step whose einsums sum in other orders (the noise floor), the
kernel step and the step whose glimpse backward drops the filter gradients.
Prints one JSON line per batch with, for each pair, the loss difference,
the gradient errors (worst leaf, all leaves at once, median leaf), the
update error, how many examples' matchings differ and the forwards'
differences, then the card's name and power limit.  chip_smoke.py gates one
of these batches (seed 1000, draws seed 1); this script shows how the
statistics spread over others.  Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import sys

import chip_smoke


def main():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--batches', type=int, default=5)
  ap.add_argument('--step', type=int, default=30000)
  ap.add_argument('--batch', type=int, default=chip_smoke.TRAIN_BATCH)
  args = ap.parse_args()

  import torch
  if not torch.cuda.is_available():
    sys.exit('step_noise: CUDA is not available; this script runs on a card')
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.config import cvppp_full_config
  from rec_attend_tpu_torch.data.synthetic import synthetic_instances
  from rec_attend_tpu_torch.engine.trainer import Trainer
  from rec_attend_tpu_torch.models.full_model import draw_train_randoms
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.ops import matching
  from rec_attend_tpu_torch.ops.cuda import glimpse as gk

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cfg = cvppp_full_config()
  trainer = Trainer(cfg, device='cuda')
  trainer.restore(chip_smoke.CHECKPOINT_DIR)
  lr = learn_rate(cfg, trainer.opt_state['count'])
  limits = (chip_smoke.STEP_LIMITS if args.step == 0
            else chip_smoke.OWN_CANVAS_LIMITS)
  keys = ('loss_rel_diff', 'grad_rel_l2_max', 'grad_rel_l2_all',
          'grad_rel_l2_median', 'update_rel_l2_max', 'matches_differ',
          'forward', 'failed')
  for i in range(args.batches):
    data = synthetic_instances(args.batch, cfg.inp_height, cfg.inp_width,
                               cfg.timespan, seed=1000 + i)
    batch = {k: v.to('cuda') for k, v in data.items()}
    draws = draw_train_randoms(cfg, args.batch,
                               torch.Generator('cuda').manual_seed(1 + i))
    gates, failures = chip_smoke.step_gates(
        torch, ts, matching, gk, trainer.model, trainer.opt_state, batch,
        draws, args.step, lr, limits)
    print(json.dumps({
        'batch_seed': 1000 + i, 'draws_seed': 1 + i, 'step': args.step,
        'batch': args.batch, 'limits': limits, 'failures': failures,
        'gates': {name: {k: v[k] for k in keys}
                  for name, v in gates.items()}}), flush=True)
  print(chip_smoke.nvidia_smi_name_power(), flush=True)


if __name__ == '__main__':
  main()
