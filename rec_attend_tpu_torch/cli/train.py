"""The train command lines of the full, box and fg models.

Counterpart of ``rec_attend_tpu/cli/train.py:17-55``: the train, data and
model flags (``cli.args``), a ``TrainingExperiment`` and its run.  The
JAX command line plots samples on the plot cadence with matplotlib; the
port has no plotting yet (ROADMAP A.4) and says so once in its log.

    python -m rec_attend_tpu_torch.cli.train box --dataset synth \\
        --num_steps 100 --batch_size 4 --save_ckpt
    python -m rec_attend_tpu_torch.cli.train box --dataset synth \\
        --num_steps 200 --save_ckpt --restore results/<model id>

The Python entry points take ``device`` as the port's others do: the card
unless ``device='cpu'``.
"""

from __future__ import annotations

import argparse
import sys

from rec_attend_tpu_torch.cli import args as A
from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
from rec_attend_tpu_torch.utils import logger


def _run(spec, make_model_cfg, add_model_args, argv=None, device=None):
  parser = argparse.ArgumentParser(description=f'Train {spec} model')
  A.add_train_args(parser)
  A.add_data_args(parser)
  add_model_args(parser)
  args = parser.parse_args(argv)
  log = logger.get()
  log.log_args()
  model_cfg = make_model_cfg(args)
  train_cfg = A.make_train_config(args)
  data_cfg = A.make_data_config(args)
  if train_cfg.steps_per_plot > 0:
    log.info('Plotting is not ported yet (ROADMAP A.4): no plots are made')
  exp = TrainingExperiment(spec, model_cfg, train_cfg, data_cfg,
                           device=device)
  exp.run()
  exp.close()
  return exp


def full_main(argv=None, device=None):
  return _run('full', A.make_full_model_config, A.add_full_model_args, argv,
              device)


def box_main(argv=None, device=None):
  return _run('box', A.make_box_model_config, A.add_box_model_args, argv,
              device)


def fg_main(argv=None, device=None):
  return _run('fg', A.make_fg_model_config, A.add_fg_model_args, argv,
              device)


MAINS = {'full': full_main, 'box': box_main, 'fg': fg_main}

if __name__ == '__main__':
  if len(sys.argv) < 2 or sys.argv[1] not in MAINS:
    sys.exit(f'usage: python -m rec_attend_tpu_torch.cli.train '
             f'{{{",".join(MAINS)}}} [flags]')
  MAINS[sys.argv[1]](sys.argv[2:])
