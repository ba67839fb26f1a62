"""The weight-export command lines: a results folder's checkpoint ->
``weights.h5``.

Counterpart of ``rec_attend_tpu/cli/read_weights.py``: restore the
folder's latest ``ckpt-*.npz`` under its ``model_opt.yaml`` and write the
nets that the model has, by name (``nn/params.py``'s schema, the BatchNorm
copies per timestep), to ``--output`` or to
``<results>/<model_id>/weights.h5``.  A full model's ``pretrain_*`` fields
and a box model's read such files.  No h5py: the file is written by
``utils/h5.py``.

    python -m rec_attend_tpu_torch.cli.read_weights box \\
        --model_id box_model_synth-20260816104712 --output /tmp/box.h5
    python -m rec_attend_tpu_torch.cli.read_weights full \\
        --model_id full_model_synth-20260816104712 --results results \\
        --output /tmp/full.h5

The default ``--output`` overwrites the folder's own ``weights.h5``.  The
model is restored on the card unless the Python caller passes
``device='cpu'``.
"""

from __future__ import annotations

import argparse
import os
import sys

from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch.config import BoxModelConfig
from rec_attend_tpu_torch.config import FullModelConfig
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.nn import params as P
from rec_attend_tpu_torch.utils import logger

BOX_NETS = ('ctrl_cnn', 'ctrl_mlp', 'glimpse_mlp', 'score_mlp', 'ctrl_lstm')
FULL_NETS = BOX_NETS + ('attn_cnn', 'attn_dcnn')
CONFIGS = {'box': BoxModelConfig, 'full': FullModelConfig}


def restore_model(spec, folder, device=None):
  """(model, config, step) of the latest checkpoint of ``folder`` under its
  ``model_opt.yaml``, the model on ``device``."""
  cfg = CONFIGS[spec].from_yaml(os.path.join(folder, 'model_opt.yaml'))
  path = saver.latest_checkpoint(folder)
  model = convert.model_class(cfg)(cfg, device=device)
  model.load_state_dict(convert.params_from_checkpoint(path, cfg))
  return model, cfg, saver.checkpoint_step(path)


def _main(spec, nets, argv=None, device=None):
  parser = argparse.ArgumentParser(
      description=f'Read pretrained {spec} weights')
  parser.add_argument('--model_id', default=None, required=True)
  parser.add_argument('--results', default='results')
  parser.add_argument('--output', default=None)
  args = parser.parse_args(argv)
  folder = os.path.join(args.results, args.model_id)
  output = args.output or os.path.join(folder, 'weights.h5')
  model, _, step = restore_model(spec, folder, device)
  P.export_weights_h5(model, nets, output)
  logger.get().info(f'Saved weights (step {step}) to {output}')
  return output


def box_main(argv=None, device=None):
  return _main('box', BOX_NETS, argv, device)


def full_main(argv=None, device=None):
  return _main('full', FULL_NETS, argv, device)


MAINS = {'box': box_main, 'full': full_main}

if __name__ == '__main__':
  if len(sys.argv) < 2 or sys.argv[1] not in MAINS:
    sys.exit('usage: python -m rec_attend_tpu_torch.cli.read_weights '
             '{box,full} --model_id ID [--results DIR] [--output PATH]')
  MAINS[sys.argv[1]](sys.argv[2:])
