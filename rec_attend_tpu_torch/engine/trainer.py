"""The training loop of the full model.

Counterpart of the step loop of ``TrainingExperiment.run``
(``rec_attend_tpu/engine/experiment.py:369-440``): a step counter, one
train step per batch and the step's metrics.  ``restore`` continues a JAX
trainer's run from its latest checkpoint, parameters, Adam state and step
(``experiment.py:445-449``).  Validation, plotting, the checkpoint cadence
and the command line are not ported yet.

    trainer = Trainer(cvppp_full_config())          # on the card
    trainer.restore('results/full_model_synth-20260816104712')
    history = trainer.run(5, batches)               # batches: an iterator
"""

from __future__ import annotations

import math

import torch

from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch import train_step as ts
from rec_attend_tpu_torch.config import FullModelConfig
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.models.full_model import FullModel
from rec_attend_tpu_torch.models.full_model import draw_train_randoms


class Trainer:
  """Trains ``FullModel(cfg)`` on ``device`` (``cuda`` unless asked for the
  CPU).  ``seed`` seeds the initial parameters and the generator of every
  random draw of training."""

  def __init__(self, cfg: FullModelConfig, device=None, seed=0):
    self.cfg = cfg
    self.model = FullModel(cfg, seed=seed, device=device)
    self.device = self.model.device
    self.opt_state = ts.init_opt_state(self.model)
    self.step = 0
    self.generator = torch.Generator(device=self.device).manual_seed(seed)

  def restore(self, folder):
    """Load the latest ``ckpt-*.npz`` of a JAX results folder: parameters,
    Adam state and step.  Returns the checkpoint's path."""
    path = saver.latest_checkpoint(folder)
    state = convert.params_from_checkpoint(path, self.cfg)
    self.model.load_state_dict(state)
    self.opt_state = convert.opt_state_from_checkpoint(path, self.cfg,
                                                       self.device)
    self.step = saver.checkpoint_step(path)
    return path

  def run(self, num_steps, batches):
    """Take ``num_steps`` steps, one batch of the iterator ``batches``
    each (dicts 'x', 'y_gt', 's_gt', float or uint8, on any device).

    Returns the list of per-step metrics ({name: float}, with 'step').
    Stops early, as the JAX loop does, at a non-finite loss."""
    history = []
    for _ in range(num_steps):
      batch = {k: v.to(self.device) for k, v in next(batches).items()}
      draws = draw_train_randoms(self.cfg, batch['x'].shape[0],
                                 self.generator)
      self.opt_state, metrics = ts.train_step(
          self.model, self.opt_state, batch, draws, self.step)
      self.step += 1
      values = torch.stack(list(metrics.values())).tolist()
      history.append({'step': self.step, **dict(zip(metrics, values))})
      if not math.isfinite(history[-1]['loss']):
        break
    return history
