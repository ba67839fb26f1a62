"""The training loop of the full, box and fg models.

Counterpart of the step loop of ``TrainingExperiment.run``
(``rec_attend_tpu/engine/experiment.py:369-440``): a step counter, one
train step per batch and the step's metrics.  ``restore`` continues a JAX
trainer's run from its latest checkpoint, parameters, optimizer state
(Adam's, or the fg model's momentum trace) and step
(``experiment.py:445-449``); ``load_pretrained`` starts nets from the
config's ``weights.h5`` files (``pretrain_*``), or a full model's
controller from a box model in memory.  The
cadenced training run (validation, logs, checkpoints) that the command
line drives is ``engine.experiment.TrainingExperiment``, built on this.

    trainer = Trainer(kitti_fg_config())              # on the card
    trainer.restore('results/fg_model_synth3-20260818a')
    history = trainer.run(5, batches)                 # batches: an iterator

    box = Trainer(kitti_box_config())                 # batches with the
    box.run(5, packed_batches)                        # packed d_in, y_in
    full = Trainer(kitti_full_config())
    full.load_pretrained(box.model)
"""

from __future__ import annotations

import math

import torch

from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch import train_step as ts
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.models import full_model
from rec_attend_tpu_torch.models.family import family


class Trainer:
  """Trains the model of ``cfg`` (a ``FullModelConfig``, a
  ``BoxModelConfig`` or an ``FGModelConfig``) on ``device`` (``cuda``
  unless asked for the CPU).  ``seed`` seeds the initial parameters and
  the generator of every random draw of training."""

  def __init__(self, cfg, device=None, seed=0):
    self.cfg = cfg
    self.family = family(cfg)
    self.model = self.family.model(cfg, seed=seed, device=device)
    self.device = self.model.device
    self.opt_state = ts.init_opt_state(self.model)
    self.step = 0
    self.generator = torch.Generator(device=self.device).manual_seed(seed)

  def restore(self, folder):
    """Load the latest ``ckpt-*.npz`` of a JAX results folder: parameters,
    optimizer state and step.  Returns the checkpoint's path."""
    path = saver.latest_checkpoint(folder)
    state = convert.params_from_checkpoint(path, self.cfg)
    self.model.load_state_dict(state)
    self.opt_state = convert.opt_state_from_checkpoint(path, self.cfg,
                                                       self.device)
    self.step = saver.checkpoint_step(path)
    return path

  def load_pretrained(self, source=None):
    """Start nets of the model from pretrained ones: with no ``source``,
    from the ``weights.h5`` files that the config names (the family's
    ``load_pretrained``; the fg model reads none); a full model's
    controller from a module (a ``BoxModel``) or its state dict
    (``full_model.load_pretrained``)."""
    if source is None:
      if self.family.load_pretrained is not None:
        self.family.load_pretrained(self.model, self.cfg)
      return
    if not isinstance(self.model, full_model.FullModel):
      raise TypeError('a pretrained module starts a full model')
    full_model.load_pretrained(self.model, source)

  def draws(self, batch_size):
    """The draws of one step or eval batch, from the trainer's generator."""
    return self.family.draws(self.cfg, batch_size, self.generator)

  def train_step(self, batch):
    """One step on ``batch`` (as ``run`` reads it): returns the step's
    metrics, {name: 0-d tensor} on the device, without waiting for them."""
    batch = {k: v.to(self.device) for k, v in batch.items()
             if k in self.family.batch_keys}
    self.opt_state, metrics = ts.train_step(
        self.model, self.opt_state, batch, self.draws(batch['x'].shape[0]),
        self.step)
    self.step += 1
    return metrics

  def run(self, num_steps, batches):
    """Take ``num_steps`` steps, one batch of the iterator ``batches``
    each: dicts of tensors, float or uint8, on any device (the full and box
    models read 'x', 'y_gt', 's_gt' and the packed 'd_in' and 'y_in'
    where the config reads them, the fg model 'x', 'c_gt' and 'd_gt'; other
    keys are not read).

    Returns the list of per-step metrics ({name: float}, with 'step').
    Stops early, as the JAX loop does, at a non-finite loss."""
    history = []
    for _ in range(num_steps):
      metrics = self.train_step(next(batches))
      values = torch.stack(list(metrics.values())).tolist()
      history.append({'step': self.step, **dict(zip(metrics, values))})
      if not math.isfinite(history[-1]['loss']):
        break
    return history
