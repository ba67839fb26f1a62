"""What the train step, the trainer and the checkpoint reader need to know
of each model.

Each model module states its model's facts in its ``FAMILY``; ``family``
maps a config to that module's ``FAMILY``, so that ``train_step``,
``engine/trainer`` and ``convert`` hold no case for each model.
"""

from __future__ import annotations

import importlib
from typing import Callable, NamedTuple

from rec_attend_tpu_torch.config import BoxModelConfig
from rec_attend_tpu_torch.config import FGModelConfig
from rec_attend_tpu_torch.config import FullModelConfig


class Family(NamedTuple):
  model: type             # (cfg, seed=, device=) -> the nn.Module
  loss: Callable          # (model, batch, draws, step, glimpse) -> (loss, aux)
  draws: Callable         # (cfg, batch size, generator) -> one step's draws
  batch_keys: tuple       # the batch keys the loss reads
  metric_keys: Callable   # cfg -> the metrics a train step returns
  frozen_nets: Callable   # cfg -> names of the nets a step does not update
  optimizer: Callable     # cfg -> 'adam' or 'momentum'


_MODULES = {FullModelConfig: 'full_model', BoxModelConfig: 'box_model',
            FGModelConfig: 'fg_model'}


def family(cfg) -> Family:
  """The ``Family`` of the model of ``cfg``."""
  name = _MODULES.get(type(cfg))
  if name is None:
    raise TypeError(f'no model for a {type(cfg).__name__}')
  return importlib.import_module(f'rec_attend_tpu_torch.models.{name}').FAMILY
