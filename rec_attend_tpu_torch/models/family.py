"""What the train step, the trainer, the experiment and the checkpoint
reader need to know of each model.

Each model module states its model's facts in its ``FAMILY``; ``family``
maps a config to that module's ``FAMILY`` and ``get_model_spec`` the JAX
package's spec name ('full', 'box', 'fg'; ``rec_attend_tpu/engine/
experiment.py:58-100``) to it, so that ``train_step``, ``engine`` and
``convert`` hold no case for each model.
"""

from __future__ import annotations

import importlib
from typing import Callable, NamedTuple, Optional

from rec_attend_tpu_torch.config import BoxModelConfig
from rec_attend_tpu_torch.config import FGModelConfig
from rec_attend_tpu_torch.config import FullModelConfig


class Family(NamedTuple):
  name: str               # the spec name: 'full', 'box' or 'fg'
  model: type             # (cfg, seed=, device=) -> the nn.Module
  loss: Callable          # (model, batch, draws, step, glimpse, train=)
                          #   -> (loss, aux)
  draws: Callable         # (cfg, batch size, generator) -> one step's draws
  batch_keys: tuple       # the batch keys the loss reads
  metric_keys: Callable   # cfg -> the metrics a train or eval step returns
  frozen_nets: Callable   # cfg -> names of the nets a step does not update
  optimizer: Callable     # cfg -> 'adam' or 'momentum'
  batch_variables: tuple  # the dataset variables a batch is made of
  batch_map: dict         # dataset variable -> batch key
  eval_metrics: tuple     # the metrics the eval passes log
  # (model, cfg) -> None: starts the model's nets from the config's
  # pretrained weights.h5 files, in place; None where the model reads none
  load_pretrained: Optional[Callable] = None


_MODULES = {FullModelConfig: 'full_model', BoxModelConfig: 'box_model',
            FGModelConfig: 'fg_model'}
_SPECS = {'full': 'full_model', 'box': 'box_model', 'fg': 'fg_model'}


def _module_family(name):
  return importlib.import_module(f'rec_attend_tpu_torch.models.{name}').FAMILY


def family(cfg) -> Family:
  """The ``Family`` of the model of ``cfg``."""
  name = _MODULES.get(type(cfg))
  if name is None:
    raise TypeError(f'no model for a {type(cfg).__name__}')
  return _module_family(name)


def get_model_spec(name) -> Family:
  """The ``Family`` of the JAX spec ``name``: 'full', 'box' or 'fg'."""
  if name not in _SPECS:
    raise ValueError(f'Unknown model spec: {name}')
  return _module_family(_SPECS[name])
