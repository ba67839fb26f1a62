"""Carry the JAX package's parameters into this package's modules.

The JAX model keeps its parameters as a nested tree of dicts and lists of
arrays (``rec_attend_tpu/nn/params.py`` names them for ``weights.h5``);
``FullModel`` and ``FGModel`` register the same leaves under dotted names,
so a leaf at ``tree['ctrl_cnn'][0]['bn']['beta']`` is ``ctrl_cnn.0.bn.beta``
here.  The JAX tree holds the BatchNorm EMA statistics among the
parameters; here they are buffers, so the Adam state keeps moments for the
trainable parameters only (the JAX moments of the EMA leaves stay zero:
their gradient is 0).
"""

from __future__ import annotations

import numpy as np
import torch

from rec_attend_tpu_torch.config import FGModelConfig
from rec_attend_tpu_torch.config import FullModelConfig
from rec_attend_tpu_torch.engine import saver


def flatten_tree(tree, prefix=''):
  """{dotted name: leaf} of a nested dict/list tree."""
  if isinstance(tree, dict):
    items = tree.items()
  elif isinstance(tree, (list, tuple)):
    items = enumerate(tree)
  else:
    return {prefix: tree}
  out = {}
  for k, v in items:
    out.update(flatten_tree(v, f'{prefix}.{k}' if prefix else str(k)))
  return out


def params_from_jax(tree):
  """State dict of ``FullModel`` or ``FGModel`` from a JAX parameter tree
  of arrays."""
  return {name: torch.from_numpy(np.array(leaf, dtype=np.float32))
          for name, leaf in flatten_tree(tree).items()}


def model_class(cfg):
  """``FGModel`` for an ``FGModelConfig``, ``FullModel`` for a
  ``FullModelConfig``."""
  if isinstance(cfg, FGModelConfig):
    from rec_attend_tpu_torch.models.fg_model import FGModel
    return FGModel
  if isinstance(cfg, FullModelConfig):
    from rec_attend_tpu_torch.models.full_model import FullModel
    return FullModel
  raise TypeError(f'no model for a {type(cfg).__name__}')


def param_shapes(cfg):
  """{dotted name: shape} of the model of ``cfg`` (``model_class``),
  without allocating it."""
  model = model_class(cfg)(cfg, device='meta')
  return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def params_from_checkpoint(path, cfg):
  """State dict of the model of ``cfg`` read from a JAX ``ckpt-*.npz``:
  its parameters are the checkpoint's last leaves, whatever optimizer
  state comes before them (``saver.load_params``)."""
  return {name: torch.from_numpy(leaf)
          for name, leaf in saver.load_params(path, param_shapes(cfg)).items()}


def _trainable(cfg, state):
  """The entries of a {name: value} dict that are trainable parameters of
  ``FullModel(cfg)``."""
  from rec_attend_tpu_torch.models.full_model import FullModel
  names = {k for k, _ in FullModel(cfg, device='meta').named_parameters()}
  return {k: v for k, v in state.items() if k in names}


def _adam_to_torch(cfg, count, mu, nu, device):
  def tensors(tree):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in _trainable(cfg, tree).items()}
  return {'count': int(count), 'mu': tensors(mu), 'nu': tensors(nu)}


def opt_state_from_checkpoint(path, cfg: FullModelConfig, device='cpu'):
  """The port's optimizer state (``train_step.init_opt_state`` form) read
  from a JAX ``ckpt-*.npz`` of the full model."""
  adam = saver.load_adam_state(path, param_shapes(cfg))
  return _adam_to_torch(cfg, adam['count'], adam['mu'], adam['nu'], device)


def opt_state_from_jax(opt_state, cfg: FullModelConfig, device='cpu'):
  """The port's optimizer state from the JAX trainer's ``opt_state`` of
  ``optax.chain(clip, adam(schedule))``: the Adam state is the one element
  with ``mu`` and ``nu``."""
  def find(node):
    if hasattr(node, 'mu') and hasattr(node, 'nu'):
      return node
    if isinstance(node, (list, tuple)):
      for child in node:
        hit = find(child)
        if hit is not None:
          return hit
    return None
  adam = find(opt_state)
  if adam is None:
    raise ValueError('no Adam state (mu, nu) in opt_state')
  return _adam_to_torch(cfg, np.asarray(adam.count), flatten_tree(adam.mu),
                        flatten_tree(adam.nu), device)
