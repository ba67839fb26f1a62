"""Carry the JAX package's parameters into this package's modules.

The JAX model keeps its parameters as a nested tree of dicts and lists of
arrays (``rec_attend_tpu/nn/params.py`` names them for ``weights.h5``);
``FullModel``, ``BoxModel`` and ``FGModel`` register the same leaves under
dotted names,
so a leaf at ``tree['ctrl_cnn'][0]['bn']['beta']`` is ``ctrl_cnn.0.bn.beta``
here.  The JAX tree holds the BatchNorm EMA statistics among the
parameters; here they are buffers, so the optimizer state keeps Adam's
moments or the momentum trace for the trainable parameters only (the JAX
moments and trace of the EMA leaves stay zero: their gradient is 0).
"""

from __future__ import annotations

import numpy as np
import torch

from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.models.family import family


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
  """State dict of ``FullModel``, ``BoxModel`` or ``FGModel`` from a JAX
  parameter tree of arrays."""
  return {name: torch.from_numpy(np.array(leaf, dtype=np.float32))
          for name, leaf in flatten_tree(tree).items()}


def model_class(cfg):
  """``FGModel`` for an ``FGModelConfig``, ``BoxModel`` for a
  ``BoxModelConfig``, ``FullModel`` for a ``FullModelConfig``."""
  return family(cfg).model


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
  the model of ``cfg``."""
  names = {k for k, _ in model_class(cfg)(cfg, device='meta')
           .named_parameters()}
  return {k: v for k, v in state.items() if k in names}


def _to_torch(cfg, tree, device):
  return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
          for k, v in _trainable(cfg, tree).items()}


def opt_state_from_checkpoint(path, cfg, device='cpu'):
  """The port's optimizer state (``train_step.init_opt_state`` form) read
  from a JAX ``ckpt-*.npz`` of the model of ``cfg``, onto ``device``:
  Adam's count and moments, or, for a config with
  ``optimizer='momentum'`` (the fg presets), the schedule's count and the
  momentum trace."""
  shapes = param_shapes(cfg)
  if family(cfg).optimizer(cfg) == 'momentum':
    state = saver.load_momentum_state(path, shapes)
    return {'count': state['count'],
            'trace': _to_torch(cfg, state['trace'], device)}
  adam = saver.load_adam_state(path, shapes)
  return {'count': adam['count'], 'mu': _to_torch(cfg, adam['mu'], device),
          'nu': _to_torch(cfg, adam['nu'], device)}


def opt_state_from_jax(opt_state, cfg, device='cpu'):
  """The port's optimizer state from the JAX trainer's ``opt_state`` of
  ``optax.chain(clip or identity, adam(schedule))`` (the element with
  ``mu`` and ``nu``) or of ``optax.chain(identity, sgd(schedule,
  momentum))`` (the element with ``trace``, then the schedule's count)."""
  def find(node, fields):
    # optax states are named tuples: look at their fields (every tuple has
    # a ``count`` method).
    if all(f in getattr(node, '_fields', ()) for f in fields):
      return node
    if isinstance(node, (list, tuple)):
      for child in node:
        hit = find(child, fields)
        if hit is not None:
          return hit
    return None
  if family(cfg).optimizer(cfg) == 'momentum':
    trace = find(opt_state, ('trace',))
    sched = find(opt_state, ('count',))
    if trace is None or sched is None:
      raise ValueError('no momentum state (trace, count) in opt_state')
    return {'count': int(np.asarray(sched.count)),
            'trace': _to_torch(cfg, flatten_tree(trace.trace), device)}
  adam = find(opt_state, ('mu', 'nu'))
  if adam is None:
    raise ValueError('no Adam state (mu, nu) in opt_state')
  return {'count': int(np.asarray(adam.count)),
          'mu': _to_torch(cfg, flatten_tree(adam.mu), device),
          'nu': _to_torch(cfg, flatten_tree(adam.nu), device)}


def checkpoint_leaves(model, opt_state):
  """The leaves of the JAX trainer's ``{'opt_state', 'params'}`` for
  ``model`` and its optimizer state (``train_step.init_opt_state`` form),
  as numpy arrays in flatten order (``engine/saver.py``): with Adam the
  count (int32, shape ()), the first and the second moments of every leaf
  of the parameter tree, the schedule's count and the parameters; with
  momentum the trace, the count and the parameters.  The BatchNorm EMA
  statistics are leaves of the JAX parameter tree; their moments and trace
  are zeros there, as their gradient is 0, and are written so here."""
  state = model.state_dict()
  names = saver.jax_leaf_order(state)
  params = [state[n].detach().cpu().numpy() for n in names]
  count = np.asarray(opt_state['count'], np.int32)

  def per_leaf(key):
    return [opt_state[key][n].detach().cpu().numpy() if n in opt_state[key]
            else np.zeros_like(p) for n, p in zip(names, params)]
  if family(model.cfg).optimizer(model.cfg) == 'momentum':
    return per_leaf('trace') + [count] + params
  return [count] + per_leaf('mu') + per_leaf('nu') + [count.copy()] + params
