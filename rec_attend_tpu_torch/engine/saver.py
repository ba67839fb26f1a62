"""Checkpoints in the JAX trainer's layout: write, prune, find, read.

Counterpart of ``rec_attend_tpu/engine/saver.py:25-109``.  A results folder
holds numbered checkpoints ``ckpt-<step>.npz`` (the last ``max_to_keep``,
2, are kept) beside the ``model_opt.yaml`` and ``data_opt.yaml`` snapshots
(written and read by ``utils.opt_yaml``, the bytes PyYAML writes).  A
checkpoint stores ``num_leaves`` and the leaves ``leaf_<i>`` of a pytree in
``jax.tree_util`` flatten order: dict keys sorted, lists in order.  The
trainer saves ``{'params', 'opt_state'}``, so the optimizer state comes
first and the parameters are the last leaves; a params-only checkpoint
holds just them.  The full and box models' optimizer,
``optax.chain(clip, adam(schedule))``, flattens to Adam's update count, its
first moments (one leaf per parameter, in parameter order), its second
moments, and the schedule's count: 2 + 3 * P leaves in all.  The fg model's,
``optax.chain(clip, sgd(schedule, momentum=0.9))``, flattens to the
momentum trace (one leaf per parameter) and the schedule's count, so its
checkpoint holds 2 * P + 1 leaves, the parameters from leaf P + 1 on.
``convert.checkpoint_leaves`` makes these leaves of a model and its
optimizer state, and ``convert`` reads them back.
"""

from __future__ import annotations

import os
import re

import numpy as np

from rec_attend_tpu_torch.utils import logger
from rec_attend_tpu_torch.utils import opt_yaml

CKPT_RE = re.compile(r'ckpt-(\d+)\.npz$')


def checkpoint_step(path):
  """The step in a checkpoint's file name, ``ckpt-<step>.npz``."""
  return int(CKPT_RE.search(path).group(1))


def list_checkpoints(folder):
  """[(step, path)] of the ``ckpt-*.npz`` in ``folder``, by step."""
  out = []
  for name in os.listdir(folder):
    m = CKPT_RE.search(name)
    if m:
      out.append((int(m.group(1)), os.path.join(folder, name)))
  return sorted(out)


def latest_checkpoint(folder):
  """Path of the highest-step ``ckpt-*.npz`` in ``folder``."""
  ckpts = list_checkpoints(folder)
  if not ckpts:
    raise FileNotFoundError(f'No checkpoint in {folder}')
  return ckpts[-1][1]


def _tree_key(name):
  # List indices sort as numbers, dict keys as strings; siblings are all of
  # one kind, so the tuples never compare an int with a str.
  return tuple(int(p) if p.isdigit() else p for p in name.split('.'))


def jax_leaf_order(names):
  """Dotted parameter names (``ctrl_cnn.0.bn.beta``) in the order
  ``jax.tree_util.tree_flatten`` visits the corresponding nested tree."""
  return sorted(names, key=_tree_key)


def load_params(path, shapes):
  """Read the parameters of checkpoint ``path``.

  Args:
    shapes: {dotted name: shape} of the parameter tree to read.
  Returns:
    {dotted name: np.ndarray}.
  Raises ValueError if the file has fewer leaves than the tree or if any
  leaf's shape differs from the tree's.
  """
  names = jax_leaf_order(shapes)
  with np.load(path) as data:
    n = int(data['num_leaves'])
    if n < len(names):
      raise ValueError(f'{path} has {n} leaves; the model has {len(names)} '
                       'parameters')
    first = n - len(names)
    out = {}
    for i, name in enumerate(names):
      leaf = data[f'leaf_{first + i}']
      if tuple(leaf.shape) != tuple(shapes[name]):
        raise ValueError(f'{path}: leaf {first + i} for {name} has shape '
                         f'{leaf.shape}, the model wants '
                         f'{tuple(shapes[name])}')
      out[name] = leaf
  return out


def load_adam_state(path, shapes):
  """Read the Adam state of a full-model checkpoint.

  Args:
    shapes: {dotted name: shape} of the parameter tree.
  Returns:
    {'count': int, 'mu': {name: array}, 'nu': {name: array}}.
  Raises ValueError unless the file holds exactly the leaves of
  ``{'opt_state', 'params'}`` for this tree, with equal Adam and schedule
  counts.
  """
  names = jax_leaf_order(shapes)
  p = len(names)
  with np.load(path) as data:
    n = int(data['num_leaves'])
    if n != 2 + 3 * p:
      raise ValueError(f'{path} has {n} leaves; Adam state and parameters '
                       f'of this model make {2 + 3 * p}')
    count, sched_count = int(data['leaf_0']), int(data[f'leaf_{1 + 2 * p}'])
    if count != sched_count:
      raise ValueError(f'{path}: Adam count {count}, schedule count '
                       f'{sched_count}')
    out = {'count': count, 'mu': {}, 'nu': {}}
    for m, key in enumerate(('mu', 'nu')):
      for i, name in enumerate(names):
        leaf = data[f'leaf_{1 + m * p + i}']
        if tuple(leaf.shape) != tuple(shapes[name]):
          raise ValueError(f'{path}: {key} leaf for {name} has shape '
                           f'{leaf.shape}, the model wants '
                           f'{tuple(shapes[name])}')
        out[key][name] = leaf
  return out


def load_momentum_state(path, shapes):
  """Read the momentum state of an fg-model checkpoint
  (``optax.chain(identity, sgd(schedule, momentum=0.9))``).

  Args:
    shapes: {dotted name: shape} of the parameter tree.
  Returns:
    {'count': int, 'trace': {name: array}}: the schedule's update count and
    the momentum trace.
  Raises ValueError unless the file holds exactly the 2 * P + 1 leaves of
  ``{'opt_state', 'params'}`` for this tree: the trace, the count, then the
  parameters.
  """
  names = jax_leaf_order(shapes)
  p = len(names)
  with np.load(path) as data:
    n = int(data['num_leaves'])
    if n != 2 * p + 1:
      raise ValueError(f'{path} has {n} leaves; momentum state and '
                       f'parameters of this model make {2 * p + 1}')
    out = {'count': int(data[f'leaf_{p}']), 'trace': {}}
    for i, name in enumerate(names):
      leaf = data[f'leaf_{i}']
      if tuple(leaf.shape) != tuple(shapes[name]):
        raise ValueError(f'{path}: trace leaf for {name} has shape '
                         f'{leaf.shape}, the model wants '
                         f'{tuple(shapes[name])}')
      out['trace'][name] = leaf
  return out


def save_pytree(path, leaves):
  """Write ``leaves`` (arrays in ``jax.tree_util`` flatten order) as the
  JAX ``save_pytree`` does."""
  np.savez(path, num_leaves=len(leaves),
           **{f'leaf_{i}': np.asarray(leaf) for i, leaf in enumerate(leaves)})


class Saver:
  """The checkpoints of one results folder (JAX ``Saver``): the option
  snapshots are written when given, ``save`` writes ``ckpt-<step>.npz``
  and keeps the last ``max_to_keep``."""

  def __init__(self, folder, model_opt=None, data_opt=None, max_to_keep=2):
    self.folder = folder
    self.log = logger.get()
    self.max_to_keep = max_to_keep
    os.makedirs(folder, exist_ok=True)
    if model_opt is not None:
      self.save_opt_dict('model_opt.yaml', model_opt)
    if data_opt is not None:
      self.save_opt_dict('data_opt.yaml', data_opt)

  def save_opt_dict(self, name, opt):
    if hasattr(opt, 'to_dict'):
      opt = opt.to_dict()
    opt_yaml.write(os.path.join(self.folder, name), opt)

  def load_opt_dict(self, name):
    path = os.path.join(self.folder, name)
    if not os.path.exists(path):
      return None
    return opt_yaml.read(path)

  def save(self, leaves, step):
    """Save the checkpoint of ``step`` (``convert.checkpoint_leaves``) and
    prune the old ones; returns its path."""
    path = os.path.join(self.folder, f'ckpt-{step}.npz')
    save_pytree(path, leaves)
    self.log.info(f'Saved checkpoint {path}')
    for _, old in self.list_ckpts()[:-self.max_to_keep]:
      os.remove(old)
    return path

  def list_ckpts(self):
    """[(step, path)] of the folder's checkpoints, by step."""
    return list_checkpoints(self.folder)

  def get_latest_ckpt(self):
    """(step, path) of the latest checkpoint, or None."""
    ckpts = self.list_ckpts()
    return ckpts[-1] if ckpts else None
