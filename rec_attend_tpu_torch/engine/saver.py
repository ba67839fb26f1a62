"""Read the JAX trainer's checkpoints without JAX.

Counterpart of the loading half of ``rec_attend_tpu/engine/saver.py:31-46``.
A checkpoint ``ckpt-<step>.npz`` stores ``num_leaves`` and the leaves
``leaf_<i>`` of a pytree in ``jax.tree_util`` flatten order: dict keys
sorted, lists in order.  The trainer saves ``{'params', 'opt_state'}``, so
the optimizer state comes first and the parameters are the last leaves; a
params-only checkpoint holds just them.  The full model's optimizer,
``optax.chain(clip, adam(schedule))``, flattens to Adam's update count, its
first moments (one leaf per parameter, in parameter order), its second
moments, and the schedule's count: 2 + 3 * P leaves in all.  The fg model's,
``optax.chain(clip, sgd(schedule, momentum=0.9))``, flattens to the
momentum trace (one leaf per parameter) and the schedule's count, so its
checkpoint holds 2 * P + 1 leaves, the parameters from leaf P + 1 on.
"""

from __future__ import annotations

import os
import re

import numpy as np

CKPT_RE = re.compile(r'ckpt-(\d+)\.npz$')


def checkpoint_step(path):
  """The step in a checkpoint's file name, ``ckpt-<step>.npz``."""
  return int(CKPT_RE.search(path).group(1))


def latest_checkpoint(folder):
  """Path of the highest-step ``ckpt-*.npz`` in ``folder``."""
  ckpts = []
  for name in os.listdir(folder):
    m = CKPT_RE.search(name)
    if m:
      ckpts.append((int(m.group(1)), os.path.join(folder, name)))
  if not ckpts:
    raise FileNotFoundError(f'No checkpoint in {folder}')
  return max(ckpts)[1]


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
