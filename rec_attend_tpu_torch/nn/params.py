"""Named weights in the ``weights.h5`` schema: export, load and merge.

Counterpart of ``rec_attend_tpu/nn/params.py``, on the port's own HDF5
codec (``utils/h5.py``: the card's machine has no h5py).  The keys
(``:25-56``):

  {net}_w_{i}, {net}_b_{i}                   a layer's weight and bias
  {net}_{i}_{t}_{beta|gamma|ema_mean|ema_var}  BatchNorm copy t of layer i
                                             (a single copy is copy 0)
  {net}_{w_xi|w_hi|b_i|...}                  the LSTM's 12 matrices

A net in tree form is what JAX keeps under ``params[net]``: a list of
layer dicts {'w', 'b', 'bn': {'beta', 'gamma', 'ema_mean', 'ema_var'}} of
float32 numpy arrays, the BatchNorm copies stacked to [T, C] (a single copy
[C]), or the LSTM's flat dict.  ``net_from_state`` and ``net_to_state``
map that form to and from the port's state-dict names (``ctrl_cnn.0.w``,
``ctrl_cnn.0.bn.beta``, ``ctrl_lstm.w_xi``: ``convert``'s names of the JAX
tree), and ``h5_arrays`` to the file's keys: the one place where the keys
meet the port's names.

    export_weights_h5(box_model, ('ctrl_cnn', 'ctrl_lstm'), 'weights.h5')
    layers = load_net_h5('weights.h5', 'ctrl_cnn', cnn_prefix_sniff=True)
    load_nets(full_model, [('ctrl_cnn', layers, cfg.timespan)])
"""

from __future__ import annotations

import numpy as np
import torch

from rec_attend_tpu_torch.utils import h5

LSTM_KEYS = ('w_xi', 'w_hi', 'b_i', 'w_xf', 'w_hf', 'b_f', 'w_xu', 'w_hu',
             'b_u', 'w_xo', 'w_ho', 'b_o')
BN_KEYS = ('beta', 'gamma', 'ema_mean', 'ema_var')


def _numpy(v):
  if torch.is_tensor(v):
    return v.detach().cpu().numpy()
  return np.asarray(v)


def _is_lstm(net):
  return net.endswith('lstm')


# ---- tree form <-> state dict <-> file keys ---------------------------

def net_from_state(state, net):
  """The net ``net`` of a state dict ({dotted name: tensor or array}) in
  tree form, or None where the state has no such net."""
  prefix = net + '.'
  items = {k[len(prefix):]: _numpy(v) for k, v in state.items()
           if k.startswith(prefix)}
  if not items:
    return None
  if _is_lstm(net):
    return items
  layers = {}
  for k, v in items.items():
    i, _, key = k.partition('.')
    layer = layers.setdefault(int(i), {})
    if key.startswith('bn.'):
      layer.setdefault('bn', {})[key[3:]] = v
    else:
      layer[key] = v
  return [layers[i] for i in range(len(layers))]


def net_to_state(net, value):
  """{dotted name: array} of the net ``net`` in tree form."""
  if isinstance(value, dict):
    return {f'{net}.{k}': v for k, v in value.items()}
  out = {}
  for i, layer in enumerate(value):
    for key, v in layer.items():
      if key == 'bn':
        out.update({f'{net}.{i}.bn.{k}': bv for k, bv in v.items()})
      else:
        out[f'{net}.{i}.{key}'] = v
  return out


def h5_arrays(net, value):
  """The file's {key: array} of the net ``net`` in tree form (JAX
  ``_export_layer_list``, ``:25-44``)."""
  if isinstance(value, dict):
    return {f'{net}_{k}': _numpy(v) for k, v in value.items()}
  out = {}
  for i, layer in enumerate(value):
    out[f'{net}_w_{i}'] = _numpy(layer['w'])
    if 'b' in layer:
      out[f'{net}_b_{i}'] = _numpy(layer['b'])
    if 'bn' in layer:
      bn = {k: _numpy(layer['bn'][k]) for k in BN_KEYS}
      if bn['beta'].ndim == 1:     # a single copy is written as copy 0
        bn = {k: v[None] for k, v in bn.items()}
      for t in range(bn['beta'].shape[0]):
        for k in BN_KEYS:
          out[f'{net}_{i}_{t}_{k}'] = bn[k][t]
  return out


# ---- the file ------------------------------------------------------------

def export_weights_h5(model_or_state, nets, path):
  """Write the nets ``nets`` of a model (or its state dict) that it has to
  a ``weights.h5`` at ``path`` (JAX ``export_weights_h5`` of
  ``{n: params[n] for n in nets if n in params}``).  Returns the path."""
  state = (model_or_state.state_dict()
           if isinstance(model_or_state, torch.nn.Module)
           else model_or_state)
  arrays = {}
  for net in nets:
    value = net_from_state(state, net)
    if value is not None:
      arrays.update(h5_arrays(net, value))
  return h5.write(path, arrays)


def _count(f, key_of):
  n = 0
  while key_of(n) in f:
    n += 1
  return n


def load_net_h5(path, net, cnn_prefix_sniff=False):
  """One net of a ``weights.h5`` in tree form, or None where the file lacks
  it (JAX ``load_net_h5``, ``:73-128``).  The BatchNorm copies are stacked
  to [T, C] (one copy: [C]); a file without the EMA statistics gives zero
  means and unit variances.  Arrays are float32, as ``jnp.asarray`` makes
  them.  With ``cnn_prefix_sniff`` the CNN's keys are looked for under
  ``attn_cnn``, then ``cnn``, then ``ctrl_cnn`` (the first that the file
  has)."""
  def f32(a):
    return np.asarray(a, dtype=np.float32)
  with h5.File(path) as f:
    if cnn_prefix_sniff:
      for prefix in ('attn_', '', 'ctrl_'):
        if f'{prefix}cnn_w_0' in f:
          net = f'{prefix}cnn'
          break
    if _is_lstm(net):
      if f'{net}_{LSTM_KEYS[0]}' not in f:
        return None
      return {k: f32(f[f'{net}_{k}']) for k in LSTM_KEYS}
    layers = []
    for i in range(_count(f, lambda n: f'{net}_w_{n}')):
      layer = {'w': f32(f[f'{net}_w_{i}'])}
      if f'{net}_b_{i}' in f:
        layer['b'] = f32(f[f'{net}_b_{i}'])
      copies = _count(f, lambda t: f'{net}_{i}_{t}_beta')
      if copies:
        keys = BN_KEYS if f'{net}_{i}_0_ema_mean' in f else BN_KEYS[:2]
        bn = {k: np.stack([f32(f[f'{net}_{i}_{t}_{k}'])
                           for t in range(copies)]) for k in keys}
        if 'ema_mean' not in bn:   # files of beta and gamma only
          bn['ema_mean'] = np.zeros_like(bn['beta'])
          bn['ema_var'] = np.ones_like(bn['gamma'])
        if copies == 1:
          bn = {k: v[0] for k, v in bn.items()}
        layer['bn'] = bn
      layers.append(layer)
    return layers or None


# ---- merging into a model ------------------------------------------------

def merge_pretrained(init_layers, loaded_layers, timespan=None):
  """Loaded layers laid over a net's initial ones, both in tree form (JAX
  ``merge_pretrained``, ``:131-153``): a net that is None leaves the
  initial one; the loaded layers replace their counterparts and the
  initial tail layers stay; a layer's BatchNorm that the loaded one lacks
  stays, and one held with another number of copies, given ``timespan``,
  is its last copy broadcast over the initial copies.  A leaf that the
  initial layer lacks, or whose shape then differs from it, raises."""
  if loaded_layers is None:
    return init_layers
  out = []
  for i, init in enumerate(init_layers):
    if i >= len(loaded_layers):
      out.append(init)
      continue
    layer = dict(loaded_layers[i])
    if 'bn' in init and 'bn' in layer:
      want = np.shape(init['bn']['beta'])
      if (np.shape(layer['bn']['beta']) != want and timespan is not None
          and len(want) == 2):
        layer['bn'] = {k: np.array(np.broadcast_to(
            v[-1] if v.ndim == 2 else v, want))
                       for k, v in layer['bn'].items()}
    elif 'bn' in init:
      layer['bn'] = init['bn']
    for key in init:
      layer.setdefault(key, init[key])
    want, got = net_to_state('', [init]), net_to_state('', [layer])
    for k, v in got.items():
      if k not in want:
        raise ValueError(f'layer {i} {k[3:]}: the model has no such '
                         'parameter')
      if np.shape(v) != np.shape(want[k]):
        raise ValueError(f'layer {i} {k[3:]}: pretrained shape '
                         f'{np.shape(v)}, the model takes '
                         f'{np.shape(want[k])}')
    out.append(layer)
  return out


def load_nets(model, nets):
  """Lay nets over the parameters of ``model``, in place: ``nets`` is a
  list of (net, loaded, timespan), ``loaded`` in tree form or None (the
  net stays).  A layer list merges by ``merge_pretrained``; the LSTM is
  taken whole."""
  state = model.state_dict()
  for net, loaded, timespan in nets:
    if loaded is None:
      continue
    if _is_lstm(net):
      new = net_to_state(net, loaded)
      if set(new) != {k for k in state if k.startswith(net + '.')}:
        raise ValueError(f'{net}: pretrained leaves {sorted(new)}')
    else:
      new = net_to_state(net, merge_pretrained(net_from_state(state, net),
                                               loaded, timespan))
    with torch.no_grad():
      for k, v in new.items():
        if tuple(np.shape(v)) != tuple(state[k].shape):
          raise ValueError(f'{k}: pretrained shape {np.shape(v)}, the '
                           f'model takes {tuple(state[k].shape)}')
        state[k].copy_(torch.as_tensor(np.asarray(v, np.float32)))
  return model
