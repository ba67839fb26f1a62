"""One optimisation step of the full, box or fg model, and one eval step.

Counterpart of ``rec_attend_tpu/parallel/train_step.py:28-157``
(``encode_batch``, ``make_train_step`` without a mesh and
``make_eval_step``).  The train step: decode the batch, run the model's
loss and its gradients, clip each gradient element to +-``clip_gradient``
where the config has one (``optax.clip``: per element, not by norm; the fg
config has none, and its gradients are not clipped), take the optimizer's
step with the staircase learning rate evaluated at the optimizer's update
count (starting at 0, as optax's schedule is), leave the frozen parameters
as they were, and write the forward's new BatchNorm EMA statistics back.

The optimizer state is a dict: 'count' (updates taken) and, under the
parameters' names, for Adam (``optimizer='adam'``, eps 1e-7) 'mu' and 'nu',
its first and second moments, and for momentum (``optimizer='momentum'``,
``optax.sgd(momentum=0.9)``) 'trace'.  The arithmetic is optax's:
Adam's update is mu/(1 - b1^n) / (sqrt(nu/(1 - b2^n)) + eps); momentum's
trace <- g + 0.9 trace, update = -lr(count) trace.

The eval step is the model's loss in eval mode (no crop, BatchNorm on its
EMA statistics, no knob; the box model still degrades the ground truth it
paints into its canvas with its draws' noise) at step 0, and returns its
metrics without the outputs or the matches.
"""

from __future__ import annotations

import numpy as np
import torch

from rec_attend_tpu_torch.models.family import family
from rec_attend_tpu_torch.models.full_model import learn_rate

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7
MOMENTUM = 0.9
# Batch arrays sent to the device as uint8 (images and binary or PNG-born
# maps round-trip exactly; JAX train_step.py:28).
QUANTIZED_KEYS = ('x', 'y_gt', 'c_gt', 'd_gt', 'y_in', 'd_in')


def encode_batch(batch):
  """The float arrays in [0, 1] of a host batch under ``QUANTIZED_KEYS``
  as uint8, round(v * 255); other entries as they are."""
  out = {}
  for k, v in batch.items():
    if k in QUANTIZED_KEYS and np.issubdtype(np.asarray(v).dtype,
                                             np.floating):
      out[k] = np.round(np.asarray(v) * 255.0).astype(np.uint8)
    else:
      out[k] = v
  return out


def decode_batch(batch):
  """uint8 arrays -> float32 / 255; float inputs pass through.  Every key
  is carried, the packed maps 'd_in' and 'y_in' included."""
  return {k: (v.float() / 255.0 if v.dtype == torch.uint8 else v)
          for k, v in batch.items()}


def optimizer_of(cfg):
  """'adam' or 'momentum', as the model's family reads the config."""
  opt = family(cfg).optimizer(cfg)
  if opt not in ('adam', 'momentum'):
    raise ValueError(f'Unknown optimizer: {opt}')
  return opt


def init_opt_state(model):
  """The state of a fresh optimizer: count 0, zero moments or trace."""
  params = dict(model.named_parameters())
  keys = (('trace',) if optimizer_of(model.cfg) == 'momentum'
          else ('mu', 'nu'))
  return {'count': 0, **{key: {k: torch.zeros_like(p)
                               for k, p in params.items()} for key in keys}}


def freeze_mask(model):
  """{parameter name: True if it is not updated}: the parameters of the
  nets that the model's family freezes (the full model's freeze_* flags;
  the fg and box models freeze nothing)."""
  frozen = family(model.cfg).frozen_nets(model.cfg)
  return {k: k.split('.')[0] in frozen for k, _ in model.named_parameters()}


def loss_and_grads(model, batch, draws, step, glimpse='kernel'):
  """(loss, aux, {parameter name: gradient}) of one batch, by the loss of
  the model's family: aux holds the metrics, 'outputs' and 'new_bn'."""
  model.zero_grad(set_to_none=True)
  loss, aux = family(model.cfg).loss(model, decode_batch(batch), draws, step,
                                     glimpse)
  loss.backward()
  grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
           for k, p in model.named_parameters()}
  model.zero_grad(set_to_none=True)
  return loss, aux, grads


def _adam_updates(opt_state, names, gs, count):
  mus = [opt_state['mu'][k] for k in names]
  nus = [opt_state['nu'][k] for k in names]
  torch._foreach_mul_(mus, ADAM_B1)
  torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - ADAM_B1))
  torch._foreach_mul_(nus, ADAM_B2)
  torch._foreach_add_(nus, torch._foreach_mul(
      torch._foreach_mul(gs, gs), 1 - ADAM_B2))
  bc1 = 1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** count
  bc2 = 1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** count
  denom = torch._foreach_add(torch._foreach_sqrt(
      torch._foreach_div(nus, float(bc2))), ADAM_EPS)
  return torch._foreach_div(torch._foreach_div(mus, float(bc1)), denom)


def _momentum_updates(opt_state, names, gs):
  traces = [opt_state['trace'][k] for k in names]
  torch._foreach_mul_(traces, MOMENTUM)
  torch._foreach_add_(traces, gs)
  return traces


@torch.no_grad()
def apply_updates(model, opt_state, grads, new_bn):
  """Clip where the config clips, take the optimizer's step in place on
  the model's parameters, write the BatchNorm EMA back; returns the new
  optimizer state (its moments or trace are updated in place)."""
  cfg = model.cfg
  names = [k for k, _ in model.named_parameters()]
  params = dict(model.named_parameters())
  lr = learn_rate(cfg, opt_state['count'])
  count = opt_state['count'] + 1
  clip = getattr(cfg, 'clip_gradient', None)
  gs = [grads[k] if clip is None else torch.clamp(grads[k], -clip, clip)
        for k in names]
  if optimizer_of(cfg) == 'momentum':
    updates = _momentum_updates(opt_state, names, gs)
  else:
    updates = _adam_updates(opt_state, names, gs, count)
  frozen = freeze_mask(model)
  live = [i for i, k in enumerate(names) if not frozen[k]]
  torch._foreach_add_([params[names[i]] for i in live],
                      torch._foreach_mul([updates[i] for i in live], -lr))
  buffers = dict(model.named_buffers())
  for k, v in new_bn.items():
    buffers[k].copy_(v)
  return {**opt_state, 'count': count}


def train_step(model, opt_state, batch, draws, step, glimpse='kernel'):
  """One step: returns (new optimizer state, {metric: 0-d tensor}).

  batch: the model's batch (float, or uint8 as ``encode_batch`` leaves
  it) on the model's device: the full and box models' 'x', 'y_gt', 's_gt'
  and, where the config reads them, the packed maps 'd_in' and 'y_in'; the
  fg model's 'x', 'c_gt' and 'd_gt'.  draws: the model's draws (its
  family's ``draws``); step: the global step (for the knob schedule and the
  reported learning rate)."""
  _, aux, grads = loss_and_grads(model, batch, draws, step, glimpse)
  opt_state = apply_updates(model, opt_state, grads, aux['new_bn'])
  return opt_state, {k: aux[k].detach()
                     for k in family(model.cfg).metric_keys(model.cfg)}


@torch.no_grad()
def eval_step(model, batch, draws, glimpse='kernel'):
  """The loss of ``batch`` in eval mode: returns {metric: 0-d tensor},
  the metrics of a train step (``metric_keys``) with the learning rate at
  step 0.  batch and glimpse as in ``train_step``; draws: the model's
  draws (only the box model reads them, its canvas noise; the others take
  None)."""
  fam = family(model.cfg)
  _, aux = fam.loss(model, decode_batch(batch), draws, 0, glimpse,
                    train=False)
  return {k: aux[k] for k in fam.metric_keys(model.cfg)}
