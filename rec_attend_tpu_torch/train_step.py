"""One optimisation step of the full model.

Counterpart of ``rec_attend_tpu/parallel/train_step.py:28-130``
(``make_train_step`` without a mesh): decode the batch, run the loss and
its gradients, clip each gradient element to +-``clip_gradient``
(``optax.clip``: per element, not by norm), take an Adam step (eps 1e-7, the
staircase learning rate evaluated at the optimizer's update count, starting
at 0, as optax's schedule is), leave the frozen subnets' parameters as they
were, and write the forward's new BatchNorm EMA statistics back.

The optimizer state is a dict: 'count' (updates taken) and per trainable
parameter 'mu' and 'nu', Adam's first and second moments, under the
parameters' names.  The arithmetic is optax's ``scale_by_adam``:
mu/(1 - b1^n) / (sqrt(nu/(1 - b2^n)) + eps).
"""

from __future__ import annotations

import torch

from rec_attend_tpu_torch.models.full_model import full_model_loss
from rec_attend_tpu_torch.models.full_model import learn_rate

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7
METRIC_KEYS = ('loss', 'box_loss', 'segm_loss', 'conf_loss', 'wd_loss',
               'iou_soft', 'iou_soft_box', 'iou_hard', 'dice', 'wt_cov_soft',
               'unwt_cov_soft', 'wt_cov_hard', 'unwt_cov_hard', 'count_acc',
               'dic', 'dic_abs', 'learn_rate')


def decode_batch(batch):
  """uint8 arrays -> float32 / 255; float inputs pass through."""
  return {k: (v.float() / 255.0 if v.dtype == torch.uint8 else v)
          for k, v in batch.items()}


def init_opt_state(model):
  """Adam state of a fresh optimizer: count 0, zero moments."""
  params = dict(model.named_parameters())
  return {'count': 0,
          'mu': {k: torch.zeros_like(p) for k, p in params.items()},
          'nu': {k: torch.zeros_like(p) for k, p in params.items()}}


def freeze_mask(model):
  """{parameter name: True if it is not updated} from the freeze_* flags."""
  cfg = model.cfg
  frozen = {'ctrl_cnn': cfg.freeze_ctrl_cnn, 'ctrl_lstm': cfg.freeze_ctrl_rnn,
            'glimpse_mlp': cfg.freeze_ctrl_rnn,
            'ctrl_mlp': cfg.freeze_ctrl_mlp,
            'attn_cnn': cfg.freeze_attn_net, 'attn_dcnn': cfg.freeze_attn_net,
            'score_mlp': False}
  return {k: frozen[k.split('.')[0]] for k, _ in model.named_parameters()}


def loss_and_grads(model, batch, draws, step, glimpse='kernel'):
  """(loss, aux, {parameter name: gradient}) of one batch."""
  model.zero_grad(set_to_none=True)
  loss, aux = full_model_loss(model, decode_batch(batch), draws, step,
                              glimpse)
  loss.backward()
  grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
           for k, p in model.named_parameters()}
  model.zero_grad(set_to_none=True)
  return loss, aux, grads


@torch.no_grad()
def apply_updates(model, opt_state, grads, new_bn):
  """Clip, take the Adam step in place on the model's parameters, write the
  BatchNorm EMA back; returns the new optimizer state (the moments are
  updated in place)."""
  cfg = model.cfg
  names = [k for k, _ in model.named_parameters()]
  params = dict(model.named_parameters())
  lr = learn_rate(cfg, opt_state['count'])
  count = opt_state['count'] + 1
  gs = [torch.clamp(grads[k], -cfg.clip_gradient, cfg.clip_gradient)
        for k in names]
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
  updates = torch._foreach_div(torch._foreach_div(mus, float(bc1)), denom)
  frozen = freeze_mask(model)
  live = [i for i, k in enumerate(names) if not frozen[k]]
  torch._foreach_add_([params[names[i]] for i in live],
                      torch._foreach_mul([updates[i] for i in live], -lr))
  buffers = dict(model.named_buffers())
  for k, v in new_bn.items():
    buffers[k].copy_(v)
  return {'count': count, 'mu': opt_state['mu'], 'nu': opt_state['nu']}


def train_step(model, opt_state, batch, draws, step, glimpse='kernel'):
  """One step: returns (new optimizer state, {metric: 0-d tensor}).

  batch: 'x', 'y_gt' (float, or uint8 as ``encode_batch`` leaves them) and
  's_gt' on the model's device; draws: ``draw_train_randoms``; step: the
  global step (for the knob schedule)."""
  _, aux, grads = loss_and_grads(model, batch, draws, step, glimpse)
  opt_state = apply_updates(model, opt_state, grads, aux['new_bn'])
  return opt_state, {k: aux[k].detach() for k in METRIC_KEYS}
