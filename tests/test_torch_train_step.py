"""One and two train steps of the port against the JAX package's
``make_train_step(partial(full_model_loss, matcher='native'), cfg)``.

Tiny configs (64x64, T=4), JAX ``init_full_model`` parameters with the
weights scaled by up to 11x (out of the near-constant regime of the 0.01
init, short of the steep regime where float32 noise decides the
gradients), a numpy-seeded batch of rectangle instances with an empty slot,
and JAX's own random draws: the test rebuilds them from the step's key by
the ``jax.random.split`` sequence of ``full_model.py:218-262``,
``image_ops.py:141-146`` and the scan keys, and hands them to the port.
Both sides match with the same host Hungarian solver.

Compared, with their tolerances (float32 on both sides; the conv stacks and
the contractions sum in other orders in XLA and in PyTorch):
  loss and aux metrics      rtol 1e-4, atol 1e-5
  every gradient leaf       rtol 1e-3, atol 1e-4 times the leaf's largest
                            magnitude (the gradient tolerance of the
                            kernels' ROADMAP acceptance, scaled per leaf);
                            a conv bias that a train-mode BatchNorm follows
                            has gradient 0 in exact arithmetic, so there
                            both sides must stay below 1e-4 of the layer's
                            weight gradient instead
  BatchNorm EMA             rtol 1e-4, atol as for the gradients
  Adam mu, nu               rtol 1e-3, 2e-3, atol as for the gradients
  updated parameters        see ``_assert_updates_agree``
The two-step test sets the port's parameters to JAX's after the first step,
so the second compares one step from the same parameters with the Adam
state each side carried over.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rec_attend_tpu import config as JC
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu.parallel import train_step as JT
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch import train_step as TS
from rec_attend_tpu_torch.models import full_model as TF
from test_torch_image_ops import jax_colour_draws

torch.set_num_threads(1)

B = 2
SCALE = 10
VARIANTS = {
    # step 0: both knobs are 1, the GT box and GT segmentation mix run.
    'knob_on_remat': (dict(use_knob=True, remat=True), 0.0),
    # a late step: both knob probabilities are ~0.
    'knob_off': (dict(use_knob=True, remat=False), 100000.0),
    'iou_box': (dict(use_knob=True, use_iou_box=True, remat=False), 0.0),
    'no_knob_canvas_grad': (dict(use_knob=False, remat=True,
                                 stop_canvas_grad=False,
                                 segm_weight_alpha=0.5), 0.0),
    # The loss options (full_model.py:627-681), at step 0.
    'box_mse': (dict(use_knob=True, box_loss_fn='mse'), 0.0),
    'box_huber': (dict(use_knob=True, box_loss_fn='huber'), 0.0),
    'box_wt_cov': (dict(use_knob=True, box_loss_fn='wt_cov'), 0.0),
    'box_bce': (dict(use_knob=True, box_loss_fn='bce'), 0.0),
    'segm_wt_cov': (dict(use_knob=True, segm_loss_fn='wt_cov'), 0.0),
    'segm_bce': (dict(use_knob=True, segm_loss_fn='bce'), 0.0),
    'accumulate_greedy_match': (dict(use_knob=True, remat=True,
                                     accumulate_greedy_match=True), 0.0),
    # Timestep t against instance t (full_model.py:398-401, :468-469,
    # :597-600, :644-658): with the knob, the ground truth of timestep t is
    # mixed in; without it, only the identity matchings remain.
    'fixed_order_knob_on': (dict(use_knob=True, remat=True,
                                 fixed_order=True), 0.0),
    'fixed_order_knob_off': (dict(use_knob=False, fixed_order=True), 0.0),
    # The colour jitter of the augmentation (image_ops.py:167-174).
    'rnd_colour': (dict(use_knob=True, rnd_colour=True), 0.0),
}
AUG = dict(rnd_hflip=True, rnd_vflip=True, rnd_transpose=True)


def _configs(variant):
  over = dict(VARIANTS[variant][0], **AUG)
  return JC.tiny_full_config(**over), C.tiny_full_config(**over)


def _params(jcfg, seed=0):
  rng = np.random.RandomState(seed)
  params = JF.init_full_model(jax.random.PRNGKey(seed), jcfg)
  return jax.tree_util.tree_map(
      lambda a: np.asarray(a) * (1 + SCALE * rng.rand(*a.shape)).astype(
          np.float32) if a.ndim >= 2 else np.asarray(a), params)


def _batch(cfg, seed):
  """Rectangles as instances, later ones occluding earlier ones; the last
  slot of the first image stays empty."""
  rng = np.random.RandomState(seed)
  t, h, w = cfg.timespan, cfg.inp_height, cfg.inp_width
  x = (rng.rand(B, h, w, 3) * 0.2).astype(np.float32)
  y = np.zeros((B, t, h, w), np.float32)
  s = np.zeros((B, t), np.float32)
  for b in range(B):
    for k in range(t - 1 if b == 0 else t):
      y0, x0 = rng.randint(0, h - 12), rng.randint(0, w - 12)
      dy, dx = rng.randint(6, 24), rng.randint(6, 24)
      y[b, :k, y0:y0 + dy, x0:x0 + dx] = 0
      y[b, k, y0:y0 + dy, x0:x0 + dx] = 1
      x[b, y0:y0 + dy, x0:x0 + dx] = rng.rand(3) * 0.5 + 0.5
      s[b, k] = 1
  return {'x': x, 'y_gt': y, 's_gt': s}


def jax_draws(key, jcfg, b):
  """The draws JAX full_model_forward makes from ``key``, in the port's
  ``draw_train_randoms`` form (as numpy / Python values)."""
  t, h, w = jcfg.timespan, jcfg.inp_height, jcfg.inp_width
  _, k_aug, k_noise, k_knob_box, k_knob_segm, k_scan = jax.random.split(
      key, 6)
  k_off, k_h, k_v, k_t = jax.random.split(k_aug, 8)[:4]
  off = np.asarray(jax.random.randint(k_off, (2,), 0,
                                      max(2 * jcfg.padding, 1)))
  k_n1, k_n2 = jax.random.split(k_noise)
  pad = jcfg.attn_box_padding_ratio
  scan_keys = jax.random.split(k_scan, t)
  aug = {'offset': (int(off[0]), int(off[1])),
         'hflip': bool(jax.random.uniform(k_h) < 0.5),
         'vflip': bool(jax.random.uniform(k_v) < 0.5),
         'transpose': bool(jax.random.uniform(k_t) < 0.5)}
  if jcfg.rnd_colour:
    aug['colour'] = jax_colour_draws(k_aug)
  return {
      'aug': aug,
      'pad_noise': jax.random.uniform(
          k_n1, (b, t, 1), minval=pad - jcfg.gt_box_pad_noise,
          maxval=pad + jcfg.gt_box_pad_noise),
      'ctr_noise': jax.random.uniform(
          k_n2, (b, t, 2), minval=-jcfg.gt_box_ctr_noise,
          maxval=jcfg.gt_box_ctr_noise),
      'knob_box': jax.random.uniform(k_knob_box, (b, t, 1)),
      'knob_segm': jax.random.uniform(k_knob_segm, (b, t, 1)),
      'segm_noise': jnp.stack([
          jax.random.uniform(k, (b, h, w, 1), minval=0.0,
                             maxval=jcfg.gt_segm_noise) for k in scan_keys]),
  }


def to_torch(draws):
  return {k: (v if k == 'aug' else torch.from_numpy(np.array(v)))
          for k, v in draws.items()}


@functools.lru_cache(maxsize=None)
def _jax_fns(variant):
  """(jitted fn, tx): fn(params, opt_state, batch, key, step) returns
  ((loss, aux), grads) of the loss and the outputs of the JAX package's
  train step, ``make_train_step``'s step function, compiled as one
  program."""
  jcfg, _ = _configs(variant)
  loss_fn = functools.partial(JF.full_model_loss, matcher='native')
  grad_fn = jax.value_and_grad(
      lambda p, b, k, s: loss_fn(p, b, jcfg, True, k, s), has_aux=True)
  step_fn, tx = JT.make_train_step(loss_fn, jcfg, jit=False)
  return jax.jit(lambda p, o, b, k, s: (grad_fn(p, b, k, s),
                                        step_fn(p, o, b, k, s))), tx


def _names(tree):
  return [jax.tree_util.keystr(p, simple=True, separator='.')
          for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _flat(tree):
  return dict(zip(_names(tree), (np.asarray(v) for v in
                                 jax.tree_util.tree_leaves(tree))))


def _zero_grad_leaves(model):
  """{bias name: weight name} of the conv layers that a BatchNorm follows:
  train-mode BatchNorm subtracts the batch mean, so the bias's gradient is
  0 up to float32 noise."""
  return {f'{name}.b': f'{name}.w' for name in (
      k[:-len('.bn')] for k, m in model.named_modules()
      if k.endswith('.bn') and m is not None)}


def _close(got, want, rtol, what):
  scale = max(float(np.abs(want).max()), 1e-30)
  np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-4 * scale,
                             err_msg=what)


def _assert_updates_agree(old, new_port, new_jax, grads_jax, zero, lr,
                          what):
  """Updated parameters.  Adam's first steps move a parameter by about
  lr * sign(g): where a gradient is float32 noise around 0 (a leaf of
  ``zero``, or |g| within the gradient tolerance, 1e-4 of the leaf's
  largest |g|), the two sides may move it by up to 2 lr apart, and that is
  all they may differ by there.  Elsewhere the updates (new - old) agree to
  rtol 1e-3 and atol 1e-3 lr."""
  for k, want in new_jax.items():
    if k.endswith(('ema_mean', 'ema_var')):   # compared elsewhere
      continue
    g = np.abs(grads_jax[k])
    noise = g <= 1e-4 * max(float(g.max()), 1e-30)
    if k in zero:
      noise[...] = True
    d_port = new_port[k] - old[k]
    d_jax = want - old[k]
    err = np.abs(d_port - d_jax)
    assert (err[noise] <= 2 * lr * (1 + 1e-3)).all(), (what, k)
    np.testing.assert_allclose(d_port[~noise], d_jax[~noise], rtol=1e-3,
                               atol=1e-3 * lr, err_msg=f'{what} {k}')


def _port_model(cfg, params):
  model = TF.FullModel(cfg, device='cpu')
  model.load_state_dict(convert.params_from_jax(params))
  return model


def _run_steps(variant, n_steps):
  jcfg, cfg = _configs(variant)
  step0 = VARIANTS[variant][1]
  jax_fn, tx = _jax_fns(variant)
  params = _params(jcfg)
  opt_state = tx.init(params)
  model = _port_model(cfg, params)
  port_opt = TS.init_opt_state(model)
  zero = _zero_grad_leaves(model)
  for i in range(n_steps):
    batch = _batch(cfg, seed=10 + i)
    key = jax.random.PRNGKey(100 + i)
    step = jnp.asarray(step0 + i, jnp.float32)
    draws = to_torch(jax_draws(key, jcfg, B))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    what = f'{variant} step {i}'

    # Loss, metrics and gradients.
    ((j_loss, j_aux), j_grads), (j_params, j_opt_state, j_metrics) = jax_fn(
        params, opt_state, batch, key, step)
    loss, aux, grads = TS.loss_and_grads(model, tbatch, draws,
                                         step0 + i)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-4,
                               atol=1e-5, err_msg=what)
    for k in TF.METRIC_KEYS:
      np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-4,
                                 atol=1e-5, err_msg=f'{what} {k}')
    np.testing.assert_array_equal(aux['match'].numpy(),
                                  np.asarray(j_aux['match']))
    j_grads = _flat(j_grads)
    port_grads = {k: v.numpy() for k, v in grads.items()}
    assert set(port_grads) < set(j_grads)
    for k, g in port_grads.items():
      if k in zero:
        limit = 1e-4 * float(np.abs(j_grads[zero[k]]).max())
        assert np.abs(g).max() <= limit, (what, k)
        assert np.abs(j_grads[k]).max() <= limit, (what, k)
      else:
        _close(g, j_grads[k], 1e-3, f'{what} grad {k}')

    # The update: JAX's make_train_step against the port's step.
    old = {k: v.detach().numpy().copy() for k, v in
           model.state_dict().items()}
    params, opt_state = j_params, j_opt_state
    port_opt, metrics = TS.train_step(model, port_opt, tbatch, draws,
                                      step0 + i)
    np.testing.assert_allclose(float(metrics['loss']),
                               float(j_metrics['loss']), rtol=1e-4,
                               atol=1e-5, err_msg=what)
    new_jax = _flat(params)
    new_port = {k: v.detach().numpy() for k, v in
                model.state_dict().items()}
    for k in new_jax:
      if k.endswith(('ema_mean', 'ema_var')):
        _close(new_port[k], new_jax[k], 1e-4, f'{what} {k}')
    lr = TF.learn_rate(cfg, i)
    _assert_updates_agree(old, new_port, new_jax, j_grads, zero, lr, what)
    j_opt = convert.opt_state_from_jax(opt_state, cfg)
    assert port_opt['count'] == j_opt['count'] == i + 1
    for k in port_opt['mu']:
      mu, nu = port_opt['mu'][k].numpy(), port_opt['nu'][k].numpy()
      if k in zero:
        limit = 1e-4 * float(np.abs(j_grads[zero[k]]).max())
        assert np.abs(mu).max() <= limit and np.sqrt(nu).max() <= limit
        continue
      _close(mu, j_opt['mu'][k].numpy(), 1e-3, f'{what} mu {k}')
      _close(nu, j_opt['nu'][k].numpy(), 2e-3, f'{what} nu {k}')
    # The next step starts from JAX's parameters (see the docstring).
    model.load_state_dict(convert.params_from_jax(params))


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_one_step_matches_jax(variant):
  _run_steps(variant, 1)


def test_two_steps_match_jax():
  _run_steps('knob_on_remat', 2)


def test_draws_come_from_a_generator():
  """draw_train_randoms gives every draw the forward reads, with the shapes
  and ranges of JAX's."""
  jcfg, cfg = _configs('knob_on_remat')
  draws = TF.draw_train_randoms(cfg, 3, torch.Generator().manual_seed(0))
  want = jax_draws(jax.random.PRNGKey(0), jcfg, 3)
  assert draws.keys() == want.keys()
  assert draws['aug'].keys() == want['aug'].keys()
  for k, v in draws.items():
    if k == 'aug':
      assert all(0 <= o < 2 * cfg.padding for o in v['offset'])
      continue
    assert tuple(v.shape) == tuple(want[k].shape), k
    lo, hi = float(np.min(want[k])), float(np.max(want[k]))
    span = hi - lo
    assert float(v.min()) >= lo - span and float(v.max()) <= hi + span, k


def test_frozen_subnets_keep_their_parameters():
  """freeze_attn_net: the attention CNN/DCNN's parameters stay (their Adam
  moments still move, as optax's do under the JAX trainer's freeze mask),
  the rest are updated, and the BN EMA is written back everywhere."""
  jcfg, cfg = _configs('knob_on_remat')
  cfg = cfg.replace(freeze_attn_net=True)
  model = _port_model(cfg, _params(jcfg))
  frozen = TS.freeze_mask(model)
  assert {k.split('.')[0] for k, f in frozen.items() if f} == {
      'attn_cnn', 'attn_dcnn'}
  old = {k: v.detach().clone() for k, v in model.state_dict().items()}
  opt = TS.init_opt_state(model)
  draws = TF.draw_train_randoms(cfg, B, torch.Generator().manual_seed(0))
  batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3).items()}
  opt, _ = TS.train_step(model, opt, batch, draws, 0)
  new = model.state_dict()
  for k, f in frozen.items():
    assert torch.equal(new[k], old[k]) == f, k
    assert opt['mu'][k].abs().sum() > 0 or k in _zero_grad_leaves(model), k
  for k in new:
    if k.endswith('ema_mean'):
      assert not torch.equal(new[k], old[k]), k


def test_uint8_batches_decode_as_jax():
  x = np.random.RandomState(0).randint(0, 256, (2, 4, 4, 3)).astype(
      np.uint8)
  got = TS.decode_batch({'x': torch.from_numpy(x),
                         's_gt': torch.ones(2, 3)})
  want = JT.decode_batch({'x': jnp.asarray(x), 's_gt': jnp.ones((2, 3))})
  np.testing.assert_array_equal(got['x'].numpy(), np.asarray(want['x']))
  assert got['s_gt'].dtype == torch.float32
