"""The box model in the port against the JAX package's ``box_model``.

Tiny box configs (64x64, T=4): the KITTI shape (the packed orientation and
foreground channels, ``dynamic_var``, remat), and one without them with
the flips on and the boxes' IoU from their corners (``use_iou_box``).  JAX
``init_box_model`` parameters with the weights scaled by up to 11x, a
numpy-seeded batch of rectangle instances with an empty slot, random
packed maps, and JAX's own random draws, rebuilt from the key by the
``jax.random.split`` sequence of ``box_model.py:87-122`` (``key -> (_,
k_aug, k_scan)``, one canvas-noise uniform per timestep from
``split(k_scan, T)``).  Both sides match with the same host Hungarian
solver (JAX ``matcher='native'``); the inputs give no ties in the soft box
IoU that it matches on.

Compared, with their tolerances (float32 on both sides, as in
``test_torch_train_step.py``):
  eval and train forwards   rtol 1e-4, atol 1e-5 (every output)
  loss and aux metrics      rtol 1e-4, atol 1e-5
  every gradient leaf       rtol 1e-3, atol 1e-4 times the leaf's largest
                            magnitude; the conv biases that a train-mode
                            BatchNorm follows stay below 1e-4 of the
                            layer's weight gradient on both sides
  BatchNorm EMA             rtol 1e-4, atol as for the gradients
  Adam mu, nu               rtol 1e-3, 2e-3, atol as for the gradients
  updated parameters        ``_assert_updates_agree``
The Adam state read from the committed ``ckpt-12000.npz`` equals the JAX
``Saver``'s restore, and the full model's controller loaded from that
checkpoint equals JAX ``load_pretrained`` from the committed
``weights.h5``.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rec_attend_tpu import config as JC
from rec_attend_tpu.engine.saver import Saver
from rec_attend_tpu.models import box_model as JB
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu.parallel import train_step as JT
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch import train_step as TS
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.engine.trainer import Trainer
from rec_attend_tpu_torch.models import box_model as TB
from rec_attend_tpu_torch.models import full_model as TF
from test_torch_train_step import _assert_updates_agree
from test_torch_train_step import _close
from test_torch_train_step import _flat
from test_torch_train_step import _zero_grad_leaves

torch.set_num_threads(1)

RESULTS = os.path.join(os.path.dirname(__file__), '..', 'results')
BOX_SYNTH3 = os.path.join(RESULTS, 'box_model_synth3-20260818a')
B = 2
SCALE = 10
VARIANTS = {
    'packed_remat': dict(add_d_out=True, add_y_out=True, dynamic_var=True,
                         remat=True),
    'flips_iou_box': dict(rnd_hflip=True, rnd_vflip=True,
                          rnd_transpose=True, use_iou_box=True),
    # JAX's box model reads no dtype: a bfloat16 config trains in float32.
    'packed_remat_bf16_config': dict(add_d_out=True, add_y_out=True,
                                     dynamic_var=True, remat=True,
                                     dtype='bfloat16'),
}


def _configs(variant, **over):
  jcfg = JC.tiny_box_config(**VARIANTS[variant], **over)
  return jcfg, C.BoxModelConfig.from_dict(jcfg.to_dict())


def _params(jcfg, seed=0):
  rng = np.random.RandomState(seed)
  params = JB.init_box_model(jax.random.PRNGKey(seed), jcfg)
  return jax.tree_util.tree_map(
      lambda a: np.asarray(a) * (1 + SCALE * rng.rand(*a.shape)).astype(
          np.float32) if a.ndim >= 2 else np.asarray(a), params)


def _batch(cfg, seed):
  """Rectangles as instances, later ones occluding earlier ones; the last
  slot of the first image stays empty; random packed maps where the config
  reads them."""
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
  batch = {'x': x, 'y_gt': y, 's_gt': s}
  if cfg.add_d_out:
    batch['d_in'] = rng.rand(B, h, w, 8).astype(np.float32)
  if cfg.add_y_out:
    batch['y_in'] = rng.rand(B, h, w, cfg.num_semantic_classes).astype(
        np.float32)
  return batch


def box_jax_draws(key, jcfg, b):
  """The draws JAX box_model_forward makes from ``key``, in the port's
  ``draw_box_randoms`` form."""
  t, h, w = jcfg.timespan, jcfg.inp_height, jcfg.inp_width
  _, k_aug, k_scan = jax.random.split(key, 3)
  k_off, k_h, k_v, k_t = jax.random.split(k_aug, 8)[:4]
  off = np.asarray(jax.random.randint(k_off, (2,), 0,
                                      max(2 * jcfg.padding, 1)))
  return {
      'aug': {'offset': (int(off[0]), int(off[1])),
              'hflip': bool(jax.random.uniform(k_h) < 0.5),
              'vflip': bool(jax.random.uniform(k_v) < 0.5),
              'transpose': bool(jax.random.uniform(k_t) < 0.5)},
      'segm_noise': torch.from_numpy(np.stack([
          np.asarray(jax.random.uniform(k, (b, h, w, 1), minval=0.0,
                                        maxval=jcfg.gt_segm_noise))
          for k in jax.random.split(k_scan, t)])),
  }


def _port_model(cfg, params):
  model = TB.BoxModel(cfg, device='cpu')
  model.load_state_dict(convert.params_from_jax(params))
  return model


FORWARD_KEYS = ('s_out', 'attn_box', 'attn_ctr', 'attn_size',
                'attn_top_left', 'attn_bot_right', 'attn_ctr_norm',
                'attn_lg_size', 'glimpse_map', 'iou_soft_box_t', 'x_trans',
                'y_gt_trans', 'attn_box_gt', 'attn_ctr_norm_gt',
                'attn_lg_size_gt')


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_forward_matches_jax(variant, train):
  jcfg, cfg = _configs(variant)
  params = _params(jcfg)
  batch = _batch(cfg, seed=3)
  key = jax.random.PRNGKey(7)
  want, want_params = jax.jit(
      lambda p, b, k: JB.box_model_forward(p, b, jcfg, train, k))(
          params, batch, key)
  model = _port_model(cfg, params)
  draws = box_jax_draws(key, jcfg, B)
  if train and not cfg.add_d_out:
    assert draws['aug']['offset'] != (cfg.padding, cfg.padding)
  with torch.no_grad():
    got, new_bn = TB.box_model_forward(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, draws,
        train)
  for k in FORWARD_KEYS:
    assert got[k].shape == want[k].shape, k
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               rtol=1e-4, atol=1e-5, err_msg=k)
  # The scaled weights move the boxes apart across the batch and the
  # timesteps.
  assert float(np.asarray(want['attn_ctr']).std()) > 0.1
  want_bn = {k: v for k, v in _flat(want_params).items()
             if k.endswith(('ema_mean', 'ema_var'))}
  if train:
    assert sorted(new_bn) == sorted(want_bn)
    for k, v in new_bn.items():
      _close(v.numpy(), want_bn[k], 1e-4, k)
  else:
    assert new_bn == {}


def jax_loss_grad(jcfg):
  loss_fn = functools.partial(JB.box_model_loss, matcher='native')
  return jax.jit(jax.value_and_grad(
      lambda p, b, k, s: loss_fn(p, b, jcfg, True, k, s), has_aux=True))


@pytest.mark.parametrize('box_loss_fn', ['iou', 'mse', 'huber', 'wt_cov',
                                         'wt_iou', 'bce', 'fixed_order'])
def test_loss_and_gradients_match_jax(box_loss_fn):
  """Every box loss, and the fixed-order identity matching, on the KITTI
  shape; the metrics and every gradient."""
  over = ({'fixed_order': True} if box_loss_fn == 'fixed_order'
          else {'box_loss_fn': box_loss_fn, 'accumulate_greedy_match':
                box_loss_fn == 'huber'})
  jcfg, cfg = _configs('packed_remat', **over)
  params = _params(jcfg)
  batch = _batch(cfg, seed=4)
  key = jax.random.PRNGKey(11)
  (j_loss, j_aux), j_grads = jax_loss_grad(jcfg)(params, batch, key,
                                                 jnp.asarray(0.0))
  model = _port_model(cfg, params)
  loss, aux, grads = TS.loss_and_grads(
      model, {k: torch.from_numpy(v) for k, v in batch.items()},
      box_jax_draws(key, jcfg, B), 0)
  np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-4,
                             atol=1e-5)
  for k in TB.METRIC_KEYS:
    np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-4,
                               atol=1e-5, err_msg=k)
  np.testing.assert_array_equal(aux['match_box'].numpy(),
                                np.asarray(j_aux['match_box']))
  j_grads = _flat(j_grads)
  zero = _zero_grad_leaves(model)
  for k, g in grads.items():
    g = g.numpy()
    if k in zero:
      limit = 1e-4 * float(np.abs(j_grads[zero[k]]).max())
      assert np.abs(g).max() <= limit, k
      assert np.abs(j_grads[k]).max() <= limit, k
    else:
      _close(g, j_grads[k], 1e-3, f'grad {k}')
  assert np.abs(grads['ctrl_cnn.0.w'].numpy()[:, :, -9:]).max() > 0


@functools.lru_cache(maxsize=None)
def _jax_step(variant):
  jcfg, _ = _configs(variant)
  loss_fn = functools.partial(JB.box_model_loss, matcher='native')
  step_fn, tx = JT.make_train_step(loss_fn, jcfg, jit=False)
  return jax.jit(step_fn), tx


def _run_steps(variant, n_steps):
  jcfg, cfg = _configs(variant)
  jax_step, tx = _jax_step(variant)
  grad_fn = jax_loss_grad(jcfg)
  params = _params(jcfg)
  opt_state = tx.init(params)
  model = _port_model(cfg, params)
  port_opt = TS.init_opt_state(model)
  zero = _zero_grad_leaves(model)
  assert not any(TS.freeze_mask(model).values())
  for i in range(n_steps):
    batch = _batch(cfg, seed=20 + i)
    key = jax.random.PRNGKey(200 + i)
    step = jnp.asarray(i, jnp.float32)
    draws = box_jax_draws(key, jcfg, B)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    what = f'{variant} step {i}'
    _, j_grads = grad_fn(params, batch, key, step)
    j_grads = _flat(j_grads)
    old = {k: v.detach().numpy().copy() for k, v in
           model.state_dict().items()}
    params, opt_state, j_metrics = jax_step(params, opt_state, batch, key,
                                            step)
    port_opt, metrics = TS.train_step(model, port_opt, tbatch, draws, i)
    assert sorted(metrics) == sorted(TB.METRIC_KEYS)
    for k in TB.METRIC_KEYS:
      np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                 rtol=1e-4, atol=1e-5, err_msg=f'{what} {k}')
    new_jax = _flat(params)
    new_port = {k: v.detach().numpy() for k, v in
                model.state_dict().items()}
    for k in new_jax:
      if k.endswith(('ema_mean', 'ema_var')):
        _close(new_port[k], new_jax[k], 1e-4, f'{what} {k}')
    _assert_updates_agree(old, new_port, new_jax, j_grads, zero,
                          TF.learn_rate(cfg, i), what)
    j_opt = convert.opt_state_from_jax(opt_state, cfg)
    assert port_opt['count'] == j_opt['count'] == i + 1
    for k in port_opt['mu']:
      if k in zero:
        continue
      _close(port_opt['mu'][k].numpy(), j_opt['mu'][k].numpy(), 1e-3,
             f'{what} mu {k}')
      _close(port_opt['nu'][k].numpy(), j_opt['nu'][k].numpy(), 2e-3,
             f'{what} nu {k}')
    model.load_state_dict(convert.params_from_jax(params))


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_one_step_matches_jax(variant):
  _run_steps(variant, 1)


def test_two_steps_match_jax():
  _run_steps('packed_remat', 2)


def test_the_box_is_rendered_by_paste_without_its_backward():
  """The box is the paste of a constant patch: a train step pastes T times
  and T more in the recompute (remat), and launches no d_p extract."""
  calls = []

  def paste(p, f_y, f_x):
    calls.append(p.requires_grad)
    return TF.attention.paste_patch(p, f_y, f_x)
  _, cfg = _configs('packed_remat')
  model = TB.BoxModel(cfg, device='cpu')
  batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 5).items()}
  draws = TB.draw_box_randoms(cfg, B, torch.Generator().manual_seed(0))
  TS.loss_and_grads(model, batch, draws, 0,
                    glimpse=(TF.attention.extract_patch, paste))
  assert calls == [False] * (2 * cfg.timespan)


def test_kitti_box_preset_matches_the_synth3_folder():
  import dataclasses
  want = C.BoxModelConfig.from_yaml(os.path.join(BOX_SYNTH3,
                                                 'model_opt.yaml'))
  got = C.kitti_box_config()
  assert dataclasses.asdict(got) == dataclasses.asdict(want)
  assert dataclasses.asdict(got) == dataclasses.asdict(
      C.BoxModelConfig.from_dict(JC.kitti_box_config().to_dict()))
  assert dataclasses.asdict(C.tiny_box_config()) == dataclasses.asdict(
      C.BoxModelConfig.from_dict(JC.tiny_box_config().to_dict()))
  assert got.ccnn_inp_depth == 13 and got.glimpse_map_dim == 56


def test_adam_state_of_the_synth3_checkpoint_matches_jax():
  cfg, jcfg = C.kitti_box_config(), JC.kitti_box_config()
  path = saver.latest_checkpoint(BOX_SYNTH3)
  params = JB.init_box_model(jax.random.PRNGKey(0), jcfg)
  tree, step = Saver(BOX_SYNTH3).restore(
      {'params': params, 'opt_state': JT.make_optimizer(jcfg).init(params)})
  want = convert.opt_state_from_jax(tree['opt_state'], cfg)
  trainer = Trainer(cfg, device='cpu')
  assert trainer.restore(BOX_SYNTH3) == path
  got = trainer.opt_state
  assert step == trainer.step == got['count'] == want['count'] == 12000
  for key in ('mu', 'nu'):
    assert sorted(got[key]) == sorted(want[key])
    for k, v in want[key].items():
      assert torch.equal(got[key][k], v), (key, k)
  state = trainer.model.state_dict()
  for k, v in convert.flatten_tree(tree['params']).items():
    np.testing.assert_array_equal(state[k].numpy(), np.asarray(v), k)


def test_load_pretrained_from_the_box_checkpoint_matches_jax():
  """The full model's controller from ckpt-12000 (the port: no h5py on the
  card) equals JAX load_pretrained from the committed weights.h5; the
  attention nets and the score MLP keep their initial values."""
  jcfg = JC.kitti_full_config().replace(
      pretrain_ctrl_net=os.path.join(BOX_SYNTH3, 'weights.h5'))
  init = JF.init_full_model(jax.random.PRNGKey(0), jcfg)
  want = convert.flatten_tree(jax.tree_util.tree_map(
      np.asarray, JF.load_pretrained(dict(init), jcfg)))
  init = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, init))
  trainer = Trainer(C.kitti_full_config(), device='cpu')
  trainer.model.load_state_dict(convert.params_from_jax(init))
  trainer.load_pretrained(BOX_SYNTH3, cfg=C.kitti_box_config())
  got = trainer.model.state_dict()
  assert sorted(got) == sorted(want)
  loaded = 0
  for k, v in want.items():
    np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    if k.split('.')[0] in TF.CTRL_NETS:
      loaded += 1
      assert not np.array_equal(v, init[k]) or k.endswith('ema_var'), k
    else:
      np.testing.assert_array_equal(v, init[k], err_msg=k)
  # ctrl_cnn: 8 layers of w, b and 4 BatchNorm leaves; ctrl_mlp: 1 dense
  # layer; glimpse_mlp: 2; the LSTM's 12 matrices.
  assert loaded == 8 * 6 + 1 * 2 + 2 * 2 + 12


def test_merge_pretrained_rules():
  """A partial net leaves its tail layers as they were; a single BatchNorm
  copy is broadcast over the timesteps; a shape that disagrees raises."""
  cfg = C.tiny_full_config()
  model = TF.FullModel(cfg, device='cpu', seed=0)
  state = {k: v.clone() for k, v in model.state_dict().items()}
  loaded = {k: torch.full_like(v[0] if '.bn.' in k else v, 7.0)
            for k, v in state.items() if k.startswith('ctrl_cnn.0.')}
  got = TF.merge_pretrained(state, loaded, 'ctrl_cnn', cfg.timespan)
  for k, v in got.items():
    if k.startswith('ctrl_cnn.0.'):
      assert (v == 7.0).all() and v.shape == state[k].shape, k
    else:
      assert torch.equal(v, state[k]), k
  bad = {'ctrl_mlp.0.w': torch.zeros(3, 3)}
  with pytest.raises(ValueError, match='shape'):
    TF.merge_pretrained(state, bad, 'ctrl_mlp', cfg.timespan)
  # An in-memory box model's controller fits the full model's.
  box = TB.BoxModel(C.tiny_box_config(), device='cpu')
  TF.load_pretrained(model, box)
  got = model.state_dict()
  for k, v in box.state_dict().items():
    if k.split('.')[0] in TF.CTRL_NETS:
      assert torch.equal(got[k], v), k
