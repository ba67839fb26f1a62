"""The fg model's training in the port against the JAX package's
``make_train_step(fg_model_loss, cfg)``.

Tiny fg configs (64x64): the KITTI shape of the model (one foreground
class, the orientation head, BCE, momentum), a three-class softmax with the
orientation head (the Cityscapes shape: CE over the classes, the
orientation CE over the foreground classes), and one class without the
orientation head under the IoU loss and Adam, with the flips on; and the
synthcs fg preset's layers at a 64x128 input (one momentum step).  JAX
``init_fg_model`` parameters with the weights scaled by up to 21x (out of
the near-constant regime of the 0.01 init), a numpy-seeded batch of
rectangle instances with its foreground and orientation targets, and JAX's
own augmentation draws: the test rebuilds them from the step's key, which
``fg_model_forward`` hands straight to ``random_transformation``
(``image_ops.py:141-146``).

Compared, with their tolerances (float32 on both sides; the conv stacks sum
in other orders in XLA and in PyTorch):
  loss and aux metrics      rtol 1e-4, atol 1e-5
  every gradient leaf       rtol 1e-3, atol 1e-4 times the leaf's largest
                            magnitude; a conv bias that a train-mode
                            BatchNorm follows has gradient 0 in exact
                            arithmetic, so there both sides must stay below
                            1e-4 of the layer's weight gradient instead
  BatchNorm EMA             rtol 1e-4, atol as for the gradients
  momentum trace            as the gradients (the trace is g, then
                            g + 0.9 g_prev)
  Adam mu, nu               rtol 1e-3, 2e-3, atol as for the gradients
  updated parameters        momentum: within lr times the trace's
                            tolerance plus one float32 spacing of the
                            parameter on each side; Adam:
                            ``_assert_updates_agree``
The two-step test sets the port's parameters to JAX's after the first step,
so the second compares one step from the same parameters with the
optimizer state each side carried over.  The momentum state that the port
reads from the committed ``ckpt-3000.npz`` equals the JAX ``Saver``'s
restore.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rec_attend_tpu import config as JC
from rec_attend_tpu.data import orientation as jorientation
from rec_attend_tpu.engine.saver import Saver
from rec_attend_tpu.models import fg_model as JG
from rec_attend_tpu.ops import losses as jlosses
from rec_attend_tpu.parallel import train_step as JT
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch import train_step as TS
from rec_attend_tpu_torch.data import orientation as orientation
from rec_attend_tpu_torch.data.synthetic import synthetic_instances
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.engine.trainer import Trainer
from rec_attend_tpu_torch.models import fg_model as TG
from rec_attend_tpu_torch.models.full_model import learn_rate
from rec_attend_tpu_torch.ops import losses
from test_torch_train_step import _assert_updates_agree
from test_torch_train_step import _close
from test_torch_train_step import _flat
from test_torch_train_step import _zero_grad_leaves

torch.set_num_threads(1)

FG_SYNTH3 = os.path.join(os.path.dirname(__file__), '..', 'results',
                         'fg_model_synth3-20260818a')
B = 2
SCALE = 20
# The synthcs layers' gradients against their float32 floor (see
# test_one_momentum_step_of_the_synthcs_layers_matches_jax).
FLOOR_FACTOR = 3.0
VARIANTS = {
    'orientation_momentum': dict(
        add_orientation=True, dcnn_depth=(8, 4, 9), segm_loss_fn='bce',
        optimizer='momentum'),
    'softmax3_momentum': dict(
        add_orientation=True, num_semantic_classes=3, dcnn_depth=(8, 4, 11),
        segm_loss_fn='bce', optimizer='momentum'),
    'iou_adam_flips': dict(rnd_hflip=True, rnd_vflip=True,
                           rnd_transpose=True),
    # JAX's fg model reads no dtype: a bfloat16 config trains in float32.
    'orientation_momentum_bf16_config': dict(
        add_orientation=True, dcnn_depth=(8, 4, 9), segm_loss_fn='bce',
        optimizer='momentum', dtype='bfloat16'),
}


def _synthcs_layers():
  """The synthcs fg preset's layers (JAX run_pipeline.py:396-399: the
  Cityscapes preset, 3 classes; 20 conv and 13 transposed-conv layers up
  to 512 channels, BCE over the classes' softmax, momentum) at a 64x128
  input instead of 256x512, so that a step takes seconds."""
  jcfg = JC.cityscapes_fg_config()
  return jcfg.replace(num_semantic_classes=3,
                      dcnn_depth=jcfg.dcnn_depth[:-1] + (11,),
                      inp_height=64, inp_width=128)


# Configs other than the tiny one's variants.
PRESETS = {'synthcs_layers_64x128': _synthcs_layers}


def _configs(variant):
  jcfg = (PRESETS[variant]() if variant in PRESETS
          else JC.tiny_fg_config(**VARIANTS[variant]))
  return jcfg, C.FGModelConfig.from_dict(jcfg.to_dict())


def _params(jcfg, seed=0):
  rng = np.random.RandomState(seed)
  params = JG.init_fg_model(jax.random.PRNGKey(seed), jcfg)
  return jax.tree_util.tree_map(
      lambda a: np.asarray(a) * (1 + SCALE * rng.rand(*a.shape)).astype(
          np.float32) if a.ndim >= 2 else np.asarray(a), params)


def _batch(cfg, seed):
  """Rectangles as instances, later ones occluding earlier ones; the
  foreground (per class: instance k has class k % C + 1, channel 0 the
  background) and the one-hot orientation as the JAX dataset reads them."""
  rng = np.random.RandomState(seed)
  h, w, n_sem = cfg.inp_height, cfg.inp_width, cfg.num_semantic_classes
  x = (rng.rand(B, h, w, 3) * 0.2).astype(np.float32)
  c = np.zeros((B, h, w, n_sem), np.float32)
  d = np.zeros((B, h, w, 8), np.float32)
  for b in range(B):
    masks = np.zeros((5, h, w), np.uint8)
    for k in range(5):
      y0, x0 = rng.randint(0, h - 12), rng.randint(0, w - 12)
      dy, dx = rng.randint(6, 24), rng.randint(6, 24)
      masks[:k, y0:y0 + dy, x0:x0 + dx] = 0
      masks[k, y0:y0 + dy, x0:x0 + dx] = 1
      x[b, y0:y0 + dy, x0:x0 + dx] = rng.rand(3) * 0.5 + 0.5
    if n_sem == 1:
      c[b, :, :, 0] = masks.max(0)
    else:
      for k in range(5):
        c[b, :, :, k % (n_sem - 1) + 1] = np.maximum(
            c[b, :, :, k % (n_sem - 1) + 1], masks[k])
      c[b, :, :, 0] = 1 - c[b, :, :, 1:].max(-1)
    ori = jorientation.get_orientation(masks[None], encoding='class')[0]
    d[b] = ori[..., None] == np.arange(8)
  return {'x': x, 'c_gt': c, 'd_gt': d}


def fg_jax_draws(key, jcfg):
  """The draws JAX fg_model_forward makes from ``key`` (it passes the key
  to ``random_transformation`` as it is), in ``draw_fg_randoms``' form."""
  k_off, k_h, k_v, k_t = jax.random.split(key, 8)[:4]
  off = np.asarray(jax.random.randint(k_off, (2,), 0,
                                      max(2 * jcfg.padding, 1)))
  return {'aug': {'offset': (int(off[0]), int(off[1])),
                  'hflip': bool(jax.random.uniform(k_h) < 0.5),
                  'vflip': bool(jax.random.uniform(k_v) < 0.5),
                  'transpose': bool(jax.random.uniform(k_t) < 0.5)}}


def _jax_batch(batch, jcfg):
  out = {'x': batch['x'], 'y_gt': batch['c_gt']}
  if jcfg.add_orientation:
    out['d_gt'] = batch['d_gt']
  return out


@functools.lru_cache(maxsize=None)
def _jax_fns(variant):
  """(jitted fn, tx): fn(params, opt_state, batch, key, step) returns
  ((loss, aux), grads) of the loss and the outputs of the JAX package's
  train step, compiled as one program."""
  jcfg, _ = _configs(variant)
  loss_fn = JG.fg_model_loss
  grad_fn = jax.value_and_grad(
      lambda p, b, k, s: loss_fn(p, b, jcfg, True, k, s), has_aux=True)
  step_fn, tx = JT.make_train_step(loss_fn, jcfg, jit=False)
  return jax.jit(lambda p, o, b, k, s: (grad_fn(p, b, k, s),
                                        step_fn(p, o, b, k, s))), tx


def _metric_keys(cfg):
  return TG.METRIC_KEYS + (TG.ORIENTATION_METRIC_KEYS
                           if cfg.add_orientation else ())


def _assert_momentum_updates_agree(old, new_port, new_jax, trace_jax, zero,
                                   limits, lr, what):
  for k, want in new_jax.items():
    if k.endswith(('ema_mean', 'ema_var')):
      continue
    t = np.abs(trace_jax[k])
    if k in zero:
      tol = lr * 2 * limits[k]
    else:
      tol = lr * (1e-3 * t + 1e-4 * max(float(t.max()), 1e-30))
    tol = tol + np.spacing(np.abs(want)) + np.spacing(np.abs(new_port[k]))
    err = np.abs(new_port[k] - want)
    assert (err <= tol).all(), (what, k, float((err - tol).max()))
    assert np.abs(want - old[k]).max() > 0 or k in zero, (what, k)


def _run_steps(variant, n_steps):
  jcfg, cfg = _configs(variant)
  jax_fn, tx = _jax_fns(variant)
  params = _params(jcfg)
  opt_state = tx.init(params)
  model = TG.FGModel(cfg, device='cpu')
  model.load_state_dict(convert.params_from_jax(params))
  port_opt = TS.init_opt_state(model)
  zero = _zero_grad_leaves(model)
  momentum = cfg.optimizer == 'momentum'
  for i in range(n_steps):
    batch = _batch(cfg, seed=10 + i)
    key = jax.random.PRNGKey(100 + i)
    draws = fg_jax_draws(key, jcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    what = f'{variant} step {i}'

    ((j_loss, j_aux), j_grads), (j_params, j_opt_state, j_metrics) = jax_fn(
        params, opt_state, _jax_batch(batch, jcfg), key,
        jnp.asarray(i, jnp.float32))
    loss, aux, grads = TS.loss_and_grads(model, tbatch, draws, i)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-4,
                               atol=1e-5, err_msg=what)
    for k in _metric_keys(cfg):
      np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-4,
                                 atol=1e-5, err_msg=f'{what} {k}')
    # The outputs are not constant: the scaled weights left the 0.01
    # init's near-constant regime.
    assert float(aux['outputs']['y_out'].detach().std()) > 1e-3, what
    j_grads = _flat(j_grads)
    limits = {k: 1e-4 * float(np.abs(j_grads[zero[k]]).max())
              for k in zero}
    port_grads = {k: v.numpy() for k, v in grads.items()}
    assert set(port_grads) < set(j_grads)
    for k, g in port_grads.items():
      if k in zero:
        assert np.abs(g).max() <= limits[k], (what, k)
        assert np.abs(j_grads[k]).max() <= limits[k], (what, k)
      else:
        _close(g, j_grads[k], 1e-3, f'{what} grad {k}')

    old = {k: v.detach().numpy().copy() for k, v in
           model.state_dict().items()}
    params, opt_state = j_params, j_opt_state
    port_opt, metrics = TS.train_step(model, port_opt, tbatch, draws, i)
    assert sorted(metrics) == sorted(_metric_keys(cfg))
    np.testing.assert_allclose(float(metrics['loss']),
                               float(j_metrics['loss']), rtol=1e-4,
                               atol=1e-5, err_msg=what)
    new_jax = _flat(params)
    new_port = {k: v.detach().numpy() for k, v in
                model.state_dict().items()}
    for k in new_jax:
      if k.endswith(('ema_mean', 'ema_var')):
        _close(new_port[k], new_jax[k], 1e-4, f'{what} {k}')
    j_opt = convert.opt_state_from_jax(opt_state, cfg)
    assert port_opt['count'] == j_opt['count'] == i + 1
    lr = learn_rate(cfg, i)
    if momentum:
      assert sorted(port_opt) == ['count', 'trace']
      for k, t in port_opt['trace'].items():
        t = t.numpy()
        if k in zero:
          assert np.abs(t).max() <= (i + 1) * limits[k], (what, k)
          continue
        _close(t, j_opt['trace'][k].numpy(), 1e-3, f'{what} trace {k}')
      trace_jax = {k: v.numpy() for k, v in j_opt['trace'].items()}
      _assert_momentum_updates_agree(old, new_port, new_jax, trace_jax, zero,
                                     limits, lr, what)
    else:
      _assert_updates_agree(old, new_port, new_jax, j_grads, zero, lr, what)
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


def test_two_momentum_steps_match_jax():
  _run_steps('orientation_momentum', 2)


def test_one_momentum_step_of_the_synthcs_layers_matches_jax():
  """One momentum step of the synthcs fg preset's 33 layers at 64x128, b2.
  The loss, the metrics and the BatchNorm EMA are held at the file's
  tolerances.  The gradients are not: through 28 train-mode BatchNorms
  over two images, float32 alone moves them by up to 1.4e-2 from the
  float64 step, JAX's and the port's alike (measured against the port's
  step in float64).  So each leaf's gradient and update (at step 0 the
  update is -lr times the gradient) is held, by its relative L2 error, to
  FLOOR_FACTOR times that leaf's float32 floor: the two steps on the batch
  in the other order (its BatchNorm sums run in another order) against
  the two steps, JAX's and the port's errors added.  On this batch the
  port against JAX reads at most 1.9 times the floor; a fault of the port
  reads about 1 in the leaves it touches."""
  import dataclasses
  variant = 'synthcs_layers_64x128'
  jcfg, cfg = _configs(variant)
  assert dataclasses.asdict(cfg) == dataclasses.asdict(
      C.synthcs_fg_config().replace(inp_height=64, inp_width=128))
  assert cfg.optimizer == 'momentum' and cfg.segm_loss_fn == 'bce'
  jax_fn, tx = _jax_fns(variant)
  params = _params(jcfg)
  batch = _batch(cfg, seed=10)
  flipped = {k: np.ascontiguousarray(v[::-1]) for k, v in batch.items()}
  key = jax.random.PRNGKey(100)
  draws = fg_jax_draws(key, jcfg)

  def jax_step(b):
    return jax_fn(params, tx.init(params), _jax_batch(b, jcfg), key,
                  jnp.asarray(0.0, jnp.float32))

  def port_step(b):
    model = TG.FGModel(cfg, device='cpu')
    model.load_state_dict(convert.params_from_jax(params))
    tbatch = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, aux, grads = TS.loss_and_grads(model, tbatch, draws, 0)
    opt, metrics = TS.train_step(model, TS.init_opt_state(model), tbatch,
                                 draws, 0)
    return loss, aux, grads, model, opt
  ((j_loss, j_aux), j_grads), (j_params, j_opt_state, _) = jax_step(batch)
  (_, j_grads_f), (j_params_f, _, _) = jax_step(flipped)
  loss, aux, grads, model, port_opt = port_step(batch)
  _, _, grads_f, model_f, _ = port_step(flipped)
  np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-4,
                             atol=1e-5)
  for k in _metric_keys(cfg):
    np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-4,
                               atol=1e-5, err_msg=k)
  assert float(aux['outputs']['y_out'].detach().std()) > 1e-3

  old = _flat(params)
  j_new, j_new_f = _flat(j_params), _flat(j_params_f)
  new = {k: v.detach().numpy() for k, v in model.state_dict().items()}
  new_f = {k: v.detach().numpy() for k, v in model_f.state_dict().items()}
  j_grads, j_grads_f = _flat(j_grads), _flat(j_grads_f)
  zero = _zero_grad_leaves(model)

  def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
  worst = 0.0
  for k, g in grads.items():
    if k in zero:
      limit = 1e-4 * float(np.abs(j_grads[zero[k]]).max())
      assert np.abs(g.numpy()).max() <= limit, k
      assert np.abs(j_grads[k]).max() <= limit, k
      continue
    floor = rel(j_grads_f[k], j_grads[k]) + rel(grads_f[k].numpy(),
                                                g.numpy())
    got = rel(g.numpy(), j_grads[k])
    assert got <= FLOOR_FACTOR * floor, (k, got, floor)
    up_floor = (rel(j_new_f[k] - old[k], j_new[k] - old[k])
                + rel(new_f[k] - old[k], new[k] - old[k]))
    up = rel(new[k] - old[k], j_new[k] - old[k])
    assert up <= FLOOR_FACTOR * up_floor, (k, up, up_floor)
    worst = max(worst, floor)
  # The floor is float32's, not a fault's.
  assert worst < 0.05
  for k in j_new:
    if k.endswith(('ema_mean', 'ema_var')):
      _close(new[k], j_new[k], 1e-4, k)
  j_opt = convert.opt_state_from_jax(j_opt_state, cfg)
  assert port_opt['count'] == j_opt['count'] == 1
  assert sorted(port_opt) == ['count', 'trace']


def test_gradients_are_not_clipped():
  """The fg config has no clip_gradient, so JAX chains optax.identity():
  a gradient element beyond 1 goes into the trace as it is."""
  _, cfg = _configs('orientation_momentum')
  model = TG.FGModel(cfg, device='cpu')
  opt = TS.init_opt_state(model)
  grads = {k: torch.full_like(p, 3.0) for k, p in model.named_parameters()}
  old = {k: p.detach().clone() for k, p in model.named_parameters()}
  opt = TS.apply_updates(model, opt, grads, {})
  for k, p in model.named_parameters():
    assert torch.equal(opt['trace'][k], grads[k]), k
    torch.testing.assert_close(p.detach(), old[k] - learn_rate(cfg, 0) * 3.0,
                               rtol=0, atol=1e-7)


def test_momentum_state_of_the_synth3_checkpoint_matches_jax():
  """The trace and schedule count that the port reads from ckpt-3000 (the
  optimizer state before the parameters, 2P+1 leaves) equal the JAX
  Saver's restore, and the Trainer puts them on its device."""
  cfg, jcfg = C.kitti_fg_config(), JC.kitti_fg_config()
  path = saver.latest_checkpoint(FG_SYNTH3)
  got = convert.opt_state_from_checkpoint(path, cfg)
  params = JG.init_fg_model(jax.random.PRNGKey(0), jcfg)
  tree, step = Saver(FG_SYNTH3).restore(
      {'params': params, 'opt_state': JT.make_optimizer(jcfg).init(params)})
  want = convert.opt_state_from_jax(tree['opt_state'], cfg)
  assert step == got['count'] == want['count'] == 3000
  assert sorted(got) == ['count', 'trace']
  assert sorted(got['trace']) == sorted(want['trace'])
  assert len(got['trace']) == 170 - 2 * 28   # less the 28 BN layers' EMA
  for k, v in want['trace'].items():
    assert torch.equal(got['trace'][k], v), k
  assert any(float(v.abs().max()) > 0 for v in got['trace'].values())
  trainer = Trainer(cfg, device='cpu')
  trainer.restore(FG_SYNTH3)
  assert trainer.step == trainer.opt_state['count'] == 3000
  assert trainer.opt_state['trace']['dcnn.10.w'].device.type == 'cpu'
  torch.testing.assert_close(trainer.opt_state['trace']['cnn.0.w'],
                             want['trace']['cnn.0.w'], rtol=0, atol=0)


def test_fg_losses_match_jax():
  rng = np.random.RandomState(0)
  a = rng.rand(2, 8, 8, 3).astype(np.float32)
  b = (rng.rand(2, 8, 8, 3) > 0.5).astype(np.float32)
  np.testing.assert_allclose(
      losses.f_ce(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
      np.asarray(jlosses.f_ce(a, b)), rtol=1e-6)
  np.testing.assert_allclose(
      float(losses.f_iou_all(torch.from_numpy(a), torch.from_numpy(b))),
      float(jlosses.f_iou_all(a, b)), rtol=1e-6)


def test_synthetic_targets_are_those_of_the_jax_dataset():
  """c_gt is the union of every instance drawn, d_gt the JAX orientation
  of those instances, one-hot over every pixel (background in bin 0), as
  the JAX dataset reads them from the assembled H5."""
  data = synthetic_instances(3, 40, 56, 2, seed=5, max_objects=6)
  assert data['c_gt'].shape == (3, 40, 56, 1)
  assert data['d_gt'].shape == (3, 40, 56, 8)
  d = data['d_gt'].numpy()
  np.testing.assert_array_equal(d.sum(-1), 1)
  # With up to 6 instances and 2 slots, some images hold more instances
  # than y_gt: their foreground reaches beyond y_gt's union.
  union = data['y_gt'].numpy().max(1)
  assert (data['c_gt'].numpy()[..., 0] >= union).all()
  assert (data['c_gt'].numpy()[..., 0] > union).any()
  y = np.random.RandomState(1).rand(2, 3, 20, 24) > 0.6
  y = y & (np.cumsum(y, axis=1) == 1)     # disjoint instances
  np.testing.assert_array_equal(
      orientation.get_orientation(y),
      jorientation.get_orientation(y, encoding='class'))
