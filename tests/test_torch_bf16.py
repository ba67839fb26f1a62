"""The flagship model in bfloat16 (``dtype: bfloat16``) in the port against
the JAX package's compiled bfloat16 program.

JAX casts at explicit points (``rec_attend_tpu/models/full_model.py:288``,
``:324``, ``:351``, ``:434``, ``:440``, ``:451``, ``:464`` and
``nn/layers.py``), and XLA, compiling them, drops some of the roundings
that those casts imply; the port reproduces the compiled program
(``rec_attend_tpu_torch/nn/layers.py``: the bias added in float32 before a
BatchNorm, the convolutions' gradients, the LSTM's sum).  Compared:

1. Each layer in bfloat16 against JAX's jitted layer: convolution and
   transposed convolution (values and both gradients), BatchNorm in train
   and eval, LSTM, MLP.  Values and input gradients equal to the bit or
   within one bfloat16 spacing (2^-7 of the value) in at most 1 % of the
   elements (XLA and oneDNN sum the products in other orders, and a
   float32 difference of 1e-7 can cross a rounding boundary); float32
   weight gradients and EMA statistics rtol 1e-5.
2. The dtype at every island of the forward: each network's compute dtype
   and result dtype, and the outputs' dtypes, recorded in both packages.
3. One train step of a tiny config (64x64, T=4, the weights of
   ``test_torch_train_step.py``) at step 0, where the ground truth fills
   the canvas, against JAX's jitted ``make_train_step``, with the same
   Hungarian matchings.  The limits are twice the floor of the JAX package
   itself: its jitted step against its step run without ``jit`` (the scan
   compiled alone, the loss op by op), whose largest differences over six
   batches (``python tests/test_torch_bf16.py --floor`` prints them) were
   loss 2.87e-6 relative, all gradients at once 1.35e-4 relative L2, the
   worst leaf 1.65e-3, the updates 3.01e-5 (see ``step_stats``).  On the
   gated batch the port read 3.06e-6, 1.33e-4, 1.65e-3 and 1.42e-5, and
   it stayed within the limits on the four other batches whose matchings
   agree with JAX's (on batch 12 the box matching differs, as a float32
   step's can near a tie).  Its median leaf (1.2e-4 here) is reported, not gated: the floor's
   reached 2.47e-5, as the two JAX steps share every convolution's
   arithmetic and the port does not.  The port's float32 step must fail
   each limit (it read 2.59e-2, 2.12e-2, 0.278 and 6.66e-2).  The
   BatchNorm EMA agree at the float32 step's tolerance (rtol 1e-4, atol
   1e-4 of the leaf's largest): the forward agrees with JAX's to float32
   precision.  Once the model's own masks fill the canvas (a late
   step, or no knob), bfloat16 rounding differences grow through the
   steep output sigmoid as float32 ones do at step 30000 (``chip_smoke.py``
   OWN_CANVAS_LIMITS): the port's and JAX's steps differ there by 0.1 in
   all gradients, not gated.
4. The committed bfloat16 checkpoint
   (``results/full_model_synth1024bf16-r5/ckpt-30000.npz``): ``eval_split``
   over the first 8 images of its regenerated valid split (256 examples,
   seed 4, up to 9 objects), mask threshold 0.40, score threshold 0.50,
   per example against the JAX package's bfloat16 ``eval_split`` on the
   CPU: SBD within 1e-3, counts equal.  A ``slow`` test runs the whole
   split and holds the means to the committed headline
   (``count_calibration.json``: SBD 0.8442 within 0.002, count_acc 0.6875
   within 1/64).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rec_attend_tpu import config as JC
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu.nn import layers as jnn
from rec_attend_tpu.parallel import train_step as JT
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch import train_step as TS
from rec_attend_tpu_torch.models import full_model as TF
from rec_attend_tpu_torch.nn import layers as L
import test_torch_train_step as TT

torch.set_num_threads(1)

BF = jnp.bfloat16
RESULTS = os.path.join(os.path.dirname(__file__), '..', 'results')
BF16_RUN = os.path.join(RESULTS, 'full_model_synth1024bf16-r5')
# The headline of count_calibration.json: mask 0.40, score 0.50.
HEADLINE = {'sbd': 0.8442, 'count_acc': 0.6875}
MASK_THRESHOLD, SCORE_THRESHOLD = 0.4, 0.5
VALID_EXAMPLES = 256

# Layers: the share of elements that may differ, each by one bfloat16
# spacing at most; float32 results' rtol.
ULP_SHARE, F32_RTOL = 0.01, 1e-5
# The train step: twice the floor (module docstring).
STEP_LIMITS = {'loss_rel_diff': 5.8e-6, 'grad_rel_l2_all': 2.7e-4,
               'grad_rel_l2_max': 3.3e-3, 'update_rel_l2_all': 6.0e-5}
STEP_OVER = dict(use_knob=True, remat=True, **TT.AUG)
LR0 = TF.learn_rate(C.tiny_full_config(), 0)
GATED_BATCH = 10
FLOOR_BATCHES = range(10, 16)


def _rand(*shape, seed=0):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(a, dtype=torch.float32):
  return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(
      0, 3, 1, 2)


def _f32(a):
  if torch.is_tensor(a):
    return a.detach().float().numpy()
  return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_bf16_close(got, want, what):
  """Equal, but for at most ULP_SHARE of the elements, each within one
  bfloat16 spacing."""
  got, want = _f32(got), _f32(want)
  assert got.shape == want.shape, what
  diff = np.abs(got - want)
  spacing = np.maximum(np.abs(want), 1e-30) * 2.0 ** -7
  assert (diff <= spacing).all(), (what, float((diff / spacing).max()))
  assert (got != want).mean() <= ULP_SHARE, (what, (got != want).mean())


# ---------------------------------------------------------------------------
# 1. Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('x_dtype', ['float32', 'bfloat16'])
def test_conv2d_and_its_gradients(x_dtype):
  """A float32 x is cast by the convolution, as ``x.astype(bfloat16)``
  before JAX's conv2d; its gradient stays float32, unrounded."""
  x, w, r = _rand(2, 9, 10, 5), _rand(3, 3, 5, 6, seed=1), _rand(
      2, 9, 10, 6, seed=2)
  cast = jnp.float32 if x_dtype == 'float32' else BF

  def jloss(x, w):
    return jnp.sum(jnn.conv2d(x.astype(BF), w).astype(jnp.float32) * r)
  x_in = jnp.asarray(x).astype(cast)
  want = jax.jit(lambda x, w: jnn.conv2d(x.astype(BF), w))(x_in, w)
  gx, gw = jax.jit(jax.grad(jloss, (0, 1)))(x_in, w)
  tx = torch.from_numpy(x).to(getattr(torch, x_dtype)).requires_grad_()
  tw = torch.from_numpy(w).requires_grad_()
  got = L.nhwc(L.conv2d_same(tx.permute(0, 3, 1, 2), tw, torch.bfloat16))
  assert got.dtype == torch.bfloat16
  assert_bf16_close(got, want, 'conv')
  (got.float() * torch.from_numpy(r)).sum().backward()
  assert tx.grad.dtype == tx.dtype and tw.grad.dtype == torch.float32
  assert_bf16_close(tx.grad, gx, 'conv dx')
  np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw),
                             rtol=F32_RTOL, atol=F32_RTOL * np.abs(gw).max())


def test_conv2d_transpose_and_its_gradients():
  """The weight gradient of a transposed convolution is rounded to
  bfloat16, as XLA keeps that cast's round trip."""
  x, w, r = _rand(2, 5, 6, 6), _rand(3, 3, 4, 6, seed=1), _rand(
      2, 10, 12, 4, seed=2)
  xb = jnp.asarray(x).astype(BF)
  want = jax.jit(lambda x, w: jnn.conv2d_transpose(x, w, 2))(xb, w)
  gx, gw = jax.jit(jax.grad(lambda x, w: jnp.sum(jnn.conv2d_transpose(
      x, w, 2).astype(jnp.float32) * r), (0, 1)))(xb, w)
  tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
  tw = torch.from_numpy(w).requires_grad_()
  got = L.nhwc(L.conv2d_transpose_same(tx.permute(0, 3, 1, 2), tw, 2))
  assert_bf16_close(got, want, 'deconv')
  (got.float() * torch.from_numpy(r)).sum().backward()
  assert_bf16_close(tx.grad, gx, 'deconv dx')
  np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw),
                             rtol=F32_RTOL, atol=F32_RTOL * np.abs(gw).max())
  assert (tw.grad.numpy() == _f32(tw.grad.to(torch.bfloat16))).all()


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_batch_norm(train):
  bn = {'beta': _rand(5, seed=4), 'gamma': _rand(5, seed=5) + 2,
        'ema_mean': _rand(5, seed=6), 'ema_var': np.abs(_rand(5, seed=7)) + 1}
  x = _rand(4, 6, 6, 5, seed=8) * 3 + 1
  want, new = jax.jit(lambda x: jnn.apply_batch_norm(x.astype(BF), bn,
                                                     train))(x)
  mod = L.BatchNorm(5, None)
  mod.load_state_dict({k: torch.from_numpy(v) for k, v in bn.items()})
  stats = [] if train else None
  got = L.nhwc(mod(_nchw(x, torch.bfloat16), None, stats))
  assert got.dtype == torch.bfloat16
  assert_bf16_close(got, want, 'bn')
  if train:
    for k, v in zip(('ema_mean', 'ema_var'), stats[0]):
      assert v.dtype == torch.float32
      np.testing.assert_allclose(v.numpy(), np.asarray(new[k]),
                                 rtol=F32_RTOL)


def test_conv_bias_batch_norm_as_compiled():
  """conv + b reaches the BatchNorm unrounded: the compiled JAX program
  fuses the sum with the BatchNorm's cast (rounding it first changes most
  of a layer's outputs)."""
  steps = 3
  params = jax.tree_util.tree_map(lambda a: a * 30.0, jnn.init_cnn(
      jax.random.PRNGKey(0), (3, 3), (4, 6, 8), [True, True],
      num_bn_copies=steps))
  x = _rand(2, 16, 16, 4)
  one = [dict(layer, bn={k: v[1] for k, v in layer['bn'].items()})
         for layer in params]
  want, _ = jax.jit(lambda x: jnn.apply_cnn(one, x.astype(BF), (2, 1),
                                            [jax.nn.relu] * 2, True))(x)
  mod = L.init_cnn((3, 3), (4, 6, 8), [True, True], steps,
                   torch.Generator().manual_seed(0))
  mod.load_state_dict(convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, params)))
  got = L.apply_cnn(mod, _nchw(x), (2, 1), [F.relu] * 2, 1, [],
                    torch.bfloat16)
  for i, (g, w) in enumerate(zip(got, want)):
    assert g.dtype == torch.bfloat16
    assert_bf16_close(L.nhwc(g), w, f'layer {i}')


def test_mlp():
  params = jax.tree_util.tree_map(lambda a: a * 30.0, jnn.init_mlp(
      jax.random.PRNGKey(2), [7, 9, 4]))
  x = _rand(3, 7)
  want = jax.jit(lambda x: jnn.apply_mlp(params, x.astype(BF),
                                         [jax.nn.relu, None]))(x)
  mod = L.init_mlp([7, 9, 4], torch.Generator().manual_seed(0))
  mod.load_state_dict(convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, params)))
  got = L.apply_mlp(mod, torch.from_numpy(x).to(torch.bfloat16),
                    [F.relu, None])
  for i, (g, w) in enumerate(zip(got, want)):
    assert g.dtype == torch.bfloat16
    assert_bf16_close(g, w, f'mlp {i}')


def test_lstm():
  """bfloat16 products, summed with the bias in float32; the state stays
  float32."""
  params = jax.tree_util.tree_map(lambda a: a * 40.0, jnn.init_lstm(
      jax.random.PRNGKey(3), 6, 5))
  mod = L.LSTM(6, 5, torch.Generator().manual_seed(0))
  mod.load_state_dict(convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, params)))
  step = jax.jit(lambda s, x: jnn.apply_lstm(params, x.astype(BF), s)[0])
  state_j, state_t = jnp.zeros((2, 10)), torch.zeros(2, 10)
  for k in range(3):
    x = _rand(2, 6, seed=k)
    state_j = step(state_j, x)
    state_t = mod(torch.from_numpy(x).to(torch.bfloat16), state_t)
    assert state_t.dtype == torch.float32
    np.testing.assert_allclose(state_t.detach().numpy(), np.asarray(state_j),
                               rtol=F32_RTOL, atol=F32_RTOL)


# ---------------------------------------------------------------------------
# 2. The islands
# ---------------------------------------------------------------------------

def _islands(record, monkeypatch, module, names):
  """Wrap module's layer functions ``names``: each call records (name, the
  weight shapes, compute dtype, result dtypes)."""
  for name in names:
    fn = getattr(module, name)

    def wrapped(params, x, *args, _fn=fn, _name=name, **kw):
      out = _fn(params, x, *args, **kw)
      h = out[0] if isinstance(out, tuple) else out
      h = h if isinstance(h, list) else [h]
      dtype = kw.get('dtype') or x.dtype
      shapes = tuple(tuple(p['w'].shape if isinstance(p, dict) else
                           p.w.shape) for p in params)
      record.add((_name, shapes, str(dtype).split('.')[-1],
                  tuple(str(a.dtype).split('.')[-1] for a in h)))
      return out
    monkeypatch.setattr(module, name, wrapped)


def test_dtype_at_every_island(monkeypatch):
  """Each network's compute and result dtypes and the outputs' dtypes of
  the train forward, as JAX's."""
  jcfg = JC.tiny_full_config(dtype='bfloat16', **STEP_OVER)
  cfg = C.tiny_full_config(dtype='bfloat16', **STEP_OVER)
  params = TT._params(jcfg)
  batch = TT._batch(cfg, GATED_BATCH)
  key = jax.random.PRNGKey(90 + GATED_BATCH)
  want, got = set(), set()
  layer_fns = ('apply_cnn', 'apply_dcnn', 'apply_mlp')
  _islands(want, monkeypatch, jnn, layer_fns)
  j_out, _ = JF.full_model_forward(params, batch, jcfg, True, key, 0.0)
  _islands(got, monkeypatch, L, layer_fns)
  model = TT._port_model(cfg, params)
  draws = TT.to_torch(TT.jax_draws(key, jcfg, TT.B))
  glimpse_dtypes = set()

  def recorded(fn, name):
    def call(a, f_y, f_x):
      out = fn(a, f_y, f_x)
      glimpse_dtypes.add((name, str(a.dtype), str(out.dtype)))
      return out
    return call
  from rec_attend_tpu_torch.ops import attention
  with torch.no_grad():
    t_out, _ = TF.full_model_train_forward(
        model, *(torch.from_numpy(batch[k]) for k in ('x', 'y_gt', 's_gt')),
        draws, 0, glimpse=(recorded(attention.extract_patch, 'extract'),
                           recorded(attention.paste_patch, 'paste')))
  # The controller's and attention's convolutions in bfloat16, their MLPs
  # (the LSTM's input is a float32 sum) in float32.
  assert got == want
  assert {(r[0], r[2]) for r in got} == {
      ('apply_cnn', 'bfloat16'), ('apply_dcnn', 'bfloat16'),
      ('apply_mlp', 'float32')}
  for k, v in t_out.items():
    if k in j_out:
      assert str(v.dtype).split('.')[-1] == str(j_out[k].dtype), k
  assert t_out['y_out_patch'].dtype == torch.float32
  assert j_out['x_patch'].dtype == j_out['y_out_patch'].dtype == jnp.float32
  assert glimpse_dtypes == {('extract', 'torch.float32', 'torch.float32'),
                            ('paste', 'torch.float32', 'torch.float32')}


def test_glimpses_refuse_bfloat16():
  """The glimpses stay float32 in the bfloat16 model; a bfloat16 operand
  is refused, not cast."""
  from rec_attend_tpu_torch.ops.cuda import glimpse as gk
  x = torch.rand(1, 16, 16, 2)
  f_y, f_x = torch.rand(1, 16, 4), torch.rand(1, 16, 4)
  for fn, a in ((gk.glimpse_extract, x),
                (gk.glimpse_paste, torch.rand(1, 4, 4, 1))):
    with pytest.raises(TypeError, match='float32'):
      fn(a.to(torch.bfloat16), f_y, f_x)
    with pytest.raises(TypeError, match='float32'):
      fn(a, f_y.to(torch.bfloat16), f_x)


# ---------------------------------------------------------------------------
# 3. The train step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_step(jit):
  jcfg = JC.tiny_full_config(dtype='bfloat16', **STEP_OVER)
  loss_fn = functools.partial(JF.full_model_loss, matcher='native')
  grad_fn = jax.value_and_grad(
      lambda p, b, k, s: loss_fn(p, b, jcfg, True, k, s), has_aux=True)
  step_fn, tx = JT.make_train_step(loss_fn, jcfg, jit=False)

  def both(p, o, b, k, s):
    return grad_fn(p, b, k, s), step_fn(p, o, b, k, s)
  return (jax.jit(both) if jit else both), tx


def jax_step(seed, jit=True):
  """(loss, grads, new params, old params, matchings) of JAX's bfloat16
  step on batch ``seed``, each as numpy."""
  jcfg = JC.tiny_full_config(dtype='bfloat16', **STEP_OVER)
  fn, tx = _jax_step(jit)
  params = TT._params(jcfg)
  batch = TT._batch(C.tiny_full_config(**STEP_OVER), seed)
  ((loss, aux), grads), (new, _, _) = fn(
      params, tx.init(params), batch, jax.random.PRNGKey(90 + seed),
      jnp.float32(0))
  return (float(loss), TT._flat(grads), TT._flat(new),
          TT._flat(jax.tree_util.tree_map(np.asarray, params)),
          {k: np.asarray(aux[k]) for k in ('match', 'match_box')})


def port_step(seed, dtype):
  """The same for the port's step with ``dtype`` (no old parameters),
  from the same parameters, batch and draws."""
  jcfg = JC.tiny_full_config(dtype='bfloat16', **STEP_OVER)
  cfg = C.tiny_full_config(dtype=dtype, **STEP_OVER)
  model = TT._port_model(cfg, TT._params(jcfg))
  batch = {k: torch.from_numpy(v) for k, v in
           TT._batch(cfg, seed).items()}
  draws = TT.to_torch(TT.jax_draws(jax.random.PRNGKey(90 + seed), jcfg,
                                   TT.B))
  loss, aux, grads = TS.loss_and_grads(model, batch, draws, 0)
  TS.train_step(model, TS.init_opt_state(model), batch, draws, 0)
  return (float(loss.detach()), {k: v.numpy() for k, v in grads.items()},
          {k: v.detach().numpy() for k, v in model.state_dict().items()},
          None, {k: aux[k].numpy() for k in ('match', 'match_box')})


def step_stats(got, want, old):
  """The statistics STEP_LIMITS names, of step ``got`` (loss, grads, new
  params) against ``want``, from parameters ``old``; the conv biases
  that a train-mode BatchNorm follows, whose gradient is float32 noise
  around 0, are left out, and so are the EMA statistics, compared on
  their own.  Adam's first step moves an element by about lr times the
  sign of its gradient: 'update_rel_l2_all' compares the updates of the
  elements whose gradient exceeds 1e-2 of its leaf's largest (a smaller
  one may change sign with a gradient difference at the floor), and
  'update_in_lr_max' the largest update difference of any element, in
  units of lr."""
  loss, grads, new = got[:3]
  loss_ref, grads_ref, new_ref = want[:3]
  live = [k for k in grads if not (k.endswith('.b')
                                   and k[:-2] + '.bn.beta' in grads)]

  def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

  def cat(d, keys):
    return np.concatenate([np.ravel(d[k]) for k in keys])
  per_leaf = {k: rel(grads[k], grads_ref[k]) for k in live}
  worst = max(per_leaf, key=per_leaf.get)
  big = cat({k: np.abs(g) > 1e-2 * np.abs(g).max()
             for k, g in grads_ref.items()}, live)
  step, step_ref = (cat(new, live) - cat(old, live),
                    cat(new_ref, live) - cat(old, live))
  return {
      'loss_rel_diff': abs(loss - loss_ref) / abs(loss_ref),
      'grad_rel_l2_all': rel(cat(grads, live), cat(grads_ref, live)),
      'grad_rel_l2_max': per_leaf[worst], 'worst_leaf': worst,
      'grad_rel_l2_median': float(np.median(list(per_leaf.values()))),
      'update_rel_l2_all': rel(step[big], step_ref[big]),
      'update_in_lr_max': float(np.abs(step - step_ref).max() / LR0),
      'matches_agree': all((got[4][k] == want[4][k]).all()
                           for k in ('match', 'match_box'))}


def failures(stats):
  return [k for k, limit in STEP_LIMITS.items() if stats[k] > limit]


def test_train_step_matches_jax_at_its_floor():
  want = jax_step(GATED_BATCH)
  got = port_step(GATED_BATCH, 'bfloat16')
  stats = step_stats(got, want, want[3])
  assert stats['matches_agree'], stats
  assert not failures(stats), stats
  for k, v in want[2].items():
    if k.endswith(('ema_mean', 'ema_var')):
      TT._close(got[2][k], v, 1e-4, k)
  control = step_stats(port_step(GATED_BATCH, 'float32'), want, want[3])
  assert sorted(failures(control)) == sorted(STEP_LIMITS), control


def floor_main():
  """Print, per batch, the JAX package's jitted bfloat16 step against its
  step without jit (the floor), the port's against the jitted one, and
  the port's float32 step against it (the control)."""
  for seed in FLOOR_BATCHES:
    want = jax_step(seed)
    pairs = {'jax_eager_vs_jit': jax_step(seed, jit=False),
             'port_vs_jit': port_step(seed, 'bfloat16'),
             'port_float32_vs_jit': port_step(seed, 'float32')}
    for name, got in pairs.items():
      stats = step_stats(got, want, want[3])
      print(seed, name, ' '.join(
          f'{k} {v:.3g}' if isinstance(v, float) else f'{k} {v}'
          for k, v in stats.items()), flush=True)


# ---------------------------------------------------------------------------
# 4. The committed bfloat16 checkpoint
# ---------------------------------------------------------------------------

def _jax_eval(ds, out, batch_size):
  import yaml
  from rec_attend_tpu.cli import eval as jeval
  from rec_attend_tpu.engine.experiment import EvalExperiment
  with open(os.path.join(BF16_RUN, 'model_opt.yaml')) as f:
    cfg = JC.FullModelConfig.from_dict(yaml.safe_load(f))
  assert cfg.dtype == 'bfloat16'
  train_cfg = JC.TrainConfig(restore=BF16_RUN, batch_size=batch_size,
                             results=RESULTS)
  data_cfg = JC.DataConfig(dataset='synth', folder=os.path.dirname(out),
                           height=224, width=224, timespan=21)
  exp = EvalExperiment('full', cfg.replace(use_knob=False), train_cfg,
                       data_cfg, splits=['valid'])
  exp.get_dataset = lambda split: ds
  jeval.eval_split(exp, 'valid', out, [MASK_THRESHOLD], ['sbd', 'dic'],
                   render_output=False, batch_size=batch_size,
                   score_threshold=SCORE_THRESHOLD)


def _port_eval(ds, out, batch_size, analyzers=('sbd', 'dic')):
  from rec_attend_tpu_torch.cli import eval as teval
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from test_torch_eval import PortView
  exp = EvalExperiment(BF16_RUN, device='cpu')
  assert exp.cfg.dtype == 'bfloat16' and exp.step == 30000
  summary = teval.eval_split(exp, PortView(ds), out, [MASK_THRESHOLD],
                             list(analyzers), batch_size=batch_size,
                             score_threshold=SCORE_THRESHOLD)
  return {k.split()[0]: v[0] for k, v in summary[MASK_THRESHOLD].items()}


def _valid_split(path, n):
  """The bfloat16 run's valid split (its data_opt.yaml: 1024 examples, so
  256 in valid, seed 4, up to 9 objects); example i does not depend on
  n."""
  from rec_attend_tpu.data.synthetic import make_synthetic_h5
  return make_synthetic_h5(path, height=224, width=224, num_examples=n,
                           seed=4, max_objects=9)


def test_bf16_checkpoint_eval_matches_jax_per_example(tmp_path):
  from test_torch_eval import _scores
  ds = _valid_split(str(tmp_path / 'valid_224x224.h5'), 8)
  _port_eval(ds, str(tmp_path / 'port'), 8)
  _jax_eval(ds, str(tmp_path / 'jax'), 8)
  got, want = ({n: _scores(str(tmp_path / side / f'{n}.csv'))
                for n in ('sbd', 'dic')} for side in ('port', 'jax'))
  ids = [k for k in want['sbd'] if k.startswith('synth')]
  assert len(ids) == 8
  for k in ids:
    assert abs(got['sbd'][k] - want['sbd'][k]) <= 1e-3, (
        k, got['sbd'][k], want['sbd'][k])
    assert got['dic'][k] == want['dic'][k], k
  assert max(want['sbd'][k] for k in ids) > 0.5       # masks were found


@pytest.mark.slow
def test_bf16_headline_on_its_valid_split(tmp_path):
  from rec_attend_tpu_torch.cli.eval import DEFAULT_ANALYZERS
  ds = _valid_split(str(tmp_path / 'valid_224x224.h5'), VALID_EXAMPLES)
  means = _port_eval(ds, str(tmp_path / 'port'), 32, DEFAULT_ANALYZERS)
  print('bf16 valid split means', means)
  assert abs(means['sbd'] - HEADLINE['sbd']) <= 0.002, means
  assert abs(means['count_acc'] - HEADLINE['count_acc']) <= 1 / 64, means


def test_eval_command_line_runs_the_bf16_islands(tmp_path, monkeypatch):
  """The eval command line on the bfloat16 folder reads ``dtype`` from its
  model_opt.yaml (there is no flag, as in JAX) and runs the convolutions
  in bfloat16."""
  from rec_attend_tpu_torch.cli import eval as eval_cli
  dtypes = set()
  conv = L._conv

  def recorded(x, weight, stride, padding, transposed, dtype):
    dtypes.add(dtype)
    return conv(x, weight, stride, padding, transposed, dtype)
  monkeypatch.setattr(L, '_conv', recorded)
  out = tmp_path / 'out'
  exp = eval_cli.full_main(
      ['--results', RESULTS, '--model_id', os.path.basename(BF16_RUN),
       '--dataset', 'synth', '--split', 'valid', '--dataset_folder',
       str(tmp_path / 'data'), '--data_examples', '32', '--output',
       str(out), '--batch_size', '2', '--max_batches', '1',
       '--threshold_list', str(MASK_THRESHOLD), '--analyzers', 'sbd',
       '--score_threshold', str(SCORE_THRESHOLD)], device='cpu')
  assert exp.cfg.dtype == 'bfloat16'
  assert dtypes == {torch.bfloat16}
  assert (out / 'sbd.csv').read_text().count('synth') == 2


if __name__ == '__main__' and sys.argv[1:] == ['--floor']:
  floor_main()
