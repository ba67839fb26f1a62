"""The KITTI-shaped three-stage chain through the port: the full model's
packed input channels, and fg -> pack -> full -> eval_split against the
JAX package.

1. The KITTI full preset equals the synth3 folder's ``model_opt.yaml``.
2. The augmentation crops the packed maps at the image's offset, as JAX's
   ``random_transformation`` does, and refuses flips with them.
3. The synth3 full checkpoint's eval forward at b2 against JAX's, with the
   same d_in/y_in: the fg model's packed maps of the first two examples of
   the synth3 valid split, held by the flagship criterion of
   ``test_torch_full_model.py`` (mean |dy| < 1e-5, under 1e-3 of the
   pixels beyond 1e-3, |ds| <= 1e-4; measured 2.8e-7, 4.4e-6, 2.0e-6).
   Seeded uniform maps too, held at the first timestep (every output at
   rtol 1e-4 / atol 1e-4 of its scale): such noise is far outside what the
   model was trained on, and its 20 feedbacks grow the float32 differences
   of XLA's and oneDNN's convolutions (1e-5 of the glimpse at t=0) into a
   mean |dy| of 2.3e-5 by the last step.  A wrong channel order moves the
   first timestep by far more.
4. A tiny train step with packed channels (crop offset drawn by JAX, no
   flips) against JAX's ``make_train_step``, as ``test_torch_train_step.py``
   compares them.
5. The chain on the first 64 examples of the synth3 valid split (JAX's
   ``provider.py`` split: seed 4, up to 12 objects, 128x448), mask
   threshold 0.40 and score threshold 0.15: each example's SBD within 1e-3,
   and its count, of the committed ``output_valid_calibrated/*_40.csv`` or,
   where it differs from them, of the JAX package's chain on the CPU for
   that id (JAX fg forward, ``pack_predictions`` into the split's H5 file,
   JAX ``eval_split``).  The CSVs were written on another device; on the
   CPU 39 of the 64 examples differ from them, and the port agrees with the
   JAX chain there to 5e-4.  About three minutes on one thread.
   Where float32 noise in the fg maps packs to a neighbouring byte and that
   moves an example past 1e-3, the example is held to the JAX full model's
   eval of the port's own bytes (see ``_chain``).
6. ``slow``: the whole split, 256 examples, each held as in 5, and SBD
   within 0.002 of the headline's 0.6341; the headline's count_acc is the
   TPU's and is not held (see the test).
"""

import csv
import dataclasses
import os

import h5py
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from rec_attend_tpu import config as JC
from rec_attend_tpu.cli import eval as jeval
from rec_attend_tpu.data.assembler import png_encode
from rec_attend_tpu.data.dataset import pack_predictions
from rec_attend_tpu.data.synthetic import make_synthetic_h5
from rec_attend_tpu.engine.experiment import EvalExperiment as JEvalExperiment
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu.ops import image_ops as jimage_ops
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch import train_step as TS
from rec_attend_tpu_torch.cli import eval as teval
from rec_attend_tpu_torch.cli import pack
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.engine.experiment import EvalExperiment
from rec_attend_tpu_torch.models import full_model as TF
from rec_attend_tpu_torch.ops import image_ops
from test_torch_train_step import _assert_updates_agree
from test_torch_train_step import _close
from test_torch_train_step import _flat
from test_torch_train_step import _zero_grad_leaves
from test_torch_train_step import jax_draws
from test_torch_train_step import to_torch

torch.set_num_threads(1)

RESULTS = os.path.join(os.path.dirname(__file__), '..', 'results')
FG = os.path.join(RESULTS, 'fg_model_synth3-20260818a')
FULL = os.path.join(RESULTS, 'full_model_synth3-20260818a')
HEADLINE_CSVS = os.path.join(FULL, 'output_valid_calibrated')
MASK_THRESHOLD, SCORE_THRESHOLD = 0.4, 0.15
T, H, W = 20, 128, 448


class PortView:
  """A JAX package dataset seen through the port's dataset interface."""

  def __init__(self, ds):
    self.ds = ds

  def get_dataset_size(self):
    return self.ds.get_dataset_size()

  def get_batch(self, idx, timespan=None):
    return self.ds.get_batch(idx, timespan=timespan,
                             variables={'x', 's_gt', 'idx_map'})

  def get_full_size_labels(self, ids, timespan=None):
    return self.ds.get_full_size_labels(ids, timespan=timespan)


def _synth3_valid(folder, n):
  """The first n examples of the synth3 valid split (each example is drawn
  from its own seed, so they are those of the 256-example split)."""
  return make_synthetic_h5(os.path.join(folder, f'valid_{H}x{W}.h5'),
                           height=H, width=W, num_examples=n, seed=4,
                           max_objects=12)


def test_kitti_preset_matches_the_synth3_folder():
  want = C.FullModelConfig.from_yaml(os.path.join(FULL, 'model_opt.yaml'))
  got = C.kitti_full_config()
  for name in C.FORWARD_FIELDS:
    assert getattr(got, name) == getattr(want, name), name
  jcfg = JC.kitti_full_config()
  assert dataclasses.asdict(got) == dataclasses.asdict(
      C.FullModelConfig.from_dict(jcfg.to_dict()))
  assert got.ccnn_inp_depth == got.acnn_inp_depth == 3 + 1 + 8 + 1


def test_packed_maps_take_the_crop_of_the_image():
  rng = np.random.RandomState(0)
  x = rng.rand(2, 20, 24, 3).astype(np.float32)
  y = (rng.rand(2, 3, 20, 24) > 0.5).astype(np.float32)
  d = rng.rand(2, 20, 24, 8).astype(np.float32)
  c = rng.rand(2, 20, 24, 1).astype(np.float32)
  key = jax.random.PRNGKey(3)
  want = jimage_ops.random_transformation(
      key, x, 4, True, rnd_hflip=False, rnd_vflip=False,
      rnd_transpose=False, y=y, d=d, c=c)
  k_off = jax.random.split(key, 8)[0]   # JAX image_ops.py:130
  off = np.asarray(jax.random.randint(k_off, (2,), 0, 8))
  assert tuple(off) != (4, 4)   # not the centre crop
  draws = {'offset': (int(off[0]), int(off[1])), 'hflip': True,
           'vflip': True, 'transpose': True}
  got = image_ops.random_transformation(
      torch.from_numpy(x), 4, draws, rnd_hflip=False, rnd_vflip=False,
      rnd_transpose=False, y=torch.from_numpy(y), d=torch.from_numpy(d),
      c=torch.from_numpy(c))
  for k in ('x', 'y', 'd', 'c'):
    np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                  err_msg=k)
  with pytest.raises(ValueError, match='flips'):
    image_ops.random_transformation(torch.from_numpy(x), 4, draws,
                                    rnd_hflip=True, rnd_vflip=False,
                                    rnd_transpose=False,
                                    d=torch.from_numpy(d))


def _synth3_models():
  """(port FullModel, JAX params, JAX config) of the synth3 checkpoint."""
  cfg = C.kitti_full_config().replace(use_knob=False)
  jcfg = JC.kitti_full_config().replace(use_knob=False)
  state = convert.params_from_checkpoint(saver.latest_checkpoint(FULL), cfg)
  params = JF.init_full_model(jax.random.PRNGKey(0), jcfg)
  names = [jax.tree_util.keystr(p, simple=True, separator='.')
           for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
  params = jax.tree_util.tree_unflatten(
      jax.tree_util.tree_structure(params), [state[n].numpy() for n in names])
  model = TF.FullModel(cfg, device='cpu')
  model.load_state_dict(state)
  return model, params, jcfg


def _jax_forward(params, jcfg, x, d, y):
  b = x.shape[0]
  batch = {'x': x, 'd_in': d, 'y_in': y,
           'y_gt': np.zeros((b, T, H, W), np.float32),
           's_gt': np.zeros((b, T), np.float32)}
  out, _ = jax.jit(lambda p, bt: JF.full_model_forward(
      p, bt, jcfg, False, jax.random.PRNGKey(1)))(params, batch)
  return {k: np.asarray(v) for k, v in out.items()}


def test_synth3_forward_matches_jax(tmp_path):
  model, params, jcfg = _synth3_models()
  ds = _synth3_valid(str(tmp_path), 2)
  fg = EvalExperiment(FG, device='cpu', spec='fg')
  batch = pack.pack_fg(fg, PortView(ds), 2).get_batch([0, 1], timespan=T)
  x, d, y = batch['x'], batch['d_out'], batch['y_out']
  want = _jax_forward(params, jcfg, x, d, y)
  got = TF.full_model_forward(model, *(torch.from_numpy(a)
                                       for a in (x, d, y)))
  dy = np.abs(got['y_out'].numpy() - want['y_out'])
  assert dy.mean() < 1e-5, dy.mean()
  assert (dy > 1e-3).mean() < 1e-3, (dy > 1e-3).mean()
  np.testing.assert_allclose(got['s_out'].numpy(), want['s_out'], atol=1e-4,
                             rtol=0)
  # The model finds several objects in each image.
  assert ((want['s_out'] > SCORE_THRESHOLD).sum(axis=1) >= 3).all()

  # Seeded uniform maps, at the first timestep.
  rng = np.random.RandomState(0)
  d = rng.rand(2, H, W, 8).astype(np.float32)
  y = rng.rand(2, H, W, 1).astype(np.float32)
  want = _jax_forward(params, jcfg, x, d, y)
  got = TF.full_model_forward(model, *(torch.from_numpy(a)
                                       for a in (x, d, y)))
  for k in ('y_out', 's_out', 'y_out_patch', 'attn_box', 'attn_ctr',
            'attn_size', 'attn_ctr_norm', 'attn_lg_size', 'attn_lg_gamma',
            'attn_box_lg_gamma', 'y_out_lg_gamma'):
    scale = max(1.0, float(np.abs(want[k][:, 0]).max()))
    np.testing.assert_allclose(got[k][:, 0].numpy(), want[k][:, 0],
                               rtol=1e-4, atol=1e-4 * scale, err_msg=k)


def test_forward_refuses_missing_or_misshapen_maps():
  cfg = C.tiny_full_config(add_d_out=True, add_y_out=True)
  model = TF.FullModel(cfg, device='cpu')
  x = torch.zeros(1, 64, 64, 3)
  d, y = torch.zeros(1, 64, 64, 8), torch.zeros(1, 64, 64, 1)
  assert model(x, d, y)['y_out'].shape == (1, cfg.timespan, 64, 64)
  with pytest.raises(ValueError, match='d_in is missing'):
    model(x, None, y)
  with pytest.raises(ValueError, match='y_in is'):
    model(x, d, torch.zeros(1, 64, 64, 2))
  plain = TF.FullModel(C.tiny_full_config(), device='cpu')
  with pytest.raises(ValueError, match='d_in is given'):
    plain(x, d, None)


# ---------------------------------------------------------------------------
# Train step with packed channels
# ---------------------------------------------------------------------------

B = 2
STEP_VARIANTS = {
    # The reference default rules: the controller takes d and y, not the
    # image and canvas; the attention net takes all four.
    'default_flags': dict(add_d_out=True, add_y_out=True),
    # The KITTI preset's flags: all four into both nets.
    'kitti_flags': dict(add_d_out=True, add_y_out=True, ctrl_add_inp=True,
                        ctrl_add_canvas=True, dynamic_var=True,
                        fixed_gamma=False, squash_ctrl_params=False),
}


def _step_batch(cfg, seed):
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
  logits = rng.randn(B, h, w, 8).astype(np.float32) * 2
  d_in = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
  y_in = np.clip(y.max(axis=1)[..., None] * 0.8
                 + rng.rand(B, h, w, 1) * 0.2, 0, 1).astype(np.float32)
  return {'x': x, 'y_gt': y, 's_gt': s, 'd_in': d_in.astype(np.float32),
          'y_in': y_in}


@pytest.mark.parametrize('variant', sorted(STEP_VARIANTS))
def test_packed_train_step_matches_jax(variant):
  from rec_attend_tpu.parallel import train_step as JT
  over = dict(STEP_VARIANTS[variant], use_knob=True, remat=True)
  jcfg, cfg = JC.tiny_full_config(**over), C.tiny_full_config(**over)
  rng = np.random.RandomState(0)
  params = JF.init_full_model(jax.random.PRNGKey(0), jcfg)
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) * (1 + 10 * rng.rand(*a.shape)).astype(
          np.float32) if a.ndim >= 2 else np.asarray(a), params)
  loss_fn = JF.full_model_loss
  grad_fn = jax.value_and_grad(
      lambda p, b, k, s: loss_fn(p, b, jcfg, True, k, s), has_aux=True)
  step_fn, tx = JT.make_train_step(loss_fn, jcfg, jit=False)
  jax_fn = jax.jit(lambda p, o, b, k, s: (grad_fn(p, b, k, s),
                                          step_fn(p, o, b, k, s)))
  opt_state = tx.init(params)
  model = TF.FullModel(cfg, device='cpu')
  model.load_state_dict(convert.params_from_jax(params))
  assert cfg.acnn_inp_depth == 13
  zero = _zero_grad_leaves(model)
  batch = _step_batch(cfg, seed=10)
  key = jax.random.PRNGKey(100)
  draws = to_torch(jax_draws(key, jcfg, B))
  assert draws['aug']['offset'] != (cfg.padding, cfg.padding)
  tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

  ((j_loss, j_aux), j_grads), (j_params, _, j_metrics) = jax_fn(
      params, opt_state, batch, key, jnp.asarray(0.0, jnp.float32))
  loss, aux, grads = TS.loss_and_grads(model, tbatch, draws, 0)
  np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-4,
                             atol=1e-5)
  for k in TF.METRIC_KEYS:
    np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-4,
                               atol=1e-5, err_msg=k)
  np.testing.assert_array_equal(aux['match'].numpy(),
                                np.asarray(j_aux['match']))
  j_grads = _flat(j_grads)
  for k, g in grads.items():
    g = g.numpy()
    if k in zero:
      limit = 1e-4 * float(np.abs(j_grads[zero[k]]).max())
      assert np.abs(g).max() <= limit, k
      assert np.abs(j_grads[k]).max() <= limit, k
    else:
      _close(g, j_grads[k], 1e-3, f'grad {k}')
  # The packed channels' weights of both CNNs' first layers move.
  for net in ('ctrl_cnn', 'attn_cnn'):
    assert np.abs(grads[f'{net}.0.w'].numpy()[:, :, -9:]).max() > 0, net

  old = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
  _, metrics = TS.train_step(model, TS.init_opt_state(model), tbatch, draws,
                             0)
  np.testing.assert_allclose(float(metrics['loss']), float(j_metrics['loss']),
                             rtol=1e-4, atol=1e-5)
  new_jax = _flat(j_params)
  new_port = {k: v.detach().numpy() for k, v in model.state_dict().items()}
  for k in new_jax:
    if k.endswith(('ema_mean', 'ema_var')):
      _close(new_port[k], new_jax[k], 1e-4, k)
  _assert_updates_agree(old, new_port, new_jax, j_grads, zero,
                        TF.learn_rate(cfg, 0), variant)


# ---------------------------------------------------------------------------
# The chain: fg -> pack -> full -> eval_split
# ---------------------------------------------------------------------------

class Subset:
  """The examples of a JAX package dataset with the given ids."""

  def __init__(self, ds, ids):
    self.ds = ds
    self.pos = np.array([list(ds.img_ids).index(i) for i in ids])
    self.img_ids = ds.img_ids[self.pos]
    self.h5_fname = ds.h5_fname

  def get_dataset_size(self):
    return len(self.pos)

  def get_batch(self, idx, timespan=None, variables=None):
    return self.ds.get_batch(self.pos[np.asarray(idx)], timespan=timespan,
                             variables=variables)

  def get_full_size_labels(self, ids, timespan=None):
    return self.ds.get_full_size_labels(ids, timespan=timespan)

  def get_str_id(self, idx):
    return self.ds.get_str_id(idx)


def _scores(path):
  with open(path) as f:
    return {r[0]: float(r[1]) for r in list(csv.reader(f))[1:]}


def _jax_experiment(spec, folder, cfg_class, ds, ids, data_folder):
  cfg = cfg_class.from_dict(yaml.safe_load(open(os.path.join(
      folder, 'model_opt.yaml'))))
  if spec == 'full':
    cfg = cfg.replace(use_knob=False)
  train_cfg = JC.TrainConfig(restore=folder, batch_size=8,
                             results=os.path.dirname(folder))
  data_cfg = JC.DataConfig(dataset='synth', folder=data_folder, height=H,
                           width=W, timespan=T)
  exp = JEvalExperiment(spec, cfg, train_cfg, data_cfg, splits=['valid'])
  exp.get_dataset = lambda split: Subset(ds, ids)
  return exp


def _jax_full_eval(ds, ids, out):
  """The JAX package's eval_split of the full model on the CPU over the
  examples ids, reading the packed maps in the split's H5 file."""
  full = _jax_experiment('full', FULL, JC.FullModelConfig, ds, ids,
                         os.path.dirname(out))
  jeval.eval_split(full, 'valid', out, [MASK_THRESHOLD], ['sbd', 'dic'],
                   render_output=False, batch_size=8,
                   score_threshold=SCORE_THRESHOLD)
  return _scores(os.path.join(out, 'sbd.csv')), _scores(
      os.path.join(out, 'dic.csv'))


def _jax_chain(ds, ids, out):
  """The JAX package's chain on the CPU over the examples ids: the fg
  forward, pack_predictions into the split's H5 file (as its pack CLI,
  ``cli/pack.py:fg_main``), and eval_split of the full model."""
  fg = _jax_experiment('fg', FG, JC.FGModelConfig, ds, ids,
                       os.path.dirname(out))
  for _, raw, outputs in fg.iterate_split('valid'):
    for i, sid in enumerate(raw['idx_map']):
      pack_predictions(ds.h5_fname, sid, foreground=outputs['y_out'][i],
                       orientation=outputs['d_out'][i])
  ds.clear_cache()
  return _jax_full_eval(ds, ids, out)


def _h5_bytes(ds, ids):
  """The uint8 maps the JAX pack wrote for the examples ids, [n,H,W,9]."""
  pos = [list(ds.img_ids).index(k) for k in ids]
  got = ds.get_batch(np.array(pos), timespan=T, variables={'d_out', 'y_out'})
  maps = np.concatenate([got['d_out'], got['y_out']], axis=-1)
  return np.rint(maps * 255).astype(np.int32)


def _write_bytes(ds, ids, maps):
  """Write [n,H,W,9] uint8 maps into the H5 file, as pack_predictions lays
  them out (its PNG encoder, without its quantisation)."""
  with h5py.File(ds.h5_fname, 'a') as h5f:
    for k, m in zip(ids, maps):
      group = h5f[k]
      for key, a in ([(f'orientation_pred/{o:02d}', m[..., o])
                      for o in range(8)]
                     + [('foreground_pred/00', m[..., 8])]):
        if key in group:
          del group[key]
        group[key] = png_encode(np.ascontiguousarray(a, dtype=np.uint8))
  ds.clear_cache()


def _chain(tmp_path, n):
  """The port's chain over the first n examples of the synth3 valid split.

  Each example is held (SBD within 1e-3, count equal) to the committed
  CSVs or, where it differs from them, to the JAX chain on the CPU.  The
  fg maps of the two packages differ by float32 noise (4e-6), so a value
  next to a step of 1/255 packs to the neighbouring byte; through the full
  model's 20 feedbacks a few such bytes can move an example's SBD past
  1e-3 (synth0071: 14 bytes, 2.1e-3).  Where that happens, the port's
  bytes must be within one step of the JAX pack's, in at most 1e-4 of the
  values, and the example is held to the JAX full model's eval of the
  port's own bytes.  Returns the port's means."""
  ds = _synth3_valid(str(tmp_path), n)
  fg = EvalExperiment(FG, device='cpu', spec='fg')
  assert fg.step == 3000
  packed = pack.pack_fg(fg, PortView(ds), batch_size=8)
  exp = EvalExperiment(FULL, device='cpu')
  assert exp.step == 30000 and not exp.cfg.use_knob
  out = str(tmp_path / 'port')
  summary = teval.eval_split(exp, packed, out, [MASK_THRESHOLD],
                             teval.DEFAULT_ANALYZERS, batch_size=8,
                             score_threshold=SCORE_THRESHOLD)
  means = {k.split()[0]: v[0] for k, v in summary[MASK_THRESHOLD].items()}
  for name in teval.DEFAULT_ANALYZERS:
    assert np.isfinite(means[name]), name
  sbd, dic = (_scores(os.path.join(out, f'{k}.csv')) for k in ('sbd', 'dic'))
  ref_sbd, ref_dic = (_scores(os.path.join(HEADLINE_CSVS, f'{k}_40.csv'))
                      for k in ('sbd', 'dic'))
  ids = sorted(k for k in sbd if k.startswith('synth'))
  assert ids == [f'synth{i:04d}' for i in range(n)]

  def far(want_sbd, want_dic, keys):
    return [k for k in keys
            if abs(sbd[k] - want_sbd[k]) > 1e-3 or dic[k] != want_dic[k]]
  differ = far(ref_sbd, ref_dic, ids)
  if differ:
    jax_sbd, jax_dic = _jax_chain(ds, differ, str(tmp_path / 'jax'))
    noisy = far(jax_sbd, jax_dic, differ)
    if noisy:
      pos = [list(ds.img_ids).index(k) for k in noisy]
      port_bytes = np.concatenate([packed.d_out[pos], packed.y_out[pos]],
                                  axis=-1).astype(np.int32)
      step = np.abs(port_bytes - _h5_bytes(ds, noisy))
      assert step.max() <= 1 and (step > 0).mean() <= 1e-4, (
          noisy, step.max(), (step > 0).mean())
      _write_bytes(ds, noisy, port_bytes)
      own_sbd, own_dic = _jax_full_eval(ds, noisy,
                                        str(tmp_path / 'jax_port_bytes'))
      assert not far(own_sbd, own_dic, noisy), [
          (k, sbd[k], own_sbd[k], jax_sbd[k], dic[k], own_dic[k])
          for k in noisy]
  return means


def test_synth3_chain_on_the_first_64_valid_examples(tmp_path):
  _chain(tmp_path, 64)


@pytest.mark.slow
def test_synth3_chain_headline_on_the_whole_valid_split(tmp_path):
  """The whole split: each example held as in the subset, and SBD within
  0.002 of the committed headline 0.6341 (measured 0.6340).  The committed
  count_acc, 0.5078 (130 of 256), is not held: it is the TPU's.  In 21 of
  the 147 examples where the port differs from the committed CSVs, the JAX
  chain on the CPU counts as the port does, and the port's count_acc is
  0.4961 (127 of 256), 3/256 below the headline."""
  means = _chain(tmp_path, 256)
  assert abs(means['sbd'] - 0.6341) <= 0.002, means['sbd']
