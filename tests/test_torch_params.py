"""The port's named weights (``nn/params.py``), its ``load_pretrained`` of
the full and box models and ``cli/read_weights.py`` against the JAX
package's, on the same files and folders.  h5py is JAX's reader here only.

4. ``export_weights_h5`` of the same parameters (a tiny full model's, JAX
   initialised, carried over by ``convert``) writes the keys and arrays of
   JAX ``export_weights_h5``, bit for bit; JAX ``load_net_h5`` reads the
   port's file to the arrays it reads from its own.  A single-copy
   BatchNorm is written as copy 0 and read back as one copy.
5. ``load_net_h5`` (each net, each file, with and without the CNN prefix
   sniff), ``merge_pretrained`` and the full model's ``load_pretrained``
   equal JAX's in every leaf (``array_equal``), for ``pretrain_ctrl_net``
   (the flagship's, synth3's and synthcs's committed box files),
   ``pretrain_attn_net`` and ``pretrain_net`` (full ``weights.h5`` files
   that JAX's ``read_weights.full_main`` writes from the flagship's and
   synth1024's ``ckpt-30000`` into a temporary folder).
6. The box model's ``pretrain_cnn`` (the CNN under ``attn_cnn``, ``cnn``
   and ``ctrl_cnn`` keys: each prefix of the sniff) and ``pretrain_net``
   with ``freeze_pretrain_cnn``: the loaded parameters equal JAX's, and
   one tiny train step matches JAX's ``make_train_step`` with its freeze
   mask at ``test_torch_train_step.py``'s tolerances, ``ctrl_cnn``'s
   parameters unchanged on both sides.
7. ``read_weights.box_main`` and ``full_main`` write the keys and arrays of
   JAX's on the same committed folders.
"""

import functools
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rec_attend_tpu import config as JC
from rec_attend_tpu.cli import read_weights as JR
from rec_attend_tpu.models import box_model as JB
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu.nn import layers as JL
from rec_attend_tpu.nn import params as JP
from rec_attend_tpu.parallel import train_step as JT
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch import train_step as TS
from rec_attend_tpu_torch.cli import read_weights as TR
from rec_attend_tpu_torch.engine.trainer import Trainer
from rec_attend_tpu_torch.models import box_model as TB
from rec_attend_tpu_torch.models import full_model as TF
from rec_attend_tpu_torch.nn import params as P
from rec_attend_tpu_torch.utils import h5
from test_torch_box_model import B
from test_torch_box_model import _batch
from test_torch_box_model import SCALE
from test_torch_box_model import box_jax_draws
from test_torch_train_step import _assert_updates_agree
from test_torch_train_step import _close
from test_torch_train_step import _flat
from test_torch_train_step import _zero_grad_leaves

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
RESULTS = os.path.join(REPO, 'results')
FLAGSHIP = 'full_model_synth-20260816104712'
SYNTH1024 = 'full_model_synth1024-20260816'
BOXES = {'flagship': 'box_model_synth-20260816104712',
         'synth3': 'box_model_synth3-20260818a',
         'synthcs': 'box_model_synthcs-20260818a'}
# The full model each box's controller starts.
BOX_FULL = {'flagship': FLAGSHIP, 'synth3': 'full_model_synth3-20260818a',
            'synthcs': 'full_model_synthcs-20260818a'}
FULL_NETS = ('ctrl_cnn', 'ctrl_mlp', 'glimpse_mlp', 'score_mlp', 'ctrl_lstm',
             'attn_cnn', 'attn_dcnn')


def _box_h5(name):
  return os.path.join(RESULTS, BOXES[name], 'weights.h5')


def _configs(folder, **replace):
  """The JAX and the port's FullModelConfig of a committed folder."""
  with open(os.path.join(RESULTS, folder, 'model_opt.yaml')) as f:
    opt = yaml.safe_load(f)
  opt.update({'pretrain_ctrl_net': None, 'pretrain_attn_net': None,
              'pretrain_net': None, **replace})
  return JC.FullModelConfig.from_dict(opt), C.FullModelConfig.from_dict(opt)


def _h5py_read(path):
  with h5py.File(path, 'r') as f:
    return {k: np.asarray(f[k][()]) for k in f.keys()}


def _assert_arrays_equal(got, want):
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    v = np.asarray(v)
    assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
    assert got[k].tobytes() == v.tobytes(), k


@pytest.fixture(scope='module')
def full_h5(tmp_path_factory):
  """{folder: the full weights.h5 that JAX's read_weights writes from its
  ckpt-30000}.  Its restore template's initial values are overwritten by
  the checkpoint's, so they are zeros here: JAX's truncated normal
  compiles once a shape, most of a minute on one thread."""
  root = tmp_path_factory.mktemp('full_h5')
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(JL, 'trunc_normal', _zeros_init)
    return {folder: JR.full_main(['--model_id', folder, '--results', RESULTS,
                                  '--output', str(root / f'{folder}.h5')])
            for folder in (FLAGSHIP, SYNTH1024)}


def _zeros_init(key, shape, stddev=0.01, dtype=jnp.float32):
  del key, stddev
  return jnp.zeros(shape, dtype)


# ---- 4: export ----------------------------------------------------------

def test_export_writes_the_keys_and_arrays_of_jax(tmp_path, full_h5):
  """The flagship's ckpt-30000 carried into the port's model by convert:
  the port's export against the file that JAX's export wrote from the
  checkpoint's parameters."""
  _, cfg = _configs(FLAGSHIP)
  model = TF.FullModel(cfg, device='cpu')
  model.load_state_dict(convert.params_from_checkpoint(
      os.path.join(RESULTS, FLAGSHIP, 'ckpt-30000.npz'), cfg))
  got_path = str(tmp_path / 'port.h5')
  assert P.export_weights_h5(model, FULL_NETS, got_path) == got_path
  want = _h5py_read(full_h5[FLAGSHIP])
  _assert_arrays_equal(_h5py_read(got_path), want)
  _assert_arrays_equal(h5.read(got_path), want)
  for net in FULL_NETS:
    _assert_trees_equal(
        jax.tree_util.tree_map(np.asarray, JP.load_net_h5(got_path, net)),
        JP.load_net_h5(full_h5[FLAGSHIP], net))
  # A net the model lacks is left out, as JAX's ``if n in params``.
  P.export_weights_h5(model.state_dict(), ('ctrl_cnn', 'no_net'), got_path)
  assert all(k.startswith('ctrl_cnn_') for k in h5.read(got_path))


def test_a_single_batchnorm_copy_is_copy_0(tmp_path):
  rng = np.random.RandomState(0)
  layers = [{'w': rng.rand(3, 3, 2, 4).astype(np.float32),
             'b': rng.rand(4).astype(np.float32),
             'bn': {k: rng.rand(4).astype(np.float32)
                    for k in P.BN_KEYS}}]
  got_path, want_path = str(tmp_path / 'port.h5'), str(tmp_path / 'jax.h5')
  h5.write(got_path, P.h5_arrays('cnn', layers))
  JP.export_weights_h5({'cnn': layers}, want_path)
  _assert_arrays_equal(h5.read(got_path), _h5py_read(want_path))
  assert 'cnn_0_0_beta' in h5.read(got_path)
  got = P.load_net_h5(got_path, 'cnn')
  assert got[0]['bn']['beta'].shape == (4,)
  for k in P.BN_KEYS:
    np.testing.assert_array_equal(got[0]['bn'][k], layers[0]['bn'][k])


# ---- 5: load_net_h5, merge_pretrained, the full model's load_pretrained

def _assert_trees_equal(got, want):
  assert (got is None) == (want is None)
  if want is None:
    return
  want = jax.tree_util.tree_map(np.asarray, want)
  assert jax.tree_util.tree_structure(got) == \
      jax.tree_util.tree_structure(want)
  for a, b in zip(jax.tree_util.tree_leaves(got),
                  jax.tree_util.tree_leaves(want)):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize('name', sorted(BOXES) + ['full'])
def test_load_net_h5_reads_what_jax_reads(name, full_h5):
  path = full_h5[FLAGSHIP] if name == 'full' else _box_h5(name)
  for net in FULL_NETS + ('no_net', 'no_lstm'):
    _assert_trees_equal(P.load_net_h5(path, net), JP.load_net_h5(path, net))
  _assert_trees_equal(P.load_net_h5(path, 'ctrl_cnn', cnn_prefix_sniff=True),
                      JP.load_net_h5(path, 'ctrl_cnn', cnn_prefix_sniff=True))


def test_load_net_h5_of_beta_and_gamma_only(tmp_path):
  """Files of the reference carry no EMA statistics: zero means, unit
  variances, as JAX fills them."""
  arrays = {k: v for k, v in h5.read(_box_h5('synth3')).items()
            if 'ema' not in k}
  path = str(tmp_path / 'ref.h5')
  h5.write(path, arrays)
  got = P.load_net_h5(path, 'ctrl_cnn')
  _assert_trees_equal(got, JP.load_net_h5(path, 'ctrl_cnn'))
  assert not got[0]['bn']['ema_mean'].any()
  assert (got[0]['bn']['ema_var'] == 1).all()


def test_merge_pretrained_as_jax():
  """A partial net, a BatchNorm of one copy and one of other copies
  broadcast over T (its last copy), and a loaded layer without a
  BatchNorm."""
  jcfg = JC.tiny_full_config()
  init = P.net_from_state(TF.FullModel(C.FullModelConfig.from_dict(
      jcfg.to_dict()), device='cpu').state_dict(), 'ctrl_cnn')
  rng = np.random.RandomState(1)

  def like(a, shape=None):
    return rng.rand(*(a.shape if shape is None else shape)).astype(
        np.float32)
  c1 = init[1]['bn']['beta'].shape[-1]
  loaded = [
      {'w': like(init[0]['w']), 'b': like(init[0]['b']),
       'bn': {k: like(v[0]) for k, v in init[0]['bn'].items()}},
      {'w': like(init[1]['w']), 'b': like(init[1]['b']),
       'bn': {k: like(v, (7, c1)) for k, v in init[1]['bn'].items()}}]
  for loaded_layers in (loaded, loaded[:1], [
      {'w': like(init[0]['w']), 'b': like(init[0]['b'])}], None):
    want = JP.merge_pretrained(init, loaded_layers, jcfg.timespan)
    got = P.merge_pretrained(init, loaded_layers, jcfg.timespan)
    _assert_trees_equal(got, want)


def _load_cases():
  return {
      'ctrl_flagship': (FLAGSHIP, {'pretrain_ctrl_net': 'flagship'}),
      'ctrl_synth3': (BOX_FULL['synth3'], {'pretrain_ctrl_net': 'synth3'}),
      'ctrl_synthcs': (BOX_FULL['synthcs'],
                       {'pretrain_ctrl_net': 'synthcs'}),
      'attn_flagship': (FLAGSHIP, {'pretrain_attn_net': FLAGSHIP}),
      'net_flagship': (FLAGSHIP, {'pretrain_net': FLAGSHIP}),
      'net_synth1024': (SYNTH1024, {'pretrain_net': SYNTH1024}),
  }


@pytest.mark.parametrize('case', sorted(_load_cases()))
def test_full_load_pretrained_as_jax(case, full_h5):
  folder, sources = _load_cases()[case]
  paths = {k: full_h5[v] if v in full_h5 else _box_h5(v)
           for k, v in sources.items()}
  jcfg, cfg = _configs(folder, **paths)
  # The initial parameters, the port's seed-0 ones, in JAX's tree.
  model = TF.FullModel(cfg, device='cpu')
  tree = {net: jax.tree_util.tree_map(
      np.array, P.net_from_state(model.state_dict(), net))
          for net in FULL_NETS}
  want = convert.flatten_tree(jax.tree_util.tree_map(
      np.asarray, JF.load_pretrained(
          jax.tree_util.tree_map(jnp.asarray, tree), jcfg)))
  init = convert.flatten_tree(tree)
  TF.load_pretrained(model, cfg)
  got = model.state_dict()
  assert sorted(got) == sorted(want)
  changed = 0
  for k, v in want.items():
    np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    changed += not np.array_equal(v, init[k])
  assert changed > 0
  if 'pretrain_net' in sources:
    # The whole model from the checkpoint the file was written from.
    ckpt = os.path.join(RESULTS, folder, 'ckpt-30000.npz')
    for k, v in convert.params_from_checkpoint(ckpt, cfg).items():
      np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def test_a_full_model_from_a_pretrained_file_trains_from_it(full_h5):
  """The experiment's start: Trainer.load_pretrained() reads the
  config's files; an fg config reads none."""
  _, cfg = _configs(FLAGSHIP, pretrain_net=full_h5[FLAGSHIP])
  trainer = Trainer(cfg, device='cpu')
  trainer.load_pretrained()
  ckpt = os.path.join(RESULTS, FLAGSHIP, 'ckpt-30000.npz')
  want = convert.params_from_checkpoint(ckpt, cfg)
  for k, v in trainer.model.state_dict().items():
    assert torch.equal(v, want[k]), k
  Trainer(C.tiny_fg_config(), device='cpu').load_pretrained()
  with pytest.raises(TypeError):
    Trainer(C.tiny_fg_config(), device='cpu').load_pretrained(
        trainer.model)


# ---- 6: the box model's pretrained CNN and its freeze rule --------------

def _box_params(cfg, seed):
  """The tiny box's parameters in JAX's tree: the port's initial ones of
  ``seed``, the weights scaled by up to 11x as test_torch_box_model's
  ``_params`` scales JAX's."""
  rng = np.random.RandomState(seed)
  state = TB.BoxModel(cfg, seed=seed, device='cpu').state_dict()
  tree = {net: P.net_from_state(state, net) for net in TR.BOX_NETS}
  return jax.tree_util.tree_map(
      lambda a: a * (1 + SCALE * rng.rand(*a.shape)).astype(np.float32)
      if a.ndim >= 2 else np.array(a), tree)


def _box_configs(**over):
  jcfg = JC.tiny_box_config(timespan=2, **over)
  return jcfg, C.BoxModelConfig.from_dict(jcfg.to_dict())


def _box_jcfg():
  """The tiny box config with a pretrained CNN to freeze: the JAX step's
  config (the loss reads no pretrain_* field, so one compile serves every
  source)."""
  return _box_configs(pretrain_cnn='cnn.h5', freeze_pretrain_cnn=True)[0]


@functools.lru_cache(maxsize=None)
def _box_jax_fns():
  """JAX's jitted train step with the box's freeze mask, and its
  optimizer."""
  jcfg = _box_jcfg()
  params = _box_params(C.BoxModelConfig.from_dict(jcfg.to_dict()), 0)
  step_fn, tx = JT.make_train_step(
      JB.box_model_loss, jcfg,
      freeze=JB.freeze_mask(params, jcfg), jit=False)
  return jax.jit(step_fn), tx


def _pretrained_box_files(root):
  """Box weights.h5 files at the tiny box's widths from other JAX
  parameters (seed 5): the CNN under each prefix of the sniff, and a whole
  box net exported by JAX."""
  _, cfg = _box_configs()
  other = _box_params(cfg, seed=5)
  cnn = JP._export_layer_list
  paths = {}
  for prefix in ('attn_', '', 'ctrl_'):
    path = os.path.join(root, f'{prefix or "bare_"}cnn.h5')
    with h5py.File(path, 'w') as f:
      cnn(f, f'{prefix}cnn', other['ctrl_cnn'])
    paths[prefix or 'bare'] = path
  path = os.path.join(root, 'net.h5')
  JP.export_weights_h5(other, path)
  paths['net'] = path
  return paths


@pytest.mark.parametrize('source', ['attn_', 'bare', 'ctrl_', 'net'])
def test_box_pretrained_and_frozen_step_matches_jax(source, tmp_path):
  path = _pretrained_box_files(str(tmp_path))[source]
  field = 'pretrain_net' if source == 'net' else 'pretrain_cnn'
  jcfg, cfg = _box_configs(**{field: path, 'freeze_pretrain_cnn': True})
  assert cfg.freeze_pretrain_cnn and cfg.pretrain_cnn == jcfg.pretrain_cnn
  init = _box_params(cfg, seed=0)
  params = jax.tree_util.tree_map(
      np.asarray, JB.load_pretrained(dict(init), jcfg))
  model = TB.BoxModel(cfg, device='cpu')
  model.load_state_dict(convert.params_from_jax(init))
  TB.load_pretrained(model, cfg)
  flat = convert.flatten_tree(params)
  for k, v in model.state_dict().items():
    np.testing.assert_array_equal(v.numpy(), flat[k], err_msg=k)
  frozen = TS.freeze_mask(model)
  assert {k.split('.')[0] for k, f in frozen.items() if f} == {'ctrl_cnn'}
  assert not TS.freeze_mask(TB.BoxModel(cfg.replace(
      freeze_pretrain_cnn=False), device='cpu'))['ctrl_cnn.0.w']

  assert JB.freeze_mask(params, jcfg) == JB.freeze_mask(params, _box_jcfg())
  step_fn, tx = _box_jax_fns()
  batch = _batch(cfg, seed=21)
  key = jax.random.PRNGKey(201)
  new, _, j_metrics = step_fn(params, tx.init(params), batch, key,
                              jnp.asarray(0.0))
  tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
  draws = box_jax_draws(key, jcfg, B)
  # Where a gradient is float32 noise, Adam's first step may move the two
  # sides 2 lr apart: the port's gradients (held to JAX's at 1e-3 in
  # test_torch_box_model.py) say where.
  _, _, grads = TS.loss_and_grads(model, tbatch, draws, 0)
  old = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
  _, metrics = TS.train_step(model, TS.init_opt_state(model), tbatch, draws,
                             0)
  for k in TB.METRIC_KEYS:
    np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                               rtol=1e-4, atol=1e-5, err_msg=k)
  new_jax = _flat(new)
  new_port = {k: v.detach().numpy() for k, v in model.state_dict().items()}
  _assert_updates_agree(old, new_port, new_jax,
                        {k: g.numpy() for k, g in grads.items()},
                        _zero_grad_leaves(model), TF.learn_rate(cfg, 0),
                        source)
  for k in new_jax:
    if k.endswith(('ema_mean', 'ema_var')):
      _close(new_port[k], new_jax[k], 1e-4, k)
    elif k.startswith('ctrl_cnn.'):
      # Frozen: the parameters stay as loaded on both sides.
      np.testing.assert_array_equal(new_port[k], old[k], err_msg=k)
      np.testing.assert_array_equal(new_jax[k], old[k], err_msg=k)
  assert any(not np.array_equal(new_port[k], old[k]) for k in new_port
             if k.startswith('ctrl_lstm.'))


# ---- 7: read_weights --------------------------------------------------

@pytest.mark.parametrize('spec,folder', [
    ('box', BOXES['synth3']), ('box', BOXES['synthcs']),
    ('full', FLAGSHIP), ('full', SYNTH1024)])
def test_read_weights_writes_what_jax_writes(spec, folder, tmp_path,
                                             full_h5):
  got = getattr(TR, f'{spec}_main')(
      ['--model_id', folder, '--results', RESULTS, '--output',
       str(tmp_path / 'port.h5')], device='cpu')
  if spec == 'full':
    want = full_h5[folder]
  else:
    with pytest.MonkeyPatch.context() as mp:
      mp.setattr(JL, 'trunc_normal', _zeros_init)
      want = JR.box_main(['--model_id', folder, '--results', RESULTS,
                          '--output', str(tmp_path / 'jax.h5')])
    # And the folder's committed file, which JAX wrote from that
    # checkpoint.
    _assert_arrays_equal(h5.read(got), _h5py_read(os.path.join(
        RESULTS, folder, 'weights.h5')))
  _assert_arrays_equal(h5.read(got), _h5py_read(want))
  assert TR.BOX_NETS == JR.BOX_NETS and TR.FULL_NETS == JR.FULL_NETS


def test_read_weights_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    TR.box_main(['--model_id', BOXES['synth3'], '--results', RESULTS,
                 '--output', str(tmp_path / 'w.h5')])
  assert not os.path.exists(tmp_path / 'w.h5')
