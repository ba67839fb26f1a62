"""Reading the JAX trainer's checkpoints and configs without JAX, against
the JAX package's own reader (exact equality: the same bytes are read)."""

import dataclasses
import os

import numpy as np
import jax
import pytest
import torch
import yaml

from rec_attend_tpu import config as JC
from rec_attend_tpu.engine.saver import Saver
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu.parallel.train_step import make_optimizer
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.models import full_model as TFM

torch.set_num_threads(1)

FLAGSHIP = os.path.join(os.path.dirname(__file__), '..', 'results',
                        'full_model_synth-20260816104712')


def _jax_names(tree):
  return [jax.tree_util.keystr(p, simple=True, separator='.')
          for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize('preset', ['tiny', 'cvppp', 'tiny_packed_noskip'])
def test_leaf_order_matches_jax_tree_flatten(preset):
  jcfg, cfg = {
      'tiny': (JC.tiny_full_config(), C.tiny_full_config()),
      'cvppp': (JC.cvppp_full_config(), C.cvppp_full_config()),
      'tiny_packed_noskip': (
          JC.tiny_full_config(add_d_out=True, add_skip_conn=False,
                              use_bn=False),
          C.tiny_full_config(add_d_out=True, add_skip_conn=False,
                             use_bn=False)),
  }[preset]
  tree = jax.eval_shape(lambda: JF.init_full_model(jax.random.PRNGKey(0),
                                                   jcfg))
  shapes = convert.param_shapes(cfg)
  assert saver.jax_leaf_order(shapes) == _jax_names(tree)
  for name, leaf in zip(_jax_names(tree), jax.tree_util.tree_leaves(tree)):
    assert shapes[name] == tuple(leaf.shape), name


def test_flagship_checkpoint_loads_like_jax():
  path = saver.latest_checkpoint(FLAGSHIP)
  assert path.endswith('ckpt-30000.npz')
  state = convert.params_from_checkpoint(path, C.cvppp_full_config())
  assert len(state) == 146
  assert sum(v.numel() for v in state.values()) == 584076

  jcfg = JC.cvppp_full_config()
  params = JF.init_full_model(jax.random.PRNGKey(0), jcfg)
  tx = make_optimizer(jcfg)
  tree, _ = Saver(FLAGSHIP).restore({'params': params,
                                     'opt_state': tx.init(params)})
  want = convert.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                     tree['params']))
  assert set(want) == set(state)
  for name, leaf in want.items():
    np.testing.assert_array_equal(state[name].numpy(), leaf, err_msg=name)


def test_params_only_checkpoint(tmp_path):
  cfg = JC.tiny_full_config()
  params = JF.init_full_model(jax.random.PRNGKey(4), cfg)
  Saver(str(tmp_path), model_opt=cfg).save({'params': params}, 7)
  Saver(str(tmp_path)).save({'params': params}, 12)
  path = saver.latest_checkpoint(str(tmp_path))
  assert path.endswith('ckpt-12.npz')
  state = convert.params_from_checkpoint(path, C.tiny_full_config())
  want = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, params))
  for name, leaf in want.items():
    np.testing.assert_array_equal(state[name].numpy(), leaf, err_msg=name)


def test_loader_rejects_other_shapes(tmp_path):
  params = JF.init_full_model(jax.random.PRNGKey(4), JC.tiny_full_config())
  Saver(str(tmp_path)).save({'params': params}, 1)
  path = saver.latest_checkpoint(str(tmp_path))
  with pytest.raises(ValueError, match='shape'):
    convert.params_from_checkpoint(
        path, C.tiny_full_config(ctrl_rnn_hid_dim=16))
  with pytest.raises(ValueError, match='leaves'):
    convert.params_from_checkpoint(path, C.cvppp_full_config())


def test_latest_checkpoint_needs_one(tmp_path):
  with pytest.raises(FileNotFoundError):
    saver.latest_checkpoint(str(tmp_path))


def test_cvppp_preset_matches_the_flagship_folder():
  """Every field the forward reads agrees between the port's preset, the
  JAX preset and the flagship folder's model_opt.yaml (a field the yaml
  predates, segm_weight_alpha, is read there as its default); the port's
  config has every field of JAX's but the JAX compiler's switches, and the
  folder's yaml loads as the preset with the box model its run started
  from."""
  with open(os.path.join(FLAGSHIP, 'model_opt.yaml')) as f:
    opt = yaml.safe_load(f)
  ours = C.cvppp_full_config().to_dict()
  jax_preset = JC.cvppp_full_config().to_dict()
  defaults = C.FullModelConfig().to_dict()
  jax_only = {'mlp_dropout', 'remat_policy',
              'scan_unroll', 'use_pallas'}
  assert ours == {k: v for k, v in jax_preset.items() if k not in jax_only}
  assert set(jax_preset) - set(ours) == jax_only
  assert set(C.FORWARD_FIELDS) <= set(ours)
  assert set(C.FORWARD_FIELDS) - set(opt) == {'segm_weight_alpha'}
  for name in C.FORWARD_FIELDS:
    assert ours[name] == opt.get(name, defaults[name]), name
    assert ours[name] == jax_preset[name], name
  loaded = C.FullModelConfig.from_yaml(os.path.join(FLAGSHIP,
                                                    'model_opt.yaml'))
  assert loaded == C.cvppp_full_config().replace(
      pretrain_ctrl_net=opt['pretrain_ctrl_net'])


def test_config_derived_shapes_match_jax():
  for jcfg, cfg in ((JC.cvppp_full_config(), C.cvppp_full_config()),
                    (JC.tiny_full_config(add_d_out=True, add_y_out=True,
                                         num_semantic_classes=3),
                     C.tiny_full_config(add_d_out=True, add_y_out=True,
                                        num_semantic_classes=3))):
    for prop in ('ccnn_inp_depth', 'acnn_inp_depth', 'glimpse_map_dim',
                 'glimpse_feat_dim', 'core_dim', 'crnn_h', 'acnn_w'):
      assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.resolved_input_flags() == jcfg.resolved_input_flags()
    assert cfg.resolved_attn_cnn_skip() == jcfg.resolved_attn_cnn_skip()
  assert C.DATASET_DIMS['cvppp'] == JC.DATASET_DIMS['cvppp']
  assert C.DATASET_TRANSFORMS['cvppp'] == JC.DATASET_TRANSFORMS['cvppp']


def test_config_dict_round_trip():
  cfg = C.tiny_full_config(attn_cnn_skip=(1, 0))
  again = C.FullModelConfig.from_dict(dict(cfg.to_dict(), unknown_key=3))
  assert again == cfg
  assert cfg.replace(timespan=9).timespan == 9
  assert dataclasses.is_dataclass(cfg)
  assert C.FullModelConfig.from_dict({'ctrl_cnn_pool': '2,2,1'}
                                     ).ctrl_cnn_pool == (2, 2, 1)


def test_flagship_adam_state_loads_like_jax():
  """The Adam state of the flagship checkpoint, read without JAX, equals
  the JAX Saver's restore carried over by opt_state_from_jax (exact); the
  Trainer continues from it at step 30000, as restore_ckpt does."""
  from rec_attend_tpu_torch.engine.trainer import Trainer
  cfg = C.cvppp_full_config()
  path = saver.latest_checkpoint(FLAGSHIP)
  got = convert.opt_state_from_checkpoint(path, cfg)
  jcfg = JC.cvppp_full_config()
  params = JF.init_full_model(jax.random.PRNGKey(0), jcfg)
  tx = make_optimizer(jcfg)
  tree, step = Saver(FLAGSHIP).restore({'params': params,
                                        'opt_state': tx.init(params)})
  want = convert.opt_state_from_jax(tree['opt_state'], cfg)
  assert got['count'] == want['count'] == step == 30000
  trainable = {k for k, _ in
               TFM.FullModel(cfg, device='meta').named_parameters()}
  assert set(got['mu']) == set(got['nu']) == trainable
  for key in ('mu', 'nu'):
    for name in trainable:
      np.testing.assert_array_equal(got[key][name].numpy(),
                                    want[key][name].numpy(), err_msg=name)
  # The EMA leaves' moments, which the port drops, are zero in JAX.
  mu = convert.flatten_tree(jax.tree_util.tree_map(
      np.asarray, tree['opt_state'][1][0].mu))
  assert all(not mu[k].any() for k in mu if k.endswith(('ema_mean',
                                                        'ema_var')))
  trainer = Trainer(cfg, device='cpu')
  assert trainer.restore(FLAGSHIP) == path
  assert trainer.step == 30000 and trainer.opt_state['count'] == 30000
  np.testing.assert_array_equal(
      trainer.opt_state['nu']['ctrl_lstm.w_xi'].numpy(),
      got['nu']['ctrl_lstm.w_xi'].numpy())


def test_adam_state_needs_a_full_checkpoint(tmp_path):
  params = JF.init_full_model(jax.random.PRNGKey(4), JC.tiny_full_config())
  Saver(str(tmp_path)).save({'params': params}, 1)
  with pytest.raises(ValueError, match='leaves'):
    convert.opt_state_from_checkpoint(saver.latest_checkpoint(str(tmp_path)),
                                      C.tiny_full_config())
