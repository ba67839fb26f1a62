"""The port's checkpoint writer and option snapshots against the JAX
package's ``Saver``.

1. Checkpoints that a tiny port ``TrainingExperiment`` writes after two
   steps (the full and box models with Adam, the fg model with momentum)
   restore in JAX's ``Saver.restore`` into the JAX trainer's
   ``{'params', 'opt_state'}`` template: every leaf of the template's
   dtype and shape (the Adam and schedule counts int32 scalars, the fg
   model's trace before its count and its parameters), the parameters and
   the optimizer state equal to the port's live ones bit for bit; and
   JAX's ``TrainingExperiment`` restores the folder and takes a step from
   it, its loss finite (exact: the leaves are copied, not computed).
2. Pruning keeps the files that JAX's ``Saver`` keeps.
3. ``utils.opt_yaml`` writes ``yaml.safe_dump``'s bytes for every preset
   and the train and data configs, and reads every committed
   ``results/*/{model,data}_opt.yaml`` as ``yaml.safe_load`` does (exact).
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from rec_attend_tpu import config as JC
from rec_attend_tpu.engine import experiment as jexp_lib
from rec_attend_tpu.engine.saver import Saver as JSaver
from rec_attend_tpu.models import box_model as JB
from rec_attend_tpu.models import fg_model as JG
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu.parallel.train_step import make_optimizer
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
from rec_attend_tpu_torch.utils import opt_yaml

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
SIZE = 32
SMALL = dict(inp_height=SIZE, inp_width=SIZE)
GLIMPSE = dict(SMALL, filter_height=8, filter_width=8)
CONFIGS = {
    'full': (C.tiny_full_config(use_knob=True, **GLIMPSE),
             JC.tiny_full_config(use_knob=True, **GLIMPSE), JF.init_full_model),
    'box': (C.tiny_box_config(**GLIMPSE), JC.tiny_box_config(**GLIMPSE),
            JB.init_box_model),
    'fg': (C.tiny_fg_config(optimizer='momentum', **SMALL),
           JC.tiny_fg_config(optimizer='momentum', **SMALL),
           JG.init_fg_model),
    # A bfloat16 run: float32 checkpoints, ``dtype: bfloat16`` in its
    # model_opt.yaml, and JAX trains on from them in bfloat16.
    'full_bfloat16': (
        C.tiny_full_config(use_knob=True, dtype='bfloat16', **GLIMPSE),
        JC.tiny_full_config(use_knob=True, dtype='bfloat16', **GLIMPSE),
        JF.init_full_model),
}


def _train_cfgs(root, spec, num_steps):
  kw = dict(num_steps=num_steps, batch_size=2, results=str(root / 'results'),
            logs=str(root / 'logs'), steps_per_valid=0,
            steps_per_trainval=0, steps_per_log=1, steps_per_ckpt=1,
            steps_per_plot=0, save_ckpt=True, model_id=f'{spec}_ckpt')
  return C.TrainConfig(**kw), JC.TrainConfig(**kw)


def _data_cfgs(root, timespan):
  kw = dict(dataset='synth', folder=str(root / 'data'), height=SIZE,
            width=SIZE, timespan=timespan, num_examples=8)
  return C.DataConfig(**kw), JC.DataConfig(**kw)


def _names(tree):
  return [jax.tree_util.keystr(p, simple=True, separator='.')
          for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize('spec', sorted(CONFIGS))
def test_port_checkpoints_restore_in_jax(tmp_path, spec):
  cfg, jcfg, init = CONFIGS[spec]
  spec = spec.split('_')[0]
  timespan = getattr(cfg, 'timespan', 4)
  train_cfg, jtrain_cfg = _train_cfgs(tmp_path, spec, 2)
  data_cfg, jdata_cfg = _data_cfgs(tmp_path, timespan)
  exp = TrainingExperiment(spec, cfg, train_cfg, data_cfg, device='cpu')
  exp.run()
  folder = exp.folder
  assert [s for s, _ in exp.saver.list_ckpts()] == [1, 2]
  with open(os.path.join(folder, 'model_opt.yaml')) as f:
    written = yaml.safe_load(f)
  assert written['dtype'] == cfg.dtype
  assert type(jcfg).from_dict(written) == jcfg

  params = init(jax.random.PRNGKey(0), jcfg)
  template = {'params': params, 'opt_state': make_optimizer(jcfg).init(
      params)}
  tree, step = JSaver(folder).restore(template)
  assert step == 2
  got = jax.tree_util.tree_leaves(tree)
  want = jax.tree_util.tree_leaves(template)
  assert len(got) == len(want)
  for name, g, w in zip(_names(template), got, want):
    assert np.asarray(g).dtype == np.asarray(w).dtype, name
    assert np.shape(g) == np.shape(w), name
  state = exp.trainer.model.state_dict()
  jparams = convert.flatten_tree(tree['params'])
  assert sorted(jparams) == sorted(state)
  for k, v in state.items():
    assert np.array_equal(np.asarray(jparams[k]), v.numpy()), k
  restored = convert.opt_state_from_jax(tree['opt_state'], cfg)
  live = exp.trainer.opt_state
  assert restored['count'] == live['count'] == 2
  assert sorted(restored) == sorted(live)
  for key in set(live) - {'count'}:
    assert sorted(restored[key]) == sorted(live[key])
    for k, v in live[key].items():
      assert torch.equal(restored[key][k], v), (key, k)
  if spec == 'fg':
    # The trace comes before the count and the parameters.
    leaves = [np.asarray(x) for x in got]
    p = len(state)
    assert leaves[p].dtype == np.int32 and leaves[p].shape == ()
  else:
    assert np.asarray(got[0]).dtype == np.int32 and np.shape(got[0]) == ()

  # JAX's trainer goes on from the port's folder.
  jexp = jexp_lib.TrainingExperiment(
      spec, jcfg, jtrain_cfg.replace(restore=folder, num_steps=3),
      jdata_cfg)
  assert jexp.step == 2
  jexp.run()
  assert jexp.step == 3
  for leaf in jax.tree_util.tree_leaves(jexp.params):
    assert np.isfinite(np.asarray(leaf)).all()
  with open(os.path.join(jexp.logs_folder, 'loss.csv')) as f:
    rows = f.read().splitlines()
  assert rows[-1].split(',')[0] == '3'
  assert np.isfinite(float(rows[-1].split(',')[2]))


def test_pruning_keeps_the_files_of_jax(tmp_path):
  port = saver.Saver(str(tmp_path / 'port'))
  jax_saver = JSaver(str(tmp_path / 'jax'))
  leaves = [np.zeros((), np.int32), np.ones((2, 3), np.float32)]
  for step in (1, 2, 3, 5, 5, 8, 13):
    port.save(leaves, step)
    jax_saver.save({'a': leaves[0], 'b': leaves[1]}, step)
    assert (sorted(os.listdir(port.folder))
            == sorted(os.listdir(jax_saver.folder)))
    assert ([s for s, _ in port.list_ckpts()]
            == [s for s, _ in jax_saver.list_ckpts()])
  assert port.get_latest_ckpt()[0] == 13
  assert [s for s, _ in port.list_ckpts()] == [8, 13]


def _presets():
  out = []
  for name in sorted(dir(C)):
    if name.endswith('_config') and name != 'data_config_for':
      out.append((name, getattr(C, name)()))
  out += [('TrainConfig', C.TrainConfig()), ('DataConfig', C.DataConfig()),
          ('data_config_for_synth', C.data_config_for('synth')),
          ('paper_full_with_box', C.FullModelConfig.from_dict(dict(
              C.cvppp_full_config().to_dict(),
              pretrain_ctrl_net='results/box_model_synth-1/ckpt-12000.npz',
              mlp_dropout=0.5, use_pallas=True, remat_policy='dots')))]
  return out


@pytest.mark.parametrize('name,cfg', _presets(), ids=[n for n, _ in
                                                      _presets()])
def test_yaml_writes_the_bytes_of_pyyaml(tmp_path, name, cfg):
  opt = cfg.to_dict()
  want = yaml.safe_dump(opt, default_flow_style=False)
  assert opt_yaml.dumps(opt) == want
  path = str(tmp_path / 'opt.yaml')
  cfg.save_yaml(path)
  assert type(cfg).from_yaml(path) == cfg
  assert type(cfg).from_yaml(path).to_dict() == opt
  s = saver.Saver(str(tmp_path / 'folder'), model_opt=cfg)
  with open(os.path.join(s.folder, 'model_opt.yaml')) as f:
    assert f.read() == want
  assert s.load_opt_dict('model_opt.yaml') == yaml.safe_load(want)


def _snapshots():
  return sorted(os.path.relpath(p, REPO) for p in glob.glob(
      os.path.join(REPO, 'results', '*', '*_opt.yaml')))


def test_a_loaded_config_carries_the_keys_it_lacks():
  """A JAX snapshot's options that the port's config lacks are not read
  and not compared, but ``replace`` keeps them and ``to_dict`` writes them
  back."""
  opt = dict(C.tiny_box_config().to_dict(), use_pallas=True)
  cfg = C.BoxModelConfig.from_dict(opt)
  assert cfg == C.tiny_box_config()
  # freeze_pretrain_cnn is the port's own option now: read, not carried.
  frozen = C.BoxModelConfig.from_dict(dict(opt, freeze_pretrain_cnn=False))
  assert not frozen.freeze_pretrain_cnn and frozen._carried == {
      'use_pallas': True}
  assert not hasattr(cfg, 'use_pallas')
  again = cfg.replace(timespan=3)
  assert again.to_dict() == dict(opt, timespan=3)
  assert C.tiny_box_config().replace(timespan=3).to_dict() == dict(
      C.tiny_box_config().to_dict(), timespan=3)


@pytest.mark.parametrize('path', _snapshots())
def test_yaml_reads_the_committed_snapshots_as_pyyaml(path):
  with open(os.path.join(REPO, path)) as f:
    text = f.read()
  want = yaml.safe_load(text)
  assert opt_yaml.loads(text) == want
  assert opt_yaml.dumps(want) == text


def test_yaml_quotes_and_spells_scalars_as_pyyaml():
  opt = {'empty': '', 'bool_word': 'true', 'yes_word': 'yes', 'float_word': '1.0',
         'exp_no_point': '1e-05', 'quote': "it's", 'colon': 'a: b',
         'dash': '-x', 'dash_space': '- x', 'hash': '#x', 'comment': 'a #b',
         'inner_hash': 'x#y', 'null_word': 'null', 'tilde': '~',
         'hex': '0x1F', 'date': '2020-01-01', 'sexagesimal': '12:30',
         'spaces': 'a b c', 'big': 1e17, 'small': 1e-5,
         'inf': float('inf'), 'neg_zero': -0.0, 'empty_list': [],
         'mixed': [None, True, '1', 2.5, -3], 'merge': '<<', 'at': '@x',
         'lead_colon': ':x', 'trail_colon': 'x:', 'query': '?x',
         'query_space': '? x', 'doc': '---x', 'point': '.5', 'plus': '+1',
         'underscore': '1_000', 'dot_inf': '.inf', 'squote': "'q'",
         'dquote': '"q"', 'lone_dash': '-', 'comma': 'foo,bar',
         'bracket': '[x]', 'close': 'x]', 'int': 3, 'path': 'a/b-c_d.npz'}
  text = yaml.safe_dump(opt, default_flow_style=False)
  assert opt_yaml.dumps(opt) == text
  assert opt_yaml.loads(text) == yaml.safe_load(text) == opt
  for bad in ({'nested': {'a': 1}}, {'line': 'a\nb'}):
    with pytest.raises(ValueError):
      opt_yaml.dumps(bad)
