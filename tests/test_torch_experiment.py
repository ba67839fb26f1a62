"""The port's training run (``TrainingExperiment``) and its command lines
against the JAX package's.

1. A tiny port run and a JAX run of the same configs write the same files:
   the checkpoints and the two option snapshots in the results folder, the
   log CSVs and the catalog in the logs folder, each CSV with the same
   header and rows at the same steps (the values are each run's own: the
   two packages draw other data); each package's ``model_opt.yaml`` and
   ``data_opt.yaml`` load in the other's config class to the same config.
2. Restore and finetune behave as ``tests/test_engine.py:60-112`` holds for
   JAX: a restored run goes on from the checkpoint's step and state,
   ``finetune`` restarts the step and the optimizer; the log CSVs drop the
   rows past the restored step; the run stops at a non-finite loss.
3. ``cli.args`` turns the same argv into the same configs as JAX's
   (``to_dict`` equal, exact, but for the JAX compiler's switches, which
   the port's configs lack and its parser does not take).
"""

import argparse
import math
import os
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

from rec_attend_tpu import config as JC
from rec_attend_tpu.cli import args as JA
from rec_attend_tpu.engine import experiment as jexp_lib
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch.cli import args as A
from rec_attend_tpu_torch.cli import read_weights
from rec_attend_tpu_torch.cli import train as train_cli
from rec_attend_tpu_torch.data import provider as port_provider
from rec_attend_tpu_torch.engine import experiment as exp_lib
from rec_attend_tpu_torch.models.full_model import learn_rate

torch.set_num_threads(1)

# The options of the JAX configs that the port's lack (a JAX snapshot
# loaded in the port carries them and writes them back), and the flags
# that set only them.
JAX_ONLY = {'full': {'mlp_dropout', 'remat_policy',
                     'scan_unroll', 'use_pallas'},
            'box': {'use_pallas'}, 'fg': set()}
JAX_ONLY_FLAGS = {'full': {'mlp_dropout', 'use_pallas'}, 'box': set(),
                  'fg': set()}

SIZE = 32
GLIMPSE = dict(inp_height=SIZE, inp_width=SIZE, filter_height=8,
               filter_width=8)
SPECS = {
    'box': (C.tiny_box_config(**GLIMPSE), JC.tiny_box_config(**GLIMPSE)),
    'fg': (C.tiny_fg_config(inp_height=SIZE, inp_width=SIZE),
           JC.tiny_fg_config(inp_height=SIZE, inp_width=SIZE)),
    'full': (C.tiny_full_config(use_knob=True, **GLIMPSE),
             JC.tiny_full_config(use_knob=True, **GLIMPSE)),
}


def _cfgs(root, spec, num_steps=4, **train_over):
  kw = dict(num_steps=num_steps, batch_size=2, results=str(root / 'results'),
            logs=str(root / 'logs'), steps_per_valid=2, steps_per_trainval=2,
            steps_per_log=1, steps_per_ckpt=2, steps_per_plot=0,
            num_batch_valid=1, save_ckpt=True, model_id=f'{spec}_test')
  kw.update(train_over)
  data = dict(dataset='synth', folder=str(root / 'data'), height=SIZE,
              width=SIZE, timespan=4, num_examples=8)
  cfg, jcfg = SPECS[spec]
  return ((cfg, C.TrainConfig(**kw), C.DataConfig(**data)),
          (jcfg, JC.TrainConfig(**kw), JC.DataConfig(**data)))


def _csv_rows(path):
  with open(path) as f:
    lines = f.read().splitlines()
  # step and which columns hold a value, per row (time and values differ).
  return lines[0], [(r.split(',')[0],) + tuple(
      v != '' for v in r.split(',')[2:]) for r in lines[1:]]


@pytest.mark.parametrize('spec', ['box', 'fg'])
def test_runs_write_the_files_of_jax(tmp_path, spec):
  (cfg, train_cfg, data_cfg), (jcfg, _, port_jdata_cfg) = _cfgs(
      tmp_path / 'port', spec)
  (_, _, jax_data_cfg), (_, jtrain_cfg, jdata_cfg) = _cfgs(tmp_path / 'jax',
                                                          spec)
  port = exp_lib.TrainingExperiment(spec, cfg, train_cfg, data_cfg,
                                    device='cpu')
  port.run()
  jax_exp = jexp_lib.TrainingExperiment(spec, jcfg, jtrain_cfg, jdata_cfg)
  jax_exp.run()
  assert port.step == jax_exp.step == 4
  assert (sorted(os.listdir(port.folder))
          == sorted(os.listdir(jax_exp.folder))
          == ['ckpt-2.npz', 'ckpt-4.npz', 'data_opt.yaml', 'model_opt.yaml'])
  logs = sorted(os.listdir(port.logs_folder))
  assert logs == sorted(os.listdir(jax_exp.logs_folder))
  assert 'catalog' in logs and 'step_time.csv' in logs
  for name in logs:
    got = os.path.join(port.logs_folder, name)
    want = os.path.join(jax_exp.logs_folder, name)
    if name == 'catalog':
      assert open(got).read() == open(want).read()
    else:
      assert _csv_rows(got) == _csv_rows(want), name

  # Each package's snapshots load in the other's config classes; the
  # port's config is JAX's less the JAX-only options, which a JAX snapshot
  # loaded in the port carries and writes back.
  for folder, name, theirs, ours, jax_only in (
      (port.folder, 'model_opt.yaml', jcfg, cfg, JAX_ONLY[spec]),
      (jax_exp.folder, 'model_opt.yaml', jcfg, cfg, JAX_ONLY[spec]),
      (port.folder, 'data_opt.yaml', port_jdata_cfg, data_cfg, set()),
      (jax_exp.folder, 'data_opt.yaml', jdata_cfg, jax_data_cfg, set())):
    path = os.path.join(folder, name)
    with open(path) as f:
      assert type(theirs).from_dict(yaml.safe_load(f)) == theirs
    loaded = type(ours).from_yaml(path)
    assert loaded == ours
    want = theirs.to_dict()
    assert ours.to_dict() == {k: v for k, v in want.items()
                              if k not in jax_only}
    assert set(want) - set(ours.to_dict()) == jax_only
    if folder == jax_exp.folder:
      assert loaded.to_dict() == want


def _csv_values(path):
  """{(step, column): value} of a log CSV's filled cells."""
  with open(path) as f:
    lines = f.read().splitlines()
  header = lines[0].split(',')
  return {(int(r.split(',')[0]), header[i]): float(v)
          for r in lines[1:] for i, v in enumerate(r.split(',')) if i >= 2
          and v != ''}


@pytest.mark.parametrize('spec', ['fg', 'full'])
def test_runs_from_one_state_log_the_values_of_jax(tmp_path, spec,
                                                   monkeypatch):
  """Both packages' runs go on from one port-written step-0 checkpoint over
  the port's in-memory split: the valid and trainval passes at step 0 (the
  eval step, which draws nothing, over the same batches) log the same
  values, within 1e-5 relative (float32 of two frameworks: 4e-7 read; the
  valid images flipped move them by 5e-5 and more)."""
  (cfg, train_cfg, data_cfg), (jcfg, jtrain_cfg, jdata_cfg) = _cfgs(
      tmp_path, spec, num_steps=0, model_id='start', steps_per_valid=1,
      steps_per_trainval=1, num_batch_valid=2)
  start = exp_lib.TrainingExperiment(spec, cfg, train_cfg, data_cfg,
                                     device='cpu')
  start.run()
  assert os.listdir(start.folder).count('ckpt-0.npz') == 1
  folders = {}
  for name in ('port', 'jax'):
    folders[name] = str(tmp_path / name / 'run')
    shutil.copytree(start.folder, folders[name])
  # JAX reads the port's split (its own files hold other draws).
  monkeypatch.setattr(jexp_lib.provider, 'get', port_provider.get)
  port = exp_lib.TrainingExperiment(
      spec, cfg, train_cfg.replace(restore=folders['port'], num_steps=1,
                                   logs=str(tmp_path / 'port' / 'logs')),
      data_cfg, device='cpu')
  port.run()
  jax_exp = jexp_lib.TrainingExperiment(
      spec, jcfg, jtrain_cfg.replace(restore=folders['jax'], num_steps=1,
                                     logs=str(tmp_path / 'jax' / 'logs')),
      jdata_cfg)
  jax_exp.run()
  compared = 0
  for name in sorted(os.listdir(port.logs_folder)):
    if not name.endswith('.csv') or name == 'step_time.csv':
      continue
    got = _csv_values(os.path.join(port.logs_folder, name))
    want = _csv_values(os.path.join(jax_exp.logs_folder, name))
    assert sorted(got) == sorted(want), name
    for key, v in want.items():
      if key[0] == 0:
        assert got[key] == pytest.approx(v, rel=1e-5, abs=1e-9), (name, key)
        compared += 1
  assert compared >= 4


def _adam_count(exp):
  return exp.trainer.opt_state['count']


def test_restore_goes_on_from_the_checkpoint(tmp_path):
  (cfg, train_cfg, data_cfg), _ = _cfgs(tmp_path, 'box', steps_per_valid=0,
                                        steps_per_trainval=0)
  exp = exp_lib.TrainingExperiment('box', cfg, train_cfg, data_cfg,
                                   device='cpu')
  exp.run()
  w = exp.trainer.model.state_dict()['ctrl_mlp.0.w'].clone()
  restore = train_cfg.replace(restore=exp.folder, num_steps=6)
  exp2 = exp_lib.TrainingExperiment('box', cfg, restore, data_cfg,
                                    device='cpu')
  assert exp2.step == 4 and _adam_count(exp2) == 4
  assert torch.equal(exp2.trainer.model.state_dict()['ctrl_mlp.0.w'], w)
  for key in ('mu', 'nu'):
    for k, v in exp.trainer.opt_state[key].items():
      assert torch.equal(exp2.trainer.opt_state[key][k], v), (key, k)
  exp2.run()
  assert exp2.step == 6 and _adam_count(exp2) == 6
  with open(os.path.join(exp2.logs_folder, 'loss.csv')) as f:
    steps = [int(r.split(',')[0]) for r in f.read().splitlines()[1:]]
  assert steps == [1, 2, 3, 4, 5, 6]
  # A restore at step 4 drops the rows after it (the CSVs stay in order).
  os.remove(os.path.join(exp.folder, 'ckpt-6.npz'))
  exp3 = exp_lib.TrainingExperiment('box', cfg, restore, data_cfg,
                                    device='cpu')
  assert exp3.step == 4
  exp3._logger_for('loss', ['train loss', 'valid loss'])
  with open(os.path.join(exp3.logs_folder, 'loss.csv')) as f:
    steps = [int(r.split(',')[0]) for r in f.read().splitlines()[1:]]
  assert steps == [1, 2, 3, 4]


def test_finetune_restarts_the_step_and_optimizer(tmp_path):
  (cfg, train_cfg, data_cfg), _ = _cfgs(
      tmp_path, 'box', steps_per_valid=0, steps_per_trainval=0)
  cfg = cfg.replace(steps_per_learn_rate_decay=2, learn_rate_decay=0.5)
  exp = exp_lib.TrainingExperiment('box', cfg, train_cfg, data_cfg,
                                   device='cpu')
  exp.run()
  assert _adam_count(exp) == 4
  restore = train_cfg.replace(restore=exp.folder, num_steps=6)
  plain = exp_lib.TrainingExperiment('box', cfg, restore, data_cfg,
                                     device='cpu')
  assert plain.step == 4 and _adam_count(plain) == 4
  tuned = exp_lib.TrainingExperiment('box', cfg.replace(finetune=True),
                                     restore, data_cfg, device='cpu')
  assert tuned.step == 0 and _adam_count(tuned) == 0
  assert all(not v.any() for v in tuned.trainer.opt_state['mu'].values())
  assert learn_rate(cfg, _adam_count(tuned)) == pytest.approx(
      cfg.base_learn_rate, rel=1e-6)
  assert learn_rate(cfg, _adam_count(plain)) == pytest.approx(
      cfg.base_learn_rate * 0.25, rel=1e-6)
  # The restore kept the snapshots that the run wrote.
  assert C.BoxModelConfig.from_yaml(os.path.join(
      exp.folder, 'model_opt.yaml')) == cfg


def test_a_non_finite_loss_stops_the_run(tmp_path, monkeypatch):
  (cfg, train_cfg, data_cfg), _ = _cfgs(
      tmp_path, 'fg', num_steps=10, steps_per_valid=0, steps_per_trainval=0,
      steps_per_log=3)
  exp = exp_lib.TrainingExperiment('fg', cfg, train_cfg, data_cfg,
                                   device='cpu')
  step = exp.trainer.train_step

  def poisoned(batch):
    metrics = step(batch)
    if exp.step >= 2:
      metrics['loss'] = torch.tensor(math.nan)
    return metrics
  monkeypatch.setattr(exp.trainer, 'train_step', poisoned)
  exp.run()
  # Checked on the log cadence only, as in JAX: the stop comes at step 3.
  assert exp.step == 3
  assert [s for s, _ in exp.saver.list_ckpts()] == [2, 3]


def test_pretrained_controller_comes_from_the_box_checkpoint(tmp_path):
  """The box run's checkpoint, exported to its weights.h5 by the port's
  read_weights, starts the full run's controller as JAX load_pretrained
  starts it from that file, leaf for leaf; a checkpoint or a results folder
  in pretrain_ctrl_net is no weights.h5 and raises."""
  (box_cfg, train_cfg, data_cfg), _ = _cfgs(tmp_path, 'box',
                                            steps_per_valid=0,
                                            steps_per_trainval=0)
  box = exp_lib.TrainingExperiment('box', box_cfg, train_cfg, data_cfg,
                                   device='cpu')
  box.run()
  step, ckpt = box.saver.get_latest_ckpt()
  weights = read_weights.box_main(
      ['--model_id', box.model_id, '--results', train_cfg.results],
      device='cpu')
  assert weights == os.path.join(box.folder, 'weights.h5')
  full_cfg, jfull_cfg = SPECS['full']
  full = exp_lib.TrainingExperiment(
      'full', full_cfg.replace(pretrain_ctrl_net=weights),
      train_cfg.replace(model_id='full_from_h5'), data_cfg, device='cpu')
  state = full.trainer.model.state_dict()
  jparams = JF.load_pretrained(
      JF.init_full_model(jax.random.PRNGKey(0), jfull_cfg),
      jfull_cfg.replace(pretrain_ctrl_net=weights))
  want = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, jparams))
  loaded = 0
  for k, v in box.trainer.model.state_dict().items():
    if k.split('.')[0] in ('ctrl_cnn', 'ctrl_mlp', 'glimpse_mlp',
                           'ctrl_lstm'):
      assert torch.equal(state[k], v), k
      np.testing.assert_array_equal(state[k].numpy(), want[k], err_msg=k)
      loaded += 1
  assert loaded == 3 * 6 + 2 * 2 + 12
  for src in (ckpt, box.folder):
    with pytest.raises(Exception, match='HDF5|Is a directory'):
      exp_lib.TrainingExperiment(
          'full', full_cfg.replace(pretrain_ctrl_net=src),
          train_cfg.replace(model_id=f'full_{len(src)}'), data_cfg,
          device='cpu')
  with pytest.raises(TypeError):
    exp_lib.TrainingExperiment('full', box_cfg, train_cfg, data_cfg,
                               device='cpu')


ARGVS = {
    'full': [[], ['--dataset', 'synth', '--use_knob', '--ctrl_cnn_depth',
                  '4,8,8', '--ctrl_cnn_pool', '2,2,2',
                  '--ctrl_cnn_filter_size', '3,3,3', '--fixed_order',
                  '--pretrain_ctrl_net', 'results/box', '--finetune',
                  '--remat', '--num_steps', '7', '--save_ckpt',
                  '--no_valid', '--prefetch']],
    'box': [[], ['--dataset', 'kitti', '--add_d_out', '--add_y_out',
                 '--dynamic_var', '--batch_size', '8', '--restore', 'r/x',
                 '--pretrain_cnn', 'fg/weights.h5', '--freeze_pretrain_cnn']],
    'fg': [[], ['--dataset', 'cityscapes', '--add_orientation',
                '--cnn_depth', '4,8', '--cnn_pool', '2,2', '--dcnn_depth',
                '8,9', '--dcnn_pool', '2,2', '--optimizer', 'momentum',
                '--num_semantic_classes', '1', '--data_examples', '64']],
}


@pytest.mark.parametrize('spec,i', [(s, i) for s in ARGVS for i in (0, 1)])
def test_cli_args_make_the_configs_of_jax(spec, i):
  argv = ARGVS[spec][i]
  parsers = []
  for mod in (A, JA):
    p = argparse.ArgumentParser()
    mod.add_train_args(p)
    mod.add_data_args(p)
    getattr(mod, f'add_{spec}_model_args')(p)
    parsers.append(p.parse_args(argv))
  args, jargs = parsers
  assert vars(args) == {k: v for k, v in vars(jargs).items()
                        if k not in JAX_ONLY_FLAGS[spec]}
  assert JAX_ONLY_FLAGS[spec] <= set(vars(jargs))
  make = f'make_{spec}_model_config'
  want = getattr(JA, make)(jargs).to_dict()
  assert getattr(A, make)(args).to_dict() == {
      k: v for k, v in want.items() if k not in JAX_ONLY[spec]}
  assert A.make_train_config(args).to_dict() == JA.make_train_config(
      jargs).to_dict()
  assert A.make_data_config(args).to_dict() == JA.make_data_config(
      jargs).to_dict()


def test_cli_trains_on_the_card_unless_asked(tmp_path, monkeypatch):
  argv = ['--dataset', 'synth', '--num_steps', '2', '--batch_size', '2',
          '--results', str(tmp_path / 'r'), '--logs', str(tmp_path / 'l'),
          '--model_id', 'fg_cli', '--save_ckpt', '--steps_per_valid', '0',
          '--steps_per_trainval', '0', '--cnn_depth', '4,8',
          '--cnn_pool', '2,2', '--dcnn_depth', '4,1', '--dcnn_pool', '2,2']
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    train_cli.fg_main(argv)
  exp = train_cli.fg_main(argv, device='cpu')
  assert exp.step == 2
  assert sorted(os.listdir(exp.folder)) == [
      'ckpt-2.npz', 'data_opt.yaml', 'model_opt.yaml']
  # And on from its checkpoint.
  exp = train_cli.fg_main(argv[:3] + ['4'] + argv[4:] + [
      '--restore', exp.folder], device='cpu')
  assert exp.step == 4
