"""The port's CVPPP and KITTI pipelines (``run_pipeline --dataset cvppp``:
box -> full -> eval; ``--dataset kitti``: fg -> pack into the H5 -> box ->
full -> eval) with the synth pipelines' tiny models
(``_small_h5_models.py``) on layout fixtures the port assembles at 64x64
(``chip_smoke.py``'s, at 60x50 and 40x124), a few steps a stage: at these
counts the full models find no instance, so the SBD compared is 0 and the
counts compared are the ground truth's.

The JAX package then works from the port's folders:

- its full ``EvalExperiment`` restores the port's CVPPP and KITTI full
  models (their ``pretrain_ctrl_net``, the box's ``weights.h5``, read
  first) and its ``eval_split`` gives the port's CSVs per example, SBD to
  1e-3 (4 decimals and float32 noise) and counts (``dic``) equal;
- its fg outputs, quantised as its ``pack_predictions`` writes them, are
  the bytes the port packed into KITTI's H5 files, one-level differences
  allowed in at most 1e-3 of the bytes (float32 noise at a truncation
  edge; 64x64 maps hold few bytes);
- it trains the port's KITTI full model on from its checkpoint, one step,
  on the port's files with the packed maps;
- the port's full pack (``cli.pack.full_main``) writes instance maps and
  scores into the valid H5 that JAX reads to the port's arrays.
"""

import csv
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from rec_attend_tpu import config as JC
from rec_attend_tpu.cli import eval as jeval
from rec_attend_tpu.data import provider as jprovider
from rec_attend_tpu.engine import experiment as jexp_lib
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.cli import pack
from rec_attend_tpu_torch.cli import setup_dataset
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.engine.experiment import EvalExperiment
from rec_attend_tpu_torch.pipelines import run_pipeline

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
import chip_smoke as cs  # noqa: E402
from _small_h5_models import small_models  # noqa: E402

STEPS = {'cvppp': 4, 'kitti': 4}
FULL_STEPS = 6
FIXTURES = {'cvppp': dict(count=10, height=60, width=50, seed=3),
            'kitti': dict(counts={'train': 6, 'valid': 3, 'test': 3},
                          height=40, width=124, seed=4)}


def _argv(root, dataset, *extra):
  return ['--dataset', dataset, '--scale', 'tiny', '--num_steps',
          str(STEPS[dataset]), '--full_steps', str(FULL_STEPS), '--results',
          os.path.join(root, 'results'), '--logs', os.path.join(root, 'logs'),
          '--dataset_folder', os.path.join(root, 'data'), '--model_id', 't',
          *extra]


@pytest.fixture(scope='module', autouse=True)
def _small():
  with small_models():
    yield


@pytest.fixture(scope='module', params=['cvppp', 'kitti'])
def run(request, tmp_path_factory):
  """The tiny pipeline on a fixture the port assembled at 64x64:
  {'dataset', 'root', 'ids', 'data_cfg'}."""
  dataset = request.param
  root = str(tmp_path_factory.mktemp(dataset))
  folder = os.path.join(root, 'data')
  (cs.kitti_fixture if dataset == 'kitti' else cs.cvppp_fixture)(
      folder, **FIXTURES[dataset])
  setup_dataset.main(['--dataset', dataset, '--folder', folder, '--splits',
                      'train,valid', '--height', '64', '--width', '64'])
  ids = run_pipeline.main(_argv(root, dataset), device='cpu')
  data_cfg = C.DataConfig.from_yaml(os.path.join(
      root, 'results', ids['full'], 'data_opt.yaml'))
  return {'dataset': dataset, 'root': root, 'ids': ids, 'data_cfg': data_cfg}


def _folder(run, stage):
  return os.path.join(run['root'], 'results', run['ids'][stage])


def _jax_data(run):
  return JC.DataConfig.from_dict(run['data_cfg'].to_dict())


def _jax_eval(run, stage, cfg_cls, **replace):
  folder = _folder(run, stage)
  with open(os.path.join(folder, 'model_opt.yaml')) as f:
    jcfg = cfg_cls.from_dict(yaml.safe_load(f)).replace(**replace)
  return jexp_lib.EvalExperiment(
      stage, jcfg, JC.TrainConfig(restore=folder, batch_size=4,
                                  results=os.path.dirname(folder)),
      _jax_data(run), splits=['valid'])


def _rows(path):
  """{example id: score} of an analyzer's CSV (its ID header and Mean and
  Std rows left out)."""
  with open(path) as f:
    return {r[0]: float(r[1]) for r in csv.reader(f)
            if r and r[0] not in ('ID', 'Mean', 'Std')}


def test_the_pipeline_writes_what_users_read(run):
  dataset = run['dataset']
  want = ['box', 'full', 'eval'] if dataset == 'cvppp' else [
      'fg', 'pack', 'box', 'full', 'eval']
  assert run['ids']['stages'] == want
  assert run['data_cfg'].dataset == dataset
  for stage, steps in (('box', STEPS[dataset]), ('full', FULL_STEPS)):
    assert saver.latest_checkpoint(_folder(run, stage)).endswith(
        f'ckpt-{steps}.npz')
  full_cfg = C.FullModelConfig.from_yaml(os.path.join(_folder(run, 'full'),
                                                      'model_opt.yaml'))
  assert full_cfg.pretrain_ctrl_net == os.path.join(_folder(run, 'box'),
                                                    'weights.h5')
  n_valid = provider.get(dataset, run['data_cfg'], 'valid').get_dataset_size()
  assert len(_rows(os.path.join(_folder(run, 'full'), 'output_valid',
                                'sbd.csv'))) == n_valid
  for split in ('train', 'valid'):
    assert provider.has_pack(run['data_cfg'], split) == (dataset == 'kitti')


def test_jax_evaluates_the_full_model_as_the_port(run, tmp_path):
  folder = _folder(run, 'full')
  jexp = _jax_eval(run, 'full', JC.FullModelConfig, use_knob=False)
  assert jexp.step == FULL_STEPS
  want_dir = str(tmp_path / 'jax')
  jeval.eval_split(jexp, 'valid', want_dir, [0.3], ['sbd', 'dic'],
                   render_output=False, batch_size=4)
  got = {m: _rows(os.path.join(folder, 'output_valid', f'{m}.csv'))
         for m in ('sbd', 'dic')}
  want = {m: _rows(os.path.join(want_dir, f'{m}.csv'))
          for m in ('sbd', 'dic')}
  assert sorted(got['sbd']) == sorted(want['sbd']) and want['sbd']
  for k in want['sbd']:
    assert abs(got['sbd'][k] - want['sbd'][k]) <= 1e-3, k
    assert got['dic'][k] == want['dic'][k], k


def test_kitti_packs_hold_jax_bytes_and_jax_trains_on(run):
  if run['dataset'] != 'kitti':
    pytest.skip('CVPPP has no fg stage, so no pack')
  jexp = _jax_eval(run, 'fg', JC.FGModelConfig)
  for split in ('train', 'valid'):
    ds = provider.get('kitti', run['data_cfg'], split=split)
    jds = jprovider.get('kitti', _jax_data(run), split=split)
    jexp.get_dataset = lambda _, jds=jds: jds
    want = {'d_out': [], 'y_out': []}
    for _, _, outputs in jexp.iterate_split(split):
      for k in want:
        want[k].append((np.clip(outputs[k], 0, 1) * 255).astype('uint8'))
    got = ds.get_batch(np.arange(ds.get_dataset_size()),
                       variables={'d_out', 'y_out'})
    for k in want:
      g = np.rint(got[k] * 255).astype(int)
      w = np.concatenate(want[k]).astype(int)
      assert g.shape == w.shape
      diff = np.abs(g - w)
      assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (split, k)
  # JAX trains the port's full model on, one step, on the packed files.
  folder = _folder(run, 'full')
  with open(os.path.join(folder, 'model_opt.yaml')) as f:
    jcfg = JC.FullModelConfig.from_dict(yaml.safe_load(f))
  train_cfg = JC.TrainConfig(restore=folder, num_steps=FULL_STEPS + 1,
                             batch_size=2, save_ckpt=False,
                             steps_per_valid=0, steps_per_trainval=0,
                             steps_per_plot=0, results=os.path.dirname(
                                 folder), logs=str(os.path.join(
                                     run['root'], 'jax_logs')))
  exp = jexp_lib.TrainingExperiment('full', jcfg, train_cfg, _jax_data(run))
  assert exp.step == FULL_STEPS
  exp.run()
  assert exp.step == FULL_STEPS + 1


def test_the_full_pack_into_the_h5_reads_in_jax(run):
  if run['dataset'] != 'kitti':
    pytest.skip('the fg pack is KITTI\'s; the full pack needs it')
  folder = _folder(run, 'full')
  written = pack.full_main(['--model_id', run['ids']['full'], '--results',
                            os.path.dirname(folder), '--split', 'valid',
                            '--batch_size', '2'], device='cpu')
  path = provider.h5_path('kitti', run['data_cfg'], 'valid')
  assert written['valid'][0] == path
  ds = provider.get('kitti', run['data_cfg'], split='valid')
  jds = jprovider.get('kitti', _jax_data(run), split='valid')
  n, t = ds.get_dataset_size(), 6
  v = {'y_out_ins', 's_out', 'y_out', 'd_out'}
  got = ds.get_batch(np.arange(n), timespan=t, variables=v)
  want = jds.get_batch(np.arange(n), timespan=t, variables=v)
  for k in v:
    assert got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  exp = EvalExperiment(folder, device='cpu')
  outs = [o for _, _, o in exp.iterate_split(ds, 2)]
  maps = torch.cat([pack.quantise(o['y_out']) for o in outs]).numpy()
  np.testing.assert_array_equal(got['y_out_ins'], maps / np.float32(255))
  np.testing.assert_array_equal(
      got['s_out'], torch.cat([o['s_out'] for o in outs]).numpy())


def test_resume_and_stages_of_the_h5_chains(run, tmp_path):
  dataset = run['dataset']
  # --resume with a full checkpoint skips the prefix (KITTI: only where
  # both splits hold the packed maps).
  again = run_pipeline.main(_argv(run['root'], dataset, '--resume',
                                  '--stages', ','.join(run['ids']['stages'])),
                            device='cpu')
  assert again['stages'] == ['full', 'eval']
  if dataset == 'cvppp':
    with pytest.raises(ValueError, match='fg'):
      run_pipeline.main(_argv(str(tmp_path), dataset, '--stages', 'fg'),
                        device='cpu')
  else:
    data = os.path.join(str(tmp_path), 'data')
    cs.kitti_fixture(data, **FIXTURES['kitti'])
    setup_dataset.main(['--dataset', 'kitti', '--folder', data, '--splits',
                        'train,valid', '--height', '64', '--width', '64'])
    with pytest.raises(FileNotFoundError, match='pack stage'):
      run_pipeline.main(_argv(str(tmp_path), 'kitti', '--stages', 'box'),
                        device='cpu')


@pytest.mark.parametrize('dataset', ['cvppp', 'kitti'])
def test_the_tiny_scale_is_jaxs_paper_presets_for_100_steps(dataset):
  """As JAX's run_cvppp and run_kitti: --scale tiny trains the paper
  presets at the dataset's size for --num_steps or 100 steps a stage."""
  configs = {'cvppp': run_pipeline.cvppp_stages,
             'kitti': run_pipeline.kitti_stages}[dataset]
  paper, tiny = configs('paper', dataset_folder='d'), configs(
      'tiny', dataset_folder='d')
  assert paper[:4] == tiny[:4] and paper[6] == tiny[6]
  assert tiny[0] == C.data_config_for(dataset, 'd')
  assert set(tiny[5].values()) == {100}
  assert set(configs('tiny', num_steps=7)[5].values()) == {7}
  assert max(paper[5].values()) > 100
