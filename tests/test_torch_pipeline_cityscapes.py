"""The port's Cityscapes pipeline (``run_pipeline --dataset cityscapes``: fg
-> pack into the train, valid and test H5 files -> box -> full ->
full_pack -> cityscapes_eval of valid and test) with the tiny models of
``_small_h5_models.py`` (9 semantic channels), on chip_smoke.py's layout
fixture prepared by ``data.cityscapes_prep`` and assembled at 64x64, a few
steps a stage.  The JAX package then works from the port's folders:

- it reads the fg and the full model's packs from the port's H5 files to
  the port's arrays;
- its ``cli/cityscapes_eval.main`` over the port's packed valid split
  writes the port's CSVs, renders and submission files;
- its ``run_cityscapes`` presets are the port's at both scales.

Last, chip_smoke.py's ``cityscapes_pipeline`` phase on the CPU at a small
fixture, its digests and AP made here with the JAX package's prep,
assembler and command lines.
"""

import glob
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

from rec_attend_tpu import config as JC
from rec_attend_tpu.cli import cityscapes_eval as jcs
from rec_attend_tpu.data import cityscapes_prep as jprep
from rec_attend_tpu.data.cityscapes import Cityscapes as JCityscapes
from rec_attend_tpu.data.cityscapes import CityscapesAssembler as JAssembler
from rec_attend_tpu.data.dataset import pack_predictions as jpack
from rec_attend_tpu.eval_cityscapes import instance_eval as jie
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.cli import setup_dataset
from rec_attend_tpu_torch.data import cityscapes_prep as prep
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.ops.cuda import glimpse as gk
from rec_attend_tpu_torch.pipelines import run_pipeline

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
import chip_smoke as cs  # noqa: E402
from _small_h5_models import small_models  # noqa: E402
from test_torch_cityscapes_eval_cli import _same_outputs  # noqa: E402

STEPS = 3
FIXTURE = dict(counts={'train': 8, 'valid': 4, 'test': 4}, height=128,
               width=256, seed=31)
SPLITS = ('train', 'valid', 'test')


def _argv(root, *extra):
  return ['--dataset', 'cityscapes', '--scale', 'tiny', '--num_steps',
          str(STEPS), '--results', os.path.join(root, 'results'), '--logs',
          os.path.join(root, 'logs'), '--dataset_folder',
          os.path.join(root, 'data'), '--model_id', 't', *extra]


@pytest.fixture(scope='module')
def run(tmp_path_factory):
  root = str(tmp_path_factory.mktemp('cityscapes'))
  folder = os.path.join(root, 'data')
  cs.cityscapes_fixture(folder, **FIXTURE)
  prep.main(['--dataset', folder])
  setup_dataset.main(['--dataset', 'cityscapes', '--folder', folder,
                      '--splits', ','.join(SPLITS), '--height', '64',
                      '--width', '64'])
  with small_models('cityscapes'):
    ids = run_pipeline.main(_argv(root), device='cpu')
  data_cfg = C.DataConfig.from_yaml(os.path.join(
      root, 'results', ids['full'], 'data_opt.yaml'))
  return {'root': root, 'ids': ids, 'data_cfg': data_cfg}


def _folder(run, stage):
  return os.path.join(run['root'], 'results', run['ids'][stage])


def test_the_pipeline_writes_what_users_read(run):
  assert run['ids']['stages'] == list(run_pipeline.CITYSCAPES_STAGES)
  cfg = run['data_cfg']
  assert (cfg.dataset, cfg.timespan) == ('cityscapes', 6)
  for stage in ('fg', 'box', 'full'):
    assert saver.latest_checkpoint(_folder(run, stage)).endswith(
        f'ckpt-{STEPS}.npz')
  full_cfg = C.FullModelConfig.from_yaml(os.path.join(_folder(run, 'full'),
                                                      'model_opt.yaml'))
  assert full_cfg.pretrain_ctrl_net == os.path.join(_folder(run, 'box'),
                                                    'weights.h5')
  for split in SPLITS:
    assert provider.has_pack(cfg, split)
  for split in run_pipeline.CITYSCAPES_EVAL_SPLITS:
    out = os.path.join(_folder(run, 'full'), f'output_{split}')
    ds = provider.get('cityscapes', cfg, split=split)
    for name in ('sbd.csv', 'wt_cov.csv', 'unwt_cov.csv', '60/count.csv'):
      assert os.path.exists(os.path.join(out, name)), name
    for i in ds.img_ids:
      fname = ds.get_fname(i)
      assert os.path.exists(os.path.join(out, 'cityscapes',
                                         fname.split('_')[0],
                                         fname[:-4] + '.txt'))
      render = cv2.imread(os.path.join(out, '60', fname), -1)
      assert render.shape == (128, 256, 3)
    summary, folder = run['ids']['cityscapes_eval'][split]
    assert folder == out and sorted(summary) == [0.6]


def test_jax_reads_the_port_packs(run):
  cfg = run['data_cfg']
  for split in SPLITS:
    ds = provider.get('cityscapes', cfg, split=split)
    idx = np.arange(ds.get_dataset_size())
    v = {'y_out', 'd_out'} | ({'y_out_ins', 's_out'} if split != 'train'
                             else set())
    got = ds.get_batch(idx, timespan=6, variables=v)
    want = JCityscapes(ds.h5_fname).get_batch(idx, timespan=6, variables=v)
    for k in v:
      assert np.array_equal(got[k], want[k]), (split, k)
    assert got['y_out'].shape[-1] == 9


def test_jax_evaluates_the_port_packs_to_the_port_files(run, tmp_path):
  """JAX's command line over the port's packed valid split (the full
  model's data_opt.yaml, written by the port) writes the port's files."""
  out = str(tmp_path / 'jax')
  jcs.main(['--model_id', run['ids']['full'], '--results',
            os.path.join(run['root'], 'results'), '--dataset', 'cityscapes',
            '--split', 'valid', '--output', out])
  _same_outputs(os.path.join(_folder(run, 'full'), 'output_valid'), out)


def test_stages_and_resume(run, tmp_path):
  """The eval stages alone again write the same files; --resume skips the
  trained prefix; a chain without its packs refuses the box stage."""
  valid = os.path.join(_folder(run, 'full'), 'output_valid')
  before = str(tmp_path / 'before')
  shutil.copytree(valid, before)
  with small_models('cityscapes'):
    again = run_pipeline.main(_argv(run['root'], '--stages',
                                    'full_pack,cityscapes_eval'),
                              device='cpu')
    assert again['stages'] == ['full_pack', 'cityscapes_eval']
    _same_outputs(valid, before)
    resumed = run_pipeline.main(_argv(run['root'], '--resume', '--stages',
                                      'fg,pack,box,full'), device='cpu')
    assert resumed['stages'] == ['full']
    data = str(tmp_path / 'data')
    cs.cityscapes_fixture(data, {'train': 2, 'valid': 1}, 64, 128, 2)
    prep.main(['--dataset', data])
    setup_dataset.main(['--dataset', 'cityscapes', '--folder', data,
                        '--splits', 'train,valid', '--height', '64',
                        '--width', '64'])
    with pytest.raises(FileNotFoundError, match='pack stage'):
      run_pipeline.main(_argv(str(tmp_path), '--stages', 'box'),
                        device='cpu')


@pytest.mark.parametrize('scale', ['paper', 'tiny'])
def test_the_presets_are_jaxs_run_cityscapes(scale):
  """As JAX's run_cityscapes: the Cityscapes presets, fg b8 prefetched,
  box b4, full b2, 40,000, 60,000 and 70,000 steps at the paper scale and
  --num_steps or 100 at the tiny one."""
  data_cfg, fg, box, full, train_cfg, steps, batch = (
      run_pipeline.cityscapes_stages(scale, dataset_folder='d'))
  assert data_cfg == C.data_config_for('cityscapes', 'd')
  for got, want in ((fg, JC.cityscapes_fg_config()),
                    (box, JC.cityscapes_box_config()),
                    (full, JC.cityscapes_full_config())):
    assert {k: v for k, v in got.to_dict().items()
            if k in want.to_dict()} == {
                k: v for k, v in want.to_dict().items()
                if k in got.to_dict()}
  assert batch == {'fg': 8, 'box': 4, 'full': 2}
  assert train_cfg.prefetch and not train_cfg.device_data
  assert steps == ({'fg': 40000, 'box': 60000, 'full': 70000}
                   if scale == 'paper' else dict.fromkeys(steps, 100))
  assert set(run_pipeline.cityscapes_stages(
      scale, num_steps=7)[5].values()) == ({7} if scale == 'tiny' else {7})


def _jax_pinned(tmp_path, fixture, size):
  """The phase's three pins made by the JAX package on ``fixture``: the
  digest of its prep's images, of its assembler's files at ``size``, and
  the AP of the valid split's ground-truth pack through its command
  lines."""
  root = str(tmp_path / 'jax')
  cs.cityscapes_fixture(root, **fixture)
  jprep.main(['--dataset', root])
  opt = {'height': size[0], 'width': size[1]}
  paths = []
  for split in SPLITS:
    paths.append(os.path.join(root, f'{split}_{size[0]}x{size[1]}.h5'))
    JAssembler(root, opt, split=split, output_fname=paths[-1]).assemble()
  h5_digest = cs.cityscapes_h5_digest(paths)
  ds = JCityscapes(paths[1])
  for pos in range(ds.get_dataset_size()):
    b = ds.get_batch([pos], timespan=20, variables={'y_gt', 'c_gt', 'd_gt',
                                                    's_gt', 'idx_map'})
    jpack(paths[1], ds.get_str_id(b['idx_map'][0]), foreground=b['c_gt'][0],
          orientation=b['d_gt'][0], instance=b['y_gt'][0],
          score=b['s_gt'][0] * 0.9)
  results = str(tmp_path / 'results')
  os.makedirs(os.path.join(results, 'gt_pack'))
  with open(os.path.join(results, 'gt_pack', 'data_opt.yaml'), 'w') as f:
    yaml.safe_dump(JC.DataConfig(dataset='cityscapes', folder=root,
                                 height=size[0], width=size[1],
                                 timespan=20).to_dict(), f)
  jcs.main(['--model_id', 'gt_pack', '--results', results, '--split',
            'valid'])
  ap = jie.main(['--predictions', os.path.join(
      results, 'gt_pack', 'output_valid', 'cityscapes'), '--dataset', root,
                 '--split', 'val'])
  return {'prep': cs.cityscapes_prep_digest(root),
          'h5': h5_digest,
          'ap': {k: ap[k] for k in cs.CITYSCAPES_GT_AP}}


def test_chip_smoke_cityscapes_pipeline_phase_on_cpu(tmp_path):
  fixture = dict(FIXTURE, height=256, width=512, seed=5)
  pinned = _jax_pinned(tmp_path, fixture, (64, 64))
  assert pinned['ap']['allAp'] > 0
  with small_models('cityscapes'):
    out, failures = cs.h5_pipeline_phase(
        torch, gk, torch.device('cpu'), 'cityscapes', fixture=fixture,
        size=(64, 64), pinned=pinned)
  assert failures == []
  for g in (out['prep']['gate'], out['h5_digest']['gate'],
            out['files_gate'], out['eval_step']['gate'],
            out['pack']['gate'], out['gt_ap']['gate'],
            out['codec_gate'], out['jax_h5']['gate']):
    assert g['failures'] == [] and g['control_failures']
  assert out['gt_ap']['ap'] == pinned['ap']
  for stage in ('fg', 'box', 'full'):
    assert sorted(out[stage]['step_ms_at_log']) == [cs.H5_PIPELINE_STEPS]
  assert sorted(out['assemble']) == sorted(SPLITS)
  assert set(out['cityscapes_eval_host_seconds_per_image']) == {
      'postprocess', 'analyzers', 'renders', 'submission'}
  assert len(out['pack']['full_pack_seconds']) == 1
  # On the CPU the kernel glimpses are the plain ones: nothing launches.
  assert not any(out['eval_launches']['launches'].values())
  assert 'launch_gate' not in out
  assert glob.glob(os.path.join(cs.REPO, '.chip_smoke_cityscapes-*')) == []
