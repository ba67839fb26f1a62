"""The port's synth3 pipeline (fg -> pack -> box -> full -> eval) at
``--scale tiny``, its pack store on disk, its options, and
``chip_smoke.py``'s ``synth3_pipeline`` phase at the tiny scale on the CPU.

The chain runs as two invocations of ``run_pipeline.main``, ``--stages
fg,pack`` and then ``--stages box,full,eval --model_id <id>``: the packed
maps cross from one to the other through the pack files only.  The fg and
box stages take 20 steps, as the JAX pipeline's ``--num_steps 20``; the
full stage takes 60, enough that the full model finds instances (at 20 its
SBD is 0 in every example, and the comparison would compare nothing).  The
JAX package then restores the port's folders on the port's splits:

- its fg ``EvalExperiment`` and ``pipelines/eval_fg_metrics.main`` give
  the port's ``fg_metrics_valid.json`` within 2e-4 (the file holds 4
  decimals);
- its fg outputs, quantised as its ``pack_predictions`` writes them, are
  the port's pack files' bytes, one-step differences allowed in at most
  1e-4 of the bytes (float32 noise at a truncation edge);
- its full ``EvalExperiment`` reads the port's packed bytes, and its
  ``eval_split`` gives the port's CSVs at each of the six thresholds to
  1e-3 in SBD per example (4 decimals and float32 noise), with equal
  counts (``dic``).
"""

import argparse
import csv
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

from rec_attend_tpu import config as JC
from rec_attend_tpu.cli import eval as jeval
from rec_attend_tpu.data.dataset import pack_predictions
from rec_attend_tpu.data.synthetic import make_synthetic_h5
from rec_attend_tpu.engine import experiment as jexp_lib
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import train_step as ts
from rec_attend_tpu_torch.cli import pack
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
from rec_attend_tpu_torch.pipelines import run_pipeline

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
import chip_smoke as cs  # noqa: E402
from pipelines import eval_fg_metrics as jfg_metrics  # noqa: E402
from rec_attend_tpu_torch.ops.cuda import glimpse as gk  # noqa: E402

STEPS, FULL_STEPS = 20, 60
THRESHOLDS = [0.2, 0.3, 0.4, 0.5, 0.6, 0.7]


def _argv(root, *extra):
  return ['--dataset', 'synth3', '--scale', 'tiny', '--num_steps',
          str(STEPS), '--results', os.path.join(root, 'results'), '--logs',
          os.path.join(root, 'logs'), '--dataset_folder',
          os.path.join(root, 'data'), '--model_id', 'chain', *extra]


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
  """The tiny chain in two invocations: {'root', 'ids', 'data_cfg'}."""
  root = str(tmp_path_factory.mktemp('synth3'))
  first = run_pipeline.main(_argv(root, '--stages', 'fg,pack'),
                            device='cpu')
  assert first['stages'] == ['fg', 'pack']
  second = run_pipeline.main(
      _argv(root, '--stages', 'box,full,eval', '--full_steps',
            str(FULL_STEPS)), device='cpu')
  assert second['stages'] == ['box', 'full', 'eval']
  assert {k: first[k] for k in ('fg', 'box', 'full')} == {
      k: second[k] for k in ('fg', 'box', 'full')}
  data_cfg = C.DataConfig.from_yaml(os.path.join(
      root, 'results', second['full'], 'data_opt.yaml'))
  return {'root': root, 'ids': second, 'data_cfg': data_cfg}


def _folder(chain, stage):
  return os.path.join(chain['root'], 'results', chain['ids'][stage])


def _jax_eval(chain, stage, cfg_cls, **replace):
  folder = _folder(chain, stage)
  with open(os.path.join(folder, 'model_opt.yaml')) as f:
    jcfg = cfg_cls.from_dict(yaml.safe_load(f)).replace(**replace)
  return jexp_lib.EvalExperiment(
      stage, jcfg, JC.TrainConfig(restore=folder, batch_size=4,
                                  results=os.path.dirname(folder)),
      JC.DataConfig.from_dict(chain['data_cfg'].to_dict()),
      splits=['valid'])


def _rows(path):
  with open(path) as f:
    return {r[0]: float(r[1]) for r in csv.reader(f)
            if r and r[0].startswith('synth')}


def test_chain_writes_what_users_read(chain):
  ids, data_cfg = chain['ids'], chain['data_cfg']
  for stage, steps in (('fg', STEPS), ('box', STEPS), ('full', FULL_STEPS)):
    assert saver.latest_checkpoint(_folder(chain, stage)).endswith(
        f'ckpt-{steps}.npz')
  full_cfg = C.FullModelConfig.from_yaml(os.path.join(_folder(chain, 'full'),
                                                      'model_opt.yaml'))
  # The box's controller is handed over as JAX hands it over: its last
  # checkpoint exported to the box folder's weights.h5.
  assert full_cfg.pretrain_ctrl_net == os.path.join(
      _folder(chain, 'box'), 'weights.h5')
  assert os.path.isfile(full_cfg.pretrain_ctrl_net)
  assert data_cfg.folder == os.path.join(chain['root'], 'data')
  for split in ('train', 'valid'):
    assert provider.has_pack(data_cfg, split)
    assert isinstance(provider.get('synth', data_cfg, split=split),
                      provider.PackedDataset)
  for tt in THRESHOLDS:
    path = os.path.join(_folder(chain, 'full'), 'output_valid',
                        f'sbd_{int(tt * 100):02d}.csv')
    assert len(_rows(path)) == 8
  with open(os.path.join(_folder(chain, 'fg'), 'fg_metrics_valid.json')) as f:
    metrics = json.load(f)
  assert metrics['step'] == STEPS and metrics['n'] == 8
  assert ids['fg'] == 'fg_model_synth3-chain'


def test_fg_metrics_as_jax(chain, monkeypatch):
  """Tolerance 2e-4: both files round to 4 decimals."""
  folder = _folder(chain, 'fg')
  with open(os.path.join(folder, 'fg_metrics_valid.json')) as f:
    got = json.load(f)
  valid = provider.get('synth', chain['data_cfg'], split='valid')
  monkeypatch.setattr(jexp_lib.EvalExperiment, 'get_dataset',
                      lambda self, split: valid)
  jfg_metrics.main(['--model_id', chain['ids']['fg'], '--results',
                    os.path.dirname(folder), '--batch_size', '4'])
  with open(os.path.join(folder, 'fg_metrics_valid.json')) as f:
    want = json.load(f)
  assert sorted(got) == sorted(want)
  for k in ('iou_soft', 'iou_hard', 'orientation_acc'):
    assert abs(got[k] - want[k]) <= 2e-4, k
  assert (got['n'], got['step']) == (want['n'], want['step'])


def test_pack_files_hold_jax_bytes(chain):
  """JAX's fg outputs quantised as pack_predictions writes them; one-step
  differences in at most 1e-4 of the bytes."""
  jexp = _jax_eval(chain, 'fg', JC.FGModelConfig)
  for split in ('train', 'valid'):
    ds = provider.get('synth', chain['data_cfg'], split=split).dataset
    jexp.get_dataset = lambda _, ds=ds: ds
    want = {'d_out': [], 'y_out': []}
    for _, _, outputs in jexp.iterate_split(split):
      for k in want:
        want[k].append((np.clip(outputs[k], 0, 1) * 255).astype('uint8'))
    with np.load(provider.pack_path(chain['data_cfg'], split)) as f:
      assert list(f['ids']) == list(ds.img_ids)
      for k in want:
        got, w = f[k].astype(int), np.concatenate(want[k]).astype(int)
        assert got.shape == w.shape
        diff = np.abs(got - w)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (split, k)


def test_full_model_evaluates_as_jax_on_the_packed_bytes(chain, tmp_path):
  folder = _folder(chain, 'full')
  # The folder as the port wrote it: JAX reads its pretrain_ctrl_net, the
  # box's weights.h5, before the checkpoint sets every parameter.
  jexp = _jax_eval(chain, 'full', JC.FullModelConfig, use_knob=False)
  assert jexp.step == FULL_STEPS
  valid = provider.get('synth', chain['data_cfg'], split='valid')
  assert isinstance(valid, provider.PackedDataset)
  jexp.get_dataset = lambda split: valid
  want_dir = str(tmp_path / 'jax')
  jeval.eval_split(jexp, 'valid', want_dir, THRESHOLDS,
                   jeval.DEFAULT_ANALYZERS, render_output=False, batch_size=4)
  sbds = []
  for tt in THRESHOLDS:
    name = f'{int(tt * 100):02d}'
    got = {m: _rows(os.path.join(folder, 'output_valid', f'{m}_{name}.csv'))
           for m in ('sbd', 'dic')}
    want = {m: _rows(os.path.join(want_dir, f'{m}_{name}.csv'))
            for m in ('sbd', 'dic')}
    assert sorted(got['sbd']) == sorted(want['sbd'])
    for k in want['sbd']:
      assert abs(got['sbd'][k] - want['sbd'][k]) <= 1e-3, (tt, k)
      assert got['dic'][k] == want['dic'][k], (tt, k)
    sbds += list(got['sbd'].values())
  assert np.isfinite(sbds).all() and max(sbds) > 0


def test_pack_store_gives_jax_read_back(tmp_path):
  """Crafted maps (every k/255, the floats between, values outside [0, 1])
  through the port's pack file and provider, and through JAX's
  pack_predictions and its Synthetic read-back: the same float32 maps, bit
  for bit."""
  h, w = 16, 32
  data_cfg = C.DataConfig(dataset='synth', folder=str(tmp_path / 'data'),
                          height=h, width=w, timespan=3, num_examples=32)
  n = provider.settings(data_cfg, 'valid')['num_examples']
  k = np.arange(256, dtype=np.float32)
  values = np.concatenate([
      k / 255, (k + 0.5) / 255, np.nextafter(k / 255, -1, dtype=np.float32),
      np.nextafter(k / 255, 2, dtype=np.float32),
      np.array([-1, -1e-7, 1 + 1e-7, 1.5, 255], np.float32)])
  rng = np.random.RandomState(0)
  d = rng.choice(values, (n, h, w, 8)).astype(np.float32)
  y = rng.choice(values, (n, h, w, 1)).astype(np.float32)
  d[0].flat[:len(values)] = values     # every value at least once
  y[1].flat[:len(values)] = values
  path = provider.pack_path(data_cfg, 'valid')
  ids = provider.get('synth', data_cfg, split='valid').img_ids
  provider.write_pack(path, ids, pack.quantise(torch.from_numpy(d)).numpy(),
                      pack.quantise(torch.from_numpy(y)).numpy(),
                      provider.settings(data_cfg, 'valid'))
  got = provider.get('synth', data_cfg, split='valid')
  assert isinstance(got, provider.PackedDataset)
  got = got.get_batch(np.arange(n), variables={'d_out', 'y_out', 'x'})
  assert sorted(got) == ['d_out', 'x', 'y_out']

  jds = make_synthetic_h5(str(tmp_path / 'jax.h5'), height=h, width=w,
                          num_examples=n)
  for i, sid in enumerate(jds.get_str_id(j) for j in jds.img_ids):
    pack_predictions(jds.h5_fname, sid, foreground=y[i], orientation=d[i])
  want = jds.get_batch(np.arange(n), variables={'d_out', 'y_out'})
  for key in ('d_out', 'y_out'):
    assert got[key].dtype == want[key].dtype == np.float32
    assert np.array_equal(got[key], want[key]), key

  # decode -> encode_batch gives back every byte, and the device's decode
  # is the table's.
  table = provider._DECODE
  enc = ts.encode_batch({'d_in': table, 'y_in': table})
  assert np.array_equal(enc['d_in'], np.arange(256)) and enc['d_in'].dtype \
      == np.uint8
  assert torch.equal(ts.decode_batch({'d_in': torch.from_numpy(
      enc['d_in'])})['d_in'], torch.from_numpy(table))

  # A file written for other settings is not used, and stays for the
  # settings it was written for.
  other = data_cfg.replace(max_objects=5)
  assert not provider.has_pack(other, 'valid')
  assert not isinstance(provider.get('synth', other, split='valid'),
                        provider.PackedDataset)
  assert isinstance(provider.get('synth', data_cfg, split='valid'),
                    provider.PackedDataset)


def test_device_split_holds_the_packed_bytes(chain, tmp_path):
  """The box stage with its split on the device (here the CPU): d_in and
  y_in are the pack file's bytes; host-fed, the same maps decoded."""
  data_cfg = chain['data_cfg']
  cfg = run_pipeline.synth3_stages('tiny')[2]
  tcfg = C.TrainConfig(num_steps=1, batch_size=4, results=str(tmp_path),
                       logs=str(tmp_path), device_data=True,
                       steps_per_valid=0, steps_per_trainval=0)
  exp = TrainingExperiment('box', cfg, tcfg, data_cfg, device='cpu')
  with np.load(provider.pack_path(data_cfg, 'train')) as f:
    for src, dst in (('d_out', 'd_in'), ('y_out', 'y_in')):
      got = exp.device_train_data[dst]
      assert got.dtype == torch.uint8
      assert np.array_equal(got.numpy(), f[src])
      host = exp.make_batch_fn(exp.train_ds, cfg.timespan)(np.arange(4))
      assert np.array_equal(host[dst], f[src][:4] / np.float32(255))
  exp.run()
  exp.close()
  assert exp.step == 1


def _copy(chain, tmp_path):
  root = str(tmp_path / 'copy')
  shutil.copytree(chain['root'], root)
  return root


def test_reused_stages_are_not_trained(chain, tmp_path):
  root = _copy(chain, tmp_path)
  ids = chain['ids']
  results = os.path.join(root, 'results')
  before = {s: saver.list_checkpoints(os.path.join(results, ids[s]))
            for s in ('fg', 'box')}
  out = run_pipeline.main(
      _argv(root, '--stages', 'fg,box,full', '--fg_from', ids['fg'],
            '--box_from', ids['box'], '--model_id', 'reuse', '--full_steps',
            '1'), device='cpu')
  assert out['stages'] == ['full']
  assert (out['fg'], out['box']) == (ids['fg'], ids['box'])
  assert {s: saver.list_checkpoints(os.path.join(results, ids[s]))
          for s in ('fg', 'box')} == before
  cfg = C.FullModelConfig.from_yaml(os.path.join(
      results, out['full'], 'model_opt.yaml'))
  assert cfg.pretrain_ctrl_net == os.path.join(results, ids['box'],
                                               'weights.h5')


def test_resume_with_other_data_raises(chain, tmp_path):
  """--data_examples sizes the paper scale's split (the tiny scale's is
  32, as JAX's): the relaunch's fg stage checks its snapshot, and the
  first setting it holds, num_examples, differs, before anything runs."""
  root = _copy(chain, tmp_path)
  with pytest.raises(ValueError, match='num_examples'):
    run_pipeline.main(_argv(root, '--stages', 'fg', '--resume', '--scale',
                            'paper', '--data_examples', '40'), device='cpu')


def test_resume_skips_the_completed_prefix(chain, tmp_path):
  root = _copy(chain, tmp_path)
  results = os.path.join(root, 'results')
  full = os.path.join(results, chain['ids']['full'])
  out = run_pipeline.main(_argv(root, '--resume', '--stages',
                                'fg,pack,box,full', '--full_steps',
                                str(FULL_STEPS + 2)), device='cpu')
  assert out['stages'] == ['full']
  assert [s for s, _ in saver.list_checkpoints(full)] == [
      FULL_STEPS, FULL_STEPS + 2]
  for stage in ('fg', 'box'):
    assert saver.latest_checkpoint(os.path.join(
        results, chain['ids'][stage])).endswith(f'ckpt-{STEPS}.npz')
  with open(os.path.join(root, 'logs', chain['ids']['full'],
                         'loss.csv')) as f:
    steps = [int(r.split(',')[0]) for r in f.read().splitlines()[1:]]
  assert steps[-1] == FULL_STEPS + 2 and FULL_STEPS + 1 not in steps[:-1]
  # Without a pack file the prefix runs again.
  os.remove(provider.pack_path(C.DataConfig.from_yaml(os.path.join(
      full, 'data_opt.yaml')).replace(folder=os.path.join(root, 'data')),
      'valid'))
  kept = run_pipeline._skip_completed_prefix(
      argparse.Namespace(resume=True, results=results),
      {'fg', 'pack', 'box', 'full'}, chain['ids']['full'],
      chain['data_cfg'].replace(folder=os.path.join(root, 'data')), None)
  assert kept == {'fg', 'pack', 'box', 'full'}


def test_unknown_stage_and_missing_pack_raise(tmp_path):
  root = str(tmp_path)
  with pytest.raises(ValueError, match='ap'):
    run_pipeline.main(_argv(root, '--stages', 'fg,ap'), device='cpu')
  with pytest.raises(FileNotFoundError, match='pack stage'):
    run_pipeline.main(_argv(root, '--stages', 'box'), device='cpu')


def test_chip_smoke_synth3_pipeline_phase_on_cpu():
  out, failures = cs.synth3_pipeline_phase(
      torch, gk, torch.device('cpu'), scale='tiny', examples=8,
      cli_examples=2)
  assert failures == []
  for gated in (out['fg']['split_gate'], out['box']['pack_gate'],
                out['full']['pretrained_gate'],
                out['fg_metrics']['gate'], out['resumed']['gate'],
                out['eval']['command_line']['gate']):
    assert gated['failures'] == [] and gated['control_failures']
  for stage in ('fg', 'box', 'full'):
    assert out[stage]['checkpoints'] == [4, 6]
    assert sorted(out[stage]['step_ms_at_log']) == list(range(1, 7))
  assert out['resumed']['stages'] == ['full']
  assert out['resumed']['start_step'] == 6
  assert out['resumed']['checkpoints'] == [6, 8]
  assert out['child']['exit_code'] == 0
  assert out['pack']['bytes']['valid'] > 0
  # The child's own runs: its box and full stages' steps, counted there.
  assert [len(out['launches_per_step'][s]) for s in ('fg', 'box', 'full')] \
      == [6, 6, 6 + 2]
  assert out['box']['start_step'] == out['full']['start_step'] == 0
  # On the CPU the kernel glimpses are the plain ones: nothing launches.
  assert not any(out['plain_step_launches']['launches'].values())
  assert 'launch_gate' not in out
