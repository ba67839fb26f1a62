"""The count calibration of the port (pipelines/count_diag.py,
calibrate_count.py and the part of write_results.py they read) against
the JAX package's scripts, which are run as modules here.

1. The helpers on the same inputs: the Mean/Std rows, the sweep's split
   (``sbd_40`` a sweep entry, a stem ending in a digit plain), the best
   threshold (ties to the lower one) and the headline's markdown of the
   committed flagship folder.
2. A tiny full model over tiny synthetic splits that the JAX package
   writes (both packages read the same H5 files): calibrate_count's
   ``count_calibration.json`` within 1e-6 with the same picked thresholds,
   count_diag's JSON and CSV of the train split byte for byte, the
   ``output_{valid,train}_calibrated/`` CSVs equal and the same renders.
   Each run writes into its own copy of the model's folder.
3. ``slow``: the flagship's calibration on the synth224 splits on the CPU,
   the port held to JAX's, and the committed values it reproduces
   (ROADMAP C.17).
"""

import argparse
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from rec_attend_tpu import config as JC
from rec_attend_tpu.cli import args as JA
from rec_attend_tpu.data import provider as JP
from rec_attend_tpu.engine import experiment as jexp
from rec_attend_tpu.engine.saver import Saver
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu_torch.cli import args as PA
from rec_attend_tpu_torch.cli import eval as teval
from rec_attend_tpu_torch.data import provider as port_provider
from rec_attend_tpu_torch.engine.experiment import EvalExperiment
from rec_attend_tpu_torch.pipelines import calibrate_count
from rec_attend_tpu_torch.pipelines import count_diag
from rec_attend_tpu_torch.pipelines import write_results

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, REPO)
from pipelines import calibrate_count as jcalibrate  # noqa: E402
from pipelines import count_diag as jcount_diag  # noqa: E402
from pipelines import write_results as jwrite_results  # noqa: E402

torch.set_num_threads(1)

FLAGSHIP = os.path.join(REPO, 'results', 'full_model_synth-20260816104712')
SIZE = 32
T = 4
TRAIN_EXAMPLES = 16
# The flagship's count_diag scores of its 256 train examples (21 each), the
# port against JAX on the CPU: 8 of the 5,632 differ by more than 1e-4,
# the largest by 0.0029, each in a slot within two of its example's count,
# where the score is off the sigmoid's flat ends; none crosses a threshold
# of the grid, and the calibration's picks and numbers are the same.  The
# eval forward makes no knob or match decision: step 0's float32 rounding
# (under 1e-6 in the attention) is carried by the canvas feedback to those
# slots (ROADMAP C.17).
CALIBRATION_SCORE_RESIDUALS = {'count': 8, 'max_abs': 0.0029 + 1e-9,
                               'slots_from_count': 2}


def _csv(path, rows):
  with open(path, 'w') as f:
    f.write('ID,Score\n')
    for k, v in rows:
      f.write(f'{k},{v:.4f}\n')


def test_helpers_match_jax(tmp_path):
  """read_analyzer_csvs, split_sweep, best_threshold and headline_block
  give JAX's results on the same folders."""
  rng = np.random.RandomState(3)
  names = ['sbd_20', 'sbd_40', 'sbd_100', 'count_acc_40', 'count_acc_20',
           'abc1_40', 'sbd', 'fg_iou_all_7', 'dic_abs_40', 'dic_abs_20']
  for name in names:
    mean, std = rng.rand(2)
    _csv(tmp_path / f'{name}.csv', [('a', rng.rand()), ('Mean', mean),
                                    ('Std', std)])
  _csv(tmp_path / 'no_trailer.csv', [('a', 0.5)])
  got = write_results.read_analyzer_csvs(str(tmp_path))
  assert got == jwrite_results.read_analyzer_csvs(str(tmp_path))
  assert 'no_trailer' not in got and len(got) == len(names)
  plain, sweep = write_results.split_sweep(got)
  assert (plain, sweep) == jwrite_results.split_sweep(got)
  assert sorted(sweep) == [0.2, 0.4, 1.0]
  assert sorted(plain) == ['abc1_40', 'fg_iou_all_7', 'sbd']
  assert write_results.best_threshold(sweep) == jwrite_results.best_threshold(
      sweep)
  # A tie goes to the lower threshold, and a metric missing counts -1.
  tie = {0.5: {'sbd': (0.8, 0)}, 0.3: {'sbd': (0.8, 0)},
         0.7: {'sbd': (0.79, 0)}, 0.1: {'dic': (1.0, 0)}}
  assert write_results.best_threshold(tie) == 0.3
  assert write_results.best_threshold(tie, by='dic') == 0.1
  assert jwrite_results.best_threshold(tie) == 0.3
  assert write_results.headline_block(FLAGSHIP) == (
      jwrite_results.headline_block(FLAGSHIP))
  assert write_results.headline_block(FLAGSHIP)[0].startswith('### Headline')
  assert write_results.headline_block(str(tmp_path)) == []


def test_count_diag_summary_of_given_scores_matches_jax(tmp_path,
                                                         monkeypatch):
  """diagnose and write on the same scores give JAX's JSON and CSV bytes,
  ties of the grid included (the lowest threshold wins)."""
  rng = np.random.RandomState(0)
  s = rng.rand(12, 5).astype(np.float32)
  s[:, 0] = 0.9
  s[3] = [0.9, 0.35, 0.12, 0.0, 0.0]
  k = rng.randint(0, 6, size=12)

  class Fake:
    def __init__(self, *a, **kw):
      pass

    def iterate_split(self, split, output_keys):
      assert output_keys == ('s_out',)
      for lo in (0, 7):
        idx = slice(lo, lo + 7)
        yield None, {'s_gt': (np.arange(5)[None] < k[idx, None]).astype(
            np.float32)}, {'s_out': s[idx]}

  folder = tmp_path / 'jax' / 'm'
  Saver(str(folder), model_opt=JC.tiny_full_config())
  monkeypatch.setattr(jexp, 'EvalExperiment', Fake)
  want = jcount_diag.main(['--model_id', 'm', '--results',
                           str(tmp_path / 'jax')])
  got = count_diag.diagnose(s, k, 'm', 'valid')
  assert got == want
  count_diag.write(str(tmp_path), 'valid', got, s, k)
  for ext in ('json', 'csv'):
    name = f'count_diag_valid.{ext}'
    assert (tmp_path / name).read_bytes() == (folder / name).read_bytes()


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
  """A tiny trained-looking full model (the JAX init with weights scaled
  up, so that masks and counts are not empty, as in test_torch_eval.py)
  with its data_opt.yaml, the JAX package's synthetic train and valid
  splits, and its output_valid/: (results folder, data folder)."""
  root = tmp_path_factory.mktemp('calibrate')
  cfg = JC.tiny_full_config(timespan=T, inp_height=SIZE, inp_width=SIZE,
                            filter_height=8, filter_width=8)
  rng = np.random.RandomState(0)
  params = jax.jit(lambda key: JF.init_full_model(key, cfg))(
      jax.random.PRNGKey(0))
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) * (1 + 40 * rng.rand(*a.shape)).astype(
          np.float32) if a.ndim >= 2 else np.asarray(a), params)
  data = str(root / 'data')
  data_cfg = JC.DataConfig(dataset='synth', folder=data, height=SIZE,
                           width=SIZE, timespan=T,
                           num_examples=TRAIN_EXAMPLES)
  results = str(root / 'results')
  folder = os.path.join(results, 'full_model_tiny')
  Saver(folder, model_opt=cfg, data_opt=data_cfg).save({'params': params},
                                                        5)
  # The JAX package writes the splits; the port's eval the folder's
  # output_valid/, which both calibrations read as it is.
  for split in ('train', 'valid'):
    JP.get('synth', data_cfg, split=split)
  with pytest.MonkeyPatch.context() as mp:
    _port_reads_jax_splits(mp, data)
    teval.full_main(['--model_id', 'full_model_tiny', '--results', results,
                     '--batch_size', '8', '--dataset', 'synth',
                     '--threshold_list', '0.2,0.3,0.4,0.5,0.6,0.7',
                     '--no_render'], device='cpu')
  return folder, data


@pytest.fixture
def jax_init_shapes(monkeypatch):
  """JAX's EvalExperiment initialises the params op by op, an XLA compile
  a layer shape (most of this file's time), and then replaces every one by
  the checkpoint it restores: zeros of the init's shapes restore to the
  same params."""
  init = JF.init_full_model
  monkeypatch.setattr(JF, 'init_full_model', lambda key, cfg: (
      jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                             jax.eval_shape(lambda k: init(k, cfg), key))))


def _port_reads_jax_splits(monkeypatch, data):
  """The port's synth provider reads the JAX package's split files (the
  port draws its own images otherwise)."""
  get = port_provider.get

  def jax_files(name, data_opt, split='train', h5_fname=None):
    return get(name, data_opt, split=split, h5_fname=h5_fname or os.path.join(
        data, f'{split}_{SIZE}x{SIZE}.h5'))
  monkeypatch.setattr(port_provider, 'get', jax_files)


def _copy(folder, dst):
  shutil.copytree(folder, dst)
  return os.path.dirname(dst), os.path.basename(dst)


def _assert_close(got, want, path=''):
  if isinstance(want, dict):
    assert sorted(got) == sorted(want), path
    for k in want:
      _assert_close(got[k], want[k], f'{path}.{k}')
  elif isinstance(want, list):
    assert len(got) == len(want), path
    for i, (g, w) in enumerate(zip(got, want)):
      _assert_close(g, w, f'{path}[{i}]')
  elif isinstance(want, float):
    assert abs(got - want) <= 1e-6, (path, got, want)
  else:
    assert got == want, (path, got, want)


def _read(folder, name):
  with open(os.path.join(folder, name), 'rb') as f:
    return f.read()


def test_tiny_calibrate_count_matches_jax(tiny, tmp_path, monkeypatch,
                                          jax_init_shapes):
  folder, data = tiny
  jres, mid = _copy(folder, str(tmp_path / 'jax' / 'full_model_tiny'))
  pres, _ = _copy(folder, str(tmp_path / 'port' / 'full_model_tiny'))
  argv = ['--model_id', mid, '--batch_size', '8', '--dataset_folder', data]
  want = jcalibrate.main(argv + ['--results', jres])
  _port_reads_jax_splits(monkeypatch, data)
  timings = {}
  got = calibrate_count.main(argv + ['--results', pres], device='cpu',
                             timings=timings)
  assert sorted(timings) == ['count_diag', 'json', 'train_sweep',
                             'valid_eval']
  _assert_close(got, want)
  assert got['headline'] is not None
  assert got['calibrated_threshold'] == want['calibrated_threshold']
  assert (got['headline']['mask_threshold']
          == want['headline']['mask_threshold'])
  jdir, pdir = os.path.join(jres, mid), os.path.join(pres, mid)
  for name in ('count_diag_train.json', 'count_diag_train.csv'):
    assert _read(pdir, name) == _read(jdir, name), name
  _assert_close(json.loads(_read(pdir, 'count_calibration.json')),
                json.loads(_read(jdir, 'count_calibration.json')))
  for sub in ('output_valid_calibrated', 'output_train_calibrated'):
    want_files = sorted(f for f in os.listdir(os.path.join(jdir, sub))
                        if f.endswith('.csv'))
    got_files = sorted(f for f in os.listdir(os.path.join(pdir, sub))
                       if f.endswith('.csv'))
    assert got_files == want_files and len(want_files) == 13 * 6
    for name in want_files:
      assert _read(os.path.join(pdir, sub), name) == _read(
          os.path.join(jdir, sub), name), (sub, name)
  # The valid eval renders each threshold's instances; the train sweep
  # renders none.
  for sub, count in (('output_valid_calibrated', 6 * 8),
                     ('output_train_calibrated', 0)):
    got_pngs = _pngs(os.path.join(pdir, sub))
    assert got_pngs == _pngs(os.path.join(jdir, sub))
    assert len(got_pngs) == count


def _pngs(folder):
  return sorted(os.path.relpath(os.path.join(root, f), folder)
                for root, _, files in os.walk(folder) for f in files
                if f.endswith('.png'))


@pytest.mark.slow
def test_flagship_calibration_matches_jax(tmp_path, monkeypatch):
  """The flagship's calibration on the synth224 splits (256 train and 64
  valid examples, as its data_opt.yaml has JAX draw them) on the CPU (about
  20 minutes, JAX's part most): the port's count_calibration.json is JAX's
  on the CPU, every number; its count_diag scores are JAX's within 1e-4
  but for CALIBRATION_SCORE_RESIDUALS (ROADMAP C.17).  Of the committed
  file, which JAX wrote on the TPU, the CPU reproduces the mask threshold
  (0.40) and the headline's counts (count_acc, count_mse, dic, dic_abs)
  and is within 0.015 of its other means (obj_pr 0.012 the farthest, SBD
  0.0006 as in C.4); it picks a stop score of 0.35 where the TPU picked
  0.40 (C.17).  The outlying scores' batches then go through both eval
  forwards: the gap starts at float32 rounding in step 0."""
  data = str(tmp_path / 'data')
  folders = {}
  for side in ('jax', 'port'):
    folder = tmp_path / side / os.path.basename(FLAGSHIP)
    folder.mkdir(parents=True)
    os.symlink(os.path.join(FLAGSHIP, 'ckpt-30000.npz'),
               folder / 'ckpt-30000.npz')
    for name in ('model_opt.yaml', 'data_opt.yaml'):
      shutil.copy(os.path.join(FLAGSHIP, name), folder / name)
    shutil.copytree(os.path.join(FLAGSHIP, 'output_valid'),
                    folder / 'output_valid')
    folders[side] = str(folder)
  argv = ['--model_id', os.path.basename(FLAGSHIP), '--batch_size', '8',
          '--dataset_folder', data]
  want = jcalibrate.main(argv + ['--results', str(tmp_path / 'jax')])
  get = port_provider.get
  monkeypatch.setattr(port_provider, 'get', lambda name, opt, split='train',
                      h5_fname=None: get(name, opt, split=split, h5_fname=(
                          os.path.join(data, f'{split}_224x224.h5'))))
  got = calibrate_count.main(argv + ['--results', str(tmp_path / 'port')],
                             device='cpu')
  assert got == want
  with open(os.path.join(FLAGSHIP, 'count_calibration.json')) as f:
    committed = json.load(f)
  assert got['calibrated_threshold'] == 0.35
  assert committed['calibrated_threshold'] == 0.4
  head, committed_head = got['headline'], committed['headline']
  assert head['mask_threshold'] == committed_head['mask_threshold'] == 0.4
  for name, (mean, _) in committed_head['metrics'].items():
    if name in ('count_acc', 'count_mse', 'dic', 'dic_abs'):
      assert head['metrics'][name][0] == mean, name
    else:
      assert abs(head['metrics'][name][0] - mean) <= 0.015, name

  def scores(side):
    with open(os.path.join(folders[side], 'count_diag_train.csv')) as f:
      rows = [line.split(',') for line in f.read().splitlines()[1:]]
    return (np.array([[float(v) for v in r[2:]] for r in rows]),
            np.array([int(r[1]) for r in rows]))
  (port, k), (jax_s, _) = scores('port'), scores('jax')
  diff = np.abs(port - jax_s)
  assert diff.shape == (256, 21)
  off = np.argwhere(diff > 1e-4 + 1e-9)
  assert len(off) <= CALIBRATION_SCORE_RESIDUALS['count']
  assert diff.max() <= CALIBRATION_SCORE_RESIDUALS['max_abs']
  for i, t in off:
    assert abs(t - k[i]) <= CALIBRATION_SCORE_RESIDUALS['slots_from_count']
    lo, hi = sorted((port[i, t], jax_s[i, t]))
    assert not ((count_diag.SCORE_GRID >= lo)
                & (count_diag.SCORE_GRID < hi)).any(), (i, t)

  # Where the gap comes from: the b8 batches of those examples through
  # both eval forwards, as count_diag ran them.  Step 0's attention agrees
  # to float32 rounding and the scores of steps 0-2 and of saturated slots
  # all but exactly; the feedback carries the rest to the slots above.
  with open(os.path.join(folders['jax'], 'model_opt.yaml')) as f:
    jcfg = JC.FullModelConfig.from_dict(yaml.safe_load(f)).replace(
        use_knob=False)
  ns = argparse.Namespace(dataset='synth', dataset_folder=data)
  jeval = jexp.EvalExperiment(
      'full', jcfg, JC.TrainConfig(restore=folders['jax'], batch_size=8,
                                   results=str(tmp_path / 'jax')),
      JA.make_data_config(ns, restore=folders['jax']), splits=['train'])
  pexp = EvalExperiment(folders['port'], device='cpu')
  pds = port_provider.get('synth', PA.make_data_config(
      ns, restore=folders['port']), split='train')
  for lo in sorted({int(i) // 8 * 8 for i, _ in off}):
    _, _, want = next(jeval.iterate_split('train', output_keys=None,
                                          start_idx=lo, end_idx=lo + 8))
    with torch.inference_mode():
      got = pexp._forward(pds.get_batch(np.arange(lo, lo + 8),
                                        timespan=jcfg.timespan))

    def gap(key):
      return np.abs(got[key].numpy().astype(np.float64).reshape(
          np.shape(want[key])) - np.asarray(want[key], np.float64))
    for key in ('attn_ctr_norm', 'attn_lg_size'):
      assert gap(key)[:, 0].max() <= 1e-6, (lo, key)
    s_gap = gap('s_out').reshape(8, -1)
    s_jax = np.asarray(want['s_out']).reshape(8, -1)
    assert s_gap[:, :3].max() <= 1e-6, lo
    assert s_gap[(s_jax <= 0.01) | (s_jax >= 0.999)].max() <= 1e-5, lo
    assert s_gap.max() > 1e-4, lo
