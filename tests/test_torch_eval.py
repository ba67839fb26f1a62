"""The port's eval path (EvalExperiment, the postprocess chain, the
analyzers and eval_split) against the JAX package's.

1. A tiny checkpoint on a tiny synthetic split, built by the JAX package:
   JAX ``eval_split`` and the port's write the same CSV files, line for
   line, at a two-threshold sweep, once with the explicit score gate and
   once with foreground maps, dilation and ``remove_tiny``.
2. The headline: the flagship checkpoint on the synth224 valid split (64
   examples, seed 4, up to 9 objects, as ``rec_attend_tpu/data/provider.py``
   builds it), score threshold 0.40 and mask threshold 0.40, no foreground,
   no ``remove_tiny`` (``count_calibration.json``'s headline).  The means
   must be SBD 0.8438 within 0.002 and count_acc 0.7188 within 1/64, and
   every example's SBD within 1e-3, and its count, those of the committed
   ``output_valid_calibrated/*_40.csv`` or, where it differs from them,
   those of the JAX package's own eval_split run on the CPU (about two
   minutes on one thread, the JAX part included).
"""

import csv
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from rec_attend_tpu import config as JC
from rec_attend_tpu.cli import eval as jeval
from rec_attend_tpu.data.synthetic import make_synthetic_h5
from rec_attend_tpu.engine.experiment import EvalExperiment as JEvalExperiment
from rec_attend_tpu.engine.saver import Saver
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.cli import eval as teval
from rec_attend_tpu_torch.engine.experiment import EvalExperiment

torch.set_num_threads(1)

FLAGSHIP = os.path.join(os.path.dirname(__file__), '..', 'results',
                        'full_model_synth-20260816104712')
HEADLINE_CSVS = os.path.join(FLAGSHIP, 'output_valid_calibrated')
SIZE = 32
T = 4
ANALYZERS = teval.DEFAULT_ANALYZERS + ['ins_iou', 'fg_iou', 'fg_dice',
                                       'fg_iou_all', 'count']


class PortView:
  """A JAX package dataset seen through the port's dataset interface (its
  get_batch decodes only the variables the eval path reads)."""

  def __init__(self, ds):
    self.ds = ds

  def get_dataset_size(self):
    return self.ds.get_dataset_size()

  def get_batch(self, idx, timespan=None):
    return self.ds.get_batch(idx, timespan=timespan,
                             variables={'x', 's_gt', 'idx_map'})

  def get_full_size_labels(self, ids, timespan=None):
    return self.ds.get_full_size_labels(ids, timespan=timespan)


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
  """(results folder, data folder) of a tiny trained-looking model: the
  JAX init with weights scaled up, so that masks and counts are not
  empty."""
  root = tmp_path_factory.mktemp('eval')
  cfg = JC.tiny_full_config(timespan=T, inp_height=SIZE, inp_width=SIZE,
                            filter_height=8, filter_width=8)
  rng = np.random.RandomState(0)
  params = JF.init_full_model(jax.random.PRNGKey(0), cfg)
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) * (1 + 40 * rng.rand(*a.shape)).astype(
          np.float32) if a.ndim >= 2 else np.asarray(a), params)
  folder = str(root / 'results' / 'full_model_eval')
  Saver(folder, model_opt=cfg).save({'params': params}, 5)
  return folder, str(root / 'data')


def _jax_experiment(folder, data_folder):
  cfg = JC.FullModelConfig.from_dict(
      __import__('yaml').safe_load(open(os.path.join(folder,
                                                     'model_opt.yaml'))))
  train_cfg = JC.TrainConfig(restore=folder, batch_size=3,
                             results=os.path.dirname(folder))
  data_cfg = JC.DataConfig(dataset='synth', folder=data_folder, height=SIZE,
                           width=SIZE, timespan=T, num_examples=32)
  return JEvalExperiment('full', cfg.replace(use_knob=False), train_cfg,
                         data_cfg, splits=['valid'])


def _read_csvs(folder):
  return {name: open(os.path.join(folder, name)).read()
          for name in sorted(os.listdir(folder)) if name.endswith('.csv')}


@pytest.mark.parametrize('chain', ['score_gate', 'foreground'])
def test_tiny_eval_split_csvs_equal_jax(tiny, tmp_path, chain):
  folder, data_folder = tiny
  jexp = _jax_experiment(folder, data_folder)
  ds = jexp.get_dataset('valid')
  n = ds.get_dataset_size()
  kw = dict(no_morph=False, remove_tiny=0, score_threshold=None)
  foreground = None
  if chain == 'score_gate':
    kw['score_threshold'] = 0.4
  else:
    # Foreground PNGs as the JAX package reads them (the largest channel
    # over 255), and the same maps given to the port as arrays.
    fg_folder = tmp_path / 'fg'
    fg_folder.mkdir()
    rng = np.random.RandomState(7)
    foreground = []
    for ii in ds.img_ids:
      img = (rng.rand(SIZE, SIZE, 3) > 0.2).astype(np.uint8) * 255
      cv2.imwrite(str(fg_folder / ds.get_fname(ii)), img)
      foreground.append(img.astype(np.float32).max(axis=2) / 255.0)
    kw['remove_tiny'] = 5
  thresholds = [0.3, 0.5]
  want_dir, got_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
  want = jeval.eval_split(
      jexp, 'valid', want_dir, thresholds, ANALYZERS, render_output=False,
      batch_size=3, foreground_folder=(None if foreground is None
                                       else str(tmp_path / 'fg')), **kw)
  exp = EvalExperiment(folder, device='cpu')
  assert exp.step == 5 and not exp.cfg.use_knob
  got = teval.eval_split(exp, PortView(ds), got_dir, thresholds, ANALYZERS,
                         batch_size=3, foreground=foreground, **kw)
  want_csvs, got_csvs = _read_csvs(want_dir), _read_csvs(got_dir)
  assert sorted(got_csvs) == sorted(want_csvs)
  assert 'sbd_30.csv' in got_csvs and 'count_50.csv' in got_csvs
  for name, text in want_csvs.items():
    assert got_csvs[name] == text, name
  assert got_csvs['sbd_30.csv'].count('\n') == n + 3
  assert got == want
  # Some masks survive the chain: the scores are not all trivial.
  assert '0.0000' not in got_csvs['sbd_30.csv'].splitlines()[-2]


def test_eval_split_single_threshold_clears_stale_csvs(tiny, tmp_path):
  """One threshold writes {name}.csv, and a rerun leaves no file of an
  older sweep behind."""
  folder, data_folder = tiny
  ds = PortView(_jax_experiment(folder, data_folder).get_dataset('valid'))
  exp = EvalExperiment(folder, device='cpu')
  out = str(tmp_path / 'out')
  teval.eval_split(exp, ds, out, [0.3, 0.5], ['sbd'], max_batches=1)
  assert sorted(os.listdir(out)) == ['sbd_30.csv', 'sbd_50.csv']
  timings = {}
  teval.eval_split(exp, ds, out, [0.4], ['sbd', 'count'], max_batches=2,
                   batch_size=2, timings=timings)
  assert sorted(os.listdir(out)) == ['count.csv', 'sbd.csv']
  assert open(os.path.join(out, 'sbd.csv')).read().count('\n') == 4 + 3
  assert [len(v) for v in timings.values()] == [2, 2, 2]


def test_synthetic_dataset_reads_as_the_eval_path_does():
  from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
  ds = SyntheticDataset(5, 32, 40, T, seed=3)
  assert ds.get_dataset_size() == 5
  raw = ds.get_batch(np.arange(1, 4), timespan=T)
  assert raw['x'].shape == (3, 32, 40, 3) and raw['s_gt'].shape == (3, T)
  assert list(raw['idx_map']) == ['synth0001', 'synth0002', 'synth0003']
  labels = ds.get_full_size_labels(raw['idx_map'], timespan=T)
  np.testing.assert_array_equal(np.stack(labels), raw['y_gt'])
  np.testing.assert_array_equal(raw['s_gt'],
                                raw['y_gt'].any(axis=(2, 3)).astype(float))
  with pytest.raises(ValueError, match='instance slots'):
    ds.get_batch([0], timespan=T + 1)


def test_eval_experiment_refuses_a_folder_without_checkpoint(tmp_path):
  with pytest.raises(FileNotFoundError, match='refusing'):
    EvalExperiment(str(tmp_path), cfg=C.tiny_full_config(), device='cpu')


class Subset:
  """The examples of a JAX package dataset with the given ids."""

  def __init__(self, ds, ids):
    self.ds = ds
    self.pos = np.array([list(ds.img_ids).index(i) for i in ids])
    self.img_ids = ds.img_ids[self.pos]

  def get_dataset_size(self):
    return len(self.pos)

  def get_batch(self, idx, timespan=None, variables=None):
    return self.ds.get_batch(self.pos[np.asarray(idx)], timespan=timespan,
                             variables=variables)

  def get_full_size_labels(self, ids, timespan=None):
    return self.ds.get_full_size_labels(ids, timespan=timespan)


def _scores(path):
  with open(path) as f:
    return {r[0]: float(r[1]) for r in list(csv.reader(f))[1:]}


def _jax_headline(ds, ids, out):
  """The JAX package's own eval_split on the CPU, over the examples ids."""
  cfg = JC.FullModelConfig.from_dict(
      __import__('yaml').safe_load(open(os.path.join(FLAGSHIP,
                                                     'model_opt.yaml'))))
  train_cfg = JC.TrainConfig(restore=FLAGSHIP, batch_size=8,
                             results=os.path.dirname(FLAGSHIP))
  data_cfg = JC.DataConfig(dataset='synth', folder=os.path.dirname(out),
                           height=224, width=224, timespan=21)
  exp = JEvalExperiment('full', cfg.replace(use_knob=False), train_cfg,
                        data_cfg, splits=['valid'])
  exp.get_dataset = lambda split: Subset(ds, ids)
  jeval.eval_split(exp, 'valid', out, [0.4], ['sbd', 'dic'],
                   render_output=False, batch_size=8, score_threshold=0.4)
  return _scores(os.path.join(out, 'sbd.csv')), _scores(
      os.path.join(out, 'dic.csv'))


def test_flagship_headline_on_synth224_valid(tmp_path):
  """The port reproduces the flagship's valid-split headline: the means
  within 0.002 (SBD) and 1/64 (count_acc) of the committed ones, and every
  example within 1e-3 in SBD, and with its count, of the committed CSVs or,
  where the example differs from them, of the JAX package's eval_split on
  the CPU.  The committed CSVs were written by the JAX package on another
  device; on the CPU it differs from them in 30 of the 64 examples
  (ROADMAP C.4), and the port agrees with it there."""
  ds = make_synthetic_h5(str(tmp_path / 'valid_224x224.h5'), height=224,
                         width=224, num_examples=64, seed=4, max_objects=9)
  exp = EvalExperiment(FLAGSHIP, device='cpu')
  out = str(tmp_path / 'port')
  summary = teval.eval_split(exp, PortView(ds), out, [0.4],
                             teval.DEFAULT_ANALYZERS, batch_size=8,
                             score_threshold=0.4)
  means = {k.split()[0]: v[0] for k, v in summary[0.4].items()}
  assert abs(means['sbd'] - 0.8438) <= 0.002
  assert abs(means['count_acc'] - 0.7188) <= 1 / 64 + 1e-4
  for name in teval.DEFAULT_ANALYZERS:
    assert np.isfinite(means[name])
  sbd, dic = (_scores(os.path.join(out, f'{n}.csv')) for n in ('sbd', 'dic'))
  want_sbd, want_dic = (_scores(os.path.join(HEADLINE_CSVS, f'{n}_40.csv'))
                        for n in ('sbd', 'dic'))
  ids = [k for k in want_sbd if k.startswith('synth')]
  assert sorted(ids) == sorted(k for k in sbd if k.startswith('synth'))
  assert len(ids) == 64
  differ = [k for k in ids
            if abs(sbd[k] - want_sbd[k]) > 1e-3 or dic[k] != want_dic[k]]
  if differ:
    jax_sbd, jax_dic = _jax_headline(ds, differ, str(tmp_path / 'jax'))
    for k in differ:
      assert abs(sbd[k] - jax_sbd[k]) <= 1e-3 and dic[k] == jax_dic[k], (
          k, sbd[k], jax_sbd[k], want_sbd[k], dic[k], jax_dic[k])
