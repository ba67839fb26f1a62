"""The port's renders and the eval command lines that write them, against
the JAX package's on the CPU.

1. ``build_orientation_img`` and the four render analyzers (instance,
   ground truth, orientation, foreground): the port's PNGs, decoded by
   cv2, are the arrays of JAX's cv2-written ones, pixel for pixel.
2. ``_read_foreground`` on cv2-written PNGs (colour and grey) gives JAX's
   maps; a missing file raises FileNotFoundError.
3. ``eval_split`` with its instance renders, with and without the ground
   truth's (``render_gt``), on the same model outputs as JAX's: the CSVs
   and the PNGs' pixels.
4. On a KITTI layout fixture assembled at 64x64 from 40x124 images (so
   every map is resized to the image's size): ``fg_main`` of a tiny fg
   model with the orientation head against JAX's ``fg_main`` (the files,
   and the pixels of every PNG), then ``full_main`` of a tiny full model
   with ``--foreground_folder`` (those renders), ``--remove_tiny`` and its
   instance renders, against JAX's: the CSVs equal and the PNGs' pixels.
"""

import os
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from rec_attend_tpu import analysis as janalysis
from rec_attend_tpu import config as JC
from rec_attend_tpu.cli import eval as jeval
from rec_attend_tpu.data import orientation as jorientation
from rec_attend_tpu.engine.saver import Saver
from rec_attend_tpu.models import fg_model as JFG
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu_torch import analysis
from rec_attend_tpu_torch.cli import eval as teval
from rec_attend_tpu_torch.cli import setup_dataset
from rec_attend_tpu_torch.data import orientation

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

SIZE = 64
T = 6
ORIG = (40, 124)


class Names:
  """A dataset's file names, as the renders ask for them."""

  def get_fname(self, idx):
    return f'img_{idx}.png'


def _pngs(folder):
  return sorted(os.path.relpath(os.path.join(root, f), folder)
                for root, _, files in os.walk(folder) for f in files
                if f.endswith('.png'))


def _decoded(folder):
  return {name: cv2.imread(os.path.join(folder, name), cv2.IMREAD_UNCHANGED)
          for name in _pngs(folder)}


def test_build_orientation_img_matches_jax():
  rng = np.random.RandomState(0)
  d = rng.rand(2, 9, 11, 8).astype(np.float32)
  d[0, 0, 0] = 0.25     # a tie: the first bin wins, as in JAX
  mask = (rng.rand(2, 9, 11) > 0.3).astype(np.float32)
  got = orientation.build_orientation_img(d, mask)
  want = jorientation.build_orientation_img(d, mask)
  assert got.dtype == want.dtype == np.uint8
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(orientation.color_wheel,
                                jorientation.color_wheel)


def _render_results(rng):
  y_out = [(rng.rand(5, 13, 17) > 0.6).astype(np.float32),
           (rng.rand(5, 13, 17) > 0.7).astype(np.float32)]
  y_gt = [(rng.rand(4, 13, 17) > 0.6).astype(np.float32) for _ in range(2)]
  return {'y_out': y_out, 'y_gt': y_gt,
          'iou_pairwise': [janalysis.f_iou_pairwise(a, b)
                           for a, b in zip(y_out, y_gt)],
          'indices': [3, 7]}


@pytest.mark.parametrize('name', ['RenderInstanceAnalyzer',
                                  'RenderGroundtruthInstanceAnalyzer',
                                  'RenderOrientationAnalyzer',
                                  'RenderForegroundAnalyzer'])
def test_render_pixels_equal_jax(tmp_path, name):
  rng = np.random.RandomState(1)
  results = _render_results(rng)
  if name == 'RenderOrientationAnalyzer':
    results = {'d_out': rng.rand(2, 13, 17, 8).astype(np.float32),
               'mask': (rng.rand(2, 13, 17) > 0.4).astype(np.float32),
               'indices': [3, 7]}
  elif name == 'RenderForegroundAnalyzer':
    results = {'y_out': rng.rand(2, 13, 17).astype(np.float32),
               'indices': [3, 7]}
  for pkg, sub in ((janalysis, 'jax'), (analysis, 'port')):
    a = getattr(pkg, name)(str(tmp_path / sub), Names())
    a.stage(results)
    assert a.finalize() is None
  want, got = _decoded(str(tmp_path / 'jax')), _decoded(str(tmp_path /
                                                            'port'))
  assert sorted(got) == sorted(want) == ['img_3.png', 'img_7.png']
  for k in want:
    assert got[k].shape == want[k].shape and got[k].dtype == np.uint8, k
    np.testing.assert_array_equal(got[k], want[k])
    assert want[k].any()


def test_read_foreground_matches_jax(tmp_path):
  rng = np.random.RandomState(2)
  ds = Names()
  cv2.imwrite(str(tmp_path / ds.get_fname(0)),
              (rng.rand(9, 7, 3) * 255).astype(np.uint8))
  cv2.imwrite(str(tmp_path / ds.get_fname(1)),
              ((rng.rand(9, 7) > 0.5) * 255).astype(np.uint8))
  got = teval._read_foreground(str(tmp_path), ds, [0, 1])
  want = jeval._read_foreground(str(tmp_path), ds, [0, 1])
  for g, w in zip(got, want):
    assert g.dtype == w.dtype and g.shape == w.shape == (9, 7)
    np.testing.assert_array_equal(g, w)
  assert sorted(np.unique(got[1])) == [0.0, 1.0]
  with pytest.raises(FileNotFoundError):
    teval._read_foreground(str(tmp_path), ds, [2])


class Labelled(Names):
  """Names and full-size labels, what eval_split reads of a dataset."""

  def __init__(self, labels):
    self.labels = labels

  def get_full_size_labels(self, ids, timespan=None):
    return [self.labels[i] for i in ids]


class GivenOutputs:
  """An experiment whose forward gives fixed outputs, as numpy arrays (for
  the JAX package's eval_split) or tensors (for the port's)."""

  def __init__(self, ds, s_gt, outputs, as_tensors):
    self.ds, self.s_gt, self.outputs = ds, s_gt, outputs
    self.as_tensors = as_tensors

  def iterate_split(self, split, batch_size):
    n = len(self.s_gt)
    for lo in range(0, n, batch_size):
      idx = np.arange(lo, min(lo + batch_size, n))
      out = {k: v[idx] for k, v in self.outputs.items()}
      if self.as_tensors:
        out = {k: torch.from_numpy(v) for k, v in out.items()}
      yield self.ds, {'idx_map': idx, 's_gt': self.s_gt[idx]}, out


@pytest.mark.parametrize('render_gt', [False, True])
def test_eval_split_renders_match_jax(tmp_path, render_gt):
  """eval_split with its instance renders and, where asked, the ground
  truth's, on the same model outputs as JAX's eval_split: the CSVs equal
  and every PNG's pixels."""
  rng = np.random.RandomState(4)
  n, t, size = 5, 4, (21, 26)
  labels, s_gt = [], np.zeros((n, t), np.float32)
  for i in range(n):
    y = np.zeros((t,) + size, np.float32)
    for j in range(rng.randint(1, t + 1)):
      r, c = rng.randint(0, 14), rng.randint(0, 18)
      y[j, r:r + rng.randint(4, 8), c:c + rng.randint(4, 9)] = 1
      s_gt[i, j] = 1
    labels.append(y)
  ds = Labelled(labels)
  outputs = {'y_out': rng.rand(n, t, 12, 12).astype(np.float32),
             's_out': rng.rand(n, t).astype(np.float32)}
  kw = dict(render_output=True, render_gt=render_gt, batch_size=2)
  names = ['sbd', 'count_acc']
  want = jeval.eval_split(GivenOutputs(ds, s_gt, outputs, False), 'valid',
                          str(tmp_path / 'jax'), [0.3, 0.5], names, **kw)
  got = teval.eval_split(GivenOutputs(ds, s_gt, outputs, True), ds,
                         str(tmp_path / 'port'), [0.3, 0.5], names, **kw)
  assert got == want
  for name in sorted(os.listdir(tmp_path / 'jax')):
    if name.endswith('.csv'):
      assert (tmp_path / 'port' / name).read_text() == (
          tmp_path / 'jax' / name).read_text(), name
  renders = _pngs(str(tmp_path / 'port'))
  subs = ['30', '50'] + (['gt'] if render_gt else [])
  assert renders == [f'{s}/img_{i}.png' for s in subs for i in range(n)]
  diffs = _pixel_diffs(str(tmp_path / 'port'), str(tmp_path / 'jax'))
  assert not any(diffs.values()), diffs
  if render_gt:
    assert all(img.any() for k, img in _decoded(str(tmp_path / 'port')).items()
               if k.startswith('gt/'))


def _scaled(params, seed):
  """JAX parameters with the weights scaled up, so that the maps are not
  all near one half."""
  rng = np.random.RandomState(seed)
  return jax.tree_util.tree_map(
      lambda a: np.asarray(a) * (1 + 40 * rng.rand(*a.shape)).astype(
          np.float32) if a.ndim >= 2 else np.asarray(a), params)


@pytest.fixture(scope='module')
def kitti(tmp_path_factory):
  """A KITTI valid split assembled at 64x64 from 40x124 images, and a tiny
  fg model (with the orientation head) and a tiny full model on it, JAX's
  init scaled up: the results folder."""
  root = tmp_path_factory.mktemp('renders')
  data = str(root / 'data')
  cs.kitti_fixture(data, {'valid': 3}, *ORIG, 5)
  setup_dataset.main(['--dataset', 'kitti', '--folder', data, '--splits',
                      'valid', '--height', str(SIZE), '--width', str(SIZE)])
  data_cfg = JC.DataConfig(dataset='kitti', folder=data, height=SIZE,
                           width=SIZE, timespan=T)
  results = str(root / 'results')
  fg_cfg = JC.tiny_fg_config(add_orientation=True, dcnn_depth=(8, 4, 9))
  params = jax.jit(lambda k: JFG.init_fg_model(k, fg_cfg))(
      jax.random.PRNGKey(1))
  Saver(os.path.join(results, 'fg_model_tiny'), model_opt=fg_cfg,
        data_opt=data_cfg).save({'params': _scaled(params, 1)}, 3)
  full_cfg = JC.tiny_full_config(timespan=T, filter_height=8,
                                 filter_width=8)
  params = jax.jit(lambda k: JF.init_full_model(k, full_cfg))(
      jax.random.PRNGKey(2))
  Saver(os.path.join(results, 'full_model_tiny'), model_opt=full_cfg,
        data_opt=data_cfg).save({'params': _scaled(params, 2)}, 3)
  return results


def _pixel_diffs(got_folder, want_folder):
  """{file: the number of pixels that differ} of two folders of PNGs with
  the same names and shapes."""
  got, want = _decoded(got_folder), _decoded(want_folder)
  assert sorted(got) == sorted(want) and want
  diffs = {}
  for k in want:
    assert got[k].shape == want[k].shape, k
    differ = got[k] != want[k]
    diffs[k] = int((differ.any(axis=-1) if differ.ndim == 3 else
                    differ).sum())
  return diffs


@pytest.fixture
def jax_init_shapes(monkeypatch):
  """JAX's EvalExperiment initialises the params op by op, an XLA compile
  a layer shape, and then replaces every one by the checkpoint it
  restores: zeros of the init's shapes restore to the same params."""
  for module, name in ((JF, 'init_full_model'), (JFG, 'init_fg_model')):
    def shapes(key, cfg, init=getattr(module, name)):
      return jax.tree_util.tree_map(
          lambda a: np.zeros(a.shape, a.dtype),
          jax.eval_shape(lambda k: init(k, cfg), key))
    monkeypatch.setattr(module, name, shapes)


def test_fg_main_and_the_foreground_eval_match_jax(kitti, tmp_path,
                                                   jax_init_shapes):
  argv = ['--results', kitti, '--dataset', 'kitti', '--split', 'valid',
          '--batch_size', '2']
  fg_argv = argv + ['--model_id', 'fg_model_tiny', '--threshold_list',
                    '0.5,0.55']
  jeval.fg_main(fg_argv + ['--output', str(tmp_path / 'jax_fg')])
  teval.fg_main(fg_argv + ['--output', str(tmp_path / 'fg')], device='cpu')
  want_files = _pngs(str(tmp_path / 'jax_fg'))
  assert _pngs(str(tmp_path / 'fg')) == want_files
  assert len(want_files) == 3 * 4
  diffs = _pixel_diffs(str(tmp_path / 'fg'), str(tmp_path / 'jax_fg'))
  assert not any(diffs.values()), diffs
  for name, img in _decoded(str(tmp_path / 'fg')).items():
    # The maps at the images' size, both sides of the threshold; the
    # orientation and the target at the model's.
    sub = name.split('/')[0]
    assert img.shape[:2] == (ORIG if sub in ('50', '55') else (SIZE, SIZE))
    if sub in ('50', '55'):
      assert sorted(np.unique(img)) == [0, 255], name

  # The full model's eval with those foreground maps.
  full_argv = argv + ['--model_id', 'full_model_tiny', '--threshold_list',
                      '0.3,0.5', '--remove_tiny', '5', '--foreground_folder',
                      str(tmp_path / 'jax_fg' / '50')]
  jeval.full_main(full_argv + ['--output', str(tmp_path / 'jax_full')])
  teval.full_main(full_argv + ['--output', str(tmp_path / 'full')],
                  device='cpu')
  want_csvs = sorted(f for f in os.listdir(tmp_path / 'jax_full')
                     if f.endswith('.csv'))
  assert len(want_csvs) == 2 * len(teval.DEFAULT_ANALYZERS)
  assert sorted(f for f in os.listdir(tmp_path / 'full')
                if f.endswith('.csv')) == want_csvs
  for name in want_csvs:
    assert (tmp_path / 'full' / name).read_text() == (
        tmp_path / 'jax_full' / name).read_text(), name
  renders = _pngs(str(tmp_path / 'full'))
  assert [r.split('/')[0] for r in renders] == ['30'] * 3 + ['50'] * 3
  diffs = _pixel_diffs(str(tmp_path / 'full'), str(tmp_path / 'jax_full'))
  assert not any(diffs.values()), diffs
  with pytest.raises(FileNotFoundError):
    teval.full_main(full_argv[:-1] + [str(tmp_path / 'missing'), '--output',
                                      str(tmp_path / 'none')], device='cpu')
