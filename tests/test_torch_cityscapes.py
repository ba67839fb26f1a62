"""The port's Cityscapes pieces against the JAX package's, on the CPU.

1. The Cityscapes and synthcs presets equal the JAX presets and the
   synthcs folders' ``model_opt.yaml``s.
2. The multiclass targets of a small JAX-generated split (2 classes):
   ``instance_targets`` of its masks and classes gives the JAX dataset's
   'c_gt', 'd_gt', 'y_gt', 's_gt' and per-slot classes ('c_gt_idx'; the
   JAX slots sorted by area, the port's in drawing order), and the
   instance-id image that ``write_instance_id_gt`` writes; the port's
   ``get_fname`` is the JAX dataset's.
3. The instance AP of ``eval_cityscapes.instance_eval`` equals JAX's
   ``evaluate_instance_predictions`` to 1e-9, every average and class, on
   the scenes of ``test_cityscapes_eval.py`` and ``test_ap_differential.py``
   (the distance rows included): JAX reads the files its tests write, the
   port gets the same arrays.
4. ``PixelEvaluator``: the same uint64 confusion matrix and every score to
   1e-12 on seeded label and instance images.
5. The submission's rows equal what JAX's ``RenderCityScapesOutputAnalyzer``
   writes (its text rows and, through cv2, its mask PNGs), on seeded maps
   with a slot skipped by the background rule, one by its score and one
   with an empty mask.
"""

import dataclasses
import math
import os

import cv2
import numpy as np
import pytest
import torch

from rec_attend_tpu import analysis as janalysis
from rec_attend_tpu import config as JC
from rec_attend_tpu.data import synthetic as jsynthetic
from rec_attend_tpu.eval_cityscapes import instance_eval as JIE
from rec_attend_tpu.eval_cityscapes import pixel_eval as JPE
from rec_attend_tpu_torch import analysis
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.data import synthetic
from rec_attend_tpu_torch.eval_cityscapes import instance_eval as IE
from rec_attend_tpu_torch.eval_cityscapes import pixel_eval as PE
import test_ap_differential
import test_cityscapes_eval

RESULTS = os.path.join(os.path.dirname(__file__), '..', 'results')
SYNTHCS = {
    'full': (C.FullModelConfig, C.synthcs_full_config,
             'full_model_synthcs-20260818a'),
    'fg': (C.FGModelConfig, C.synthcs_fg_config, 'fg_model_synthcs-20260818a'),
    'box': (C.BoxModelConfig, C.synthcs_box_config,
            'box_model_synthcs-20260818a'),
}


@pytest.mark.parametrize('spec', sorted(SYNTHCS))
def test_presets_match_jax_and_the_synthcs_folders(spec):
  cls, preset, folder = SYNTHCS[spec]
  want = cls.from_yaml(os.path.join(RESULTS, folder, 'model_opt.yaml'))
  assert dataclasses.asdict(preset()) == dataclasses.asdict(want)
  name = f'cityscapes_{spec}_config'
  assert dataclasses.asdict(getattr(C, name)()) == dataclasses.asdict(
      cls.from_dict(getattr(JC, name)().to_dict()))
  if spec == 'full':
    assert want.acnn_inp_depth == want.ccnn_inp_depth == 3 + 1 + 8 + 3
  if spec == 'fg':
    assert want.dcnn_depth[-1] == 3 + 8


# ---------------------------------------------------------------------------
# 2. The multiclass targets
# ---------------------------------------------------------------------------

def test_targets_match_a_jax_split(tmp_path):
  import h5py
  from rec_attend_tpu.data.assembler import png_decode
  t, nsc = 8, 2
  ds = jsynthetic.make_synthetic_h5(
      str(tmp_path / 'valid.h5'), height=48, width=64, num_examples=6,
      seed=4, max_objects=6, num_semantic_classes=nsc)
  gt_files = jsynthetic.write_instance_id_gt(ds, str(tmp_path / 'gt'))
  want = ds.get_batch(np.arange(6), timespan=t, variables={
      'y_gt', 's_gt', 'c_gt', 'c_gt_idx', 'd_gt'})
  classes_seen = set()
  with h5py.File(ds.h5_fname, 'r') as h5f:
    for i, idx in enumerate(ds.img_ids):
      group = h5f[ds.get_str_id(idx)]
      seg = group['label_segmentation']
      masks = np.stack([png_decode(seg[f'{k:02d}'][:]) > 0
                        for k in range(len(seg))])
      classes = group['instance_semantic_classes'][:]
      classes_seen |= set(classes.tolist())
      got = synthetic.instance_targets(masks, classes, t, nsc)
      np.testing.assert_array_equal(got['c_gt'], want['c_gt'][i])
      np.testing.assert_array_equal(got['d_gt'], want['d_gt'][i])
      ids = cv2.imread(gt_files[i], -1)
      assert ids.dtype == np.uint16
      np.testing.assert_array_equal(got['instance_ids'], ids)
      # The port keeps the drawing order, the JAX dataset sorts the slots
      # by area, largest first (data/dataset.py:164-172).
      k = len(masks)
      order = np.argsort([int(m.sum()) for m in masks])[::-1]
      np.testing.assert_array_equal(got['y_gt'][order], want['y_gt'][i][:k])
      np.testing.assert_array_equal(got['y_gt'][k:], 0)
      np.testing.assert_array_equal(got['s_gt'], want['s_gt'][i])
      slot = want['c_gt_idx'][i].argmax(axis=1) - 1
      np.testing.assert_array_equal(got['classes'][order], slot[:k])
      np.testing.assert_array_equal(got['classes'][k:], slot[k:])
      # The image-wide targets cover the instances beyond the timespan.
      short = synthetic.instance_targets(masks, classes, 2, nsc)
      for key in ('c_gt', 'd_gt', 'instance_ids'):
        np.testing.assert_array_equal(short[key], got[key])
      assert os.path.basename(gt_files[i]) == (
          synthetic.get_fname(idx)[:-len('.png')]
          + '_gtFine_instanceIds.png')
      assert synthetic.get_fname(idx) == ds.get_fname(idx)
  assert classes_seen == {0, 1}
  assert synthetic.CS_INSTANCE_LABEL_IDS == jsynthetic.CS_INSTANCE_LABEL_IDS
  assert synthetic.CS_BACKGROUND_LABEL_ID == (
      jsynthetic.CS_BACKGROUND_LABEL_ID)


def test_the_dataset_holds_the_classes():
  ds = synthetic.SyntheticDataset(4, 40, 56, 6, seed=3, max_objects=5,
                                  num_semantic_classes=2)
  batch = ds.get_batch([0, 3])
  assert batch['c_gt'].shape == (2, 40, 56, 3)
  np.testing.assert_array_equal(batch['c_gt'].sum(axis=3), 1.0)
  for i, ids in zip(range(4), ds.get_instance_id_images(ds.img_ids)):
    slots = ds.s_gt[i].astype(bool)
    assert (ds.classes[i][slots] >= 0).all()
    assert (ds.classes[i][~slots] == -1).all()
    for k in np.flatnonzero(slots):
      label = synthetic.CS_INSTANCE_LABEL_IDS[ds.classes[i][k]]
      np.testing.assert_array_equal(ids == label * 1000 + k,
                                    ds.y_gt[i][k] > 0)
  assert synthetic.get_fname('synth0003') == 'synth_000003_000000.png'


# ---------------------------------------------------------------------------
# 3. Instance AP
# ---------------------------------------------------------------------------

def _assert_same_averages(got, want):
  assert sorted(got) == sorted(want)
  for key in want:
    if key == 'classes':
      assert sorted(got[key]) == sorted(want[key])
      for name, d in want[key].items():
        for k, v in d.items():
          _assert_close(got[key][name][k], v, f'{name} {k}')
    else:
      _assert_close(got[key], want[key], key)


def _assert_close(a, b, what):
  if math.isnan(b):
    assert math.isnan(a), what
  else:
    assert abs(a - b) <= 1e-9, (what, a, b)


def _read_rows(txt):
  """The rows of a prediction text as arrays: (mask, label id, conf)."""
  rows = []
  for pred in JIE.read_pred_info(txt):
    rows.append((cv2.imread(pred['maskFile'], cv2.IMREAD_GRAYSCALE),
                 pred['labelID'], pred['conf']))
  return rows


def _box(y0, x0, h, w, size=128):
  m = np.zeros((size, size), np.uint8)
  m[y0:y0 + h, x0:x0 + w] = 1
  return m


def _disp_file(tmp_path, regions, size=128):
  disp = np.zeros((size, size), np.uint16)
  for (y0, x0, h, w), metres in regions:
    disp[y0:y0 + h, x0:x0 + w] = test_cityscapes_eval._disp_value(metres)
  path = str(tmp_path / 'disparity.png')
  cv2.imwrite(path, disp)
  return path, IE.disparity_to_distance(disp)


CAR1, CAR2 = (20, 20, 40, 40), (70, 70, 40, 40)
EVAL_SCENES = {
    'perfect': [(CAR1, 0.9), (CAR2, 0.8)],
    'half_matched_with_fp': [(CAR1, 0.9), ((10, 90, 30, 30), 0.8)],
    'void_fp_ignored': [(CAR1, 0.9), (CAR2, 0.85), ((0, 0, 30, 8), 0.8)],
    'low_overlap': [((20, 20, 40, 32), 0.9), (CAR2, 0.8)],
    'distance_rows': [(CAR1, 0.9), (CAR2, 0.8)],
    'distance_low_conf': [(CAR1, 0.9)],
}


@pytest.mark.parametrize('scene', sorted(EVAL_SCENES))
def test_ap_matches_jax_on_the_eval_scenes(scene, tmp_path):
  """The scenes of test_cityscapes_eval.py, written by its writer."""
  preds = [(_box(*b), 26, conf) for b, conf in EVAL_SCENES[scene]]
  txt, gt_file = test_cityscapes_eval._write_case(tmp_path, preds)
  distance_files = distances = None
  if scene == 'distance_rows':
    path, dist = _disp_file(tmp_path, [(CAR1, 20.0), (CAR2, 150.0)])
    distance_files, distances = [path], [dist]
  elif scene == 'distance_low_conf':
    gt = np.zeros((128, 128), np.int32)
    gt[20:60, 20:60] = 26001
    cv2.imwrite(gt_file, gt.astype(np.uint16))
    path, dist = _disp_file(tmp_path, [((20, 20, 16, 40), 20.0)])
    distance_files, distances = [path], [dist]
  want = JIE.evaluate_instance_predictions(
      [txt], [gt_file], quiet=True, distance_files=distance_files)
  gt = cv2.imread(gt_file, -1)
  got = IE.evaluate_instance_predictions(
      [[(m, label, conf) for m, label, conf in preds]], [gt],
      distance_images=distances)
  _assert_same_averages(got, want)
  assert ('allAp100m' in got) == (distances is not None)


def test_ap_matches_jax_on_the_differential_scenes(tmp_path, monkeypatch):
  """The seven scenes of test_ap_differential.py at once (double matches,
  void, undersized and group ground truth, partial overlaps, class
  confusion), and its distance scene."""
  arrays = {'gt': [], 'preds': []}
  write_gt, write_pred = (test_ap_differential._write_gt,
                          test_ap_differential._write_pred)

  def keep_gt(tmp, name, arr):
    arrays['gt'].append(arr.copy())
    return write_gt(tmp, name, arr)

  def keep_pred(tmp, name, preds):
    arrays['preds'].append([(m.astype(np.uint8) * 255, label, conf)
                            for m, label, conf in preds])
    return write_pred(tmp, name, preds)
  monkeypatch.setattr(test_ap_differential, '_write_gt', keep_gt)
  monkeypatch.setattr(test_ap_differential, '_write_pred', keep_pred)
  gt_files, pred_txts = test_ap_differential._scenes(tmp_path)
  want = JIE.evaluate_instance_predictions(pred_txts, gt_files, quiet=True)
  # The port reads what JAX reads from the files.
  read_back = [_read_rows(t) for t in pred_txts]
  for rows, kept in zip(read_back, arrays['preds']):
    for (m, label, conf), (m2, label2, conf2) in zip(rows, kept):
      np.testing.assert_array_equal(m, m2)
      assert label == label2 and conf == pytest.approx(conf2, abs=1e-6)
  for f, arr in zip(gt_files, arrays['gt']):
    np.testing.assert_array_equal(cv2.imread(f, -1), arr)
  got = IE.evaluate_instance_predictions(read_back, arrays['gt'])
  _assert_same_averages(got, want)
  assert 0.05 < got['allAp'] < 0.95

  # The distance scene.
  bfx = IE.NOMINAL_BASELINE * IE.NOMINAL_FX
  h, w = test_ap_differential.H, test_ap_differential.W
  gt = np.full((h, w), 7, np.int32)
  near = test_ap_differential._box(10, 10, 30, 40)
  far = test_ap_differential._box(60, 60, 20, 20)
  gt[near], gt[far] = 26000, 26001
  gt_file = write_gt(tmp_path, 'dist', gt)
  disp = np.zeros((h, w), np.uint16)
  disp[near] = int(1 + 256 * bfx / 30.0)
  disp[far] = int(1 + 256 * bfx / 120.0)
  kill = np.argwhere(far)[:int(0.4 * far.sum())]
  disp[kill[:, 0], kill[:, 1]] = 0
  disp_file = os.path.join(str(tmp_path), 'dist_disparity.png')
  cv2.imwrite(disp_file, disp)
  pred_txt = write_pred(tmp_path, 'dist', [(near, 26, 0.9), (far, 26, 0.6)])
  want = JIE.evaluate_instance_predictions(
      [pred_txt], [gt_file], quiet=True, distance_files=[disp_file])
  got = IE.evaluate_instance_predictions(
      [_read_rows(pred_txt)], [gt],
      distance_images=[IE.disparity_to_distance(disp)])
  _assert_same_averages(got, want)
  assert got['allAp100m'] == pytest.approx(1.0)
  np.testing.assert_array_equal(IE.disparity_to_distance(disp),
                                JIE.disparity_to_distance(disp))


# ---------------------------------------------------------------------------
# 4. Pixel-level eval
# ---------------------------------------------------------------------------

def _label_pairs(seed, n=4, h=60, w=80):
  """Seeded (prediction, ground truth, instance ids): road, sidewalk, sky
  and void background, person, rider and car instances, predictions
  that miss, mislabel and spill."""
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(n):
    gt = rng.choice([7, 8, 23, 0], size=(h, w), p=[0.5, 0.2, 0.2, 0.1])
    gt = gt.astype(np.uint8)
    inst = gt.astype(np.int64)
    for k in range(rng.randint(2, 7)):
      label = int(rng.choice([24, 25, 26]))
      y0, x0 = rng.randint(0, h - 8), rng.randint(0, w - 8)
      dy, dx = rng.randint(3, 20), rng.randint(3, 24)
      gt[y0:y0 + dy, x0:x0 + dx] = label
      inst[y0:y0 + dy, x0:x0 + dx] = label * 1000 + k
    pred = gt.copy()
    flip = rng.rand(h, w) < 0.15
    pred[flip] = rng.choice([7, 8, 11, 24, 25, 26, 27], size=flip.sum())
    out.append((pred, gt, inst))
  return out


def test_pixel_eval_matches_jax():
  got, want = PE.PixelEvaluator(), JPE.PixelEvaluator()
  for i, (pred, gt, inst) in enumerate(_label_pairs(0)):
    got.add_pair(pred, gt, instance_img=None if i == 0 else inst)
    want.add_pair(pred, gt, instance_img=None if i == 0 else inst)
  assert got.conf.dtype == want.conf.dtype == np.uint64
  np.testing.assert_array_equal(got.conf, want.conf)
  r_got, r_want = got.finalize(), want.finalize()
  assert sorted(r_got) == sorted(r_want)
  for family, scores in r_want.items():
    if isinstance(scores, dict):
      assert sorted(r_got[family]) == sorted(scores)
      for name, v in scores.items():
        assert r_got[family][name] == pytest.approx(v, abs=1e-12,
                                                    nan_ok=True), name
    else:
      assert r_got[family] == pytest.approx(scores, abs=1e-12), family
  assert 0.3 < r_got['meanInstIoU'] < 0.99


def test_synthetic_pixel_labels():
  """The synthcs pixel stage's labels (pipelines/run_pipeline.py:523-541),
  written out: the argmax of the packed fg bytes, channel 0 background,
  and the ground truth of an instance-id image."""
  rng = np.random.RandomState(1)
  fg = rng.randint(0, 256, size=(30, 40, 3)).astype(np.uint8)
  am = fg.argmax(axis=2)
  want = np.where(am == 0, 7, np.where(am == 1, 24, 25))
  np.testing.assert_array_equal(PE.prediction_labels(fg), want)
  one = fg[..., :1]
  np.testing.assert_array_equal(PE.prediction_labels(one),
                                np.where(one[..., 0] > 127, 24, 7))
  # A tensor is labelled where it lies, ties to the first channel as in
  # numpy.
  ties = rng.randint(0, 3, size=(2, 30, 40, 3)).astype(np.uint8)
  for a in (fg, one, ties):
    got = PE.prediction_labels(torch.from_numpy(a))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), PE.prediction_labels(a))
  ids = np.full((30, 40), 7, np.uint16)
  ids[2:9, 3:8] = 24000
  ids[10:20, 10:30] = 25001
  label, inst = PE.groundtruth_labels(ids)
  assert label.dtype == np.uint8 and inst.dtype == np.int64
  np.testing.assert_array_equal(
      label, np.where(ids == 24000, 24, np.where(ids == 25001, 25, 7)))
  np.testing.assert_array_equal(inst, ids)


# ---------------------------------------------------------------------------
# 5. The submission
# ---------------------------------------------------------------------------

def test_submission_rows_match_the_jax_writer(tmp_path):
  rng = np.random.RandomState(2)
  b, t, h, w = 3, 6, 40, 56
  y_out = [(rng.rand(t, h, w) > 0.8).astype(np.float32) for _ in range(b)]
  logits = rng.randn(b, h, w, 3).astype(np.float32) * 2
  fg = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
  fg = [f.astype(np.float32) for f in fg]
  conf = rng.rand(b, t).astype(np.float32) * 0.6 + 0.4
  conf[0, 1] = 0.3                 # skipped by its score
  y_out[1][2] = 0                  # skipped: an empty mask
  y_out[2][3] = 1                  # skipped by the background rule:
  fg[2][..., 0] = 0.95             # mean background under it > 0.7
  fg[2][..., 1:] = 0.025
  ids = ['synth0000', 'synth0001', 'synth0002']

  class Names:
    get_fname = staticmethod(synthetic.get_fname)
  writer = janalysis.RenderCityScapesOutputAnalyzer(str(tmp_path), Names())
  writer.stage({'y_out': y_out, 'y_in': fg, 'conf': conf, 'indices': ids})
  got = analysis.cityscapes_submission(y_out, fg, conf)
  n_rows = 0
  for idx, rows in zip(ids, got):
    stem = synthetic.get_fname(idx)[:-len('.png')]
    txt = tmp_path / 'synth' / f'{stem}.txt'
    lines = [l.split() for l in txt.read_text().splitlines()]
    assert len(lines) == len(rows)
    for (name, label, score), row in zip(lines, rows):
      assert name == f'{stem}_{row.slot:03d}.png'
      assert int(label) == row.label_id and float(score) == row.score
      np.testing.assert_array_equal(
          cv2.imread(str(tmp_path / 'synth' / name), cv2.IMREAD_GRAYSCALE),
          row.mask)
      n_rows += 1
  slots = [[r.slot for r in rows] for rows in got]
  assert 1 not in slots[0] and 2 not in slots[1] and 3 not in slots[2]
  assert n_rows >= 10
  assert {r.label_id for rows in got for r in rows} == {24, 25}
