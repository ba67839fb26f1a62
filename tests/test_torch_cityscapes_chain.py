"""The Cityscapes-shaped synthcs chain through the port against the JAX
package, with the committed checkpoints, on the first 8 examples of the
synthcs valid split (JAX's ``provider.py`` split: seed 4, up to 10 objects
of 2 classes, 256x512).

The port: ``pack_fg`` of the fg model (3 semantic channels), ``eval_split``
of the full model at mask threshold 0.40 and score threshold 0.50 (the
calibrated headline), ``pack_full``, ``cli.cityscapes_eval`` at mask
threshold 0.6 with ``remove_tiny`` 100 (the pipeline's AP stage), the
instance AP, and the pixel eval of the packed fg bytes.  The JAX side: its
fg forward packed into the split's H5 file, its ``eval_split``, and, on
the port's own bytes written into the same file, its model-free eval
(``cli/cityscapes_eval.eval_one`` with its submission writer), its AP of
the written files and its pipeline's pixel stage.

1. The fg pack's bytes equal JAX's but for float32 neighbours: at most one
   step of 1/255, in at most 1e-4 of the values.
2. The full forward at b2 on the port's bytes against JAX's, by the
   flagship criterion (mean |dy| < 1e-5, at most 1e-3 of the pixels beyond
   1e-3, |ds| <= 1e-4).
3. Per example, SBD within 1e-3 and the count of the committed
   ``output_valid_calibrated/*_40.csv`` or, where they differ, of the JAX
   chain on the CPU (those CSVs were written on another device, as for the
   synth3 chain, ROADMAP C.5).
4. The Cityscapes eval's per-example SBD and its submission give JAX's AP,
   AP_50% and every class's AP to 1e-9 on the same bytes.
5. The pixel eval of the port's fg bytes equals the JAX pipeline's pixel
   stage on them to 1e-12.
6. ``slow``: the whole split, 256 examples: SBD within 0.002 of the
   headline 0.7869, meanIoU within 0.002 of the committed 0.8396; AP is
   reported beside RESULTS.md's 0.4132.
"""

import csv
import os
import types

import h5py
import numpy as np
import jax
import pytest
import torch
import yaml

from rec_attend_tpu import analysis as janalysis
from rec_attend_tpu import config as JC
from rec_attend_tpu.cli import cityscapes_eval as jcs_eval
from rec_attend_tpu.cli import eval as jeval
from rec_attend_tpu.data import provider
from rec_attend_tpu.data import synthetic as jsynthetic
from rec_attend_tpu.data.assembler import png_decode
from rec_attend_tpu.data.assembler import png_encode
from rec_attend_tpu.data.dataset import pack_predictions
from rec_attend_tpu.engine.experiment import EvalExperiment as JEvalExperiment
from rec_attend_tpu.eval_cityscapes import instance_eval as JIE
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch.cli import cityscapes_eval
from rec_attend_tpu_torch.cli import eval as teval
from rec_attend_tpu_torch.cli import pack
from rec_attend_tpu_torch.data import synthetic
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.engine.experiment import EvalExperiment
from rec_attend_tpu_torch.eval_cityscapes import instance_eval
from rec_attend_tpu_torch.eval_cityscapes import pixel_eval
from rec_attend_tpu_torch.models import full_model as TF

torch.set_num_threads(1)

RESULTS = os.path.join(os.path.dirname(__file__), '..', 'results')
FG = os.path.join(RESULTS, 'fg_model_synthcs-20260818a')
FULL = os.path.join(RESULTS, 'full_model_synthcs-20260818a')
HEADLINE_CSVS = os.path.join(FULL, 'output_valid_calibrated')
MASK_THRESHOLD, SCORE_THRESHOLD = 0.4, 0.5
AP_THRESHOLD, AP_REMOVE_TINY = 0.6, 100
T, H, W, NSC = 20, 256, 512, 2


class PortView:
  """The JAX split seen through the port's dataset interface, with the
  instance-id images the port's evaluators read, made by the port from the
  split's masks and classes."""

  def __init__(self, ds):
    self.ds = ds

  def get_dataset_size(self):
    return self.ds.get_dataset_size()

  def get_batch(self, idx, timespan=None):
    return self.ds.get_batch(idx, timespan=timespan,
                             variables={'x', 's_gt', 'idx_map'})

  def get_full_size_labels(self, ids, timespan=None):
    return self.ds.get_full_size_labels(ids, timespan=timespan)

  def get_instance_id_images(self, ids):
    out = []
    with h5py.File(self.ds.h5_fname, 'r') as h5f:
      for idx in ids:
        group = h5f[idx]
        seg = group['label_segmentation_full_size']
        masks = [png_decode(seg[f'{k:02d}'][:]) for k in range(len(seg))]
        out.append(synthetic.instance_id_image(
            masks, group['instance_semantic_classes'][:]))
    return out


class Subset:
  """The examples of a JAX dataset with the given ids."""

  def __init__(self, ds, ids):
    self.ds = ds
    self.pos = np.array([list(ds.img_ids).index(i) for i in ids])
    self.img_ids = ds.img_ids[self.pos]
    self.h5_fname = ds.h5_fname

  def get_dataset_size(self):
    return len(self.pos)

  def get_batch(self, idx, timespan=None, variables=None):
    return self.ds.get_batch(self.pos[np.asarray(idx)], timespan=timespan,
                             variables=variables)

  def get_full_size_labels(self, ids, timespan=None):
    return self.ds.get_full_size_labels(ids, timespan=timespan)

  def get_str_id(self, idx):
    return self.ds.get_str_id(idx)


def _data_cfg(folder, n):
  """The synthcs split's DataConfig (data_opt.yaml of the full model), with
  a train size whose valid split holds the first n examples."""
  return JC.DataConfig(dataset='synth', folder=folder, height=H, width=W,
                       timespan=T, num_examples=max(4 * n, 32),
                       max_objects=10, num_semantic_classes=NSC)


def _scores(path):
  with open(path) as f:
    return {r[0]: float(r[1]) for r in list(csv.reader(f))[1:]}


def _jax_experiment(spec, folder, cfg_class, ds, ids, data_cfg):
  cfg = cfg_class.from_dict(yaml.safe_load(open(os.path.join(
      folder, 'model_opt.yaml'))))
  if spec == 'full':
    cfg = cfg.replace(use_knob=False)
  train_cfg = JC.TrainConfig(restore=folder, batch_size=8,
                             results=os.path.dirname(folder))
  exp = JEvalExperiment(spec, cfg, train_cfg, data_cfg, splits=['valid'])
  exp.get_dataset = lambda split: Subset(ds, ids)
  return exp


def _jax_fg_pack(ds, data_cfg):
  """The JAX fg forward packed into the split's H5 file (as its pack CLI,
  ``cli/pack.py:fg_main``); returns its bytes [n,H,W,8+3]."""
  fg = _jax_experiment('fg', FG, JC.FGModelConfig, ds, list(ds.img_ids),
                       data_cfg)
  for _, raw, outputs in fg.iterate_split('valid'):
    for i, sid in enumerate(raw['idx_map']):
      pack_predictions(ds.h5_fname, sid, foreground=outputs['y_out'][i],
                       orientation=outputs['d_out'][i])
  ds.clear_cache()
  got = ds.get_batch(np.arange(ds.get_dataset_size()), timespan=T,
                     variables={'d_out', 'y_out'})
  return np.rint(np.concatenate([got['d_out'], got['y_out']], axis=-1)
                 * 255).astype(np.int32)


def _jax_full_eval(ds, ids, out, data_cfg):
  """JAX's eval_split of the full model over ids, on the maps packed in
  the split's H5 file: ({id: sbd}, {id: dic})."""
  full = _jax_experiment('full', FULL, JC.FullModelConfig, ds, ids,
                         data_cfg)
  jeval.eval_split(full, 'valid', out, [MASK_THRESHOLD], ['sbd', 'dic'],
                   render_output=False, batch_size=8,
                   score_threshold=SCORE_THRESHOLD)
  return (_scores(os.path.join(out, 'sbd.csv')),
          _scores(os.path.join(out, 'dic.csv')))


def _write_packed(ds, packed):
  """Write the port's packed arrays into the split's H5 file as the JAX
  pack lays them out (its PNGs, without its quantisation)."""
  def u8(a):
    return png_encode(np.ascontiguousarray(a, dtype=np.uint8))
  with h5py.File(ds.h5_fname, 'a') as h5f:
    for i, sid in enumerate(ds.img_ids):
      items = ([(f'orientation_pred/{o:02d}', u8(packed.d_out[i, ..., o]))
                for o in range(8)]
               + [(f'foreground_pred/{c:02d}', u8(packed.y_out[i, ..., c]))
                  for c in range(packed.y_out.shape[-1])])
      if packed.y_out_ins is not None:
        items += [(f'instance_pred/{t:02d}', u8(packed.y_out_ins[i, t]))
                  for t in range(T)]
        items.append(('score_pred', packed.s_out[i].astype(np.float32)))
      group = h5f[sid]
      for key, val in items:
        if key in group:
          del group[key]
        group[key] = val
  ds.clear_cache()


def _jax_cityscapes(ds, root):
  """JAX's model-free Cityscapes eval of the maps in the H5 file
  (``eval_one`` with the SBD analyzer and the submission writer, as its
  pipeline's AP stage runs it), its AP of the written files and its
  pipeline's pixel stage: ({id: sbd}, AP averages, pixel result)."""
  from pipelines.run_pipeline import run_pixel_stage
  out = os.path.join(root, 'cs')
  sub = os.path.join(out, 'cityscapes')
  analyzers = [janalysis.create_analyzer(
      'sbd', display_name='sbd', fname=os.path.join(out, 'sbd.csv')),
               janalysis.RenderCityScapesOutputAnalyzer(sub, ds)]
  os.makedirs(out, exist_ok=True)
  for pos in range(ds.get_dataset_size()):
    jcs_eval.eval_one(ds, pos, [AP_THRESHOLD], [analyzers],
                      {'remove_tiny': AP_REMOVE_TINY}, timespan=T)
  for a in analyzers:
    a.finalize()
  gt_files = jsynthetic.write_instance_id_gt(ds, os.path.join(root, 'gt'))
  txts = [JIE.find_prediction_file(g, sub) for g in gt_files]
  ap = JIE.evaluate_instance_predictions(txts, gt_files, quiet=True)
  args = types.SimpleNamespace(results=os.path.join(root, 'results'),
                               dataset_folder=None, data_examples=None)
  pixel = run_pixel_stage(args, 'port_bytes', _data_cfg(
      os.path.dirname(ds.h5_fname), ds.get_dataset_size()))
  return _scores(os.path.join(out, 'sbd.csv')), ap, pixel


def _port_pixel_eval(view, packed):
  ev = pixel_eval.PixelEvaluator()
  for i, ids in enumerate(view.get_instance_id_images(
      list(view.ds.img_ids))):
    label, inst = pixel_eval.groundtruth_labels(ids)
    ev.add_pair(pixel_eval.prediction_labels(packed.y_out[i]), label,
                instance_img=inst)
  return ev.finalize()


def _chain(root, n):
  """The port's chain over the first n examples, held per example as the
  module's docstring says (items 1, 3, 4 and 5).  Returns the port's
  means, AP and pixel result."""
  data_cfg = _data_cfg(root, n)
  ds = provider.get('synth', data_cfg, split='valid')
  assert ds.get_dataset_size() == n and ds.get_num_semantic_classes() == NSC
  view = PortView(ds)
  fg = EvalExperiment(FG, device='cpu', spec='fg')
  assert fg.step == 3000 and fg.cfg == C.synthcs_fg_config()
  packed = pack.pack_fg(fg, view, batch_size=8)
  assert packed.y_out.shape == (n, H, W, 3)
  exp = EvalExperiment(FULL, device='cpu')
  assert exp.step == 30000 and not exp.cfg.use_knob
  out = os.path.join(root, 'port')
  summary = teval.eval_split(exp, packed, out, [MASK_THRESHOLD],
                             teval.DEFAULT_ANALYZERS, batch_size=8,
                             score_threshold=SCORE_THRESHOLD)
  means = {k.split()[0]: v[0] for k, v in summary[MASK_THRESHOLD].items()}
  sbd, dic = (_scores(os.path.join(out, f'{k}.csv')) for k in ('sbd', 'dic'))
  ids = sorted(k for k in sbd if k.startswith('synth'))
  assert ids == [f'synth{i:04d}' for i in range(n)]

  # 1. The fg pack's bytes against JAX's.
  jax_bytes = _jax_fg_pack(ds, data_cfg)
  port_bytes = np.concatenate([packed.d_out, packed.y_out],
                              axis=-1).astype(np.int32)
  step = np.abs(port_bytes - jax_bytes)
  assert step.max() <= 1 and (step > 0).mean() <= 1e-4, (
      step.max(), (step > 0).mean())

  # 3. Per example, against the committed CSVs or the JAX chain.
  ref_sbd, ref_dic = (_scores(os.path.join(HEADLINE_CSVS, f'{k}_40.csv'))
                      for k in ('sbd', 'dic'))

  def far(want_sbd, want_dic, keys):
    return [k for k in keys
            if abs(sbd[k] - want_sbd[k]) > 1e-3 or dic[k] != want_dic[k]]
  differ = far(ref_sbd, ref_dic, ids)
  if differ:
    jax_sbd, jax_dic = _jax_full_eval(ds, differ, os.path.join(root, 'jax'),
                                      data_cfg)
    noisy = far(jax_sbd, jax_dic, differ)
    if noisy:
      # Float32 neighbours in the bytes: JAX's full model on the port's.
      _write_packed(ds, packed)
      own_sbd, own_dic = _jax_full_eval(ds, noisy,
                                        os.path.join(root, 'jax_own'),
                                        data_cfg)
      assert not far(own_sbd, own_dic, noisy), [
          (k, sbd[k], own_sbd[k], jax_sbd[k], dic[k], own_dic[k])
          for k in noisy]

  # 4 and 5. The Cityscapes eval, AP and pixel eval on the same bytes.
  full_packed = pack.pack_full(exp, packed, batch_size=8)
  assert full_packed.y_out_ins.shape == (n, T, H, W)
  cs_out = os.path.join(root, 'port_cs')
  cs_summary, rows = cityscapes_eval.cityscapes_eval(
      full_packed, cs_out, [AP_THRESHOLD], ['sbd'],
      remove_tiny=AP_REMOVE_TINY, batch_size=8, device='cpu')
  # The rows come in the dataset's index order.
  ap = instance_eval.evaluate_instance_predictions(
      rows[AP_THRESHOLD], view.get_instance_id_images(list(ds.img_ids)))
  pixel = _port_pixel_eval(view, packed)
  _write_packed(ds, full_packed)
  jax_cs_sbd, jax_ap, jax_pixel = _jax_cityscapes(ds, os.path.join(root,
                                                                   'jax_cs'))
  assert _scores(os.path.join(cs_out, 'sbd.csv')) == jax_cs_sbd
  for key in ('allAp', 'allAp50%'):
    assert abs(ap[key] - jax_ap[key]) <= 1e-9, (key, ap[key], jax_ap[key])
  for name, d in jax_ap['classes'].items():
    for k, v in d.items():
      got = ap['classes'][name][k]
      assert (np.isnan(got) and np.isnan(v)) or abs(got - v) <= 1e-9, (
          name, k, got, v)
  for family, scores in jax_pixel.items():
    if isinstance(scores, dict):
      for name, v in scores.items():
        assert pixel[family][name] == pytest.approx(v, abs=1e-12,
                                                    nan_ok=True), name
    else:
      assert pixel[family] == pytest.approx(scores, abs=1e-12), family
  return {'means': means, 'cs_sbd': cs_summary[AP_THRESHOLD]['sbd 0.60'],
          'ap': ap, 'pixel': pixel, 'packed': packed, 'rows': rows}


@pytest.fixture(scope='module')
def first_8(tmp_path_factory):
  return _chain(str(tmp_path_factory.mktemp('synthcs8')), 8)


def test_chain_on_the_first_8_valid_examples(first_8):
  """Items 1, 3, 4 and 5 hold (inside ``_chain``); the model finds and
  submits instances of both classes."""
  assert 0.6 < first_8['means']['sbd'] < 0.95
  n_rows = [len(r) for r in first_8['rows'][AP_THRESHOLD]]
  assert sum(n_rows) >= 8
  assert {r.label_id for rows in first_8['rows'][AP_THRESHOLD]
          for r in rows} == {24, 25}
  assert 0.0 < first_8['ap']['allAp'] < 1.0
  assert 0.5 < first_8['pixel']['meanIoU'] < 1.0


def test_full_forward_matches_jax(first_8):
  """Item 2: the b2 forward on the port's packed bytes."""
  cfg = C.synthcs_full_config().replace(use_knob=False)
  jcfg = JC.cityscapes_full_config().replace(use_knob=False,
                                             num_semantic_classes=3)
  state = convert.params_from_checkpoint(saver.latest_checkpoint(FULL), cfg)
  params = JF.init_full_model(jax.random.PRNGKey(0), jcfg)
  names = [jax.tree_util.keystr(p, simple=True, separator='.')
           for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
  params = jax.tree_util.tree_unflatten(
      jax.tree_util.tree_structure(params), [state[n].numpy() for n in names])
  model = TF.FullModel(cfg, device='cpu')
  model.load_state_dict(state)
  packed = first_8['packed']
  batch = packed.get_batch([0, 1], timespan=T)
  x, d, y = batch['x'], batch['d_out'], batch['y_out']
  assert y.shape == (2, H, W, 3)
  jbatch = {'x': x, 'd_in': d, 'y_in': y,
            'y_gt': np.zeros((2, T, H, W), np.float32),
            's_gt': np.zeros((2, T), np.float32)}
  out, _ = jax.jit(lambda p, b: JF.full_model_forward(
      p, b, jcfg, False, jax.random.PRNGKey(1)))(params, jbatch)
  want = {k: np.asarray(v) for k, v in out.items()}
  got = TF.full_model_forward(model, *(torch.from_numpy(a)
                                       for a in (x, d, y)))
  dy = np.abs(got['y_out'].numpy() - want['y_out'])
  assert dy.mean() < 1e-5, dy.mean()
  assert (dy > 1e-3).mean() < 1e-3, (dy > 1e-3).mean()
  np.testing.assert_allclose(got['s_out'].numpy(), want['s_out'], atol=1e-4,
                             rtol=0)
  assert ((want['s_out'] > SCORE_THRESHOLD).sum(axis=1) >= 1).all()


@pytest.mark.slow
def test_synthcs_headline_on_the_whole_valid_split(tmp_path):
  """The whole split, each example held as in the subset: SBD within 0.002
  of the committed headline 0.7869 and meanIoU within 0.002 of the
  committed 0.8396.  AP is printed beside RESULTS.md's 0.4132, which has
  no committed export to hold it to."""
  result = _chain(str(tmp_path), 256)
  print('AP', result['ap'], 'pixel', result['pixel']['meanIoU'],
        result['pixel']['meanInstIoU'])
  assert abs(result['means']['sbd'] - 0.7869) <= 0.002, result['means']
  assert abs(result['pixel']['meanIoU'] - 0.8396) <= 0.002, (
      result['pixel']['meanIoU'])
