"""The port's synthcs pipeline (fg -> pack -> box -> full -> eval -> ap ->
pixel) at ``--scale tiny``, its full model's pack on disk, its options, and
``chip_smoke.py``'s ``synthcs_pipeline`` phase at the tiny scale on the CPU.

The chain runs as two invocations of ``run_pipeline.main``, ``--stages
fg,pack`` and then ``--stages box,full,eval,ap,pixel --model_id <id>``: the
packed maps cross from one to the other through the pack files only.  The
fg and box stages take 20 steps, as the JAX pipeline's ``--num_steps 20``;
the full stage takes 60, enough that the full model finds instances, and
the ap stage removes regions of up to 10 pixels (the default 100 is most of
an instance at 64x64).  The JAX package then restores the port's folders on
the port's splits:

- its fg ``EvalExperiment`` and ``pipelines/eval_fg_metrics.main`` give
  the port's ``fg_metrics_valid.json`` within 2e-4 (the file holds 4
  decimals);
- its fg outputs (3 class and 8 orientation channels), quantised as its
  ``pack_predictions`` writes them, are the port's pack files' bytes,
  one-step differences allowed in at most 1e-4 of the bytes (float32 noise
  at a truncation edge);
- its full ``EvalExperiment`` reads the port's packed bytes, and its
  ``eval_split`` gives the port's CSVs at each of the six thresholds to
  1e-3 in SBD per example (4 decimals and float32 noise), with equal
  counts (``dic``);
- its ``instance_eval.evaluate_instance_predictions``, over the submission
  of the port's pack written as the JAX writer lays it out (cv2 PNGs and
  text rows) and the split's instance-id images, gives ``ap.json``'s
  averages to 1e-9; the same on a pack of the ground truth's instance
  maps, where the AP is far from 0;
- its ``PixelEvaluator`` over the pack's fg bytes, labelled as its pixel
  stage labels them, gives ``pixel_eval.json`` exactly.
"""

import argparse
import csv
import dataclasses
import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

from rec_attend_tpu import config as JC
from rec_attend_tpu.cli import eval as jeval
from rec_attend_tpu.data import synthetic as jsynthetic
from rec_attend_tpu.engine import experiment as jexp_lib
from rec_attend_tpu.eval_cityscapes import instance_eval as JIE
from rec_attend_tpu.eval_cityscapes import pixel_eval as JPE
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.cli import pack
from rec_attend_tpu_torch.cli.cityscapes_eval import cityscapes_eval
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.pipelines import run_pipeline

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
import chip_smoke as cs  # noqa: E402
from pipelines import eval_fg_metrics as jfg_metrics  # noqa: E402
from rec_attend_tpu_torch.ops.cuda import glimpse as gk  # noqa: E402

STEPS, FULL_STEPS, REMOVE_TINY = 20, 60, 10
THRESHOLDS = [0.2, 0.3, 0.4, 0.5, 0.6, 0.7]


def _argv(root, *extra):
  return ['--dataset', 'synthcs', '--scale', 'tiny', '--num_steps',
          str(STEPS), '--results', os.path.join(root, 'results'), '--logs',
          os.path.join(root, 'logs'), '--dataset_folder',
          os.path.join(root, 'data'), '--model_id', 'chain', *extra]


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
  """The tiny chain in two invocations: {'root', 'ids', 'data_cfg'}."""
  root = str(tmp_path_factory.mktemp('synthcs'))
  first = run_pipeline.main(_argv(root, '--stages', 'fg,pack'),
                            device='cpu')
  assert first['stages'] == ['fg', 'pack']
  second = run_pipeline.main(
      _argv(root, '--stages', 'box,full,eval,ap,pixel', '--full_steps',
            str(FULL_STEPS), '--ap_remove_tiny', str(REMOVE_TINY)),
      device='cpu')
  assert second['stages'] == ['box', 'full', 'eval', 'ap', 'pixel']
  assert {k: first[k] for k in ('fg', 'box', 'full')} == {
      k: second[k] for k in ('fg', 'box', 'full')}
  data_cfg = C.DataConfig.from_yaml(os.path.join(
      root, 'results', second['full'], 'data_opt.yaml'))
  return {'root': root, 'ids': second, 'data_cfg': data_cfg}


def _folder(chain, stage, root=None):
  return os.path.join(root or chain['root'], 'results', chain['ids'][stage])


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


def _json(path):
  with open(path) as f:
    return json.load(f)


def _same(a, b):
  """Equal results, NaN equal to NaN."""
  return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


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
  assert full_cfg.num_semantic_classes == 3
  assert data_cfg.num_semantic_classes == 2
  # The fg maps in both pack files, the full model's in the valid one.
  for split, full_maps in (('train', False), ('valid', True)):
    packed = provider.get('synth', data_cfg, split=split)
    assert isinstance(packed, provider.PackedDataset)
    assert packed.y_out.shape[-1] == 3
    assert (packed.y_out_ins is not None) == full_maps, split
  valid = provider.get('synth', data_cfg, split='valid')
  assert valid.y_out_ins.shape == (8, 6, 64, 64)
  assert valid.y_out_ins.dtype == np.uint8
  assert valid.s_out.shape == (8, 6) and valid.s_out.dtype == np.float32
  out = os.path.join(_folder(chain, 'full'), 'output_valid')
  for tt in THRESHOLDS:
    assert len(_rows(os.path.join(out, f'sbd_{int(tt * 100):02d}.csv'))) == 8
  assert len(_rows(os.path.join(_folder(chain, 'full'), 'cs_output_valid',
                                'sbd.csv'))) == 8
  ap = _json(os.path.join(out, 'ap.json'))
  assert sorted(ap) == ['aps', 'averages']
  assert _same(ap['averages'], ids['ap'])
  assert np.asarray(ap['aps'], float).shape == (1, 8, 10)
  assert _json(os.path.join(out, 'pixel_eval.json'))['meanIoU'] == ids[
      'pixel']['meanIoU']
  metrics = _json(os.path.join(_folder(chain, 'fg'), 'fg_metrics_valid.json'))
  assert metrics['step'] == STEPS and metrics['n'] == 8
  assert ids['fg'] == 'fg_model_synthcs-chain'


def test_full_pack_reads_back_as_in_memory(chain):
  """The valid pack file's full maps read back through the provider are
  pack_full's in memory of the same model on the same split, and give its
  batches' float32 values."""
  data_cfg = chain['data_cfg']
  on_disk = provider.get('synth', data_cfg, split='valid')
  fg_only = provider.PackedDataset(on_disk.dataset, on_disk.d_out,
                                   on_disk.y_out)
  exp = pack.EvalExperiment(_folder(chain, 'full'), device='cpu')
  in_memory = pack.pack_full(exp, fg_only, 4)
  for key in ('d_out', 'y_out', 'y_out_ins', 's_out'):
    a, b = getattr(on_disk, key), getattr(in_memory, key)
    assert a.dtype == b.dtype and np.array_equal(a, b), key
  idx = np.arange(8)
  got = on_disk.get_batch(idx, timespan=6)
  want = in_memory.get_batch(idx, timespan=6)
  for key in ('y_out_ins', 's_out', 'y_out', 'd_out'):
    assert got[key].dtype == np.float32
    assert np.array_equal(got[key], want[key]), key
  # write_pack holds the full maps to their types.
  with pytest.raises(ValueError, match='s_out'):
    provider.write_pack(
        os.path.join(chain['root'], 'bad.npz'), on_disk.dataset.img_ids,
        on_disk.d_out, on_disk.y_out, {}, y_out_ins=on_disk.y_out_ins,
        s_out=on_disk.s_out.astype(np.float64))


def test_fg_metrics_as_jax(chain, monkeypatch):
  """Tolerance 2e-4: both files round to 4 decimals."""
  folder = _folder(chain, 'fg')
  got = _json(os.path.join(folder, 'fg_metrics_valid.json'))
  valid = provider.get('synth', chain['data_cfg'], split='valid')
  monkeypatch.setattr(jexp_lib.EvalExperiment, 'get_dataset',
                      lambda self, split: valid)
  jfg_metrics.main(['--model_id', chain['ids']['fg'], '--results',
                    os.path.dirname(folder), '--batch_size', '4'])
  want = _json(os.path.join(folder, 'fg_metrics_valid.json'))
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
        assert got.shape == w.shape and got.shape[-1] == {'d_out': 8,
                                                          'y_out': 3}[k]
        diff = np.abs(got - w)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (split, k)


def test_full_model_evaluates_as_jax_on_the_packed_bytes(chain, tmp_path):
  folder = _folder(chain, 'full')
  # The folder as the port wrote it: JAX reads its pretrain_ctrl_net, the
  # box's weights.h5, before the checkpoint sets every parameter.
  jexp = _jax_eval(chain, 'full', JC.FullModelConfig, use_knob=False)
  assert jexp.step == FULL_STEPS
  valid = provider.get('synth', chain['data_cfg'], split='valid')
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


def _jax_ap(packed, root, remove_tiny):
  """JAX's AP of the port's Cityscapes eval of ``packed``: the submission
  written as the JAX writer lays it out (a text file of mask PNG, label id
  and score rows an image) and the instance-id images as uint16 PNGs,
  read by JAX's evaluator.  Returns (port averages, JAX averages)."""
  _, rows = cityscapes_eval(packed, os.path.join(root, 'cs'),
                            [run_pipeline.AP_THRESHOLD], ['sbd'],
                            remove_tiny=remove_tiny, batch_size=4,
                            device='cpu')
  rows = rows[run_pipeline.AP_THRESHOLD]
  ds = packed.dataset
  gt_images = ds.get_instance_id_images(ds.img_ids)
  txts, gt_files = [], []
  for i, (image_rows, gt) in enumerate(zip(rows, gt_images)):
    lines = []
    for j, row in enumerate(image_rows):
      name = f'synth_{i:06d}_{j:02d}.png'
      cv2.imwrite(os.path.join(root, name), row.mask)
      lines.append(f'{name} {row.label_id} {row.score:f}\n')
    txts.append(os.path.join(root, f'synth_{i:06d}.txt'))
    with open(txts[-1], 'w') as f:
      f.writelines(lines)
    gt_files.append(os.path.join(root, f'synth_{i:06d}_gtFine.png'))
    cv2.imwrite(gt_files[-1], np.asarray(gt, np.uint16))
  want = JIE.evaluate_instance_predictions(txts, gt_files, quiet=True)
  from rec_attend_tpu_torch.eval_cityscapes import instance_eval
  return instance_eval.evaluate_instance_predictions(rows, gt_images), want


def _assert_same_averages(got, want):
  for key in ('allAp', 'allAp50%'):
    assert abs(got[key] - want[key]) <= 1e-9, (key, got[key], want[key])
  assert sorted(got['classes']) == sorted(want['classes'])
  for name, d in want['classes'].items():
    for k, v in d.items():
      g = got['classes'][name][k]
      assert (np.isnan(g) and np.isnan(v)) or abs(g - v) <= 1e-9, (name, k)


def test_ap_json_as_jax(chain, tmp_path):
  """The chain's ap.json against JAX's evaluator on the same submission;
  then the AP stage over a pack of the ground truth's instance maps (its
  full pack not run: the file's maps are the ground truth's), where the
  AP is far from 0."""
  data_cfg = chain['data_cfg']
  packed = provider.get('synth', data_cfg, split='valid')
  got, want = _jax_ap(packed, str(tmp_path), REMOVE_TINY)
  ap = _json(os.path.join(_folder(chain, 'full'), 'output_valid', 'ap.json'))
  assert _same(ap['averages'], got)
  _assert_same_averages(ap['averages'], want)
  # The tiny model's AP on its own maps is 0 (its submission is compared
  # all the same); on the ground truth's instance maps it is not.

  root = str(tmp_path / 'gt')
  shutil.copytree(chain['root'], root)
  gt_cfg = data_cfg.replace(folder=os.path.join(root, 'data'))
  ds = packed.dataset
  path = provider.pack_path(gt_cfg, 'valid')
  provider.write_pack(path, ds.img_ids, packed.d_out, packed.y_out,
                      provider.settings(gt_cfg, 'valid'),
                      y_out_ins=pack.quantise(torch.from_numpy(
                          ds.y_gt)).numpy(), s_out=ds.s_gt)
  args = argparse.Namespace(results=os.path.join(root, 'results'),
                            dataset_folder=gt_cfg.folder, data_examples=None,
                            ap_remove_tiny=100)
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(run_pipeline.pack_cli, 'full_main', lambda *a, **k: None)
    avg = run_pipeline.run_ap_stage(args, chain['ids']['full'], gt_cfg, 4,
                                    device='cpu')
  os.makedirs(str(tmp_path / 'gt_files'))
  got, want = _jax_ap(provider.get('synth', gt_cfg, split='valid'),
                      str(tmp_path / 'gt_files'), 100)
  assert _same(avg, got)
  _assert_same_averages(avg, want)
  assert avg['allAp'] > 0.25


def test_pixel_eval_as_jax(chain):
  """JAX's PixelEvaluator over the pack's fg bytes, each labelled as its
  pixel stage labels the decoded PNG channels, against the instances
  drawn as its stage draws them from the split's masks and classes."""
  packed = provider.get('synth', chain['data_cfg'], split='valid')
  ds = packed.dataset
  ids_tbl = jsynthetic.CS_INSTANCE_LABEL_IDS
  background = jsynthetic.CS_BACKGROUND_LABEL_ID
  ev = JPE.PixelEvaluator()
  for i, fg in enumerate(packed.y_out):
    am = fg.argmax(axis=2)
    pred = np.where(am == 0, background,
                    np.asarray(ids_tbl)[(am - 1) % len(ids_tbl)])
    gt_label = np.full(pred.shape, background, np.uint8)
    gt_inst = np.full(pred.shape, background, np.int64)
    for jj in range(int(ds.s_gt[i].sum())):
      mask = ds.y_gt[i, jj] > 0
      lid = ids_tbl[int(ds.classes[i, jj]) % len(ids_tbl)]
      gt_label[mask] = lid
      gt_inst[mask] = lid * 1000 + jj
    ev.add_pair(pred.astype(np.uint8), gt_label, instance_img=gt_inst)
  want = json.loads(json.dumps(ev.finalize()))
  got = _json(os.path.join(_folder(chain, 'full'), 'output_valid',
                           'pixel_eval.json'))
  assert _same(got, want)
  assert 0 < got['meanIoU'] < 1


def _copy(chain, tmp_path):
  root = str(tmp_path / 'copy')
  shutil.copytree(chain['root'], root)
  return root


def test_ap_stage_alone_repacks_with_its_remove_tiny(chain, tmp_path):
  """--stages ap runs the full pack again (here into a pack file that lost
  the full maps) and hands --ap_remove_tiny to the Cityscapes eval."""
  root = _copy(chain, tmp_path)
  cfg = chain['data_cfg'].replace(folder=os.path.join(root, 'data'))
  packed = provider.get('synth', cfg, split='valid')
  provider.write_pack(provider.pack_path(cfg, 'valid'),
                      packed.dataset.img_ids, packed.d_out, packed.y_out,
                      provider.settings(cfg, 'valid'))
  assert provider.get('synth', cfg, split='valid').y_out_ins is None
  seen = []

  def spy(fn):
    def call(argv, **kw):
      seen.append(int(argv[argv.index('--remove_tiny') + 1]))
      return fn(argv, **kw)
    return call
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(run_pipeline.cs_eval_cli, 'main',
               spy(run_pipeline.cs_eval_cli.main))
    out = run_pipeline.main(_argv(root, '--stages', 'ap', '--ap_remove_tiny',
                                  '37'), device='cpu')
  assert out['stages'] == ['ap'] and seen == [37]
  again = provider.get('synth', cfg, split='valid')
  assert np.array_equal(again.y_out_ins, packed.y_out_ins)
  assert np.array_equal(again.s_out, packed.s_out)
  # The fg pack writes the file anew: the full maps go with the old maps.
  pack.fg_main(['--model_id', chain['ids']['fg'], '--results',
                os.path.join(root, 'results'), '--dataset', 'synth',
                '--split', 'valid', '--batch_size', '4', '--dataset_folder',
                cfg.folder], device='cpu')
  assert provider.get('synth', cfg, split='valid').y_out_ins is None
  with pytest.raises(FileNotFoundError, match='full model maps'):
    run_pipeline._packed_split(cfg, 'valid', full_maps=True)


def test_unknown_stage_and_missing_pack_raise(tmp_path):
  root = str(tmp_path)
  with pytest.raises(ValueError, match='render'):
    run_pipeline.main(_argv(root, '--stages', 'fg,render'), device='cpu')
  with pytest.raises(FileNotFoundError, match='pack stage'):
    run_pipeline.main(_argv(root, '--stages', 'box'), device='cpu')
  with pytest.raises(FileNotFoundError, match='pack stage'):
    run_pipeline.main(_argv(root, '--stages', 'pixel'), device='cpu')


def test_resume_skips_the_completed_prefix(chain, tmp_path):
  root = _copy(chain, tmp_path)
  full = _folder(chain, 'full', root)
  out = run_pipeline.main(_argv(root, '--resume', '--stages',
                                'fg,pack,box,full', '--full_steps',
                                str(FULL_STEPS + 2)), device='cpu')
  assert out['stages'] == ['full']
  assert [s for s, _ in saver.list_checkpoints(full)] == [
      FULL_STEPS, FULL_STEPS + 2]
  for stage in ('fg', 'box'):
    assert saver.latest_checkpoint(_folder(chain, stage, root)).endswith(
        f'ckpt-{STEPS}.npz')


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
  assert (out['fg'], out['box'], out['full']) == (
      ids['fg'], ids['box'], 'full_model_synthcs-reuse')
  assert {s: saver.list_checkpoints(os.path.join(results, ids[s]))
          for s in ('fg', 'box')} == before
  cfg = C.FullModelConfig.from_yaml(os.path.join(
      results, out['full'], 'model_opt.yaml'))
  assert cfg.pretrain_ctrl_net == os.path.join(results, ids['box'],
                                               'weights.h5')


def test_paper_scale_is_the_jax_pipelines():
  """The paper scale's configs are JAX run_synth_cs's (run_pipeline.py:
  392-415): the Cityscapes presets with 3 classes, fg b8, box and full
  b4."""
  data_cfg, fg, box, full, train_cfg, steps, batch = (
      run_pipeline.synthcs_stages('paper', data_examples=16))
  jfg = JC.cityscapes_fg_config()
  jfg = jfg.replace(num_semantic_classes=3,
                    dcnn_depth=jfg.dcnn_depth[:-1] + (11,))
  for got, want in (
      (fg, jfg), (box, JC.cityscapes_box_config().replace(
          num_semantic_classes=3)),
      (full, JC.cityscapes_full_config().replace(num_semantic_classes=3))):
    assert dataclasses.asdict(got) == dataclasses.asdict(
        type(got).from_dict(want.to_dict()))
  assert (data_cfg.height, data_cfg.width, data_cfg.timespan,
          data_cfg.num_examples, data_cfg.max_objects,
          data_cfg.num_semantic_classes) == (256, 512, 20, 16, 10, 2)
  assert batch == {'fg': 8, 'box': 4, 'full': 4}
  assert steps == {'fg': 1500, 'box': 4000, 'full': 6000}
  assert train_cfg.batch_size == 8 and train_cfg.device_data


# The box and full steps' limits on the card rest on their float32 floors
# at the synthcs presets.  At this size the dropped-filter control moves the
# full model's median leaf by about 2.6e-3 and its gradients and the box's
# all at once by a few 1e-3 only, near or inside those limits, while the
# tiny steps' floor (reordered plain against plain, CPU) is about 1e-6:
# here those gates are held to 1e-5, as test_torch_chain_train.py holds
# its tiny full step.
TINY_BOX_LIMITS = {**cs.SYNTHCS_BOX_STEP_LIMITS, 'grad_rel_l2_all': 1e-5}
TINY_FULL_LIMITS = {**cs.SYNTHCS_FULL_STEP_LIMITS, 'grad_rel_l2_all': 1e-5,
                    'grad_rel_l2_median': 1e-5}


def test_chip_smoke_synthcs_pipeline_phase_on_cpu(chain):
  """The phase at the tiny scale; its second run (ap, pixel on the
  ground truth's maps) takes the chain's 60-step full model, which finds
  instances, where the phase takes the committed synthcs one."""
  out, failures = cs.synthcs_pipeline_phase(
      torch, gk, torch.device('cpu'), scale='tiny', bit_equal=True,
      oracle_dir=_folder(chain, 'full'), ap_remove_tiny=REMOVE_TINY,
      limits=(cs.SYNTHCS_FG_STEP_LIMITS, TINY_BOX_LIMITS, TINY_FULL_LIMITS))
  assert failures == []
  for gated in (out['packs']['fg_gate'], out['packs']['full_gate'],
                out['full_controller_gate'], out['ap']['gate'],
                out['pixel']['gate']):
    assert gated['failures'] == [] and gated['control_failures']
  for stage in ('fg', 'box', 'full'):
    assert out[stage]['checkpoints'] == list(range(
        cs.SYNTHCS_EVERY, cs.SYNTHCS_STEPS + 1, cs.SYNTHCS_EVERY))[-2:]
    assert out[stage]['start_step'] == 0
  assert out['stages'] == list(run_pipeline.SYNTHCS_STAGES)
  assert out['ap']['oracle']['kernel']['allAp'] > 0
  assert out['pack']['bytes']['valid'] > out['pack']['bytes']['train'] / 2
  assert sorted(out['stage_host_seconds']) == [
      'ap', 'eval', 'full_pack', 'pack', 'pixel']
  assert len(out['stage_host_seconds']['eval']) == 2
  # The box's sigmoid score head fails its gate (the fg control does not
  # bite at this size: the tiny fg loss is the IoU, not the CE).
  assert 'grad_rel_l2_max' in out['box_gates'][
      'sigmoid_scores_vs_cpu_pinned']['failed']
  # On the CPU the kernel glimpses are the plain ones: nothing launches.
  assert not any(out['plain_step_launches']['launches'].values())
  assert 'launch_gate' not in out
