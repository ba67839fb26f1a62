"""The training pipelines: box -> full -> eval, and fg -> pack -> box ->
full -> eval (-> ap -> pixel), on the synthetic datasets, CVPPP and
KITTI.

Counterpart of ``run_synth``, ``run_synth3`` and ``run_synth_cs`` (here
both chains are ``run_chain``), ``run_pixel_stage`` and ``run_ap_stage``
of ``pipelines/run_pipeline.py:198-610``.  ``--dataset synth``: the box model
trains on the synthetic split, the full model starts from the box's
controller and trains, and the eval command line scores the full model on
the valid split.  ``--scale paper`` is the CVPPP-shaped run (224x224, T=21,
up to 9 instances, the CVPPP presets, b8, 12,000 box and 20,000 full steps
on 256 generated examples); ``--scale tiny`` a 64x64 smoke run.

``--dataset synth3`` is the KITTI-shaped chain: the fg model with its
orientation head trains, the pack stage writes its maps into each split's
pack file (``cli.pack.fg_main``), the box model and then the full model
train on the packed channels, and the eval stage scores the fg model
(``pipelines.eval_fg_metrics``) and the full model over six thresholds.
``--scale paper`` is 128x448, T=20, up to 12 instances, the KITTI presets,
b8, 3,000 fg, 12,000 box and 16,000 full steps on 256 examples
(``--data_examples``), each split kept on the device; ``--scale tiny`` a
64x64 smoke run on 32 examples.

``--dataset synthcs`` is the Cityscapes-shaped chain on images of two
instance classes (3 config classes with the background): the same stages
with the Cityscapes presets, the fg model's softmax over the classes and
the box model's softmax score head, then two more.  ``ap``: the full
model's pack (``cli.pack.full_main``) of the valid split into its pack
file, the model-free Cityscapes eval of that file
(``cli.cityscapes_eval``, mask threshold 0.6, regions of up to
``--ap_remove_tiny`` pixels removed) and the official instance AP of its
submission against the split's instance-id images, written to
``results/<full id>/output_valid/ap.json`` in the JAX layout.  ``pixel``:
the official pixel-level eval of the fg model's packed bytes against the
same images, written to ``output_valid/pixel_eval.json``.  The JAX stage
also writes the submission's ``.txt`` and PNG files and the gtFine PNGs
through cv2; here the rows and images stay in memory (ROADMAP A.5, with
the PNG codec).  ``--scale paper`` is 256x512, T=20, up to 10 instances,
the synthcs presets (``config.synthcs_*_config``), fg at b8 and box and
full at b4, 1,500 fg, 4,000 box and 6,000 full steps on 256 examples;
``--scale tiny`` a 64x64 smoke run on 32 examples.

For both chains ``--stages`` picks stages and ``--model_id`` names the
chain, so a chain can go on in another process: no stage hands another
anything in memory, each reads its split through ``data.provider``, as the
JAX stages read the H5.  ``--fg_from`` and ``--box_from`` reuse a trained
stage; ``--resume`` restores each trained stage from its folder (its data
snapshot must match), and skips fg, pack and box once a full checkpoint
and both pack files exist.

``--dataset cvppp`` and ``--dataset kitti`` are the twins of JAX's
``run_cvppp`` and ``run_kitti`` (``run_pipeline.py:84-149``) in
``run_chain``, on the splits ``cli.setup_dataset`` assembled into
``--dataset_folder``: CVPPP box (b5) -> full (b5) -> eval on valid, KITTI
fg (b8) -> pack into the split's H5 files -> box (b5) -> full (b2) ->
eval on valid, the paper presets with 60,000 box and 30,000 full steps
(CVPPP) and 40,000 fg, 60,000 box and 100,000 full (KITTI) unless
``--num_steps`` or a stage's flag says otherwise (JAX's paper scale
ignores ``--num_steps``); ``--scale tiny`` runs the same presets for
``--num_steps`` or 100 steps a stage, as JAX's does.  Cityscapes' waits
(ROADMAP A.5).

The full model starts from the box's controller as the JAX pipeline hands
it over: ``cli.read_weights.box_main`` exports the box's last checkpoint
to ``<results>/<box id>/weights.h5`` and the full model's
``pretrain_ctrl_net`` names that file.  The command line runs on the
card; ``main(argv, device='cpu')`` runs on the host.

    python -m rec_attend_tpu_torch.pipelines.run_pipeline --dataset synth \\
        --scale tiny --num_steps 20
    python -m rec_attend_tpu_torch.pipelines.run_pipeline --dataset synth3 \\
        --scale tiny --stages fg,pack --model_id chain
    python -m rec_attend_tpu_torch.pipelines.run_pipeline --dataset synth3 \\
        --scale tiny --stages box,full,eval --model_id chain
    python -m rec_attend_tpu_torch.pipelines.run_pipeline --dataset synthcs \\
        --scale tiny --model_id cs
    python -m rec_attend_tpu_torch.pipelines.run_pipeline --dataset kitti \\
        --dataset_folder data/kitti --num_steps 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.cli import args as A
from rec_attend_tpu_torch.cli import eval as eval_cli
from rec_attend_tpu_torch.cli import pack as pack_cli
from rec_attend_tpu_torch.cli import read_weights
from rec_attend_tpu_torch.cli.cityscapes_eval import cityscapes_eval
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.data.provider import PackedDataset
from rec_attend_tpu_torch.device import resolve_device
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
from rec_attend_tpu_torch.engine.experiment import assign_model_id
from rec_attend_tpu_torch.eval_cityscapes import instance_eval
from rec_attend_tpu_torch.eval_cityscapes import pixel_eval
from rec_attend_tpu_torch.pipelines import eval_fg_metrics
from rec_attend_tpu_torch.utils import logger

SYNTH3_STAGES = ('fg', 'pack', 'box', 'full', 'eval')
SYNTHCS_STAGES = SYNTH3_STAGES + ('ap', 'pixel')
# The eval stage's thresholds (JAX run_pipeline.py:366-371, :463-468); the
# AP stage's mask threshold, the Cityscapes command line's default
# (cli/cityscapes_eval.py:111).
EVAL_THRESHOLDS = '0.2,0.3,0.4,0.5,0.6,0.7'
AP_THRESHOLD = 0.6
# The paper scale's cadence (JAX run_pipeline.py:222-224, :314-316).
PAPER_CADENCE = dict(steps_per_valid=250, steps_per_trainval=250,
                     steps_per_plot=0, num_batch_valid=4, prefetch=True,
                     num_worker=2, device_data=True)


def _tiny_cadence(steps):
  return dict(steps_per_valid=max(steps // 2, 1),
              steps_per_trainval=max(steps // 2, 1), steps_per_plot=0)


def synth_stages(scale, results='results', logs='logs', dataset_folder=None,
                 num_steps=None):
  """The configs of ``run_synth`` at ``scale``: (data config, box config,
  full config before its pretrained controller is named, the box stage's
  train config, the full stage's step count)."""
  if scale == 'paper':
    data_cfg = C.DataConfig(dataset='synth', folder=dataset_folder,
                            height=224, width=224, timespan=21,
                            num_examples=256, max_objects=9)
    box_cfg = C.cvppp_box_config()
    full_base = C.cvppp_full_config()
    bs = 8
    box_steps = num_steps or 12000
    full_steps = num_steps or 20000
    cadence = PAPER_CADENCE
  else:
    data_cfg = C.data_config_for('synth', dataset_folder)
    box_cfg = C.tiny_box_config(timespan=6)
    full_base = C.tiny_full_config(timespan=6, use_knob=True)
    bs = 4
    box_steps = full_steps = num_steps or 100
    cadence = _tiny_cadence(box_steps)
  train_cfg = C.TrainConfig(num_steps=box_steps, batch_size=bs,
                            save_ckpt=True, results=results, logs=logs,
                            **cadence)
  return data_cfg, box_cfg, full_base, train_cfg, full_steps


def synth3_stages(scale, results='results', logs='logs', dataset_folder=None,
                  num_steps=None, data_examples=None, fg_steps=None,
                  box_steps=None, full_steps=None):
  """The configs of ``run_synth3`` at ``scale`` (JAX
  ``run_pipeline.py:304-334``): (data config, fg config, box config, full
  config before its pretrained controller is named, the train config of
  the fg stage, {stage: its step count}, {stage: its batch size})."""
  if scale == 'paper':
    data_cfg = C.DataConfig(dataset='synth', folder=dataset_folder,
                            height=128, width=448, timespan=20,
                            num_examples=data_examples or 256,
                            max_objects=12)
    fg_cfg = C.kitti_fg_config()
    box_cfg = C.kitti_box_config()
    full_base = C.kitti_full_config()
    bs = 8
    steps = {'fg': fg_steps or 3000, 'box': box_steps or 12000,
             'full': full_steps or 16000}
    cadence = PAPER_CADENCE
  else:
    data_cfg = C.DataConfig(dataset='synth', folder=dataset_folder,
                            height=64, width=64, timespan=6,
                            num_examples=32, max_objects=4)
    fg_cfg = C.tiny_fg_config(add_orientation=True, dcnn_depth=(8, 4, 9))
    box_cfg = C.tiny_box_config(timespan=6, add_d_out=True, add_y_out=True)
    full_base = C.tiny_full_config(
        timespan=6, use_knob=True, add_d_out=True, add_y_out=True,
        ctrl_add_inp=True, ctrl_add_canvas=True,
        attn_add_inp=True, attn_add_canvas=True)
    bs = 4
    n = num_steps or 20
    steps = {'fg': fg_steps or n, 'box': box_steps or n,
             'full': full_steps or n}
    cadence = _tiny_cadence(steps['fg'])
  train_cfg = C.TrainConfig(num_steps=steps['fg'], batch_size=bs,
                            save_ckpt=True, results=results, logs=logs,
                            **cadence)
  return (data_cfg, fg_cfg, box_cfg, full_base, train_cfg, steps,
          dict.fromkeys(('fg', 'box', 'full'), bs))


def synthcs_stages(scale, results='results', logs='logs',
                   dataset_folder=None, num_steps=None, data_examples=None,
                   fg_steps=None, box_steps=None, full_steps=None):
  """The configs of ``run_synth_cs`` at ``scale`` (JAX
  ``run_pipeline.py:392-431``), as ``synth3_stages`` returns them: 2
  instance classes in the data, 3 config classes with the background."""
  nsc_data = 2
  nsc_cfg = nsc_data + 1
  if scale == 'paper':
    data_cfg = C.DataConfig(dataset='synth', folder=dataset_folder,
                            height=256, width=512, timespan=20,
                            num_examples=data_examples or 256,
                            max_objects=10, num_semantic_classes=nsc_data)
    fg_cfg = C.synthcs_fg_config()
    box_cfg = C.synthcs_box_config()
    full_base = C.synthcs_full_config()
    batch = {'fg': 8, 'box': 4, 'full': 4}
    steps = {'fg': fg_steps or 1500, 'box': box_steps or 4000,
             'full': full_steps or 6000}
    cadence = PAPER_CADENCE
  else:
    data_cfg = C.DataConfig(dataset='synth', folder=dataset_folder,
                            height=64, width=64, timespan=6,
                            num_examples=32, max_objects=4,
                            num_semantic_classes=nsc_data)
    fg_cfg = C.tiny_fg_config(add_orientation=True,
                              num_semantic_classes=nsc_cfg,
                              dcnn_depth=(8, 4, nsc_cfg + 8))
    box_cfg = C.tiny_box_config(timespan=6, add_d_out=True, add_y_out=True,
                                num_semantic_classes=nsc_cfg)
    full_base = C.tiny_full_config(
        timespan=6, use_knob=True, add_d_out=True, add_y_out=True,
        num_semantic_classes=nsc_cfg, ctrl_add_inp=True,
        ctrl_add_canvas=True, attn_add_inp=True, attn_add_canvas=True)
    batch = dict.fromkeys(('fg', 'box', 'full'), 4)
    n = num_steps or 20
    steps = {'fg': fg_steps or n, 'box': box_steps or n,
             'full': full_steps or n}
    cadence = _tiny_cadence(steps['fg'])
  train_cfg = C.TrainConfig(num_steps=steps['fg'], batch_size=batch['fg'],
                            save_ckpt=True, results=results, logs=logs,
                            **cadence)
  return data_cfg, fg_cfg, box_cfg, full_base, train_cfg, steps, batch


def _steps(scale, paper, num_steps, given):
  """{stage: steps}: a stage's own flag, else --num_steps, else the paper
  scale's count (``paper``) or 100 at the tiny scale."""
  return {stage: given.get(stage) or num_steps
          or (n if scale == 'paper' else 100)
          for stage, n in paper.items()}


def cvppp_stages(scale, results='results', logs='logs', dataset_folder=None,
                 num_steps=None, data_examples=None, fg_steps=None,
                 box_steps=None, full_steps=None):
  """The configs of ``run_cvppp`` (JAX ``run_pipeline.py:84-112``, ref
  run_cvppp.sh), as ``synth3_stages`` returns them (the fg config None):
  the CVPPP presets at 224x224, T=21, box and full at b5, 60,000 box and
  30,000 full steps at the paper scale and 100 at the tiny one."""
  del data_examples, fg_steps    # the assembled splits; no fg stage
  batch = {'box': 5, 'full': 5}
  steps = _steps(scale, {'box': 60000, 'full': 30000}, num_steps,
                 {'box': box_steps, 'full': full_steps})
  train_cfg = C.TrainConfig(num_steps=steps['box'], batch_size=batch['box'],
                            save_ckpt=True, results=results, logs=logs,
                            **PAPER_CADENCE)
  return (C.data_config_for('cvppp', dataset_folder), None,
          C.cvppp_box_config(), C.cvppp_full_config(), train_cfg, steps,
          batch)


def kitti_stages(scale, results='results', logs='logs', dataset_folder=None,
                 num_steps=None, data_examples=None, fg_steps=None,
                 box_steps=None, full_steps=None):
  """The configs of ``run_kitti`` (JAX ``run_pipeline.py:115-149``, ref
  run_kitti.sh), as ``synth3_stages`` returns them: the KITTI presets at
  128x448, T=20, fg at b8, box at b5 and full at b2, 40,000 fg, 60,000 box
  and 100,000 full steps at the paper scale and 100 at the tiny one."""
  del data_examples
  batch = {'fg': 8, 'box': 5, 'full': 2}
  steps = _steps(scale, {'fg': 40000, 'box': 60000, 'full': 100000},
                 num_steps, {'fg': fg_steps, 'box': box_steps,
                             'full': full_steps})
  train_cfg = C.TrainConfig(num_steps=steps['fg'], batch_size=batch['fg'],
                            save_ckpt=True, results=results, logs=logs,
                            **PAPER_CADENCE)
  return (C.data_config_for('kitti', dataset_folder), C.kitti_fg_config(),
          C.kitti_box_config(), C.kitti_full_config(), train_cfg, steps,
          batch)


# The chains of run_chain: {dataset: (its stages, the function of its
# stages' configs, whether its eval stage scores the fg model too, the
# full model's eval thresholds (None: the eval command line's own))}.
CVPPP_STAGES = ('box', 'full', 'eval')
CHAINS = {'synth3': (SYNTH3_STAGES, synth3_stages, True, EVAL_THRESHOLDS),
          'synthcs': (SYNTHCS_STAGES, synthcs_stages, True, EVAL_THRESHOLDS),
          'cvppp': (CVPPP_STAGES, cvppp_stages, False, None),
          'kitti': (SYNTH3_STAGES, kitti_stages, False, None)}


def _data_flags(args):
  """The data flags forwarded to the pack and eval command lines (they
  read the model's data_opt.yaml snapshot otherwise)."""
  return ((['--dataset_folder', args.dataset_folder]
           if args.dataset_folder else [])
          + (['--data_examples', str(args.data_examples)]
             if args.data_examples else []))


def _reuse_stages(args, stages, log):
  """--fg_from/--box_from reuse a trained stage: its train stage is
  dropped, so that a default --stages cannot train a fresh model into the
  reused folder."""
  for flag, stage in (('fg_from', 'fg'), ('box_from', 'box')):
    if getattr(args, flag) and stage in stages:
      log.warning(f'--{flag} given: skipping the {stage!r} train stage '
                  f'(reusing {getattr(args, flag)})')
      stages.discard(stage)
  return stages


def _restore_folder(args, model_id, data_cfg=None):
  """results/<id> where --resume was passed and a run exists there, else
  None (a fresh run).  A resumed run's data snapshot (data_opt.yaml) must
  match the data config, else the checkpoint would go on on another
  split: a mismatch raises."""
  folder = os.path.join(args.results, model_id)
  if not (args.resume and os.path.isdir(folder)):
    return None
  snap_path = os.path.join(folder, 'data_opt.yaml')
  if data_cfg is not None and os.path.exists(snap_path):
    snap = C.DataConfig.from_yaml(snap_path)
    for key in ('num_examples', 'height', 'width', 'timespan',
                'max_objects', 'num_semantic_classes'):
      cur, was = getattr(data_cfg, key), getattr(snap, key)
      if was != cur:
        raise ValueError(
            f'--resume {model_id}: DataConfig.{key}={cur} does not match '
            f'the run snapshot {snap_path} ({key}={was}); pass matching '
            'data flags to extend this run')
  return folder


def _skip_completed_prefix(args, stages, full_id, data_cfg, log, packs=True):
  """On a --resume relaunch with a full-stage checkpoint, skip fg, pack and
  box: the checkpoint exists only if they completed.  Where the chain
  packs (``packs``), only where both splits hold the fg model's maps for
  these settings (a checkout may keep the checkpoint and lose the ignored
  data folder: then the prefix runs again)."""
  if not args.resume:
    return stages
  full_folder = os.path.join(args.results, full_id)
  if not (os.path.isdir(full_folder) and saver.list_checkpoints(full_folder)):
    return stages
  if not packs or all(provider.has_pack(data_cfg, split)
                      for split in ('train', 'valid')):
    stages -= {'fg', 'pack', 'box'}
    log.info('--resume: full-stage ckpt + pack files present; skipping '
             'fg/pack/box')
  return stages


def _train(spec, cfg, train_cfg, data_cfg, device):
  exp = TrainingExperiment(spec, cfg, train_cfg, data_cfg, device=device)
  exp.run()
  exp.close()
  return exp


def run_synth(args, device=None):
  """Train the box and the full model and evaluate the full model on the
  valid split; returns the full model's id."""
  log = logger.get()
  model_id = assign_model_id()
  box_id = f'box_model_synth-{model_id}'
  full_id = f'full_model_synth-{model_id}'
  data_cfg, box_cfg, full_base, train_cfg, full_steps = synth_stages(
      args.scale, args.results, args.logs, args.dataset_folder,
      args.num_steps)

  train_cfg = train_cfg.replace(model_id=box_id)
  _train('box', box_cfg, train_cfg, data_cfg, device)
  weights = read_weights.box_main(
      ['--model_id', box_id, '--results', args.results], device=device)

  full_cfg = full_base.replace(pretrain_ctrl_net=weights)
  train_cfg = train_cfg.replace(model_id=full_id, num_steps=full_steps)
  _train('full', full_cfg, train_cfg, data_cfg, device)
  eval_cli.full_main(['--model_id', full_id, '--results', args.results,
                      '--dataset', 'synth', '--split', 'valid',
                      '--batch_size', str(train_cfg.batch_size)]
                     + (['--dataset_folder', args.dataset_folder]
                        if args.dataset_folder else []), device=device)
  log.info(f'Pipeline done: {full_id}')
  return full_id


def _snapshot_data_config(args, full_id, data_cfg):
  """The data config that the full model's run wrote (its data_opt.yaml),
  with --dataset_folder and --data_examples over it, else ``data_cfg``:
  the ground truth of the AP and pixel stages must come from the split the
  predictions were packed for (JAX ``run_pipeline.py:501-511``,
  ``:590-598``)."""
  folder = os.path.join(args.results, full_id)
  if not os.path.exists(os.path.join(folder, 'data_opt.yaml')):
    return data_cfg
  return A.make_data_config(args, restore=folder)


def _packed_split(data_cfg, split, full_maps=False):
  packed = provider.get('synth', data_cfg, split=split)
  if not isinstance(packed, PackedDataset) or (
      full_maps and packed.y_out_ins is None):
    raise FileNotFoundError(
        f'{provider.pack_path(data_cfg, split)} holds no '
        f'{"full" if full_maps else "fg"} model maps for these settings: '
        'run the pack stage first')
  return packed


def run_ap_stage(args, full_id, data_cfg, batch_size, split='valid',
                 device=None):
  """The official Cityscapes instance-level AP of a trained full model
  (JAX ``run_ap_stage``, ``run_pipeline.py:560-610``): its instance maps
  and scores packed into the split's pack file (``cli.pack.full_main``),
  the split read back, the model-free Cityscapes eval of the pack
  (``cs_output_<split>/sbd.csv``), and the AP of its submission against
  the split's instance-id images, written to
  ``results/<full_id>/output_<split>/ap.json``.  The submission's text and
  PNG files and the gtFine PNGs that the JAX stage writes through cv2 are
  not written (ROADMAP A.5).  Returns the averages."""
  pack_cli.full_main(['--model_id', full_id, '--results', args.results,
                      '--dataset', 'synth', '--split', split,
                      '--batch_size', str(batch_size)] + _data_flags(args),
                     device=device)
  packed = _packed_split(_snapshot_data_config(args, full_id, data_cfg),
                         split, full_maps=True)
  folder = os.path.join(args.results, full_id)
  _, rows = cityscapes_eval(
      packed, os.path.join(folder, f'cs_output_{split}'), [AP_THRESHOLD],
      ['sbd'], remove_tiny=args.ap_remove_tiny, batch_size=batch_size,
      device=device)
  ds = packed.dataset
  export = os.path.join(folder, f'output_{split}', 'ap.json')
  avg = instance_eval.evaluate_instance_predictions(
      rows[AP_THRESHOLD], ds.get_instance_id_images(ds.img_ids),
      export_file=export)
  logger.get().info(f"AP {avg['allAp']:.4f} AP_50% {avg['allAp50%']:.4f} "
                    f'-> {export}')
  return avg


def run_pixel_stage(args, full_id, data_cfg, split='valid', device=None):
  """The official Cityscapes pixel-level eval of the fg model's packed
  bytes (JAX ``run_pixel_stage``, ``run_pipeline.py:476-558``): each
  example's labels from its packed maps (``pixel_eval.prediction_labels``,
  made on ``device``) against its instance-id image
  (``groundtruth_labels``), written to
  ``results/<full_id>/output_<split>/pixel_eval.json``.  Returns the
  result."""
  packed = _packed_split(_snapshot_data_config(args, full_id, data_cfg),
                         split)
  labels = pixel_eval.prediction_labels(torch.from_numpy(packed.y_out).to(
      resolve_device(device))).cpu().numpy()
  ds = packed.dataset
  ev = pixel_eval.PixelEvaluator()
  for pred, ids in zip(labels, ds.get_instance_id_images(ds.img_ids)):
    gt_label, gt_inst = pixel_eval.groundtruth_labels(ids)
    ev.add_pair(pred, gt_label, instance_img=gt_inst)
  result = ev.finalize()
  export = os.path.join(args.results, full_id, f'output_{split}',
                        'pixel_eval.json')
  os.makedirs(os.path.dirname(export), exist_ok=True)
  with open(export, 'w') as f:
    json.dump(result, f, indent=2)
  logger.get().info(f'Pixel-level eval over {len(labels)} images: meanIoU '
                    f'{result["meanIoU"]:.4f} -> {export}')
  return result


def run_chain(args, dataset, device=None):
  """The stages of ``--stages`` of the chain of ``dataset`` (synth3,
  synthcs, cvppp or kitti; JAX ``run_synth3``, ``run_synth_cs``,
  ``run_cvppp``, ``run_kitti``); returns {'fg', 'box', 'full': the model
  ids, 'stages': the stages that ran, in order, and 'ap', 'pixel': those
  stages' results where they ran}."""
  log = logger.get()
  all_stages, stages_fn, fg_metrics, thresholds = CHAINS[dataset]
  stages = set((args.stages or ','.join(all_stages)).split(','))
  unknown = stages - set(all_stages)
  if unknown:
    raise ValueError(f'--stages: {sorted(unknown)} are not stages of the '
                     f'{dataset} pipeline {all_stages}')
  model_id = args.model_id or assign_model_id()
  fg_id = args.fg_from or f'fg_model_{dataset}-{model_id}'
  box_id = args.box_from or f'box_model_{dataset}-{model_id}'
  full_id = f'full_model_{dataset}-{model_id}'
  data_cfg, fg_cfg, box_cfg, full_base, train_cfg, steps, batch = stages_fn(
      args.scale, args.results, args.logs, args.dataset_folder,
      args.num_steps, args.data_examples, args.fg_steps, args.box_steps,
      args.full_steps)
  bs = {k: str(v) for k, v in batch.items()}
  # The provider's name of the chain's data: 'synth' for the synthetic
  # chains.
  data_flags = ['--dataset', data_cfg.dataset] + _data_flags(args)
  packs = 'pack' in all_stages

  def stage_cfg(stage, model_id):
    # _restore_folder (and its data snapshot check) only for the stages
    # that train: a reused stage is not held to the current data flags.
    return train_cfg.replace(model_id=model_id, num_steps=steps[stage],
                             batch_size=batch[stage],
                             restore=_restore_folder(args, model_id,
                                                     data_cfg))

  stages = _reuse_stages(args, stages, log)
  stages = _skip_completed_prefix(args, stages, full_id, data_cfg, log,
                                  packs)
  out = {'fg': fg_id, 'box': box_id, 'full': full_id}
  if 'fg' in stages:
    _train('fg', fg_cfg, stage_cfg('fg', fg_id), data_cfg, device)
  if 'pack' in stages:
    pack_cli.fg_main(['--model_id', fg_id, '--results', args.results,
                      '--split', 'train,valid', '--batch_size', bs['fg']]
                     + data_flags, device=device)
  if packs and ('box' in stages or 'full' in stages):
    missing = [s for s in ('train', 'valid')
               if not provider.has_pack(data_cfg, s)]
    if missing:
      raise FileNotFoundError(
          f'no pack of the fg model for these settings of the {missing} '
          f'split(s) at {provider.pack_location(data_cfg, missing[0])}: run '
          'the pack stage first')
  if 'box' in stages:
    _train('box', box_cfg, stage_cfg('box', box_id), data_cfg, device)
  if 'full' in stages:
    weights = read_weights.box_main(
        ['--model_id', box_id, '--results', args.results], device=device)
    _train('full', full_base.replace(pretrain_ctrl_net=weights),
           stage_cfg('full', full_id), data_cfg, device)
  if 'eval' in stages:
    if fg_metrics:
      eval_fg_metrics.main(['--model_id', fg_id, '--results', args.results,
                            '--batch_size', bs['fg']] + _data_flags(args),
                           device=device)
    eval_cli.full_main(['--model_id', full_id, '--results', args.results,
                        '--split', 'valid', '--batch_size', bs['full']]
                       + (['--threshold_list', thresholds] if thresholds
                          else []) + data_flags, device=device)
  if 'ap' in stages:
    out['ap'] = run_ap_stage(args, full_id, data_cfg, batch['full'],
                             device=device)
  if 'pixel' in stages:
    out['pixel'] = run_pixel_stage(args, full_id, data_cfg, device=device)
  log.info('Pipeline done: ' + ' -> '.join(
      out[s] for s in ('fg', 'box', 'full') if s in all_stages))
  out['stages'] = [s for s in all_stages if s in stages]
  return out


def main(argv=None, device=None):
  """``device``: the card unless it names another."""
  parser = argparse.ArgumentParser()
  parser.add_argument('--dataset', default='synth',
                      choices=['synth', 'synth3', 'synthcs', 'cvppp',
                               'kitti'],
                      help='the synthetic pipelines and those of CVPPP and '
                           'KITTI (assembled by cli.setup_dataset) are '
                           'ported (Cityscapes\'s waits: ROADMAP A.5)')
  parser.add_argument('--dataset_folder', default=None)
  parser.add_argument('--results', default='results')
  parser.add_argument('--logs', default='logs')
  parser.add_argument('--scale', default='paper', choices=['paper', 'tiny'])
  parser.add_argument('--num_steps', default=None, type=int,
                      help='steps per stage (default: the scale\'s own)')
  chain = parser.add_argument_group('synth3, synthcs, cvppp and kitti')
  chain.add_argument('--model_id', default=None,
                     help='reuse an id (go on with a chain)')
  chain.add_argument('--stages', default=None,
                     help='the stages to run (default: all of the '
                          'dataset\'s, ' + ', '.join(
                              f'{k}: {",".join(v)}'
                              for k, (v, *_) in CHAINS.items()) + ')')
  chain.add_argument('--fg_steps', default=None, type=int)
  chain.add_argument('--box_steps', default=None, type=int)
  chain.add_argument('--full_steps', default=None, type=int)
  chain.add_argument('--data_examples', default=None, type=int,
                     help='the train split\'s size (synth3 and synthcs '
                          'at the paper scale)')
  chain.add_argument('--fg_from', default=None,
                     help='reuse this trained fg model id')
  chain.add_argument('--box_from', default=None,
                     help='reuse this trained box model id (its last '
                          'checkpoint starts the full model)')
  chain.add_argument('--resume', action='store_true',
                     help='restore each trained stage from its '
                          'results/<id> checkpoint')
  chain.add_argument('--ap_remove_tiny', default=100, type=int,
                     help='the ap stage\'s least region size in pixels '
                          '(synthcs)')
  args = parser.parse_args(argv)
  if args.dataset in CHAINS:
    return run_chain(args, args.dataset, device=device)
  return run_synth(args, device=device)


if __name__ == '__main__':
  main(sys.argv[1:])
