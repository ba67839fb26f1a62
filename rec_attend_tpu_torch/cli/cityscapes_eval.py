"""The model-free Cityscapes eval at full resolution: the command line, and
the chain over packed arrays under it.

Counterpart of ``rec_attend_tpu/cli/cityscapes_eval.py``.  No model runs:
each image's packed instance maps, scores and fg maps (``cli.pack``) go
through the chain on ``device``:

  fg maps resized to the labels' full size -> the foreground mask (one
  channel: over FG_THRESHOLD; several: background channel at most
  1 - FG_THRESHOLD) -> instance maps upsampled (bilinear, then the
  bilateral filter) -> weighted by their scores -> one label a pixel ->
  per mask threshold: binarised, masked to the foreground, cleared of
  regions of at most ``remove_tiny`` pixels (their scores zeroed, from the
  raw scores at each threshold) -> the analyzers.

With ``--lrr_seg`` the semantic maps and the foreground come from an
external LRR segmentation instead, one ``{lrr_folder}/{train|val|test}/
{run}/{id}_ss.mat`` an image (``read_foreground_lrr``).  The JAX package
reads one image at a time; here a batch of images goes through at once
(``--batch_size``, 1 by default), each on its own.

``main``, the command line, evaluates each split of ``--split`` from the
split's H5 file (or, for the synthetic chain, its pack file), with the
data config of the model's ``data_opt.yaml`` where ``--model_id`` names a
folder, into ``--output`` or ``{results}/{model_id}/output_{split}``:
the analyzers' ``{name}.csv`` (``{name}_NN.csv`` for a sweep of
thresholds), and per threshold NN the instance renders and ``count.csv``
under ``NN/`` and the Cityscapes submission under ``cityscapes/``
(``cityscapes/NN/`` for a sweep), the layout of the JAX command line;
``--render_gt`` also renders the ground truth under ``gt/``;
``--split_id``/``--num_split`` evaluate one shard of the split.

    python -m rec_attend_tpu_torch.cli.cityscapes_eval --model_id <full id> \\
        --dataset cityscapes --split valid,test

``cityscapes_eval`` is the chain with the analyzers alone, the submission's
rows kept in memory (``analysis.cityscapes_submission``):

    full = pack_full(EvalExperiment(full_folder), pack_fg(fg, ds, 32), 32)
    summary, rows = cityscapes_eval(full, out_folder, [0.6], ['sbd'],
                                    remove_tiny=100)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from rec_attend_tpu_torch import analysis
from rec_attend_tpu_torch.cli import args as A
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.data.provider import PackedDataset
from rec_attend_tpu_torch.device import resolve_device
from rec_attend_tpu_torch.device import synchronize
from rec_attend_tpu_torch.utils import logger
from rec_attend_tpu_torch.utils import postprocess as pp

FG_THRESHOLD = 0.3
# The LRR segmentation's ids of the 8 instance classes, person ... bicycle.
LRR_SEM_IDS = [12, 13, 14, 15, 16, 17, 18, 19]


def foreground_mask(fg):
  """[H, W] 0/1 foreground of a [H, W, C] fg map: one channel over
  FG_THRESHOLD, else the background channel at most 1 - FG_THRESHOLD."""
  if fg.shape[-1] == 1:
    return (fg[..., 0] > FG_THRESHOLD).float()
  return (fg[..., 0] <= (1 - FG_THRESHOLD)).float()


def read_foreground_lrr(lrr_folder, split, idx):
  """The [H, W, 9] float32 one-hot semantic maps of an external LRR
  segmentation: ``{lrr_folder}/{train|val|test}/{run}/{idx}_ss.mat``'s
  'semanticPrediction', channel c + 1 where it holds LRR_SEM_IDS[c],
  channel 0 the rest."""
  import scipy.io
  folder = ('train' if split.startswith('train') else
            'val' if split.startswith('val') else 'test')
  runname = idx.split('_')[0]
  matfn = os.path.join(lrr_folder, folder, runname, f'{idx}_ss.mat')
  fgraw = scipy.io.loadmat(matfn)['semanticPrediction']
  fg = np.zeros(list(fgraw.shape) + [9], dtype='float32')
  for ii in range(8):
    fg[:, :, ii + 1] = (fgraw == LRR_SEM_IDS[ii]).astype('float32')
  fg[:, :, 0] = 1 - fg.max(axis=-1)
  return fg


def _full_size_labels(dataset, ids, positions, timespan):
  """Each image's [T, H, W] labels at full size: a pack's as its dataset
  gives them; an H5 split's as its batch of one gives them ('y_gt_full',
  the largest ``timespan`` instances, largest first), as JAX reads them."""
  if isinstance(dataset, PackedDataset):
    return dataset.get_full_size_labels(ids, timespan=timespan)
  return [dataset.get_batch([p], timespan=timespan,
                            variables={'y_gt_full'})['y_gt_full']
          for p in positions]


def _chain(dataset, positions, threshold_list, remove_tiny, batch_size, dev,
           timespan, lrr=None, timings=None):
  """Yield, per batch of ``positions``, (ids, full-size labels, fg maps,
  hard scores, s_gt, [(masks, scores) per threshold]) on the host.
  ``lrr``: (folder, split) to read the semantic maps from LRR files.
  ``timings['postprocess']`` gains each batch's host seconds."""
  # A pack's dataset may take no ``variables``; an H5 split decodes only
  # those asked for.
  kw = ({} if isinstance(dataset, PackedDataset) else
        {'variables': {'y_out', 'y_out_ins', 's_out', 's_gt', 'idx_map'}})
  for lo in range(0, len(positions), batch_size):
    t0 = time.perf_counter()
    pos = np.asarray(positions[lo:lo + batch_size])
    batch = dataset.get_batch(pos, timespan=timespan, **kw)
    ids = list(batch['idx_map'])
    y_gt_h = _full_size_labels(dataset, ids, pos, timespan)
    sizes = [tuple(g.shape[-2:]) for g in y_gt_h]
    if len(set(sizes)) != 1:
      raise ValueError(f'the images of a batch have full sizes {sizes}: '
                       'the chain takes one size a batch')
    if lrr is None:
      fg = torch.as_tensor(batch['y_out']).to(dev)
      fg_h = [pp.resize(f.permute(2, 0, 1), s).permute(1, 2, 0)
              for f, s in zip(fg, sizes)]
      fg_mask = [foreground_mask(f) for f in fg_h]
    else:
      fg_h = [torch.as_tensor(read_foreground_lrr(*lrr, i)).to(dev)
              for i in ids]
      fg_mask = [1 - f[..., 0] for f in fg_h]
    conf = torch.as_tensor(batch['s_out']).to(dev)
    y = pp.upsample(torch.as_tensor(batch['y_out_ins']).to(dev), sizes)
    y, conf_hard = pp.apply_confidence(y, conf)
    y = pp.apply_one_label(y)
    staged = []
    for thresh in threshold_list:
      y_t = pp.mask_foreground(pp.apply_threshold(y, thresh), fg_mask)
      y_t, conf_t = pp.remove_tiny(y_t, conf, threshold=remove_tiny)
      staged.append(([m.cpu().numpy() for m in y_t], conf_t.cpu().numpy()))
    fg_host = [f.cpu().numpy() for f in fg_h]
    conf_hard = conf_hard.cpu().numpy()
    synchronize(dev)
    if timings is not None:
      timings.setdefault('postprocess', []).append(time.perf_counter() - t0)
    yield ids, y_gt_h, fg_host, conf_hard, batch['s_gt'], staged


def _results(ids, y_gt_h, fg_host, conf_hard, s_gt, y_host, conf_host,
             iou=True):
  """The results dict that the analyzers read."""
  out = {'y_out': y_host, 'y_gt': y_gt_h, 's_out': conf_hard,
         'conf': conf_host, 'y_in': fg_host, 's_gt': s_gt, 'indices': ids}
  if iou:
    out['iou_pairwise'] = [analysis.f_iou_pairwise(a, b)
                           for a, b in zip(y_host, y_gt_h)]
  return out


def cityscapes_eval(dataset, output_folder, threshold_list=(0.6,),
                    analyzer_names=('sbd', 'wt_cov', 'unwt_cov'),
                    remove_tiny=1200, batch_size=8, device=None,
                    timings=None):
  """Run the chain over ``dataset`` in index order.

  Args:
    dataset: a ``cli.pack.PackedDataset`` with the full model's maps (read
      at its timespan, the packed slots), its images' labels all of one
      full size a batch.
    output_folder: where the analyzers write their CSVs ({name}.csv for
      one threshold, {name}_NN.csv for a sweep).
    threshold_list, analyzer_names, remove_tiny: the mask thresholds,
      the analyzers and the region size removed; the defaults are the JAX
      command line's.
    device: where the chain runs, ``cuda`` unless the caller asks for the
      CPU.
    timings: a dict that gains, per batch, the host seconds of the chain
      ('postprocess', the device synchronised after), of the analyzers and
      of the submission's rows.
  Returns:
    ({threshold: {analyzer display name: (mean, std)}},
     {threshold: the submission's rows of each image, in index order}).
  """
  dev = resolve_device(device)
  os.makedirs(output_folder, exist_ok=True)
  analyzer_sets = [_analyzers(analyzer_names, thresh, output_folder,
                              len(threshold_list) > 1)
                   for thresh in threshold_list]
  rows = {thresh: [] for thresh in threshold_list}
  if timings is not None:
    for key in ('postprocess', 'analyzers', 'submission'):
      timings.setdefault(key, [])
  n = dataset.get_dataset_size()
  for ids, y_gt_h, fg_host, conf_hard, s_gt, staged in _chain(
      dataset, np.arange(n), threshold_list, remove_tiny, batch_size, dev,
      dataset.y_out_ins.shape[1], timings=timings):
    t1 = time.perf_counter()
    for (y_host, conf_host), analyzers in zip(staged, analyzer_sets):
      results = _results(ids, y_gt_h, fg_host, conf_hard, s_gt, y_host,
                         conf_host)
      for a in analyzers:
        a.stage(results)
    t2 = time.perf_counter()
    for thresh, (y_host, conf_host) in zip(threshold_list, staged):
      rows[thresh].extend(analysis.cityscapes_submission(
          y_host, fg_host, conf_host))
    if timings is not None:
      timings['analyzers'].append(t2 - t1)
      timings['submission'].append(time.perf_counter() - t2)
  return _finalize(threshold_list, analyzer_sets), rows


def _analyzers(names, thresh, folder, sweep):
  """The metric analyzers of one threshold: ``{name}.csv``, or
  ``{name}_NN.csv`` in a sweep."""
  stem = f'{{}}_{int(thresh * 100):02d}.csv' if sweep else '{}.csv'
  return [analysis.create_analyzer(
      name, display_name=f'{name} {thresh:.2f}',
      fname=os.path.join(folder, stem.format(name))) for name in names]


def _finalize(threshold_list, analyzer_sets):
  summary = {}
  for thresh, analyzers in zip(threshold_list, analyzer_sets):
    summary[thresh] = {}
    for a in analyzers:
      r = a.finalize()
      if r is not None:
        summary[thresh][a.name] = r
  return summary


def main(argv=None, device=None, timings=None):
  """The command line (JAX ``cli/cityscapes_eval.py:106-185``).  Returns
  {split: ({threshold: {analyzer: (mean, std)}}, the output folder)}.
  ``device``: the card unless it names another.  ``timings``: a dict that
  gains, per batch, the host seconds of the chain ('postprocess'), of the
  metric analyzers ('analyzers'), of the instance renders and counts
  ('renders') and of the submission ('submission')."""
  parser = argparse.ArgumentParser(
      description='Cityscapes full-resolution eval (model-free)')
  A.add_eval_args(parser)
  A.add_data_args(parser)
  parser.set_defaults(batch_size=1)
  parser.add_argument('--threshold_list', default='0.6')
  parser.add_argument('--analyzers', default='sbd,wt_cov,unwt_cov')
  parser.add_argument('--remove_tiny', default=1200, type=int)
  parser.add_argument('--lrr_seg', action='store_true')
  parser.add_argument('--lrr_folder', default=None)
  parser.add_argument('--no_iou', action='store_true')
  parser.add_argument('--render_gt', action='store_true')
  parser.add_argument('--render_cityscapes', action='store_true',
                      default=True)
  parser.add_argument('--split_id', default=0, type=int)
  parser.add_argument('--num_split', default=1, type=int)
  args = parser.parse_args(argv)
  log = logger.get()
  dev = resolve_device(device)

  # The packed predictions live in the split the model was trained on:
  # its data_opt.yaml snapshot, where --model_id names a folder.
  restore = (os.path.join(args.results, args.model_id)
             if args.model_id else None)
  if restore is not None and not os.path.isdir(restore):
    restore = None
  data_cfg = A.make_data_config(args, restore=restore)
  threshold_list = [float(t) for t in args.threshold_list.split(',')]
  analyzer_names = args.analyzers.split(',') if args.analyzers else []
  sweep = len(threshold_list) > 1
  if timings is not None:
    for key in ('postprocess', 'analyzers', 'renders', 'submission'):
      timings.setdefault(key, [])

  out = {}
  for split in args.split.split(','):
    ds = provider.get(data_cfg.dataset, data_cfg, split=split)
    output_folder = (args.output or os.path.join(
        args.results, args.model_id or 'cityscapes_eval',
        f'output_{split}'))
    os.makedirs(output_folder, exist_ok=True)
    metric_sets, render_sets, submissions = [], [], []
    for thresh in threshold_list:
      nn = f'{int(thresh * 100):02d}'
      metric_sets.append(_analyzers(analyzer_names, thresh, output_folder,
                                    sweep))
      render_sets.append([
          analysis.RenderInstanceAnalyzer(
              os.path.join(output_folder, nn), ds),
          analysis.CountAnalyzer(
              os.path.join(output_folder, nn, 'count.csv'))])
      submissions.append(analysis.RenderCityScapesOutputAnalyzer(
          os.path.join(output_folder, 'cityscapes', *([nn] if sweep else [])),
          ds) if args.render_cityscapes else None)
    gt_render = (analysis.RenderGroundtruthInstanceAnalyzer(
        os.path.join(output_folder, 'gt'), ds) if args.render_gt else None)

    # One shard of the split (ref cityscapes_eval.py:39-44, 265-266).
    n = ds.get_dataset_size()
    per = int(np.ceil(n / args.num_split))
    start = args.split_id * per
    positions = np.arange(start, min(start + per, n))
    lrr = (args.lrr_folder, split) if args.lrr_seg else None
    for ids, y_gt_h, fg_host, conf_hard, s_gt, staged in _chain(
        ds, positions, threshold_list, args.remove_tiny, args.batch_size,
        dev, data_cfg.timespan, lrr=lrr, timings=timings):
      spent = dict.fromkeys(('analyzers', 'renders', 'submission'), 0.0)
      for tt, (y_host, conf_host) in enumerate(staged):
        results = _results(ids, y_gt_h, fg_host, conf_hard, s_gt, y_host,
                           conf_host, iou=not args.no_iou)
        stages = [('analyzers', metric_sets[tt]), ('renders', render_sets[tt]),
                  ('submission', [submissions[tt]] if submissions[tt] else [])]
        if gt_render is not None and tt == len(staged) - 1:
          stages.append(('renders', [gt_render]))
        for key, analyzers in stages:
          t0 = time.perf_counter()
          for a in analyzers:
            a.stage(results)
          spent[key] += time.perf_counter() - t0
      if timings is not None:
        for key, v in spent.items():
          timings[key].append(v)
    summary = _finalize(threshold_list, metric_sets)
    log.info(f'Cityscapes eval of {len(positions)} {split} images -> '
             f'{output_folder}')
    out[split] = (summary, output_folder)
  return out


if __name__ == '__main__':
  main(sys.argv[1:])
