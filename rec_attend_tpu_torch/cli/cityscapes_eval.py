"""The model-free Cityscapes eval at full resolution, over packed arrays.

Counterpart of ``eval_one`` of ``rec_attend_tpu/cli/cityscapes_eval.py:
48-103``.  No model runs: each image's packed instance maps, scores and fg
maps (``cli.pack.pack_full``) go through the chain on ``device``:

  fg maps resized to the labels' full size -> the foreground mask (one
  channel: over FG_THRESHOLD; several: background channel at most
  1 - FG_THRESHOLD) -> instance maps upsampled (bilinear, then the
  bilateral filter) -> weighted by their scores -> one label a pixel ->
  per mask threshold: binarised, masked to the foreground, cleared of
  regions of at most ``remove_tiny`` pixels (their scores zeroed, from the
  raw scores at each threshold) -> the analyzers and the Cityscapes
  submission (``analysis.cityscapes_submission``).

The JAX package reads the packed maps from the dataset's H5 file one image
at a time and writes the submission's files; here a batch of images goes
through at once, each on its own, and the submission's rows come back in
memory, for ``eval_cityscapes.instance_eval``.  The command line, the
external LRR foreground and the render analyzers wait.

    full = pack_full(EvalExperiment(full_folder), pack_fg(fg, ds, 32), 32)
    summary, rows = cityscapes_eval(full, out_folder, [0.6], ['sbd'],
                                    remove_tiny=100)
    ap = evaluate_instance_predictions(
        rows[0.6], ds.get_instance_id_images(ds.img_ids))
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from rec_attend_tpu_torch import analysis
from rec_attend_tpu_torch.device import resolve_device
from rec_attend_tpu_torch.device import synchronize
from rec_attend_tpu_torch.utils import postprocess as pp

FG_THRESHOLD = 0.3


def foreground_mask(fg):
  """[H, W] 0/1 foreground of a [H, W, C] fg map: one channel over
  FG_THRESHOLD, else the background channel at most 1 - FG_THRESHOLD."""
  if fg.shape[-1] == 1:
    return (fg[..., 0] > FG_THRESHOLD).float()
  return (fg[..., 0] <= (1 - FG_THRESHOLD)).float()


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
      command line's, and the synthcs pipeline's AP stage passes ['sbd']
      and 100.
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
  sweep = len(threshold_list) > 1
  analyzer_sets = []
  for thresh in threshold_list:
    stem = f'{{}}_{int(thresh * 100):02d}.csv' if sweep else '{}.csv'
    analyzer_sets.append([analysis.create_analyzer(
        name, display_name=f'{name} {thresh:.2f}',
        fname=os.path.join(output_folder, stem.format(name)))
                          for name in analyzer_names])
  rows = {thresh: [] for thresh in threshold_list}
  if timings is not None:
    for key in ('postprocess', 'analyzers', 'submission'):
      timings.setdefault(key, [])
  n = dataset.get_dataset_size()
  timespan = dataset.y_out_ins.shape[1]
  for lo in range(0, n, batch_size):
    t0 = time.perf_counter()
    batch = dataset.get_batch(np.arange(lo, min(lo + batch_size, n)),
                              timespan=timespan)
    ids = list(batch['idx_map'])
    y_gt_h = dataset.get_full_size_labels(ids, timespan=timespan)
    sizes = [tuple(g.shape[-2:]) for g in y_gt_h]
    if len(set(sizes)) != 1:
      raise ValueError(f'the images of a batch have full sizes {sizes}: '
                       'the chain takes one size a batch')
    fg = torch.as_tensor(batch['y_out']).to(dev)
    fg_h = [pp.resize(f.permute(2, 0, 1), s).permute(1, 2, 0)
            for f, s in zip(fg, sizes)]
    fg_mask = [foreground_mask(f) for f in fg_h]
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
    t1 = time.perf_counter()
    for (y_host, conf_host), analyzers in zip(staged, analyzer_sets):
      results = {
          'y_out': y_host, 'y_gt': y_gt_h, 's_out': conf_hard,
          'conf': conf_host, 'y_in': fg_host, 's_gt': batch['s_gt'],
          'iou_pairwise': [analysis.f_iou_pairwise(a, b)
                           for a, b in zip(y_host, y_gt_h)],
          'indices': ids,
      }
      for a in analyzers:
        a.stage(results)
    t2 = time.perf_counter()
    for thresh, (y_host, conf_host) in zip(threshold_list, staged):
      rows[thresh].extend(analysis.cityscapes_submission(
          y_host, fg_host, conf_host))
    if timings is not None:
      timings['postprocess'].append(t1 - t0)
      timings['analyzers'].append(t2 - t1)
      timings['submission'].append(time.perf_counter() - t2)

  summary = {}
  for thresh, analyzers in zip(threshold_list, analyzer_sets):
    summary[thresh] = {}
    for a in analyzers:
      r = a.finalize()
      if r is not None:
        summary[thresh][a.name] = r
  return summary, rows
