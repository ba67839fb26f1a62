"""Instance eval of the full model: the postprocess chain and the analyzers
over one dataset split.

Counterpart of ``eval_split`` and ``DEFAULT_ANALYZERS`` of
``rec_attend_tpu/cli/eval.py:24-129``: confidence (or the explicit score
gate) -> upsample to the labels' full size -> [morph] -> one-label ->
threshold sweep -> [foreground mask, remove-tiny] -> analyzers, each
threshold's analyzers writing their CSVs.  The chain runs on the tensors
where the forward left them, on the card or the CPU; the analyzers read
host arrays.  The command line, the foreground PNG reader and the render
analyzers of that module need cv2, h5py or YAML and are not ported.
"""

from __future__ import annotations

import glob
import os
import time

import torch

from rec_attend_tpu_torch import analysis
from rec_attend_tpu_torch.device import synchronize
from rec_attend_tpu_torch.utils import postprocess as pp

DEFAULT_ANALYZERS = ['sbd', 'wt_cov', 'unwt_cov', 'avg_fp', 'avg_fn',
                     'avg_pr', 'avg_re', 'obj_pr', 'obj_re', 'count_acc',
                     'count_mse', 'dic', 'dic_abs']


def _clear_stale_csvs(output_folder, analyzer_names):
  # The analyzers of a sweep write {name}_NN.csv: a run with another list
  # of thresholds must not leave older thresholds' files behind.
  for name in analyzer_names:
    for stale in ([os.path.join(output_folder, f'{name}.csv')]
                  + glob.glob(os.path.join(output_folder, f'{name}_*.csv'))):
      if os.path.exists(stale):
        os.remove(stale)


def _analyzer_sets(output_folder, threshold_list, analyzer_names):
  sets = []
  for tt in threshold_list:
    # One threshold writes {name}.csv, a sweep {name}_NN.csv.
    csv_stem = ('{}.csv' if len(threshold_list) == 1 else
                f'{{}}_{int(tt * 100):02d}.csv')
    sets.append([analysis.create_analyzer(
        name, display_name=f'{name} {tt:.2f}',
        fname=os.path.join(output_folder, csv_stem.format(name)))
                 for name in analyzer_names])
  return sets


def eval_split(exp, dataset, output_folder, threshold_list, analyzer_names,
               foreground=None, no_morph=False, remove_tiny=0, batch_size=8,
               score_threshold=None, max_batches=None, timings=None):
  """Run the instance eval chain over ``dataset`` with ``exp``, an
  ``engine.experiment.EvalExperiment``.

  Args:
    foreground: one [H, W] foreground map (array or tensor) per example of
      the dataset, in its index order; with it the masks are dilated
      (unless ``no_morph``), masked and cleared of regions of at most
      ``remove_tiny`` pixels.
    score_threshold: the explicit stop gate: slots scored at most this are
      zeroed; None keeps the reference's 0.5-hardened, score-weighted masks.
    max_batches: stop after this many batches.
    timings: a dict that gains, per batch, the host seconds of the forward,
      of the postprocess chain and of the analyzers ('forward',
      'postprocess', 'analyzers' lists), the device synchronised between.
  Returns:
    {threshold: {analyzer display name: (mean, std)}}.
  """
  os.makedirs(output_folder, exist_ok=True)
  _clear_stale_csvs(output_folder, analyzer_names)
  analyzer_sets = _analyzer_sets(output_folder, threshold_list,
                                 analyzer_names)
  if timings is not None:
    for key in ('forward', 'postprocess', 'analyzers'):
      timings.setdefault(key, [])
  batches = exp.iterate_split(dataset, batch_size)
  offset = 0
  n_batch = 0
  while max_batches is None or n_batch < max_batches:
    t0 = time.perf_counter()
    try:
      ds, raw, outputs = next(batches)
    except StopIteration:
      break
    n_batch += 1
    y_out, s_out = outputs['y_out'], outputs['s_out']
    synchronize(y_out.device)
    t1 = time.perf_counter()
    idx_map = raw['idx_map']
    y_gt_h = ds.get_full_size_labels(idx_map, timespan=y_out.shape[1])
    fg = None
    if foreground is not None:
      fg = [torch.as_tensor(foreground[offset + i], device=y_out.device,
                            dtype=torch.float32)
            for i in range(len(idx_map))]
    offset += len(idx_map)

    if score_threshold is not None:
      # The explicit stop gate: slots under the calibrated score are
      # zeroed, so the count does not hang on the mask threshold.
      y_out, s_out = pp.apply_confidence(y_out, s_out,
                                         threshold=score_threshold)
      y_out = y_out * s_out[:, :, None, None]
    else:
      y_out, s_out = pp.apply_confidence(y_out, s_out)
    y_out = pp.upsample(y_out, [g.shape[-2:] for g in y_gt_h])
    if fg is not None and not no_morph:
      y_out = pp.morph(y_out)
    y_out = pp.apply_one_label(y_out)
    staged = []
    for thresh in threshold_list:
      y_thresh = pp.apply_threshold(y_out, thresh)
      s_thresh = s_out
      if fg is not None:
        y_thresh = pp.mask_foreground(y_thresh, fg)
        y_thresh, s_thresh = pp.remove_tiny(y_thresh, s_thresh,
                                            threshold=remove_tiny)
      staged.append(([y.cpu().numpy() for y in y_thresh],
                     s_thresh.cpu().numpy()))
    t2 = time.perf_counter()
    for (y_host, s_host), analyzers in zip(staged, analyzer_sets):
      results = {
          'y_out': y_host, 'y_gt': y_gt_h, 's_out': s_host,
          's_gt': raw['s_gt'],
          'iou_pairwise': [analysis.f_iou_pairwise(a, b)
                           for a, b in zip(y_host, y_gt_h)],
          'indices': list(idx_map),
      }
      for a in analyzers:
        a.stage(results)
    if timings is not None:
      timings['forward'].append(t1 - t0)
      timings['postprocess'].append(t2 - t1)
      timings['analyzers'].append(time.perf_counter() - t2)

  summary = {}
  for thresh, analyzers in zip(threshold_list, analyzer_sets):
    summary[thresh] = {}
    for a in analyzers:
      r = a.finalize()
      if r is not None:
        summary[thresh][a.name] = r
  return summary
