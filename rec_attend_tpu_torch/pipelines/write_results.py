"""The eval folders' summaries that the count calibration reads.

Counterpart of ``pipelines/write_results.py:32-102``: the Mean/Std trailer
rows of the analyzers' CSVs (``analysis.StatsAnalyzer.finalize``), a
threshold sweep's per-threshold files (``{name}_NN.csv``, NN the integer
percent, as ``cli.eval.eval_split`` writes them) told apart from plain
ones, the sweep's best threshold, and the markdown lines of the
train-calibrated headline of a model's ``count_calibration.json``.  The
rest of that script, which writes RESULTS.md's sections, is not here.
"""

from __future__ import annotations

import glob
import json
import os
import re


def read_analyzer_csvs(folder):
  """{analyzer: (mean, std)} from the Mean/Std trailer rows."""
  out = {}
  for fname in sorted(glob.glob(os.path.join(folder, '*.csv'))):
    mean = std = None
    with open(fname) as f:
      for line in f:
        if line.startswith('Mean,'):
          mean = float(line.split(',')[1])
        elif line.startswith('Std,'):
          std = float(line.split(',')[1])
    if mean is not None:
      out[os.path.splitext(os.path.basename(fname))[0]] = (mean, std)
  return out


def split_sweep(metrics):
  """Split flat {name or name_NN: stats} into (plain, {thresh: {name:
  stats}}): ``sbd_40`` is threshold 0.40's sbd; a name whose stem ends in a
  digit, such as ``sbd2_40``, stays plain."""
  plain, sweep = {}, {}
  for key, stats in metrics.items():
    m = re.fullmatch(r'(.+)_(\d{2,3})', key)
    if m and not m.group(1)[-1].isdigit():
      sweep.setdefault(int(m.group(2)) / 100.0, {})[m.group(1)] = stats
    else:
      plain[key] = stats
  return plain, sweep


def best_threshold(sweep, by='sbd'):
  """The threshold with the highest mean of ``by``; a tie goes to the
  lower threshold."""
  return max(sorted(sweep), key=lambda t: sweep[t].get(by, (-1, 0))[0])


def headline_block(full_folder):
  """Markdown lines of the train-calibrated headline of the model in
  ``full_folder`` (its ``count_calibration.json``'s 'headline': the valid
  split at the mask threshold and stop score both picked on the train
  split), or [] where it has none."""
  path = os.path.join(full_folder, 'count_calibration.json')
  if not os.path.exists(path):
    return []
  with open(path) as f:
    cal = json.load(f)
  head = cal.get('headline')
  if not head:
    return []
  lines = []
  w = lines.append
  w('### Headline (train-calibrated thresholds — no valid-set selection)')
  w('')
  w(f'Mask threshold {head["mask_threshold"]:.2f} and stop score '
    f'{head["score_threshold"]:.2f} were both picked on the TRAIN split '
    '(`pipelines/calibrate_count.py`); this row is the valid split at '
    'those fixed knobs. The sweep table below is diagnostics only.')
  w('')
  w('| Metric | Mean | Std |')
  w('|---|---|---|')
  order = ['sbd', 'wt_cov', 'unwt_cov', 'count_acc', 'count_mse', 'dic',
           'dic_abs']
  m = head['metrics']
  for name in list(dict.fromkeys(order + sorted(m))):
    if name in m:
      w(f'| {name} | {m[name][0]:.4f} | {m[name][1]:.4f} |')
  w('')
  return lines
