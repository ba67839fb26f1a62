"""Side-by-side comparison table of evaluated runs.

Counterpart of ``pipelines/compare_runs.py``.  For each model id it reads
the train-calibrated headline (``count_calibration.json``, from
``pipelines.calibrate_count``), the best-of-sweep row of the analyzers'
CSVs in ``output_valid/`` and the last point of the loss curve, and writes
a markdown table to stdout and, with ``--notes``, appends it to a
``notes.md`` (the run's commentary that ``write_results`` copies into
RESULTS.md).

    python -m rec_attend_tpu_torch.pipelines.compare_runs \\
        --ids full_model_synth1024-20260816,full_model_synth1024bf16-r5 \\
        --labels f32,bf16 [--notes results/<id>/notes.md --title "..."]
"""

from __future__ import annotations

import argparse
import json
import os

from rec_attend_tpu_torch.pipelines.write_results import (
    best_threshold, read_analyzer_csvs, read_loss_curve, split_sweep)

METRICS = ('sbd', 'count_acc', 'dic_abs', 'count_mse', 'wt_cov',
           'unwt_cov')


def collect(results, logs, model_id):
  """One run's row: {'id', 'sweep' (best-of-sweep, or the plain eval's,
  means), 'sweep_best_thr', 'headline', 'headline_thr', 'final_loss',
  'final_step'}, each present where the run's files have it."""
  folder = os.path.join(results, model_id)
  row = {'id': model_id}
  metrics, sweep = split_sweep(read_analyzer_csvs(
      os.path.join(folder, 'output_valid')))
  if sweep:
    bt = best_threshold(sweep)
    row['sweep_best_thr'] = bt
    row['sweep'] = {k: sweep[bt][k][0] for k in METRICS if k in sweep[bt]}
  elif metrics:
    row['sweep'] = {k: metrics[k][0] for k in METRICS if k in metrics}
  cal = os.path.join(folder, 'count_calibration.json')
  if os.path.exists(cal):
    with open(cal) as f:
      head = json.load(f).get('headline')
    if head:
      row['headline_thr'] = (head['mask_threshold'],
                             head['score_threshold'])
      row['headline'] = {k: head['metrics'][k][0]
                         for k in METRICS if k in head['metrics']}
  loss = read_loss_curve(os.path.join(logs, model_id, 'loss.csv'))
  if loss:
    row['final_loss'] = loss[-1][1]
    row['final_step'] = loss[-1][0]
  return row


def render(rows, labels, title):
  """The markdown table of ``rows`` under the heading ``title``."""
  lines = [f'### {title}', '']
  hdr = ['metric'] + list(labels)
  lines.append('| ' + ' | '.join(hdr) + ' |')
  lines.append('|' + '---|' * len(hdr))

  def fmt(row, key, metric):
    d = row.get(key)
    if not d or metric not in d:
      return '—'
    return f'{d[metric]:.4f}'

  # A headline row only where some run was calibrated: a table of runs
  # that were not would show rows of dashes.
  for metric in METRICS:
    if any(r.get('headline') and metric in r['headline'] for r in rows):
      lines.append(f'| {metric} (headline) | '
                   + ' | '.join(fmt(r, 'headline', metric) for r in rows)
                   + ' |')
  for metric in ('sbd', 'count_acc', 'dic_abs'):
    lines.append(f'| {metric} (best-of-sweep) | '
                 + ' | '.join(fmt(r, 'sweep', metric) for r in rows)
                 + ' |')
  tail = []
  for r in rows:
    t = []
    if 'final_loss' in r:
      t.append(f'loss {r["final_loss"]:.3f}@{r["final_step"]}')
    if 'headline_thr' in r:
      t.append(f'thr {r["headline_thr"][0]:.2f}/{r["headline_thr"][1]:.2f}')
    tail.append('; '.join(t) or '—')
  lines.append('| provenance | ' + ' | '.join(tail) + ' |')
  lines.append('')
  return '\n'.join(lines)


def main(argv=None):
  """Print the table of ``--ids`` (and append it to ``--notes``); returns
  the rows."""
  p = argparse.ArgumentParser()
  p.add_argument('--ids', required=True)
  p.add_argument('--labels', default=None)
  p.add_argument('--results', default='results')
  p.add_argument('--logs', default='logs')
  p.add_argument('--title', default='Run comparison')
  p.add_argument('--notes', default=None,
                 help='append the table to this notes.md')
  args = p.parse_args(argv)
  ids = args.ids.split(',')
  labels = args.labels.split(',') if args.labels else ids
  rows = [collect(args.results, args.logs, i) for i in ids]
  text = render(rows, labels, args.title)
  print(text)
  if args.notes:
    os.makedirs(os.path.dirname(args.notes), exist_ok=True)
    with open(args.notes, 'a') as f:
      f.write('\n' + text)
  return rows


if __name__ == '__main__':
  main()
