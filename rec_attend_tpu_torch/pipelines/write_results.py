"""Collect a trained pipeline's evidence into RESULTS.md.

Counterpart of ``pipelines/write_results.py``: the Mean/Std trailer rows
of the analyzers' CSVs (``analysis.StatsAnalyzer.finalize``), a threshold
sweep's per-threshold files (``{name}_NN.csv``, NN the integer percent, as
``cli.eval.eval_split`` writes them) told apart from plain ones, the
sweep's best threshold, the train-calibrated headline of a model's
``count_calibration.json``, the loss curves (``logs/<id>/loss.csv``) and
the checkpoints' provenance (``results/<id>/model_opt.yaml``), written as
RESULTS.md's CVPPP head or, with ``--section synth3|synthcs``, as a
three-stage pipeline's section, replaced in place.  A model folder's
``notes.md`` is copied into its part at every regeneration.

    python -m rec_attend_tpu_torch.pipelines.write_results \
        --full_id full_model_synth-XXXX [--box_id box_model_synth-XXXX] \
        [--split valid] [--out RESULTS.md]
    python -m rec_attend_tpu_torch.pipelines.write_results --section synth3 \
        --fg_id fg_model_synth3-X --box_id box_model_synth3-X \
        --full_id full_model_synth3-X

The text is the JAX script's but for three lines: the head names no
accelerator (a run's folder does not say where it was trained), and the
commands it gives for regeneration are this package's modules.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

from rec_attend_tpu_torch.utils import opt_yaml

PAPER_TARGETS = {
    # CVPR-2017 paper numbers on *real* CVPPP A1 test (BASELINE.md).
    'sbd': ('CVPPP A1 SBD', 0.849),
    'dic_abs': ('CVPPP A1 |DiC|', 0.8),
}


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


def read_loss_curve(csv_path, field=2):
  """(step, value) rows of one column of a logged curve; skips empty
  cells (multi-channel CSVs leave the other channel blank on alternating
  cadences); [] where the file is missing."""
  rows = []
  if not os.path.exists(csv_path):
    return rows
  with open(csv_path) as f:
    next(f, None)
    for line in f:
      parts = line.strip().split(',')
      if len(parts) > field and parts[0].isdigit() and parts[field]:
        try:
          rows.append((int(parts[0]), float(parts[field])))
        except ValueError:
          pass
  return rows


def latest_ckpt_step(folder):
  """The step of the folder's latest ``ckpt-N.npz``, or None."""
  steps = []
  for f in glob.glob(os.path.join(folder, 'ckpt-*.npz')):
    try:
      steps.append(int(os.path.basename(f).split('-')[1].split('.')[0]))
    except ValueError:
      pass
  return max(steps) if steps else None


RUN_PIPELINE = 'python -m rec_attend_tpu_torch.pipelines.run_pipeline'
SECTION_FLAVORS = {
    # title / blurb / regen command per three-stage section flavor.
    'synth3': (
        'Three-stage pipeline at KITTI shape (fg → pack → box → full)',
        ["The reference's `run_kitti.sh` workflow executed END-TO-END: an "
         'FCN',
         'foreground+orientation model is trained, its predictions are '
         'packed',
         'into the H5 (`foreground_pred`/`orientation_pred`), and the box '
         'and',
         'full models are *trained through* the packed `d_in`/`y_in` '
         'channels',
         '(`add_d_out`/`add_y_out`, kitti presets: 128×448, T=20, '
         'dynamic_var).',
         'Dataset: built-in synth at KITTI shape, up to 12 objects/image.'],
        f'{RUN_PIPELINE} --dataset synth3 --scale paper'),
    'synthcs': (
        'Three-stage pipeline at Cityscapes shape (multiclass fg → pack → '
        'box → full)',
        ["The reference's `run_cityscapes.sh` stage wiring executed "
         'END-TO-END',
         'with the cityscapes presets (256×512, T=20) on multiclass synth',
         'data (2 shape-family instance classes + background): multiclass',
         'softmax fg head, multiclass box score head (1−s₀ conf loss), and',
         'the semantic `y_in` channels packed through real training.'],
        f'{RUN_PIPELINE} --dataset synthcs --scale paper'),
}

SECTION_MARKER = '## Three-stage pipeline at '
METRIC_ORDER = ['sbd', 'wt_cov', 'unwt_cov', 'avg_fp', 'avg_fn', 'count_acc',
                'count_mse', 'dic', 'dic_abs', 'avg_pr', 'avg_re', 'obj_pr',
                'obj_re']


def _read_json(path):
  with open(path) as f:
    return json.load(f)


def _notes(full_folder):
  """The lines of the folder's ``notes.md`` (the run's commentary that
  survives regeneration), or []."""
  path = os.path.join(full_folder, 'notes.md')
  if not os.path.exists(path):
    return []
  with open(path) as f:
    return [f.read().rstrip(), '']


def three_stage_section(args):
  """Markdown section of a three-stage pipeline run (fg -> pack -> box ->
  full), ``args`` as ``main`` parses them."""
  title, blurb, regen = SECTION_FLAVORS[args.section]
  full_folder = os.path.join(args.results, args.full_id)
  out_folder = os.path.join(full_folder, f'output_{args.split}')
  metrics, sweep = split_sweep(read_analyzer_csvs(out_folder))
  thresh_note = 'threshold 0.3'
  if sweep:
    bt = best_threshold(sweep)
    metrics = sweep[bt]
    thresh_note = f'best threshold {bt:.2f} of a sweep'
  fg_folder = os.path.join(args.results, args.fg_id)
  fg_json = os.path.join(fg_folder, f'fg_metrics_{args.split}.json')
  fg_metrics = _read_json(fg_json) if os.path.exists(fg_json) else {}
  data_opt = opt_yaml.read(os.path.join(full_folder, 'data_opt.yaml'))
  model_opt = opt_yaml.read(os.path.join(full_folder, 'model_opt.yaml'))
  box_loss = read_loss_curve(os.path.join(args.logs, args.box_id,
                                          'loss.csv'))
  full_loss = read_loss_curve(os.path.join(args.logs, args.full_id,
                                           'loss.csv'))
  fg_loss = read_loss_curve(os.path.join(args.logs, args.fg_id, 'loss.csv'))

  lines = []
  w = lines.append
  w(f'## {title}')
  w('')
  lines.extend(blurb)
  w('')
  w('### Provenance')
  w('')
  w(f'- fg model: `{args.fg_id}` — '
    f'step {latest_ckpt_step(fg_folder)}, FCN (foreground + orientation '
    'heads)')
  w(f'- box model: `{args.box_id}` — '
    f'step {latest_ckpt_step(os.path.join(args.results, args.box_id))}, '
    'packed-channel inputs')
  w(f'- full model: `{args.full_id}` — '
    f'step {latest_ckpt_step(full_folder)}, ctrl net from box weights.h5, '
    'packed channels into both nets')
  w(f'- dataset: {data_opt}')
  w(f'- key opts: add_d_out={model_opt.get("add_d_out")}, '
    f'add_y_out={model_opt.get("add_y_out")}, '
    f'dynamic_var={model_opt.get("dynamic_var")}, '
    f'timespan={model_opt.get("timespan")}')
  w('')
  w('### Stage metrics')
  w('')
  if fg_loss:
    w(f'- fg loss: {fg_loss[0][1]:.4f} → {fg_loss[-1][1]:.4f} '
      f'(step {fg_loss[-1][0]})')
  if fg_metrics:
    w(f'- fg held-out ({args.split}): IoU soft {fg_metrics.get("iou_soft")}'
      f', IoU hard {fg_metrics.get("iou_hard")}, orientation acc '
      f'{fg_metrics.get("orientation_acc")}')
  if box_loss:
    w(f'- box loss: {box_loss[0][1]:.4f} → {box_loss[-1][1]:.4f} '
      f'(step {box_loss[-1][0]})')
  if full_loss:
    w(f'- full loss: {full_loss[0][1]:.4f} → {full_loss[-1][1]:.4f} '
      f'(step {full_loss[-1][0]})')
  w('')
  lines.extend(headline_block(full_folder))
  w(f'### Instance eval ({args.split} split, packed-channel model, '
    f'{thresh_note})')
  w('')
  w('| Metric | Mean | Std |')
  w('|---|---|---|')
  for name in list(dict.fromkeys(METRIC_ORDER + sorted(metrics))):
    if name in metrics:
      mean, std = metrics[name]
      w(f'| {name} | {mean:.4f} | {std:.4f} |')
  w('')
  if sweep:
    w('| Threshold | SBD | count_acc | \\|DiC\\| |')
    w('|---|---|---|---|')
    for t in sorted(sweep):
      row = sweep[t]
      cells = [f'{row[k][0]:.4f}' if k in row else '—'
               for k in ('sbd', 'count_acc', 'dic_abs')]
      mark = ' ←' if t == bt else ''
      w(f'| {t:.2f}{mark} | ' + ' | '.join(cells) + ' |')
    w('')
  ap_json = os.path.join(out_folder, 'ap.json')
  if os.path.exists(ap_json):
    ap = _read_json(ap_json)['averages']
    w('### Official Cityscapes instance-level AP (end-to-end)')
    w('')
    w('Full pack → model-free full-resolution eval → submission writer '
      '(mask')
    w('PNGs + txt) → synthetic `gtFine` instanceIds → instance-level AP')
    w('(`eval_cityscapes/instance_eval.py`, differentially tested against '
      'the')
    w("official script — ref run_cityscapes_eval.sh:27-55).  Paper context "
      'on')
    w('real Cityscapes test: AP 0.095 / AP_50% 0.189.')
    w('')
    w('| Metric | Value |')
    w('|---|---|')
    w(f"| AP | {ap['allAp']:.4f} |")
    w(f"| AP_50% | {ap['allAp50%']:.4f} |")
    for cname, d in ap.get('classes', {}).items():
      if d['ap'] == d['ap']:   # skip NaN classes (no gt and no pred)
        w(f"| {cname} ap / ap50% | {d['ap']:.4f} / {d['ap50%']:.4f} |")
    w('')
    w(f'Export: `{ap_json}`.  Regenerate: `{regen} --stages ap`.')
    w('')
  px_json = os.path.join(out_folder, 'pixel_eval.json')
  if os.path.exists(px_json):
    px = _read_json(px_json)
    w('### Official Cityscapes pixel-level semantic eval (end-to-end)')
    w('')
    w('Packed multiclass fg output → labelId argmax → confusion-matrix')
    w('kernel → class/category IoU and instance-weighted iIoU')
    w('(`eval_cityscapes/pixel_eval.py`, differentially tested to 1e-6')
    w('against the official `evalPixelLevelSemanticLabeling.py`,')
    w('`tests/test_pixel_differential.py`).')
    w('')
    w('| Metric | Value |')
    w('|---|---|')
    for k in ('meanIoU', 'meanInstIoU', 'meanCategoryIoU',
              'meanCategoryInstIoU'):
      if k in px:
        w(f'| {k} | {px[k]:.4f} |')
    for cname, v in sorted(px.get('classes', {}).items()):
      if v == v and v is not None:
        w(f'| {cname} IoU | {v:.4f} |')
    w('')
    w(f'Export: `{px_json}`.  Regenerate: `{regen} --stages pixel`.')
    w('')
  ablate_id = args.box_id.replace('box_model_', 'box_model_nofg_')
  ablate_json = os.path.join(args.results, ablate_id, 'ablation.json')
  if os.path.exists(ablate_json):
    abl = _read_json(ablate_json)
    w('### Packed-channel ablation (box stage, with vs without fg inputs)')
    w('')
    w('A twin of the box model trained with `add_d_out`/`add_y_out` OFF')
    w('(same data, steps, batch size) — does the packed fg/orientation')
    w('channel actually help?  (ref run_cityscapes.sh box stage flags;')
    w('`pipelines/ablate_packed.py`.)  Tail-5 means of the logged curves:')
    w('')
    w('| Variant | final loss | train iou_soft_box | valid iou_soft_box '
      '| steps |')
    w('|---|---|---|---|---|')
    for label in ('with_packed', 'no_packed'):
      d = abl.get(label, {})
      w(f"| {label} | {d.get('final_loss_tail5')} "
        f"| {d.get('train_iou_soft_box_tail5')} "
        f"| {d.get('valid_iou_soft_box_tail5')} | {d.get('steps')} |")
    w('')
  w(f'Analyzer CSVs: `{out_folder}/`.  Regenerate: `{regen}`.')
  w('')
  lines.extend(_notes(full_folder))
  return '\n'.join(lines)


def replace_section(existing, flavor, text):
  """``existing`` (RESULTS.md's text) with the section of ``flavor``
  replaced by ``text`` in place (up to the next section marker or the
  end), or appended; the other three-stage sections stay."""
  marker = f'## {SECTION_FLAVORS[flavor][0]}'
  if marker in existing:
    start = existing.index(marker)
    nxt = existing.find(SECTION_MARKER, start + len(marker))
    tail = existing[nxt:] if nxt != -1 else ''
    existing = existing[:start].rstrip() + '\n\n'
    text = text.rstrip() + ('\n\n' + tail if tail else '\n')
  return existing.rstrip() + '\n\n' + text


def cvppp_head(args):
  """(RESULTS.md's CVPPP head, the number of metrics in its table)."""
  full_folder = os.path.join(args.results, args.full_id)
  out_folder = os.path.join(full_folder, f'output_{args.split}')
  metrics, sweep = split_sweep(read_analyzer_csvs(out_folder))
  thresh_note = 'threshold 0.3'
  if sweep:
    bt = best_threshold(sweep)
    metrics = sweep[bt]
    thresh_note = (f'best threshold {bt:.2f} of sweep '
                   f'{[f"{t:.2f}" for t in sorted(sweep)]}')
  full_step = latest_ckpt_step(full_folder)
  box_step = (latest_ckpt_step(os.path.join(args.results, args.box_id))
              if args.box_id else None)

  full_loss = read_loss_curve(
      os.path.join(args.logs, args.full_id, 'loss.csv'))
  box_loss = (read_loss_curve(
      os.path.join(args.logs, args.box_id, 'loss.csv'))
      if args.box_id else [])
  if box_step is None and box_loss:
    # The box's checkpoints may be gone (only its weights.h5 kept): its
    # loss curve still records the step it was trained to.
    box_step = box_loss[-1][0]
  iou_csv = os.path.join(args.logs, args.full_id, 'iou_hard.csv')
  train_iou = read_loss_curve(iou_csv, field=2)
  valid_iou = read_loss_curve(iou_csv, field=3)
  model_opt = opt_yaml.read(os.path.join(full_folder, 'model_opt.yaml'))
  data_opt = opt_yaml.read(os.path.join(full_folder, 'data_opt.yaml'))

  lines = []
  w = lines.append
  w('# RESULTS — trained-pipeline accuracy evidence')
  w('')
  w('Three-stage pipeline (box pretrain → weights.h5 → full model → eval),')
  w('trained end-to-end with the CVPPP-preset configs')
  w('(`config.cvppp_box_config` / `cvppp_full_config`: 224×224, T=21,')
  w('scheduled-sampling knob, remat scan). The dataset is the built-in')
  w('`synth` family (`data/synthetic.py`) at full CVPPP shape — the real')
  w('CVPPP/KITTI/Cityscapes archives cannot be downloaded in this')
  w('zero-egress environment, so the paper rows below are *context*, not a')
  w('like-for-like comparison. Same H5 layout, area-sorted instances,')
  w('up to 9 overlapping objects per image.')
  w('')
  w('## Provenance')
  w('')
  w(f'- box model: `{args.box_id}` — trained to step {box_step}')
  w(f'- full model: `{args.full_id}` — trained to step {full_step},')
  w('  ctrl net initialised from the box model via weights.h5')
  w(f'- dataset: {data_opt}')
  w(f'- key model opts: timespan={model_opt.get("timespan")}, '
    f'knob={model_opt.get("use_knob")}, remat={model_opt.get("remat")}, '
    f'dtype={model_opt.get("dtype", "float32")}')
  w('')
  w('## Training curves')
  w('')
  if box_loss:
    w(f'- box loss: {box_loss[0][1]:.4f} (step {box_loss[0][0]}) → '
      f'{box_loss[-1][1]:.4f} (step {box_loss[-1][0]})')
  if full_loss:
    w(f'- full loss (−soft-IoU + conf): {full_loss[0][1]:.4f} '
      f'(step {full_loss[0][0]}) → {full_loss[-1][1]:.4f} '
      f'(step {full_loss[-1][0]})')
  if train_iou:
    w(f'- full hard-IoU (train channel): {train_iou[0][1]:.4f} → '
      f'{train_iou[-1][1]:.4f}')
  if valid_iou:
    w(f'- full hard-IoU (valid channel): {valid_iou[0][1]:.4f} → '
      f'{valid_iou[-1][1]:.4f}')
  w('')
  lines.extend(headline_block(full_folder))
  w(f'## Eval metrics ({args.split} split, postprocess chain '
    f'conf→upsample→one-label→{thresh_note})')
  w('')
  w('| Metric | Mean | Std | Paper target (real CVPPP, context) |')
  w('|---|---|---|---|')
  for name in list(dict.fromkeys(METRIC_ORDER + sorted(metrics))):
    if name not in metrics:
      continue
    mean, std = metrics[name]
    tgt = PAPER_TARGETS.get(name)
    tgt_s = f'{tgt[1]} ({tgt[0]})' if tgt else '—'
    w(f'| {name} | {mean:.4f} | {std:.4f} | {tgt_s} |')
  w('')
  if sweep:
    w('### Mask/score threshold sweep (count calibration)')
    w('')
    w('| Threshold | SBD | count_acc | \\|DiC\\| | count_mse |')
    w('|---|---|---|---|---|')
    for t in sorted(sweep):
      row = sweep[t]
      cells = [f'{row[k][0]:.4f}' if k in row else '—'
               for k in ('sbd', 'count_acc', 'dic_abs', 'count_mse')]
      mark = ' ←' if t == bt else ''
      w(f'| {t:.2f}{mark} | ' + ' | '.join(cells) + ' |')
    w('')
  w('Note: `avg_fp`/`avg_fn` use the reference\'s zero-IoU definition '
    '(a prediction counts as FP only if it overlaps NO ground-truth '
    'instance, ref analysis.py:579-605), so duplicate segmentations of an '
    'already-covered object lower `count_acc`/`obj_pr` without registering '
    'as FPs.')
  w('')
  lines.extend(_notes(full_folder))
  w('Analyzer CSVs (per-example scores + Mean/Std trailers): '
    f'`{out_folder}/`.')
  w('')
  box = args.box_id or '<box_id>'
  w('Regenerate: `python -m rec_attend_tpu_torch.pipelines.'
    f'resume_synth_paper --box_id {box} --skip_box` then `python -m '
    'rec_attend_tpu_torch.pipelines.write_results --full_id '
    f'{args.full_id} --box_id {box}`.')
  w('')
  return '\n'.join(lines), len(metrics)


def parse_args(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument('--full_id', required=True)
  p.add_argument('--box_id', default=None)
  p.add_argument('--fg_id', default=None)
  p.add_argument('--results', default='results')
  p.add_argument('--logs', default='logs')
  p.add_argument('--split', default='valid')
  p.add_argument('--out', default='RESULTS.md')
  p.add_argument('--section', default='cvppp',
                 choices=['cvppp'] + sorted(SECTION_FLAVORS),
                 help='synth3/synthcs append (or replace) their three-stage '
                      'section in --out instead of rewriting the file')
  return p.parse_args(argv)


def main(argv=None):
  """Write the CVPPP head of ``--out``, keeping the three-stage sections
  below it, or with ``--section`` that section, replaced in place.
  Returns the path written."""
  args = parse_args(argv)
  existing = ''
  if os.path.exists(args.out):
    with open(args.out) as f:
      existing = f.read()
  if args.section in SECTION_FLAVORS:
    if not (args.fg_id and args.box_id):
      raise ValueError('--fg_id/--box_id required')
    text = replace_section(existing, args.section,
                           three_stage_section(args))
    message = f'wrote {args.section} section in {args.out}'
  else:
    head, n_metrics = cvppp_head(args)
    # Rewriting the head keeps the three-stage sections below it.
    idx = existing.find(SECTION_MARKER)
    text = head + ('\n' + existing[idx:] if idx != -1 else '')
    message = f'wrote {args.out} ({n_metrics} metrics)'
  with open(args.out, 'w') as f:
    f.write(text)
  print(message)
  return args.out


if __name__ == '__main__':
  main()
