"""The official Cityscapes instance-level AP, on arrays and on files.

Counterpart of ``rec_attend_tpu/eval_cityscapes/instance_eval.py``,
the algorithm of the official ``evalInstanceLevelSemanticLabeling.py``:

  - overlaps 0.5:0.05:0.95, least region size 100 pixels (the rows limited
    to 100 m and 50 m, with least size 1000, only where distances are
    given);
  - a prediction matches a ground-truth instance at overlap o if
    intersection / union > o; a second match of one instance makes the
    lower score a false positive; an unmatched prediction is ignored when
    its share of void, group or filtered ground-truth pixels exceeds o;
  - AP integrates the precision-recall curve step by step over the unique
    scores, averaged over the overlaps, then over the classes (NaN-mean
    over classes without ground truth or predictions).

The evaluation reads, per image, an instance-id image and rows of (mask,
label id, confidence): in memory (``evaluate_instance_predictions``, the
rows of ``analysis.cityscapes_submission``), or from the files of a
submission, as the JAX package and the official script read them
(``evaluate_prediction_files``): a ``*_gtFine_instanceIds.png`` and a text
file of ``{mask png} {label id} {confidence}`` lines an image, the masks
beside it.  ``main`` is the official script's command line: the ground
truth of ``{dataset}/gtFine/{split}``, each image's text file found under
``--predictions`` by its ``{city}_{seq}_{frame}`` stem, and with
``--use_distance`` the ``disparity`` and ``camera`` files beside them for
the rows limited to 100 m and 50 m.  The result may be exported in the
JAX package's JSON layout.

    python -m rec_attend_tpu_torch.eval_cityscapes.instance_eval \\
        --predictions results/<id>/output_valid/cityscapes \\
        --dataset data/cityscapes --split val --export ap.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from rec_attend_tpu_torch.data.cityscapes_labels import id2label
from rec_attend_tpu_torch.data.cityscapes_labels import labels
from rec_attend_tpu_torch.utils import logger
from rec_attend_tpu_torch.utils import png

OVERLAPS = np.arange(0.5, 1.0, 0.05)
MIN_REGION_SIZES = [100, 1000, 1000]
DISTANCE_THS = [float('inf'), 100.0, 50.0]
DISTANCE_CONFS = [-float('inf'), 0.5, 0.5]
# Nominal Cityscapes stereo rig: baseline in metres, focal length in pixels
# at the full 2048x1024 resolution.
NOMINAL_BASELINE = 0.209313
NOMINAL_FX = 2262.52


def instance_labels():
  return [l.name for l in labels if l.hasInstances and not l.ignoreInEval]


def disparity_to_distance(disp_png, baseline=NOMINAL_BASELINE,
                          fx=NOMINAL_FX):
  """Metric distance [m] of an official ``_disparity.png`` image: a pixel
  p > 0 has disparity (p - 1) / 256 and depth baseline * fx / disparity;
  p == 0 is invalid (NaN).  Returns float32."""
  disp_png = np.asarray(disp_png, np.float32)
  d = (disp_png - 1.0) / 256.0
  dist = np.where(disp_png > 0, baseline * fx / np.maximum(d, 1e-9),
                  np.nan)
  return dist.astype(np.float32)


def get_gt_instances(gt_img, distance_img=None):
  """The ground-truth instances of an instance-id image, {label name:
  [instance dicts]}.  ``distance_img``: an optional [H, W] distance map
  (NaN invalid) that gives each instance its median distance over its
  valid pixels ('medDist') and their share ('distConf')."""
  inst = {}
  ids, counts = np.unique(gt_img, return_counts=True)
  for inst_id, count in zip(ids.tolist(), counts.tolist()):
    label_id = inst_id // 1000 if inst_id >= 1000 else inst_id
    if label_id not in id2label:
      continue
    label = id2label[label_id]
    if not label.hasInstances:
      continue
    med_dist, dist_conf = -1.0, 0.0
    if distance_img is not None:
      dists = distance_img[gt_img == inst_id]
      valid = dists[np.isfinite(dists)]
      if valid.size:
        med_dist = float(np.median(valid))
        dist_conf = float(valid.size) / float(count)
    inst.setdefault(label.name, []).append({
        'instID': int(inst_id), 'labelID': int(label_id),
        'pixelCount': int(count), 'medDist': med_dist,
        'distConf': dist_conf,
    })
  return inst


def assign_gt_to_preds(gt_instances, gt_img, predictions, inst_labels):
  """Cross-populate each ground-truth instance's 'matchedPred' and each
  prediction's 'matchedGt' with their intersections.  ``predictions``:
  rows whose first three entries are (mask [H, W], nonzero inside; label
  id; confidence)."""
  pred_instances = {l: [] for l in inst_labels}
  gt_instances = {l: [dict(g, matchedPred=[]) for g in gl]
                  for l, gl in gt_instances.items() if l in inst_labels}

  void_ids = [l.id for l in labels if l.ignoreInEval]
  bool_void = np.isin(gt_img, void_ids)

  count = 0
  for row in predictions:
    mask, label_id, conf = row[0], int(row[1]), float(row[2])
    if label_id not in id2label:
      continue
    label_name = id2label[label_id].name
    if label_name not in inst_labels:
      continue
    bool_pred = np.asarray(mask) != 0
    pixel_count = int(np.count_nonzero(bool_pred))
    if pixel_count == 0:
      continue
    pred_instance = {
        'predID': count, 'labelID': label_id, 'pixelCount': pixel_count,
        'confidence': conf,
        'voidIntersection': int(np.count_nonzero(bool_void & bool_pred)),
        'matchedGt': [],
    }
    for gt_num, gt in enumerate(gt_instances.get(label_name, [])):
      intersection = int(np.count_nonzero(
          (gt_img == gt['instID']) & bool_pred))
      if intersection > 0:
        gt_copy = {k: v for k, v in gt.items() if k != 'matchedPred'}
        pred_copy = {k: v for k, v in pred_instance.items()
                     if k != 'matchedGt'}
        gt_copy['intersection'] = intersection
        pred_copy['intersection'] = intersection
        pred_instance['matchedGt'].append(gt_copy)
        gt_instances[label_name][gt_num]['matchedPred'].append(pred_copy)
    count += 1
    pred_instances[label_name].append(pred_instance)
  return gt_instances, pred_instances


def evaluate_matches(matches, inst_labels, distance_available=False):
  """AP [distance setting, class, overlap] of the images' matches (a list
  of {'groundTruth', 'prediction'} in image order)."""
  if distance_available:
    min_sizes, dist_ths, dist_confs = (MIN_REGION_SIZES, DISTANCE_THS,
                                       DISTANCE_CONFS)
  else:
    min_sizes, dist_ths, dist_confs = ([MIN_REGION_SIZES[0]],
                                       [DISTANCE_THS[0]],
                                       [DISTANCE_CONFS[0]])
  ap = np.zeros((len(dist_ths), len(inst_labels), len(OVERLAPS)))

  for d_i, (min_size, dist_th, dist_conf) in enumerate(
      zip(min_sizes, dist_ths, dist_confs)):
    for o_i, overlap_th in enumerate(OVERLAPS):
      for l_i, label_name in enumerate(inst_labels):
        y_true = []
        y_score = []
        hard_fns = 0
        have_gt = False
        have_pred = False
        for img in matches:
          preds = img['prediction'].get(label_name, [])
          gts = img['groundTruth'].get(label_name, [])
          gts = [g for g in gts
                 if g['instID'] >= 1000 and g['pixelCount'] >= min_size
                 and g['medDist'] <= dist_th and g['distConf'] >= dist_conf]
          if gts:
            have_gt = True
          if preds:
            have_pred = True

          cur_true = [1.0] * len(gts)
          cur_score = [-float('inf')] * len(gts)
          cur_match = [False] * len(gts)

          for gt_i, gt in enumerate(gts):
            found_match = False
            for pred in gt['matchedPred']:
              overlap = pred['intersection'] / (
                  gt['pixelCount'] + pred['pixelCount']
                  - pred['intersection'])
              if overlap > overlap_th:
                confidence = pred['confidence']
                if cur_match[gt_i]:
                  # A second match: the lower score becomes a false
                  # positive.
                  max_s = max(cur_score[gt_i], confidence)
                  min_s = min(cur_score[gt_i], confidence)
                  cur_score[gt_i] = max_s
                  cur_true.append(0.0)
                  cur_score.append(min_s)
                  cur_match.append(True)
                else:
                  found_match = True
                  cur_match[gt_i] = True
                  cur_score[gt_i] = confidence
            if not found_match:
              hard_fns += 1

          cur_true = [t for t, m in zip(cur_true, cur_match) if m]
          cur_score = [s for s, m in zip(cur_score, cur_match) if m]

          for pred in preds:
            found_gt = False
            for gt in pred['matchedGt']:
              overlap = gt['intersection'] / (
                  gt['pixelCount'] + pred['pixelCount']
                  - gt['intersection'])
              if overlap > overlap_th:
                found_gt = True
                break
            if not found_gt:
              nb_ignore = pred['voidIntersection']
              for gt in pred['matchedGt']:
                if gt['instID'] < 1000:        # a group region
                  nb_ignore += gt['intersection']
                if (gt['pixelCount'] < min_size or gt['medDist'] > dist_th
                    or gt['distConf'] < dist_conf):
                  nb_ignore += gt['intersection']
              if nb_ignore / pred['pixelCount'] <= overlap_th:
                cur_true.append(0.0)
                cur_score.append(pred['confidence'])

          y_true.extend(cur_true)
          y_score.extend(cur_score)

        if have_gt and have_pred:
          ap[d_i, l_i, o_i] = _average_precision(
              np.array(y_true), np.array(y_score), hard_fns)
        elif have_gt:
          ap[d_i, l_i, o_i] = 0.0
        else:
          ap[d_i, l_i, o_i] = float('nan')
  return ap


def _average_precision(y_true, y_score, hard_fns):
  """The step-integrated precision-recall curve (the official
  convolution form)."""
  order = np.argsort(y_score)
  y_score_sorted = y_score[order]
  y_true_sorted = y_true[order]
  cumsum = np.cumsum(y_true_sorted)
  _, unique_idx = np.unique(y_score_sorted, return_index=True)
  nb_pr = len(unique_idx) + 1
  nb_examples = len(y_score_sorted)
  nb_true = cumsum[-1] if len(cumsum) else 0
  precision = np.zeros(nb_pr)
  recall = np.zeros(nb_pr)
  cumsum = np.append(cumsum, 0)
  for idx_res, idx_scores in enumerate(unique_idx):
    cs = cumsum[idx_scores - 1]
    tp = nb_true - cs
    fp = nb_examples - idx_scores - tp
    fn = cs + hard_fns
    precision[idx_res] = tp / (tp + fp)
    recall[idx_res] = tp / (tp + fn)
  precision[-1] = 1.0
  recall[-1] = 0.0
  recall_conv = np.append(np.append(recall[0], recall), 0.0)
  step_widths = np.convolve(recall_conv, [-0.5, 0, 0.5], 'valid')
  return float(np.dot(precision, step_widths))


def compute_averages(aps, inst_labels, distance_available=False):
  d_inf = 0
  o50 = np.where(np.isclose(OVERLAPS, 0.5))[0]
  avg = {
      'allAp': float(np.nanmean(aps[d_inf, :, :])),
      'allAp50%': float(np.nanmean(aps[d_inf, :, o50])),
      'classes': {},
  }
  if distance_available and aps.shape[0] >= 3:
    avg['allAp100m'] = float(np.nanmean(aps[1, :, :]))
    avg['allAp50m'] = float(np.nanmean(aps[2, :, :]))
  for l_i, name in enumerate(inst_labels):
    avg['classes'][name] = {
        'ap': float(np.average(aps[d_inf, l_i, :])),
        'ap50%': float(np.average(aps[d_inf, l_i, o50])),
    }
  return avg


def _match(rows, gt_img, distance_img, inst_labels):
  gt_img = np.asarray(gt_img).astype(np.int64)
  gts, preds = assign_gt_to_preds(
      get_gt_instances(gt_img, distance_img=distance_img), gt_img, rows,
      inst_labels)
  return {'groundTruth': gts, 'prediction': preds}


def _averages(matches, inst_labels, distance_available, export_file):
  aps = evaluate_matches(matches, inst_labels,
                         distance_available=distance_available)
  avg = compute_averages(aps, inst_labels,
                         distance_available=distance_available)
  log = logger.get()
  extra = (f"  AP_100m: {avg['allAp100m']:.3f}  AP_50m: {avg['allAp50m']:.3f}"
           if 'allAp100m' in avg else '')
  log.info(f"AP: {avg['allAp']:.3f}  AP_50%: {avg['allAp50%']:.3f}" + extra)
  if export_file:
    os.makedirs(os.path.dirname(export_file) or '.', exist_ok=True)
    with open(export_file, 'w') as f:
      json.dump({'averages': avg, 'aps': aps.tolist()}, f, indent=2)
  return avg


def evaluate_instance_predictions(predictions, gt_images,
                                  distance_images=None, export_file=None):
  """AP over images: ``predictions`` holds each image's rows (mask, label
  id, confidence), ``gt_images`` its [H, W] instance-id image, and
  ``distance_images``, optional, its [H, W] distances in metres (NaN
  invalid; see ``disparity_to_distance``) or None, which adds the 100 m
  and 50 m rows.  Returns the averages: 'allAp', 'allAp50%', per class
  'ap' and 'ap50%', and with distances 'allAp100m' and 'allAp50m'.
  ``export_file``, where given, gets ``{'averages': ..., 'aps': [distance
  row][class][overlap]}`` as JSON, the JAX package's layout
  (``instance_eval.py:366-369``)."""
  inst_labels = instance_labels()
  distance_available = bool(distance_images) and any(
      d is not None for d in distance_images)
  matches = [_match(rows, gt_img,
                    distance_images[i] if distance_available else None,
                    inst_labels)
             for i, (rows, gt_img) in enumerate(zip(predictions, gt_images))]
  return _averages(matches, inst_labels, distance_available, export_file)


def load_camera(camera_json):
  """(baseline, fx) of an official ``_camera.json``."""
  with open(camera_json) as f:
    cam = json.load(f)
  return (float(cam['extrinsic']['baseline']),
          float(cam['intrinsic']['fx']))


def read_pred_info(pred_txt):
  """The lines of a prediction text file, each ``{mask png} {label id}
  {confidence}``: [{'maskFile' (beside the text file), 'labelID',
  'conf'}]."""
  preds = []
  base = os.path.dirname(pred_txt)
  with open(pred_txt) as f:
    for line in f:
      parts = line.split()
      if len(parts) != 3:
        raise ValueError(
            f'Invalid prediction line in {pred_txt}: {line!r}')
      preds.append({
          'maskFile': os.path.join(base, parts[0]),
          'labelID': int(float(parts[1])),
          'conf': float(parts[2]),
      })
  return preds


def read_prediction_rows(pred_txt):
  """The rows (mask, label id, confidence) of a prediction text file, the
  masks read from their PNGs, for the labels that the AP counts."""
  inst_labels = set(instance_labels())
  return [(png.imread(p['maskFile'], png.IMREAD_GRAYSCALE), p['labelID'],
           p['conf'])
          for p in read_pred_info(pred_txt)
          if p['labelID'] in id2label
          and id2label[p['labelID']].name in inst_labels]


def evaluate_prediction_files(prediction_txts, gt_files, export_file=None,
                              distance_files=None, camera_files=None):
  """AP over the files of a submission: each image's prediction text file
  and its 16-bit ``*_instanceIds.png``, one image in memory at a time.
  ``distance_files``: optional aligned official ``_disparity.png`` paths
  (entries may be None), which add the 100 m and 50 m rows, with
  ``camera_files``' ``_camera.json`` rigs over the nominal one.  Returns
  the averages of ``evaluate_instance_predictions``."""
  inst_labels = instance_labels()
  distance_available = bool(distance_files) and any(
      d is not None for d in distance_files)
  matches = []
  for i, (pred_txt, gt_file) in enumerate(zip(prediction_txts, gt_files)):
    distance_img = None
    if distance_available and distance_files[i] is not None:
      baseline, fx = NOMINAL_BASELINE, NOMINAL_FX
      if camera_files and camera_files[i] is not None:
        baseline, fx = load_camera(camera_files[i])
      distance_img = disparity_to_distance(
          png.imread(distance_files[i], png.IMREAD_UNCHANGED), baseline, fx)
    matches.append(_match(read_prediction_rows(pred_txt),
                          png.imread(gt_file, png.IMREAD_UNCHANGED),
                          distance_img, inst_labels))
  return _averages(matches, inst_labels, distance_available, export_file)


def find_gt_files(cityscapes_path, split='val'):
  pattern = os.path.join(cityscapes_path, 'gtFine', split, '*',
                         '*_gtFine_instanceIds.png')
  return sorted(glob.glob(pattern))


def find_side_file(gt_file, cityscapes_path, split, kind, ext):
  """The ``disparity`` or ``camera`` file of a ground-truth file, by its
  stem, or None: ``{root}/{kind}/{split}/{city}/{stem}_{kind}.{ext}``."""
  base = os.path.basename(gt_file)
  stem = '_'.join(base.split('_')[:3])
  city = stem.split('_')[0]
  path = os.path.join(cityscapes_path, kind, split, city,
                      f'{stem}_{kind}.{ext}')
  return path if os.path.exists(path) else None


def find_prediction_file(gt_file, prediction_path):
  """The text file under ``prediction_path`` of a ground-truth file, by
  its ``{city}_{seq}_{frame}`` stem."""
  base = os.path.basename(gt_file)
  stem = '_'.join(base.split('_')[:3])
  hits = glob.glob(os.path.join(prediction_path, '**', f'{stem}*.txt'),
                   recursive=True)
  if not hits:
    raise FileNotFoundError(
        f'Found no prediction for ground truth {gt_file}')
  return hits[0]


def main(argv=None):
  """The official script's command line, its environment variables
  (CITYSCAPES_RESULTS, CITYSCAPES_DATASET, CITYSCAPES_SPLIT) as defaults.
  Returns the averages."""
  parser = argparse.ArgumentParser()
  parser.add_argument('--predictions',
                      default=os.environ.get('CITYSCAPES_RESULTS'))
  parser.add_argument('--dataset',
                      default=os.environ.get('CITYSCAPES_DATASET'))
  parser.add_argument('--split',
                      default=os.environ.get('CITYSCAPES_SPLIT', 'val'))
  parser.add_argument('--export', default=None)
  parser.add_argument('--use_distance', action='store_true',
                      help='distances of the instances from the official '
                      'disparity images, for AP_100m and AP_50m')
  args = parser.parse_args(argv)
  gt_files = find_gt_files(args.dataset, args.split)
  pred_txts = [find_prediction_file(g, args.predictions) for g in gt_files]
  distance_files = camera_files = None
  if args.use_distance:
    distance_files = [find_side_file(g, args.dataset, args.split,
                                     'disparity', 'png') for g in gt_files]
    camera_files = [find_side_file(g, args.dataset, args.split,
                                   'camera', 'json') for g in gt_files]
  return evaluate_prediction_files(pred_txts, gt_files,
                                   export_file=args.export,
                                   distance_files=distance_files,
                                   camera_files=camera_files)


if __name__ == '__main__':
  main()
