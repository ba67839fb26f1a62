"""Cityscapes annotation preparation: polygon JSON -> label and instance
images, without cv2.

Counterpart of ``rec_attend_tpu/data/cityscapes_prep.py`` (the toolkit's
``json2instanceImg.py``, ``json2labelImg.py`` and their batch scripts):
writes ``*_labelIds.png`` and ``*_instanceIds.png`` (or the trainId
variants) from the raw ``*_polygons.json`` annotations of ``gtFine`` and
``gtCoarse``, so that assembling the H5 files needs no external toolkit.

The encoding: a class with instances gets ``id * 1000 + n``, n its running
instance index; a ``<class>group`` polygon (``cargroup``) keeps the bare
id; other classes their id; negative ids are skipped; later polygons paint
over earlier ones.  Objects marked ``deleted`` are dropped.

Polygons are filled as ``cv2.fillPoly(img, [round(pts)], value)`` fills
them (LINE_8, shift 0; fewer than 3 points fill nothing), pixel for pixel,
by ``csrc/poly_fill.cc`` (built by ``ops/cuda/build.py`` with the host
compiler): the outline's 8-connected lines and the scanline fill of the
edges in 16-bit fixed point, edges off the image clipped as cv2 clips them.
The files are written by ``utils/png.py`` as ``cv2.imwrite`` writes them:
8-bit gray or BGR, and 16-bit gray for the instance ids.

    python -m rec_attend_tpu_torch.data.cityscapes_prep \\
        --dataset data/cityscapes
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from rec_attend_tpu_torch.data.cityscapes_labels import labels
from rec_attend_tpu_torch.data.cityscapes_labels import name2label
from rec_attend_tpu_torch.utils import logger
from rec_attend_tpu_torch.utils import png


class Annotation:
  """One image's polygon annotation: its size and its objects, a list of
  (label, [(x, y), ...]) in drawing order."""

  def __init__(self, img_height=0, img_width=0, objects=None):
    self.img_height = img_height
    self.img_width = img_width
    self.objects = objects or []

  @classmethod
  def from_json_file(cls, path):
    with open(path) as f:
      d = json.load(f)
    objects = [(str(o['label']), [(float(p[0]), float(p[1]))
                                  for p in o['polygon']])
               for o in d['objects'] if not o.get('deleted', 0)]
    return cls(int(d['imgHeight']), int(d['imgWidth']), objects)


def _resolve_label(label):
  """(Label, is_group) of a polygon's label, '<class>group' the group of
  <class>; an unknown label raises."""
  is_group = False
  if label not in name2label and label.endswith('group'):
    label = label[:-len('group')]
    is_group = True
  if label not in name2label:
    raise ValueError(f"Label '{label}' not known.")
  return name2label[label], is_group


def fill(img, polygon, value):
  """Fill ``polygon`` [(x, y), ...] into ``img`` (a C-contiguous [H, W] or
  [H, W, C] array) with ``value``, in place, as ``cv2.fillPoly(img,
  [np.round(pts).astype(np.int32)], value)`` does; fewer than 3 points fill
  nothing."""
  pts = np.round(np.asarray(polygon, np.float64)).astype(np.int32)
  if len(pts) < 3:
    return
  if not img.flags.c_contiguous:
    raise ValueError('fill takes a C-contiguous image')
  from rec_attend_tpu_torch.ops.cuda import build
  channels = img.shape[2] if img.ndim == 3 else 1
  colour = np.zeros(channels, img.dtype)
  colour[:] = value
  pts = np.ascontiguousarray(pts.reshape(-1, 2), np.int64)
  build.load_poly_fill().fill_poly(
      img.ctypes.data, img.shape[0], img.shape[1],
      img.itemsize * channels, colour.ctypes.data, pts.ctypes.data,
      len(pts))


def create_label_image(annotation, encoding='ids'):
  """The class labels of an annotation: [H, W] uint8 for 'ids' and
  'trainIds', [H, W, 3] BGR for 'color'."""
  h, w = annotation.img_height, annotation.img_width
  bg = name2label['unlabeled']
  if encoding == 'color':
    img = np.zeros((h, w, 3), np.uint8)
    img[:] = bg.color[::-1]
  else:
    img = np.full((h, w), getattr(bg, 'id' if encoding == 'ids'
                                  else 'trainId'), np.uint8)
  for label, polygon in annotation.objects:
    lt, _ = _resolve_label(label)
    if lt.id < 0:
      continue
    if encoding == 'ids':
      val = lt.id
    elif encoding == 'trainIds':
      val = lt.trainId
    elif encoding == 'color':
      val = lt.color[::-1]
    else:
      raise ValueError(f'Unknown encoding {encoding!r}')
    fill(img, polygon, val)
  return img


def create_instance_image(annotation, encoding='ids'):
  """The instance ids of an annotation, [H, W] int32."""
  if encoding not in ('ids', 'trainIds'):
    raise ValueError(f'Unknown encoding {encoding!r}')
  h, w = annotation.img_height, annotation.img_width
  attr = 'id' if encoding == 'ids' else 'trainId'
  img = np.full((h, w), getattr(name2label['unlabeled'], attr), np.int32)
  nb_instances = {lt.name: 0 for lt in labels if lt.hasInstances}
  for label, polygon in annotation.objects:
    lt, is_group = _resolve_label(label)
    value = getattr(lt, attr)
    if lt.hasInstances and not is_group:
      value = value * 1000 + nb_instances[lt.name]
      nb_instances[lt.name] += 1
    if value < 0:
      continue
    fill(img, polygon, int(value))
  return img


def _write(path, img):
  """``cv2.imwrite`` of a PNG: uint8 gray or BGR, or uint16 gray."""
  if img.dtype == np.uint16:
    blob = png.encode_samples(img, 0, 16)
  else:
    blob = png.encode(img)
  with open(path, 'wb') as f:
    f.write(blob.tobytes())


def json2label_img(in_json, out_img, encoding='ids'):
  _write(out_img, create_label_image(Annotation.from_json_file(in_json),
                                     encoding))


def json2instance_img(in_json, out_img, encoding='ids'):
  img = create_instance_image(Annotation.from_json_file(in_json), encoding)
  # The ids exceed 8 bits: 16-bit files, as the official ones.
  _write(out_img, img.astype(np.uint16))


def create_ground_truth_images(cityscapes_path, encoding='ids',
                               kinds=('instance', 'label')):
  """Convert every ``*_polygons.json`` under ``gtFine`` and ``gtCoarse``;
  returns the number of annotations converted."""
  log = logger.get()
  files = sorted(
      glob.glob(os.path.join(cityscapes_path, 'gtFine', '*', '*',
                             '*_gt*_polygons.json'))
      + glob.glob(os.path.join(cityscapes_path, 'gtCoarse', '*', '*',
                               '*_gt*_polygons.json')))
  if not files:
    raise FileNotFoundError(
        f'No *_polygons.json under {cityscapes_path}/gtFine|gtCoarse')
  suffix = 'TrainIds' if encoding == 'trainIds' else 'Ids'
  for i, f in enumerate(files):
    if 'instance' in kinds:
      json2instance_img(f, f.replace('_polygons.json',
                                     f'_instance{suffix}.png'), encoding)
    if 'label' in kinds:
      json2label_img(f, f.replace('_polygons.json',
                                  f'_label{suffix}.png'), encoding)
    if (i + 1) % 200 == 0:
      log.info(f'Converted {i + 1}/{len(files)} annotations')
  log.info(f'Converted {len(files)} annotations')
  return len(files)


def main(argv=None):
  parser = argparse.ArgumentParser(
      description='Write labelIds/instanceIds images from the polygon JSON '
      'annotations of a Cityscapes root.')
  parser.add_argument('--dataset',
                      default=os.environ.get('CITYSCAPES_DATASET'))
  parser.add_argument('--encoding', default='ids',
                      choices=['ids', 'trainIds'])
  parser.add_argument('--kinds', default='instance,label')
  args = parser.parse_args(argv)
  return create_ground_truth_images(args.dataset, args.encoding,
                                    tuple(args.kinds.split(',')))


if __name__ == '__main__':
  main()
