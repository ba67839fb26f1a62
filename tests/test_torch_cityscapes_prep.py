"""The port's Cityscapes preparation (``data/cityscapes_prep.py``: polygon
JSON -> labelIds and instanceIds images, no cv2) against the JAX
package's (``rec_attend_tpu/data/cityscapes_prep.py``, cv2.fillPoly and
cv2.imwrite), bit for bit:

- the fill of one polygon, over the cases cv2 has rules for: convex and
  concave, self-intersecting, off the image, horizontal edges, repeated
  points, 3-point slivers, fewer than 3 points, half-pixel coordinates,
  one-point clips, far away; in uint8, int32 and BGR images; and over
  seeded random polygons of each kind at small sizes and at the full
  2048x1024;
- the label images ('ids', 'trainIds', 'color') and the instance images
  ('ids', 'trainIds') of annotations with groups, a trainId-0 class and a
  deleted object, and of one full-size annotation of chip_smoke.py's
  fixture;
- the files, decoded by cv2: 8-bit gray and BGR, the 16-bit instanceIds;
  the batch conversion over gtFine and gtCoarse and the command line;
- the digest of the fixture's images that chip_smoke.py's
  cityscapes_pipeline phase gates on (CITYSCAPES_PREP_DIGEST), made with
  JAX's prep, and the port's to the same.
"""

import glob
import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from rec_attend_tpu.data import cityscapes_prep as jprep
from rec_attend_tpu_torch.data import cityscapes_prep as prep

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
import chip_smoke as cs  # noqa: E402

# (height, width, points): each a rule of cv2's fill.
CASES = {
    'convex': (40, 50, [(5, 5), (40, 8), (35, 30), (8, 33)]),
    'concave': (40, 50, [(5, 5), (25, 18), (45, 4), (40, 35), (24, 22),
                         (6, 36)]),
    'self_intersecting': (40, 50, [(3, 3), (45, 35), (45, 3), (3, 35)]),
    'crossed_star': (60, 60, [(30, 2), (40, 55), (2, 20), (58, 20),
                              (18, 55)]),
    'off_the_image': (30, 40, [(-20, 5), (60, -8), (55, 45), (-5, 38)]),
    'off_left_one_point_in': (20, 6, [(-5, 5), (0, 10), (-5, 15)]),
    'off_right_one_point_in': (20, 6, [(10, 5), (5, 10), (10, 15)]),
    'outside_entirely': (20, 20, [(-9, 2), (-3, 5), (-8, 15)]),
    'far_away': (20, 30, [(-100000, -100000), (100000, 3), (5, 100000)]),
    'border_points': (32, 64, [(-1, -1), (64, -1), (64, 20), (-1, 24)]),
    'horizontal_edges': (30, 30, [(2, 5), (20, 5), (20, 12), (27, 12),
                                  (27, 25), (2, 25)]),
    'repeated_points': (30, 30, [(3, 3), (3, 3), (25, 4), (25, 4), (25, 4),
                                 (14, 27), (3, 3)]),
    'sliver': (30, 40, [(2, 3), (37, 25), (36, 25)]),
    'collinear': (20, 20, [(0, 0), (5, 5), (10, 10)]),
    'one_point': (10, 10, [(4, 4), (4, 4), (4, 4)]),
    'two_points': (10, 10, [(1, 1), (8, 8)]),
    'half_pixels': (30, 30, [(2.5, 3.5), (20.5, 4.49), (25.51, 22.5),
                             (4.5, 25.5)]),
}


def _both(img, pts, value):
  want, got = img.copy(), img.copy()
  jprep._fill(want, pts, value)
  prep.fill(got, pts, value)
  return got, want


@pytest.mark.parametrize('name', sorted(CASES))
@pytest.mark.parametrize('kind', ['uint8', 'int32', 'bgr'])
def test_the_fill_sets_cv2s_pixels(name, kind):
  h, w, pts = CASES[name]
  img = {'uint8': np.zeros((h, w), np.uint8),
         'int32': np.full((h, w), 7, np.int32),
         'bgr': np.zeros((h, w, 3), np.uint8)}[kind]
  value = {'uint8': 26, 'int32': 26003, 'bgr': (142, 0, 1)}[kind]
  got, want = _both(img, pts, value)
  assert np.array_equal(got, want)


def _random_polygon(rng, kind, h, w):
  n = rng.randint(3, 12)
  if kind == 'random':
    return rng.uniform(-5, [w + 5, h + 5], (n, 2))
  if kind == 'star':
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(2, min(h, w) / 2, n)
    return np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)], 1)
  if kind == 'far':
    return rng.uniform(-3 * w, 4 * w, (n, 2)) * [1, h / w]
  if kind == 'horizontal':
    pts = rng.randint(-2, max(h, w) + 2, (n, 2)).astype(float)
    pts[1::2, 1] = pts[0::2, 1][:len(pts[1::2])]
    return np.repeat(pts, rng.randint(1, 3, len(pts)), axis=0)
  if kind == 'sliver':
    p0 = rng.uniform(0, [w, h])
    d = rng.uniform(-w, w, 2)
    return np.array([p0, p0 + d, p0 + d + rng.uniform(-1, 1, 2)])
  return rng.randint(-2, 2 * max(h, w), (n, 2)) / 2.0


@pytest.mark.parametrize('kind', ['random', 'star', 'far', 'horizontal',
                                  'sliver', 'halves'])
def test_seeded_random_polygons_fill_as_cv2(kind):
  rng = np.random.RandomState(len(kind))
  for _ in range(400):
    h, w = rng.randint(5, 60), rng.randint(5, 60)
    got, want = _both(np.zeros((h, w), np.uint8),
                      _random_polygon(rng, kind, h, w), 1)
    assert np.array_equal(got, want)


def test_full_size_polygons_fill_as_cv2():
  """Polygons of up to 300 points at 2048x1024, some snapped to the border
  as the annotations are, some in shuffled order."""
  rng = np.random.RandomState(3)
  for it in range(40):
    n = rng.randint(3, 300)
    cx, cy = rng.uniform(-200, 2248), rng.uniform(-200, 1224)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(5, rng.uniform(20, 900), n)
    pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1)
    if it % 3 == 0:
      pts = np.clip(pts, -1, [2048, 1024])
    if it % 5 == 0:
      pts = rng.permutation(pts)
    got, want = _both(np.zeros((1024, 2048), np.int32), pts, 24000 + it)
    assert np.array_equal(got, want)


def _write(path, objects, h=48, w=80):
  with open(path, 'w') as f:
    json.dump({'imgHeight': h, 'imgWidth': w, 'objects': objects}, f)
  return path


OBJECTS = [
    {'label': 'road', 'polygon': [[-1, 20], [80, 18], [80, 48], [-1, 48]]},
    {'label': 'sky', 'polygon': [[0, 0], [79, 0], [79, 15], [0, 17]]},
    {'label': 'car', 'polygon': [[5, 22], [30, 21], [28, 40], [12, 44],
                                 [18, 33]]},
    {'label': 'car', 'polygon': [[20, 25], [45, 25], [45, 38], [20, 38]]},
    {'label': 'person', 'polygon': [[50, 10], [56, 10], [60, 40], [50, 40],
                                    [58, 20]]},
    {'label': 'cargroup', 'polygon': [[60, 30], [79, 30], [79, 47],
                                      [60, 47]]},
    {'label': 'caravan', 'polygon': [[2, 2], [10, 2], [10, 8]]},
    {'label': 'bicycle', 'deleted': 1, 'polygon': [[0, 0], [70, 0],
                                                   [70, 47]]},
    {'label': 'rider', 'polygon': [[33, 5], [70, 12], [33, 19], [70, 1]]},
]


@pytest.mark.parametrize('encoding', ['ids', 'trainIds', 'color'])
def test_label_images_are_jaxs(tmp_path, encoding):
  ann = prep.Annotation.from_json_file(_write(str(tmp_path / 'a.json'),
                                              OBJECTS))
  jann = jprep.Annotation.from_json_file(str(tmp_path / 'a.json'))
  assert ann.objects == jann.objects and len(ann.objects) == 8
  got = prep.create_label_image(ann, encoding)
  want = jprep.create_label_image(jann, encoding)
  assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize('encoding', ['ids', 'trainIds'])
def test_instance_images_are_jaxs(tmp_path, encoding):
  path = _write(str(tmp_path / 'a.json'), OBJECTS)
  got = prep.create_instance_image(prep.Annotation.from_json_file(path),
                                   encoding)
  want = jprep.create_instance_image(jprep.Annotation.from_json_file(path),
                                     encoding)
  assert got.dtype == want.dtype and np.array_equal(got, want)
  if encoding == 'ids':
    # Cars 26000 and 26001, the group the bare 26, the person 24000.
    assert {26000, 26001, 26, 24000, 25000} <= set(np.unique(got).tolist())


def test_unknown_labels_raise_in_both(tmp_path):
  """The label table of both packages has no 'license plate' (id -1 in the
  official one): both raise on it, so the negative-id skip is never
  reached from a JSON file."""
  path = _write(str(tmp_path / 'a.json'), OBJECTS + [
      {'label': 'license plate', 'polygon': [[1, 1], [5, 1], [5, 3]]}])
  for mod in (prep, jprep):
    with pytest.raises(ValueError, match='license plate'):
      mod.create_instance_image(mod.Annotation.from_json_file(path))
  with pytest.raises(ValueError, match='encoding'):
    prep.create_instance_image(prep.Annotation.from_json_file(path), 'color')


def test_a_full_size_fixture_annotation_is_jaxs(tmp_path):
  """One annotation of chip_smoke.py's fixture at 2048x1024: up to 20
  concave and crossed instances, some off the image, a group, a trainId-0
  caravan and a deleted car."""
  root = str(tmp_path)
  cs.cityscapes_fixture(root, {'valid': 1}, 1024, 2048, 22)
  path = glob.glob(os.path.join(root, 'gtFine', 'val', '*', '*.json'))[0]
  with open(path) as f:
    labels = [o['label'] for o in json.load(f)['objects']]
  assert {'cargroup', 'caravan'} <= set(labels) and len(labels) > 6
  ann, jann = (m.Annotation.from_json_file(path) for m in (prep, jprep))
  for enc in ('ids', 'trainIds'):
    assert np.array_equal(prep.create_instance_image(ann, enc),
                          jprep.create_instance_image(jann, enc))
  for enc in ('ids', 'trainIds', 'color'):
    assert np.array_equal(prep.create_label_image(ann, enc),
                          jprep.create_label_image(jann, enc))


def test_the_files_decode_to_jaxs(tmp_path):
  path = _write(str(tmp_path / 'a.json'), OBJECTS)
  for kind, fn, jfn in (('instance', prep.json2instance_img,
                         jprep.json2instance_img),
                        ('label', prep.json2label_img, jprep.json2label_img)):
    for enc in ('ids', 'trainIds'):
      got, want = (str(tmp_path / f'{kind}_{enc}_{who}.png')
                   for who in ('port', 'jax'))
      fn(path, got, enc)
      jfn(path, want, enc)
      a, b = cv2.imread(got, -1), cv2.imread(want, -1)
      assert a.dtype == b.dtype and np.array_equal(a, b)
      assert a.dtype == (np.uint16 if kind == 'instance' else np.uint8)


def _gt_tree(root):
  return {os.path.relpath(p, root): cv2.imread(p, -1)
          for p in sorted(glob.glob(os.path.join(root, 'gt*', '*', '*',
                                                 '*Ids.png')))}


@pytest.mark.parametrize('encoding', ['ids', 'trainIds'])
def test_the_batch_conversion_and_command_line_write_jaxs_files(tmp_path,
                                                            encoding):
  """gtFine and gtCoarse both, through ``main``."""
  root = str(tmp_path / 'port')
  cs.cityscapes_fixture(root, {'train': 2, 'valid': 1}, 60, 120, 5)
  coarse = os.path.join(root, 'gtCoarse', 'train', 'aachen')
  os.makedirs(coarse)
  src = glob.glob(os.path.join(root, 'gtFine', 'train', 'aachen', '*.json'))[0]
  shutil.copyfile(src, os.path.join(coarse, os.path.basename(src).replace(
      'gtFine', 'gtCoarse')))
  jroot = str(tmp_path / 'jax')
  shutil.copytree(root, jroot)
  assert prep.main(['--dataset', root, '--encoding', encoding]) == 4
  jprep.main(['--dataset', jroot, '--encoding', encoding])
  got, want = _gt_tree(root), _gt_tree(jroot)
  assert sorted(got) == sorted(want) and len(got) == 8
  for k in got:
    assert np.array_equal(got[k], want[k]), k
  with pytest.raises(FileNotFoundError, match='polygons'):
    prep.create_ground_truth_images(str(tmp_path / 'none'))


def test_the_fixtures_digest_is_jaxs_and_pinned(tmp_path):
  """chip_smoke.py's gate: its fixture at 2048x1024 (8, 4 and 4 images)
  through JAX's prep (cv2) has CITYSCAPES_PREP_DIGEST, and through the
  port's too; one polygon moved by a pixel changes it."""
  root = str(tmp_path / 'port')
  cs.cityscapes_fixture(root, **cs.CITYSCAPES_FIXTURE)
  jroot = str(tmp_path / 'jax')
  shutil.copytree(root, jroot)
  jprep.main(['--dataset', jroot])
  assert cs.cityscapes_prep_digest(jroot) == cs.CITYSCAPES_PREP_DIGEST
  assert prep.main(['--dataset', root]) == 16
  assert cs.cityscapes_prep_digest(root) == cs.CITYSCAPES_PREP_DIGEST
  assert cs.cityscapes_prep_digest(root, moved=True) != (
      cs.CITYSCAPES_PREP_DIGEST)
