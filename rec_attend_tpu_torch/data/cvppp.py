"""CVPPP leaf segmentation dataset: its assembler and its reader.

Counterpart of ``rec_attend_tpu/data/cvppp.py`` (ref data_api/cvppp.py)
on the port's codecs.  The assembler reads a folder of
``plantNNN_{rgb,label,fg}.png`` (the label image's colours are the leaves;
without it the fg image), writes the deterministic 80/20 split files
``train.txt``, ``valid.txt`` and ``all.txt`` (seed 2) where the split's is
missing, and assembles the split into ``{split}_{H}x{W}.h5``.  The reader
takes the plant id as JAX's files store it, an integer or the group name.
"""

from __future__ import annotations

import os
import re

import numpy as np

from rec_attend_tpu_torch.data import sep_labels
from rec_attend_tpu_torch.data.assembler import InsSegAssembler
from rec_attend_tpu_torch.data.dataset import InsSegDataset
from rec_attend_tpu_torch.utils import png

TIMESPAN = 21


def semantic_union(segm):
  """The one semantic mask of a folder whose instances are all of one
  class, uint8: the union of the instance masks (JAX builds it in float64,
  which its PNG encoder writes as the same 0/1 bytes)."""
  return [np.maximum.reduce(segm)] if segm else []


class CVPPPAssembler(InsSegAssembler):
  """Assembles plantNNN_{rgb,label,fg}.png folders into the H5 format,
  writing the deterministic 80/20 split files (seed 2, ref cvppp.py:65-102).
  """

  def __init__(self, folder, opt, split=None, output_fname=None):
    self.folder = folder
    self.split = split
    self.image_regex = re.compile(r'plant(?P<imgid>[0-9]{3})_rgb.png')
    if output_fname is None:
      output_fname = os.path.join(
          folder, '{}_{}x{}.h5'.format(split, opt['height'], opt['width']))
    super().__init__(opt, output_fname)

  def read_ids(self):
    id_fname = os.path.join(self.folder, f'{self.split}.txt')
    if not os.path.exists(id_fname):
      self.write_split()
    with open(id_fname) as f:
      return [int(l.strip()) for l in f.readlines()]

  def get_str_id(self, idx):
    return f'plant{idx:03d}'

  def get_image(self, img_id):
    return png.imread(os.path.join(self.folder,
                                   f'{self.get_str_id(img_id)}_rgb.png'))

  def get_segmentations(self, img_id):
    sid = self.get_str_id(img_id)
    gt_fname = os.path.join(self.folder, f'{sid}_label.png')
    if not os.path.exists(gt_fname):
      self.log.warning(f'GT file not found: {gt_fname}')
      gt_fname = os.path.join(self.folder, f'{sid}_fg.png')
      if not os.path.exists(gt_fname):
        raise FileNotFoundError(gt_fname)
    segm, _ = sep_labels.get_separate_labels(png.imread(gt_fname))
    return segm, semantic_union(segm), [0] * len(segm)

  def write_split(self):
    random = np.random.RandomState(2)
    ids = sorted({int(self.image_regex.search(f).group('imgid'))
                  for f in os.listdir(self.folder)
                  if self.image_regex.search(f)})
    image_ids = np.array(ids)
    num_train = int(np.ceil(image_ids.size * 0.8))
    idx = np.arange(len(image_ids))
    random.shuffle(idx)
    train_ids = image_ids[idx[:num_train]]
    valid_ids = image_ids[idx[num_train:]]
    with open(os.path.join(self.folder, 'train.txt'), 'w') as f:
      f.writelines(f'{i}\n' for i in train_ids)
    with open(os.path.join(self.folder, 'valid.txt'), 'w') as f:
      f.writelines(f'{i}\n' for i in valid_ids)
    with open(os.path.join(self.folder, 'all.txt'), 'w') as f:
      f.writelines(f'{i}\n' for i in list(train_ids) + list(valid_ids))


class CVPPP(InsSegDataset):

  def get_name(self):
    return 'cvppp'

  def get_str_id(self, idx):
    # Reference-produced H5s store raw integer plant ids in index_map
    # (cvppp.py:119-120); the assembler's store the group names.
    s = str(idx)
    return f'plant{int(s):03d}' if s.isdigit() else s

  def get_fname(self, idx, fg=False):
    sid = self.get_str_id(idx)
    return f'{sid}_fg.png' if fg else f'{sid}_label.png'

  def get_default_timespan(self):
    return TIMESPAN
