"""KITTI car instance dataset: its assembler and its reader.

Counterpart of ``rec_attend_tpu/data/kitti.py`` (ref data_api/kitti.py)
on the port's codecs.  The assembler reads ``images/NNNNNN.png``, the
colour-labelled instances of ``gt/NNNNNN.png`` (``gt_man/`` for the
``valid_man`` and ``test_man`` splits) and the ids of ``{split}.txt``, and
assembles the split into ``{split}_{H}x{W}.h5``.
"""

from __future__ import annotations

import os

from rec_attend_tpu_torch.data import sep_labels
from rec_attend_tpu_torch.data.assembler import InsSegAssembler
from rec_attend_tpu_torch.data.cvppp import semantic_union
from rec_attend_tpu_torch.data.dataset import InsSegDataset
from rec_attend_tpu_torch.utils import png

TIMESPAN = 20


class KITTIAssembler(InsSegAssembler):

  def __init__(self, folder, opt, split='train', output_fname=None):
    self.folder = folder
    self.split = split
    if output_fname is None:
      output_fname = os.path.join(
          folder, '{}_{}x{}.h5'.format(split, opt['height'], opt['width']))
    gt = 'gt_man' if split in ('valid_man', 'test_man') else 'gt'
    self.gt_folder = os.path.join(folder, gt)
    self.image_folder = os.path.join(folder, 'images')
    super().__init__(opt, output_fname)

  def read_ids(self):
    with open(os.path.join(self.folder, f'{self.split}.txt')) as f:
      return [int(l.strip()) for l in f]

  def get_str_id(self, img_id):
    return f'{img_id:06d}'

  def get_image(self, img_id):
    return png.imread(os.path.join(self.image_folder,
                                   f'{self.get_str_id(img_id)}.png'))

  def get_segmentations(self, img_id):
    gt_img = png.imread(os.path.join(self.gt_folder,
                                     f'{self.get_str_id(img_id)}.png'))
    segm, _ = sep_labels.get_separate_labels(gt_img)
    return segm, semantic_union(segm), [0] * len(segm)


class KITTI(InsSegDataset):

  def get_name(self):
    return 'kitti'

  def get_str_id(self, idx):
    s = str(idx)
    return f'{int(s):06d}' if s.isdigit() else s

  def get_fname(self, idx):
    return f'{self.get_str_id(idx)}.png'

  def get_default_timespan(self):
    return TIMESPAN
