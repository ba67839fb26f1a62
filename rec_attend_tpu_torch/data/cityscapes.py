"""The Cityscapes instance dataset: its assembler and its reader.

Counterpart of ``rec_attend_tpu/data/cityscapes.py`` (ref
data_api/cityscapes.py) on the port's codecs.  The assembler walks the
cities of ``leftImg8bit/{split}`` (``leftImg8bit_trainextra/leftImg8bit``
for ``train_extra``; the ``valid`` split reads the ``val`` folders) and
decodes each image's 16-bit ``{id}_gtFine_instanceIds.png`` (``gtCoarse``
with ``coarse_label``): an id over 1000 is ``class id * 1000 + n``, and
the classes of the 8 instance trainIds (person ... bicycle) are kept, each
instance with its class and each class's union of instances as its
semantic mask.  A missing ground-truth file only warns: the image has no
instances (the test split's case).  The split goes to
``{split}_{H}x{W}.h5``.

The reader names an example's output file ``{id}_gtFine_instanceIds.png``,
has 8 semantic classes and a timespan of 20, and weighs each example's
semantic and orientation losses by its 'source' where the file holds one
(0.1 and 0 for ``train_extra``'s coarse labels, 1 and 1 for ``train`` and
``valid``).
"""

from __future__ import annotations

import os

import numpy as np

from rec_attend_tpu_torch.data import sep_labels
from rec_attend_tpu_torch.data.assembler import InsSegAssembler
from rec_attend_tpu_torch.data.cityscapes_labels import id2label
from rec_attend_tpu_torch.data.dataset import InsSegDataset
from rec_attend_tpu_torch.utils import png

NUM_SEMANTIC_CLASSES = 8
TIMESPAN = 20


class CityscapesAssembler(InsSegAssembler):

  def __init__(self, folder, opt, split='train', output_fname=None,
               coarse_label=False):
    self.folder = folder
    self.split = split
    if output_fname is None:
      output_fname = os.path.join(
          folder, '{}_{}x{}.h5'.format(split, opt['height'], opt['width']))
    splitname = 'val' if split == 'valid' else split
    img_folder = ('leftImg8bit_trainextra/leftImg8bit'
                  if split == 'train_extra' else 'leftImg8bit')
    self.gt_subfolder = 'gtCoarse' if coarse_label else 'gtFine'
    self.gt_folder = os.path.join(folder, self.gt_subfolder, splitname)
    self.image_folder = os.path.join(folder, img_folder, splitname)
    super().__init__(opt, output_fname)

  def read_ids(self):
    if not os.path.isdir(self.image_folder):
      raise FileNotFoundError(f'{self.image_folder}: no images of the '
                              f'cityscapes {self.split!r} split')
    image_ids = []
    for run in sorted(os.listdir(self.image_folder)):
      run_folder = os.path.join(self.image_folder, run)
      image_ids.extend(f.split('_leftImg8bit.png')[0]
                       for f in sorted(os.listdir(run_folder)))
    return image_ids

  def get_str_id(self, img_id):
    return img_id

  def get_image(self, img_id):
    run = img_id.split('_')[0]
    return png.imread(os.path.join(self.image_folder, run,
                                   img_id + '_leftImg8bit.png'))

  def get_segmentations(self, img_id):
    run = img_id.split('_')[0]
    fname = os.path.join(self.gt_folder, run,
                         f'{img_id}_{self.gt_subfolder}_instanceIds.png')
    try:
      gt_img = png.imread(fname, png.IMREAD_UNCHANGED)
    except FileNotFoundError:
      self.log.warning(f'GT image does not exist: {fname}')
      segm, colors = [], []
    else:
      segm, colors = sep_labels.get_separate_labels(gt_img)
    sem_segm = [None] * NUM_SEMANTIC_CLASSES
    segm_final = []
    segm_sem_cls = []
    for ss, cc in zip(segm, colors):
      if cc > 1000:
        label = id2label[int(cc) // 1000]
        if label.trainId > 0:
          segm_final.append(ss)
          k = label.trainId - 1
          sem_segm[k] = ss if sem_segm[k] is None else np.maximum(
              sem_segm[k], ss)
          segm_sem_cls.append(k)
    return segm_final, sem_segm, segm_sem_cls


class Cityscapes(InsSegDataset):

  def get_name(self):
    return 'cityscapes'

  def get_fname(self, idx):
    return f'{self.get_str_id(idx)}_gtFine_instanceIds.png'

  def get_num_semantic_classes(self):
    return NUM_SEMANTIC_CLASSES

  def get_default_timespan(self):
    return TIMESPAN

  def get_batch(self, idx, timespan=None, variables=None):
    """The batch of ``data/dataset.py`` with 'sem_weights' and
    'ori_weights' [b] from each example's 'source' (ones without)."""
    batch = super().get_batch(idx, timespan=timespan, variables=variables)
    sem_weights = np.ones(len(idx))
    ori_weights = np.ones(len(idx))
    for kk, src in enumerate(batch.get('source', ())):
      if src == 'train_extra':
        sem_weights[kk], ori_weights[kk] = 0.1, 0.0
      elif src not in ('train', 'valid'):
        raise ValueError(f'Unknown data source "{src}"')
    batch['sem_weights'] = sem_weights
    batch['ori_weights'] = ori_weights
    return batch
