"""Offline dataset assembly: raw images -> HDF5 with PNG-encoded blobs.

Counterpart of ``rec_attend_tpu/data/assembler.py:40-122``
(``InsSegAssembler``), on the port's own codecs: ``utils/png.py`` for
cv2's PNG encoding and decoding, ``utils/image.py`` for ``cv2.resize`` and
``utils/h5.py`` for h5py.  The file holds, per example:

  <id>/input                     PNG, the image resized (cubic)
  <id>/input_full_size           PNG, the image at its own size
  <id>/label_segmentation/NN     PNG, instance mask NN resized (nearest)
  <id>/label_segmentation_full_size/NN
  <id>/label_semantic_segmentation{,_full_size}/NN
  <id>/orientation               PNG, the 8-bin orientation classes
  <id>/instance_semantic_classes [T] ints
  <id>/orig_size                 [2] ints
  index_map                      the ids, in the file's order

with the ids shuffled by ``RandomState(2)`` as JAX shuffles them, so the
JAX package's ``InsSegDataset`` reads the port's file to the arrays it
reads from its own, and the port's ``data/dataset.py`` reads either.  The
file is written once, one example in memory at a time (``h5.write``, or
``h5.update`` where it exists: JAX opens it in mode 'a', keeping what else
it holds).  Images are BGR, as ``cv2.imread`` gives them.
"""

from __future__ import annotations

import os
import time

import numpy as np

from rec_attend_tpu_torch.data.orientation import get_orientation
from rec_attend_tpu_torch.utils import h5
from rec_attend_tpu_torch.utils import logger
from rec_attend_tpu_torch.utils import png
from rec_attend_tpu_torch.utils.image import resize_u8


class InsSegAssembler:
  """Subclass and implement read_ids/get_str_id/get_image/get_segmentations.

  ``stats`` after ``assemble``: the seconds it took, the examples, the
  file's bytes and the most instances of an example."""

  def __init__(self, opt, output_fname):
    self.opt = opt
    self.log = logger.get()
    self.output_fname = output_fname
    self.img_ids = self.read_ids()
    random = np.random.RandomState(2)
    shuffle = np.arange(len(self.img_ids))
    random.shuffle(shuffle)
    self.img_ids = [self.img_ids[shuffle[i]]
                    for i in range(len(self.img_ids))]
    self.stats = {}

  def read_ids(self):
    raise NotImplementedError

  def get_str_id(self, img_id):
    raise NotImplementedError

  def get_image(self, img_id):
    raise NotImplementedError

  def get_segmentations(self, img_id):
    """Returns (instance masks T*[H,W] uint8, semantic masks C*[H,W] uint8
    (entries may be None), per-instance semantic class list)."""
    raise NotImplementedError

  def example(self, img_id):
    """The group of one example: {name: PNG bytes, array or group}."""
    inp_shape = (self.opt['width'], self.opt['height'])
    img = self.get_image(img_id)
    group = {'orig_size': np.array(img.shape[:2]),
             'input_full_size': png.encode(img)}
    segm, sem_segm, segm_sem_cls = self.get_segmentations(img_id)
    group['input'] = png.encode(resize_u8(img, inp_shape, 'cubic'))
    self.stats['max_num_obj'] = max(self.stats.get('max_num_obj', 0),
                                    len(segm))
    if len(segm) > 0:
      small = [resize_u8(ss, inp_shape, 'nearest') for ss in segm]
      group['label_segmentation'] = {f'{jj:02d}': png.encode(seg)
                                     for jj, seg in enumerate(small)}
      group['label_segmentation_full_size'] = {
          f'{jj:02d}': png.encode(ss) for jj, ss in enumerate(segm)}
      ori = get_orientation(np.stack(small)[None])[0]
      group['orientation'] = png.encode(ori)
    sem = {f'{jj:02d}': ss for jj, ss in enumerate(sem_segm)
           if ss is not None}
    if sem:
      group['label_semantic_segmentation'] = {
          k: png.encode(resize_u8(ss, inp_shape, 'nearest'))
          for k, ss in sem.items()}
      group['label_semantic_segmentation_full_size'] = {
          k: png.encode(ss) for k, ss in sem.items()}
    group['instance_semantic_classes'] = np.array(segm_sem_cls)
    return group

  def assemble(self):
    t0 = time.perf_counter()
    num_ex = len(self.img_ids)
    self.log.info(f'Writing {num_ex} examples to {self.output_fname}')
    tree = {self.get_str_id(i): (lambda i=i: self.example(i))
            for i in self.img_ids}
    tree['index_map'] = np.array([self.get_str_id(i).encode()
                                  for i in self.img_ids])
    if os.path.exists(self.output_fname):
      h5.update(self.output_fname, tree)
    else:
      os.makedirs(os.path.dirname(self.output_fname) or '.', exist_ok=True)
      h5.write(self.output_fname, tree)
    self.stats.update(seconds=time.perf_counter() - t0, examples=num_ex,
                      bytes=os.path.getsize(self.output_fname))
    self.log.info(f'Maximum number of objects: '
                  f'{self.stats.get("max_num_obj", 0)}')
    return self.output_fname
