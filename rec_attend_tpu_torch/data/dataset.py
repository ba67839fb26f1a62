"""Runtime H5 dataset reader and the packed predictions written back.

Counterpart of ``rec_attend_tpu/data/dataset.py:24-298`` on the port's
own codecs (``utils/h5.py``, ``utils/png.py``): decodes the requested
variables of the assembler's files into dense numpy arrays with the same
semantics, instances sorted by area, largest first, with numpy's
``argsort(area)[::-1]`` (its default sort: ties decide the slots, and
``torch.sort`` breaks them otherwise) and truncated to the timespan, s_gt
the first k ones, semantic one-hots with a background channel, 8-bin
orientation one-hots, and the packed predictions ('y_out' from
``foreground_pred``, 'd_out' from ``orientation_pred``, 'y_out_ins' from
``instance_pred``, 's_out' from ``score_pred``) read as ``uint8 / 255``.
A bounded, thread-safe cache keeps decoded PNGs; ``clear_cache`` drops it
after a pack.

``pack_predictions`` writes a split's predictions into its file as the
JAX package's does (``:264-298``), quantised by ``(np.clip(a, 0, 1) * 255)
.astype('uint8')``, but for many examples at once: JAX opens the file once
per example in mode 'a'; here the file is rewritten once for the whole
split (``h5.update``: a temporary file, then a rename).

    ds = KITTI('data/kitti/valid_128x448.h5')
    batch = ds.get_batch([0, 1], variables={'x', 'y_gt', 's_gt'})
    pack_predictions(ds.h5_fname, {sid: {'foreground': y, 'orientation': d}})
    ds.clear_cache()
"""

from __future__ import annotations

import os
import threading

import numpy as np

from rec_attend_tpu_torch.utils import h5
from rec_attend_tpu_torch.utils import logger
from rec_attend_tpu_torch.utils import png

NUM_ORI_CLASSES = 8
DEFAULT_VARIABLES = frozenset({'x', 'y_gt', 'c_gt', 'd_gt', 's_gt',
                               'idx_map'})
# The packed maps that a batch of default variables carries where the
# file holds them: (variable, the group they are packed under).
PACKED = (('y_out', 'foreground_pred'), ('d_out', 'orientation_pred'))


class InsSegDataset:

  def __init__(self, h5_fname, cache_bytes=512 << 20):
    self.log = logger.get()
    self.h5_fname = h5_fname
    self.img_ids = self._read_ids()
    # Decoded-PNG cache: arrays are stored read-only; callers copy via
    # astype().
    self._cache = {}
    self._cache_bytes = 0
    self._cache_cap = cache_bytes
    self._cache_lock = threading.Lock()

  def _dec(self, h5f, path, flags=png.IMREAD_UNCHANGED):
    """png.decode with a bounded, thread-safe, read-only cache."""
    hit = self._cache.get(path)
    if hit is not None:
      return hit
    arr = png.decode(h5f[path], flags, path=f'{self.h5_fname}:{path}')
    with self._cache_lock:
      if (self._cache_cap and path not in self._cache
          and self._cache_bytes + arr.nbytes <= self._cache_cap):
        arr.setflags(write=False)
        self._cache[path] = arr
        self._cache_bytes += arr.nbytes
    return arr

  def clear_cache(self):
    """Drop cached decodes (call after packing predictions back into the
    H5 so re-reads see the new data)."""
    with self._cache_lock:
      self._cache = {}
      self._cache_bytes = 0

  def _read_ids(self):
    with h5.File(self.h5_fname) as h5f:
      idx = h5f['index_map']
    return np.array([i.decode() if isinstance(i, bytes) else str(i)
                     for i in idx])

  def get_name(self):
    return 'unknown'

  def get_str_id(self, idx):
    return str(idx)

  def get_fname(self, idx):
    """Output image filename for renderers (overridden per dataset)."""
    return f'{self.get_str_id(idx)}.png'

  def get_dataset_size(self):
    return len(self.img_ids)

  def get_default_timespan(self):
    raise NotImplementedError

  def get_num_semantic_classes(self):
    return 1

  def get_full_size_labels(self, img_ids, timespan=None):
    """Full-resolution GT masks, area-unsorted: a list of [timespan, H_i,
    W_i] float64 arrays (sizes vary per image)."""
    if timespan is None:
      timespan = self.get_default_timespan()
    out = []
    with h5.File(self.h5_fname) as h5f:
      for ii in img_ids:
        group = h5f[self.get_str_id(ii)]
        if 'label_segmentation_full_size' in group:
          seg_group = group['label_segmentation_full_size']
          num_obj = len(seg_group.keys())
          y_full = None
          for jj in range(min(num_obj, timespan)):
            seg = png.decode(seg_group[f'{jj:02d}'], png.IMREAD_GRAYSCALE,
                             path=self.h5_fname).astype('float32')
            if y_full is None:
              y_full = np.zeros([timespan, seg.shape[0], seg.shape[1]])
            y_full[jj] = seg
          out.append(y_full)
        else:
          out.append(np.zeros([timespan] + list(group['orig_size'])))
    return out

  def get_batch(self, idx, timespan=None, variables=None):
    """Decode a mini-batch.  idx: sequence of positions into the id list.

    ``variables`` None: 'x', 'y_gt', 'c_gt', 'd_gt', 's_gt', 'idx_map',
    and 'y_out' and 'd_out' where the first example's group holds them
    (JAX asks for those two always, and raises before a pack)."""
    if timespan is None:
      timespan = self.get_default_timespan()
    num_sem = self.get_num_semantic_classes()
    nc = 1 if num_sem == 1 else num_sem + 1

    with h5.File(self.h5_fname) as h5f:
      img_ids = self.img_ids[np.asarray(idx)]
      if variables is None:
        first = h5f[self.get_str_id(img_ids[0])] if len(img_ids) else {}
        variables = DEFAULT_VARIABLES | {v for v, key in PACKED
                                         if key in first}
      num_ex = len(idx)
      results = {}
      created = False
      for kk, ii in enumerate(img_ids):
        group = h5f[self.get_str_id(ii)]
        gname = group.name
        x = self._dec(h5f, f'{gname}/input')
        h, w = x.shape[0], x.shape[1]
        d = x.shape[2] if x.ndim == 3 else 1
        area_sort = None

        if not created:
          if 'source' in group:
            results['source'] = []
          shapes = {
              'x': (num_ex, h, w, d), 'y_gt': (num_ex, timespan, h, w),
              'y_out_ins': (num_ex, timespan, h, w),
              'c_gt': (num_ex, h, w, nc),
              'c_gt_idx': (num_ex, timespan, nc),
              'd_gt': (num_ex, h, w, NUM_ORI_CLASSES),
              'y_out': (num_ex, h, w, nc),
              'd_out': (num_ex, h, w, NUM_ORI_CLASSES),
              's_out': (num_ex, timespan), 's_gt': (num_ex, timespan),
          }
          for name, shape in shapes.items():
            if name in variables:
              results[name] = np.zeros(shape, dtype='float32')
          if 'orig_size' in variables:
            results['orig_size'] = np.zeros([num_ex, 2], dtype='int32')
          for name in ('x_full', 'y_gt_full'):
            if name in variables:
              if num_ex > 1:
                raise ValueError(
                    f'{name} can only be provided in batch_size=1 mode')
              results[name] = None
          created = True

        if 'x' in variables:
          results['x'][kk] = x.reshape(h, w, d).astype('float32') / 255

        if 'x_full' in variables and 'input_full_size' in group:
          results['x_full'] = png.decode(
              group['input_full_size'], png.IMREAD_UNCHANGED,
              path=self.h5_fname).astype('float32') / 255

        if 'y_gt' in variables and 'label_segmentation' in group:
          seg_group = group['label_segmentation']
          num_obj = len(seg_group.keys())
          segs = [self._dec(h5f, f'{seg_group.name}/{jj:02d}')
                  for jj in range(num_obj)]
          area = np.array([int(s.sum()) for s in segs])
          area_sort = np.argsort(area)[::-1]
          for jj in range(min(num_obj, timespan)):
            results['y_gt'][kk, jj] = segs[area_sort[jj]]

        if 'y_gt_full' in variables:
          if 'label_segmentation_full_size' in group:
            seg_group = group['label_segmentation_full_size']
            num_obj = len(seg_group.keys())
            segs = [png.decode(seg_group[f'{jj:02d}'], png.IMREAD_UNCHANGED,
                               path=self.h5_fname).astype('float32')
                    for jj in range(num_obj)]
            area_sort_full = np.argsort([s.sum() for s in segs])[::-1]
            results['y_gt_full'] = np.zeros(
                [timespan, segs[0].shape[0], segs[0].shape[1]])
            for jj in range(min(num_obj, timespan)):
              results['y_gt_full'][jj] = segs[area_sort_full[jj]]
          elif 'orig_size' in group:
            results['y_gt_full'] = np.zeros(
                [timespan] + list(group['orig_size']))

        if 'y_out_ins' in variables:
          if 'instance_pred' not in group:
            raise KeyError('Key not found: instance_pred')
          g = group['instance_pred']
          for jj in range(len(g.keys())):
            results['y_out_ins'][kk, jj] = self._dec(
                h5f, f'{g.name}/{jj:02d}').astype('float32') / 255

        if 'c_gt' in variables and 'label_semantic_segmentation' in group:
          g = group['label_semantic_segmentation']
          if num_sem > 1:
            for jj in range(num_sem):
              cstr = f'{jj:02d}'
              if cstr in g:
                results['c_gt'][kk, :, :, jj + 1] = self._dec(
                    h5f, f'{g.name}/{cstr}').astype('float32')
            results['c_gt'][kk, :, :, 0] = 1 - results['c_gt'][kk].max(axis=2)
          else:
            results['c_gt'][kk, :, :, 0] = self._dec(
                h5f, f'{g.name}/00').astype('float32')

        if 'c_gt_idx' in variables and 'instance_semantic_classes' in group:
          c_gt_idx = group['instance_semantic_classes']
          num_obj = len(c_gt_idx)
          if num_obj > 0 and area_sort is not None:
            c_gt_idx = c_gt_idx[area_sort]
          for jj in range(min(num_obj, timespan)):
            results['c_gt_idx'][kk, jj, c_gt_idx[jj] + 1] = 1.0
          for jj in range(num_obj, timespan):
            results['c_gt_idx'][kk, jj, 0] = 1.0

        if 'd_gt' in variables and 'orientation' in group:
          ori = self._dec(h5f, f'{gname}/orientation').astype('float32')
          for oo in range(NUM_ORI_CLASSES):
            results['d_gt'][kk, :, :, oo] = (ori == oo).astype('float32')

        if 's_gt' in variables and 'label_segmentation' in group:
          num_obj = len(group['label_segmentation'].keys())
          results['s_gt'][kk, :min(num_obj, timespan)] = 1.0

        if 'd_out' in variables:
          for oo in range(NUM_ORI_CLASSES):
            arr = self._dec(h5f, f'{gname}/orientation_pred/{oo:02d}')
            results['d_out'][kk, :, :, oo] = arr.astype('float32') / 255

        if 'y_out' in variables:
          for cc in range(nc):
            key = f'foreground_pred/{cc:02d}'
            if nc == 1 and key not in group:
              key = 'foreground_pred'
            results['y_out'][kk, :, :, cc] = self._dec(
                h5f, f'{gname}/{key}').astype('float32') / 255

        if 's_out' in variables:
          results['s_out'][kk] = group['score_pred']

        if 'source' in group and 'source' in results:
          src = group['source'][0]
          results['source'].append(
              src.decode() if isinstance(src, bytes) else src)

        if 'orig_size' in variables:
          results['orig_size'][kk] = group['orig_size']

      if 'idx_map' in variables:
        results['idx_map'] = img_ids
    return results


def quantise(a):
  """[...] floats in [0, 1] -> uint8 as the JAX pack writes them,
  ``(np.clip(a, 0, 1) * 255).astype('uint8')``; uint8 maps pass as they
  are (``cli.pack.quantise`` made them so on the card)."""
  a = np.asarray(a)
  if a.dtype == np.uint8:
    return a
  return (np.clip(a, 0, 1) * 255).astype('uint8')


def packed_group(foreground=None, orientation=None, instance=None,
                 score=None):
  """The entries that ``pack_predictions`` writes into one example's
  group: foreground [H, W] or [H, W, C] and orientation [H, W, 8] maps,
  instance maps [T, H, W] (floats in [0, 1] or uint8 already quantised)
  and scores [T]."""
  out = {}
  if foreground is not None:
    fg = quantise(foreground)
    if fg.ndim == 2:
      fg = fg[:, :, None]
    out['foreground_pred'] = {f'{cc:02d}': png.encode(fg[:, :, cc])
                              for cc in range(fg.shape[2])}
  if orientation is not None:
    ori = quantise(orientation)
    out['orientation_pred'] = {f'{oo:02d}': png.encode(ori[:, :, oo])
                               for oo in range(ori.shape[2])}
  if instance is not None:
    ins = quantise(instance)
    out['instance_pred'] = {f'{jj:02d}': png.encode(ins[jj])
                            for jj in range(ins.shape[0])}
  if score is not None:
    out['score_pred'] = np.asarray(score, dtype='float32')
  return out


def write_packed(h5_fname, groups):
  """Write {str_id: the entries of ``packed_group``} into the dataset H5 in
  one rewrite: each map replaces the one of its name, the others stay.
  Returns the file's bytes."""
  h5.update(h5_fname, groups)
  return os.path.getsize(h5_fname)


def pack_predictions(h5_fname, examples):
  """Write predictions back into the dataset H5 (the message-bus pattern:
  ref fg_model_pack.py:25-50, full_model_pack.py:35-57), one rewrite for
  all of ``examples``: {str_id: {'foreground', 'orientation', 'instance',
  'score': arrays, as ``packed_group`` takes them}}.  Returns the file's
  bytes."""
  return write_packed(h5_fname, {sid: packed_group(**maps)
                                 for sid, maps in examples.items()})
