"""Split a colour/id label image into per-instance binary masks.

A copy of ``rec_attend_tpu/data/sep_labels.py``, the port's own.  Same
contract as the reference's ``sep_labels.py``: multi-channel label images
are bit-packed into one 64-bit id per pixel (8/16/32 bits per
channel by dtype), id 0 is background, and every remaining unique id yields
one uint8 mask.  Implemented as a single broadcast comparison over the
unique-id axis rather than a per-colour python loop.
"""

from __future__ import annotations

import numpy as np

_CHANNEL_BITS = {'uint8': 8, 'uint16': 16, 'int32': 32, 'uint32': 32}


def pack_label_ids(label_img):
  """[H, W] or [H, W, C] label image -> [H, W] uint64 per-pixel ids."""
  if label_img.ndim == 2:
    return label_img.astype(np.uint64)
  bits = _CHANNEL_BITS.get(label_img.dtype.name)
  if bits is None:
    raise ValueError(f'Unknown dtype: {label_img.dtype}')
  n_ch = label_img.shape[2]
  shifts = (bits * np.arange(n_ch - 1, -1, -1)).astype(np.uint64)
  return (label_img.astype(np.uint64) << shifts).sum(
      axis=2, dtype=np.uint64)


def get_separate_labels(label_img):
  """Returns (list of [H, W] uint8 instance masks, list of int pixel ids)."""
  ids_img = pack_label_ids(label_img)
  ids = np.unique(ids_img)
  ids = ids[ids != 0]
  masks = (ids_img[None, :, :] == ids[:, None, None]).astype('uint8')
  return list(masks), [int(i) for i in ids]
