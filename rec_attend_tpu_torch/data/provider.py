"""Datasets by name.

Counterpart of ``rec_attend_tpu/data/provider.py:17-77``.  For 'synth' it
builds the split that the JAX provider generates into its H5 file, here as
an in-memory ``data.synthetic.SyntheticDataset``: seeds 3, 4 and 5 for the
train, valid and test splits (6 for any other), ``num_examples`` images in
the train split and a quarter of that, at least 8, in the others, the
``DataConfig``'s size, timespan, ``max_objects`` and
``num_semantic_classes``.  The images are the port's draws, not those of
the JAX package's files (see ``data/synthetic.py``).  The datasets read
from H5 files (CVPPP, KITTI, Cityscapes) need h5py and PNG decoding, which
the card's machine lacks: they are ROADMAP A.4's data item, and asking for
them raises.
"""

from __future__ import annotations

from rec_attend_tpu_torch.data.synthetic import SyntheticDataset

SPLIT_SEEDS = {'train': 3, 'valid': 4, 'test': 5}


def get(dataset_name, data_opt, split='train', h5_fname=None):
  """The ``split`` of ``dataset_name``; ``data_opt`` is a ``DataConfig``
  or its dict.  ``h5_fname`` names a JAX H5 file, which is not read."""
  opt = data_opt if isinstance(data_opt, dict) else data_opt.to_dict()
  if dataset_name != 'synth':
    raise NotImplementedError(
        f'dataset {dataset_name!r}: the H5 datasets and their assemblers '
        'are not ported yet (ROADMAP A.4, data)')
  if h5_fname is not None:
    raise NotImplementedError(f'{h5_fname}: H5 files are not read yet '
                              '(ROADMAP A.4, data)')
  num = int(opt.get('num_examples', 32) or 32)
  if split != 'train':
    num = max(num // 4, 8)
  return SyntheticDataset(
      num, opt['height'], opt['width'], opt['timespan'],
      seed=SPLIT_SEEDS.get(split, 6),
      max_objects=int(opt.get('max_objects', 4) or 4),
      num_semantic_classes=int(opt.get('num_semantic_classes', 1) or 1))
