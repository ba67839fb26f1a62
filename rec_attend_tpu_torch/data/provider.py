"""Datasets by name, and the fg model's predictions packed beside them.

Counterpart of ``rec_attend_tpu/data/provider.py:17-77``.  For 'synth' it
builds the split that the JAX provider generates into its H5 file, here as
an in-memory ``data.synthetic.SyntheticDataset``: seeds 3, 4 and 5 for the
train, valid and test splits (6 for any other), ``num_examples`` images in
the train split and a quarter of that, at least 8, in the others, the
``DataConfig``'s size, timespan, ``max_objects`` and
``num_semantic_classes``.  The images are the port's draws, not those of
the JAX package's files (see ``data/synthetic.py``); a JAX synthetic H5
file named by ``h5_fname`` is read as it is (``data.synthetic
.SyntheticH5``).

'cvppp', 'kitti' and 'cityscapes' read the assembled split
``{folder}/{split}_{H}x{W}.h5`` (or ``h5_fname``) of ``data/cvppp.py``,
``data/kitti.py`` and ``data/cityscapes.py``, the folder by default
``DEFAULT_FOLDERS``' (the CVPPP test split's own), as the JAX provider
does (``provider.py:17-30``, ``:72-77``); the fg and the full model's maps
are packed into that file (``data/dataset.py``'s ``pack_predictions``),
where the dataset reads them.

The pack store.  The JAX package writes the fg model's foreground and
orientation maps into the split's H5 file as uint8 PNGs,
``(np.clip(a, 0, 1) * 255).astype('uint8')``, which truncates
(``data/dataset.py:264-298``), and its dataset reads them back as
``uint8 / 255`` under 'y_out' and 'd_out' (``:235-245``), where the box
and the full model's runs find them, perhaps in another process.  Here the
same bytes go into one numpy file per split, ``{folder}/{split}_{H}x{W}
.pack.npz`` beside where JAX keeps the split's H5 (the folder
``data/synth`` by default), with the example ids and the generation
settings that JAX keeps in the H5's ``.meta.json``.  ``get`` returns a
``PackedDataset`` of the split where that file exists and its settings are
the ``DataConfig``'s; a file with other settings is stale (JAX regenerates
its H5 then, and the packed maps are lost): it is ignored, with a warning,
and the bare split comes back, until a pack for these settings replaces
it.  Nothing is cached between calls, so a re-pack is seen.

The full model's pack (JAX ``cli/pack.py:57-83``) writes its instance maps
into the same H5 file beside the fg model's, as uint8 PNGs quantised as
those are, and its scores as float32 (``data/dataset.py:290-298``); here
they go into the split's pack file beside the fg model's maps, as
'y_out_ins' [N,T,H,W] uint8 and 's_out' [N,T] float32, and ``get`` hands
them on in its ``PackedDataset``.

    write_pack(pack_path(data_cfg, 'valid'), ids, d_out, y_out,
               settings(data_cfg, 'valid'))
    packed = get('synth', data_cfg, split='valid')   # a PackedDataset
    write_pack(pack_path(data_cfg, 'valid'), ids, d_out, y_out,
               settings(data_cfg, 'valid'), y_out_ins=y_ins, s_out=s)
"""

from __future__ import annotations

import json
import os

import numpy as np

from rec_attend_tpu_torch.data.dataset import PACKED
from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
from rec_attend_tpu_torch.utils import h5
from rec_attend_tpu_torch.utils import logger

SPLIT_SEEDS = {'train': 3, 'valid': 4, 'test': 5}
H5_DATASETS = ('cvppp', 'kitti', 'cityscapes')
DEFAULT_FOLDERS = {
    'cvppp': 'data/cvppp/A1',
    'cvppp_test': 'data/cvppp_test/A1',
    'kitti': 'data/kitti',
    'cityscapes': 'data/cityscapes',
    'synth': 'data/synth',
}

# uint8 -> float32 as the JAX dataset reads a packed PNG (a float32 division
# by 255), as a table: the same values on the card and on the host.
_DECODE = np.arange(256, dtype=np.float32) / 255


class PackedDataset:
  """A dataset with packed predictions: its ``get_batch`` adds to the
  underlying dataset's batch the fg model's 'd_out' [b,H,W,8] and 'y_out'
  [b,H,W,C] and, where the full model's are packed, 'y_out_ins' [b,T,H,W]
  (float32, read from the uint8 maps as the JAX dataset does) and 's_out'
  [b,T]."""

  def __init__(self, dataset, d_out, y_out, y_out_ins=None, s_out=None):
    self.dataset = dataset
    self.d_out = d_out            # [N,H,W,8] uint8, in the dataset's order
    self.y_out = y_out            # [N,H,W,C] uint8
    self.y_out_ins = y_out_ins    # [N,T,H,W] uint8 or None
    self.s_out = s_out            # [N,T] float32 or None

  def get_dataset_size(self):
    return self.dataset.get_dataset_size()

  def get_batch(self, idx, timespan=None, variables=None):
    """The underlying batch and the packed maps of the examples at
    positions ``idx``; only those named in ``variables`` where it is
    given."""
    idx = np.asarray(idx)
    # A dataset of the eval path may take no ``variables``.
    kw = {} if variables is None else {'variables': variables}
    batch = dict(self.dataset.get_batch(idx, timespan=timespan, **kw))
    packed = {'d_out': self.d_out, 'y_out': self.y_out}
    if self.y_out_ins is not None:
      packed['y_out_ins'] = self.y_out_ins
    for key, maps in packed.items():
      if variables is None or key in variables:
        batch[key] = _DECODE[maps[idx]]
    if self.s_out is not None and (variables is None or 's_out' in variables):
      batch['s_out'] = self.s_out[idx]
    return batch

  def get_full_size_labels(self, ids, timespan=None):
    return self.dataset.get_full_size_labels(ids, timespan=timespan)

  def get_fname(self, idx):
    return self.dataset.get_fname(idx)


def _opt(data_opt):
  return data_opt if isinstance(data_opt, dict) else data_opt.to_dict()


def settings(data_opt, split):
  """The generation settings of a synthetic split, as the JAX provider
  writes them into its ``.meta.json`` (``provider.py:38-50``)."""
  opt = _opt(data_opt)
  num = int(opt.get('num_examples', 32) or 32)
  if split != 'train':
    num = max(num // 4, 8)
  gen = dict(num_examples=num, seed=SPLIT_SEEDS.get(split, 6),
             max_objects=int(opt.get('max_objects', 4) or 4))
  nsc = int(opt.get('num_semantic_classes', 1) or 1)
  if nsc > 1:
    gen['num_semantic_classes'] = nsc
  return gen


def pack_path(data_opt, split):
  """``{folder}/{split}_{H}x{W}.pack.npz``, the pack file of a split."""
  opt = _opt(data_opt)
  folder = opt.get('folder') or DEFAULT_FOLDERS['synth']
  return os.path.join(folder, '{}_{}x{}.pack.npz'.format(
      split, opt['height'], opt['width']))


def write_pack(path, ids, d_out, y_out, gen, y_out_ins=None, s_out=None):
  """Write a split's packed maps (uint8 'd_out' [N,H,W,8] and 'y_out'
  [N,H,W,C] of the fg model and, where given, the full model's uint8
  'y_out_ins' [N,T,H,W] and float32 's_out' [N,T], in the order of
  ``ids``) with its generation settings ``gen``; the file is replaced
  whole, so a reader in another process sees the old file or the new one.
  Returns the bytes written."""
  arrays = {'d_out': (d_out, np.uint8), 'y_out': (y_out, np.uint8)}
  if (y_out_ins is None) != (s_out is None):
    raise ValueError('the full model\'s pack holds y_out_ins and s_out')
  if y_out_ins is not None:
    arrays.update(y_out_ins=(y_out_ins, np.uint8), s_out=(s_out, np.float32))
  for name, (maps, dtype) in arrays.items():
    if maps.dtype != dtype or len(maps) != len(ids):
      raise ValueError(f'{name}: {maps.dtype} {maps.shape} for {len(ids)} '
                       f'ids; the pack holds {np.dtype(dtype)} arrays, one '
                       'an example')
  os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
  tmp = f'{path}.{os.getpid()}.tmp'
  with open(tmp, 'wb') as f:
    np.savez(f, ids=np.asarray(ids, dtype=str),
             settings=np.array(json.dumps(gen, sort_keys=True)),
             **{k: v for k, (v, _) in arrays.items()})
  os.replace(tmp, path)
  return os.path.getsize(path)


def read_settings(path):
  """The generation settings a pack file was written for."""
  with np.load(path) as f:
    return json.loads(str(f['settings']))


def has_pack(data_opt, split):
  """Whether the fg model's maps are packed for the split: for 'synth',
  whether its pack file exists and was written for the ``DataConfig``'s
  settings; for the H5 datasets, whether every example of its file holds
  them."""
  opt = _opt(data_opt)
  path = pack_location(opt, split)
  if opt.get('dataset') in H5_DATASETS:
    if not os.path.exists(path):
      return False
    ds = get(opt['dataset'], opt, split=split)
    with h5.File(path) as f:
      return all(all(k in f[ds.get_str_id(i)] for _, k in PACKED)
                 for i in ds.img_ids)
  return os.path.exists(path) and read_settings(path) == settings(opt, split)


def pack_location(data_opt, split):
  """Where the fg model's maps of a split are packed: the split's H5 file
  for the H5 datasets, its pack file for 'synth'."""
  opt = _opt(data_opt)
  if opt.get('dataset') in H5_DATASETS:
    return h5_path(opt['dataset'], opt, split)
  return pack_path(opt, split)


def h5_path(dataset_name, data_opt, split):
  """``{folder}/{split}_{H}x{W}.h5``, the assembled file of a split, the
  folder by default the dataset's in ``DEFAULT_FOLDERS``."""
  opt = _opt(data_opt)
  folder = opt.get('folder')
  if folder is None:
    key = ('cvppp_test' if dataset_name == 'cvppp' and split == 'test'
           else dataset_name)
    folder = DEFAULT_FOLDERS[key]
  return os.path.join(folder, '{}_{}x{}.h5'.format(
      split, opt['height'], opt['width']))


def get(dataset_name, data_opt, split='train', h5_fname=None):
  """The ``split`` of ``dataset_name``; ``data_opt`` is a ``DataConfig``
  or its dict.  'cvppp', 'kitti' and 'cityscapes': the dataset of the
  split's H5 file
  (``h5_fname``, else ``h5_path``).  'synth': a ``PackedDataset`` where the
  split's pack file holds the fg model's maps for these settings (and the
  full model's, where packed), else the in-memory split; with
  ``h5_fname``, that JAX synthetic H5 file."""
  opt = _opt(data_opt)
  if dataset_name in H5_DATASETS:
    if dataset_name == 'cvppp':
      from rec_attend_tpu_torch.data.cvppp import CVPPP as cls
    elif dataset_name == 'kitti':
      from rec_attend_tpu_torch.data.kitti import KITTI as cls
    else:
      from rec_attend_tpu_torch.data.cityscapes import Cityscapes as cls
    path = h5_fname or h5_path(dataset_name, opt, split)
    if not os.path.exists(path):
      raise FileNotFoundError(
          f'{path}: no assembled {dataset_name} {split!r} split; run '
          f'python -m rec_attend_tpu_torch.cli.setup_dataset --dataset '
          f'{dataset_name} --folder <its folder> --splits {split}')
    return cls(path)
  if dataset_name != 'synth':
    raise ValueError(f'Unknown dataset name: {dataset_name}')
  if h5_fname is not None:
    from rec_attend_tpu_torch.data.synthetic import SyntheticH5
    return SyntheticH5(h5_fname, num_semantic_classes=int(
        opt.get('num_semantic_classes', 1) or 1))
  gen = settings(opt, split)
  ds = SyntheticDataset(
      gen['num_examples'], opt['height'], opt['width'], opt['timespan'],
      seed=gen['seed'], max_objects=gen['max_objects'],
      num_semantic_classes=int(opt.get('num_semantic_classes', 1) or 1))
  path = pack_path(opt, split)
  if not os.path.exists(path):
    return ds
  if not has_pack(opt, split):
    logger.get().warning(
        f'Ignoring {path}: generation knobs changed ({read_settings(path)} '
        f'-> {gen}); its packed predictions are stale')
    return ds
  with np.load(path) as f:
    if not np.array_equal(f['ids'], ds.img_ids):
      raise ValueError(f'{path}: its ids are not those of the split')
    full = ({'y_out_ins': f['y_out_ins'], 's_out': f['s_out']}
            if 'y_out_ins' in f.files else {})
    return PackedDataset(ds, f['d_out'], f['y_out'], **full)
