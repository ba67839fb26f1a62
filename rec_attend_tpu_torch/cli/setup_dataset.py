"""Dataset assembly: raw image folders -> the standard H5 files.

Counterpart of the root ``setup_dataset.py`` (the reference's
``setup_cvppp`` and ``setup_kitti``, minus the downloads: point --folder at
a dataset root already on disk), with the same flags, on the port's codecs
and without cv2 or h5py:

  python -m rec_attend_tpu_torch.cli.setup_dataset --dataset cvppp \\
      --folder data/cvppp/A1 --splits train,valid
  python -m rec_attend_tpu_torch.cli.setup_dataset --dataset kitti \\
      --folder data/kitti --splits train,valid,test

Each split goes to ``{folder}/{split}_{H}x{W}.h5``, the size by default
the dataset's (``config.DATASET_DIMS``).  Cityscapes is the next slice of
the port (ROADMAP A.5); the synthetic dataset needs no file (the port
draws it in memory, ``data/provider.py``): both raise.
"""

from __future__ import annotations

import argparse
import sys

from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.utils import logger


def main(argv=None):
  """Assemble each split; returns {split: the assembler's stats (seconds,
  examples, bytes, max_num_obj) and 'path'}."""
  parser = argparse.ArgumentParser(description='Assemble dataset H5 files')
  parser.add_argument('--dataset', required=True,
                      choices=['cvppp', 'kitti', 'cityscapes', 'synth'])
  parser.add_argument('--folder', required=True)
  parser.add_argument('--splits', default='train,valid')
  parser.add_argument('--height', default=None, type=int)
  parser.add_argument('--width', default=None, type=int)
  parser.add_argument('--coarse_label', action='store_true',
                      help='cityscapes: use gtCoarse annotations')
  parser.add_argument('--num_examples', default=64, type=int,
                      help='synth: examples per split')
  args = parser.parse_args(argv)
  log = logger.get()
  if args.dataset == 'cityscapes':
    raise NotImplementedError(
        'setup_dataset --dataset cityscapes: the Cityscapes assembler is '
        'the next slice of the port (ROADMAP A.5, Cityscapes)')
  if args.dataset == 'synth':
    raise ValueError(
        'setup_dataset --dataset synth: the port draws the synthetic '
        'splits in memory (data/provider.py) and writes no H5 file for '
        'them; pass --dataset synth to the train and pipeline command '
        'lines directly')

  dims = C.DATASET_DIMS[args.dataset]
  opt = {'height': args.height or dims['inp_height'],
         'width': args.width or dims['inp_width']}
  if args.dataset == 'cvppp':
    from rec_attend_tpu_torch.data.cvppp import CVPPPAssembler as cls
  else:
    from rec_attend_tpu_torch.data.kitti import KITTIAssembler as cls
  out = {}
  for split in args.splits.split(','):
    log.info(f'Assembling {args.dataset} {split}...')
    asm = cls(args.folder, opt, split=split)
    path = asm.assemble()
    out[split] = dict(asm.stats, path=path)
  return out


if __name__ == '__main__':
  main(sys.argv[1:])
