"""The port's H5 datasets (``rec_attend_tpu_torch/data/{assembler,dataset,
cvppp,kitti,provider}.py``, ``cli/setup_dataset.py``) against the JAX
package's, in both directions, on layout fixtures built as
``tests/test_dataset_fixtures.py`` builds them (this file's own copy of its
helpers: cv2 ellipses, cv2-written PNGs, and palette-indexed CVPPP labels
written with PIL).

1. The port assembles a CVPPP and a KITTI folder; the JAX package's
   dataset reads the port's files to the port's arrays, exactly, for every
   variable (x, y_gt, c_gt, d_gt, s_gt, orig_size, idx_map, y_gt_full,
   x_full, get_full_size_labels; c_gt_idx raises in both for one class).
2. The JAX package assembles the same folders; the port reads its files to
   JAX's arrays, exactly.  The two files hold the same objects and the same
   pixels but for the cubic resize's pinned residual (``test_torch_png.py``):
   x differs in at most 2 values, by 1/255.  The CVPPP split files are
   JAX's.  c_gt_idx is held on a JAX file of two classes.
3. Packs: the port's ``pack_predictions`` (one rewrite for a split) and
   JAX's (one per example) write files that both packages read to the same
   maps, 'y_out', 'd_out', 'y_out_ins' and 's_out', bit for bit, maps of
   every k/255, the floats between and values outside [0, 1] included.
4. The provider: the JAX file names and default folders, Cityscapes and
   the synthetic H5 command line raise, the synthetic H5 of JAX reads; the
   committed JAX-written split has ``chip_smoke.JAX_SYNTH_DIGEST`` in the
   JAX package's reader and in the port's.
5. ``chip_smoke.py``'s ``cvppp_pipeline`` and ``kitti_pipeline`` phases
   with the tiny models (``_small_h5_models.py``) on the CPU: every gate
   passes and every control fails.
6. (``slow``) the CVPPP layout at its real size, 128 plants at 530x500,
   assembled by both packages and read both ways.
"""

import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from rec_attend_tpu.data import dataset as jdataset
from rec_attend_tpu.data import provider as jprovider
from rec_attend_tpu.data.synthetic import Synthetic as JSynthetic
from rec_attend_tpu.data.synthetic import make_synthetic_h5
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.cli import setup_dataset
from rec_attend_tpu_torch.data import dataset as pdataset
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.data.synthetic import SyntheticH5
from rec_attend_tpu_torch.utils import h5
from rec_attend_tpu_torch.utils import png

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402
from _small_h5_models import small_models  # noqa: E402
import setup_dataset as jsetup  # noqa: E402
from rec_attend_tpu_torch.ops.cuda import glimpse as gk  # noqa: E402

VARIABLES = {'x', 'y_gt', 'c_gt', 'd_gt', 's_gt', 'orig_size', 'idx_map'}
SIZES = {'cvppp': (32, 32), 'kitti': (32, 96)}
SPLITS = {'cvppp': ('train', 'valid'), 'kitti': ('train', 'valid')}


def _ellipse(h, w, cy, cx, ry, rx, value=1, img=None, dtype=np.uint8):
  m = np.zeros((h, w), dtype) if img is None else img
  cv2.ellipse(m, (cx, cy), (rx, ry), 0, 0, 360, int(value), -1)
  return m


def _cvppp_folder(folder, count=6, h=48, w=40, seed=0):
  """plantNNN_{rgb,label,fg}.png: leaves as colours, the labels of the odd
  plants palette-indexed (PIL), of the even ones BGR (cv2)."""
  os.makedirs(folder)
  rng = np.random.RandomState(seed)
  for pid in range(1, count + 1):
    rgb = (rng.rand(h, w, 3) * 80 + 40).astype(np.uint8)
    idx = np.zeros((h, w), np.uint8)
    for k in range(1, rng.randint(2, 6)):
      m = _ellipse(h, w, rng.randint(8, h - 8), rng.randint(8, w - 8),
                   rng.randint(3, 8), rng.randint(4, 10))
      idx[m > 0] = k
    colours = rng.randint(30, 256, (idx.max() + 1, 3)).astype(np.uint8)
    colours[0] = 0
    rgb[idx > 0] = colours[idx[idx > 0]]
    if pid % 2:
      label = Image.fromarray(idx, 'P')
      label.putpalette(list(colours[:, ::-1].ravel()))   # RGB entries
      label.save(os.path.join(folder, f'plant{pid:03d}_label.png'))
    else:
      cv2.imwrite(os.path.join(folder, f'plant{pid:03d}_label.png'),
                  colours[idx])
    cv2.imwrite(os.path.join(folder, f'plant{pid:03d}_rgb.png'), rgb)
    cv2.imwrite(os.path.join(folder, f'plant{pid:03d}_fg.png'),
                ((idx > 0) * 255).astype(np.uint8))


def _kitti_folder(folder, h=40, w=124, seed=1):
  """images/, gt/, gt_man/ and {split}.txt: cars as colours."""
  for sub in ('images', 'gt', 'gt_man'):
    os.makedirs(os.path.join(folder, sub))
  rng = np.random.RandomState(seed)
  for iid in range(6):
    img = (rng.rand(h, w, 3) * 80 + 40).astype(np.uint8)
    gt = np.zeros((h, w, 3), np.uint8)
    for _ in range(rng.randint(1, 5)):
      m = _ellipse(h, w, rng.randint(15, h - 5), rng.randint(10, w - 10),
                   rng.randint(3, 9), rng.randint(5, 16))
      gt[m > 0] = rng.randint(20, 256, 3)
    cv2.imwrite(os.path.join(folder, 'images', f'{iid:06d}.png'), img)
    cv2.imwrite(os.path.join(folder, 'gt', f'{iid:06d}.png'), gt)
    cv2.imwrite(os.path.join(folder, 'gt_man', f'{iid:06d}.png'), gt)
  for split, ids in (('train', '0\n1\n2\n3\n'), ('valid', '4\n5\n')):
    with open(os.path.join(folder, f'{split}.txt'), 'w') as f:
      f.write(ids)


def _jax_setup(argv):
  old = sys.argv
  sys.argv = ['setup_dataset'] + argv
  try:
    jsetup.main()
  finally:
    sys.argv = old


@pytest.fixture(scope='module', params=['cvppp', 'kitti'])
def assembled(request, tmp_path_factory):
  """{'dataset', 'port': folder the port assembled, 'jax': the same raw
  folder assembled by JAX}."""
  name = request.param
  root = tmp_path_factory.mktemp(name)
  raw = str(root / 'raw')
  (_cvppp_folder if name == 'cvppp' else _kitti_folder)(raw)
  out = {'dataset': name}
  h, w = SIZES[name]
  for who in ('port', 'jax'):
    folder = str(root / who)
    shutil.copytree(raw, folder)
    argv = ['--dataset', name, '--folder', folder, '--splits',
            ','.join(SPLITS[name]), '--height', str(h), '--width', str(w)]
    if who == 'port':
      stats = setup_dataset.main(argv)
      assert sorted(stats) == sorted(SPLITS[name])
    else:
      _jax_setup(argv)
    out[who] = folder
  return out


def _datasets(assembled, folder, split):
  name = assembled['dataset']
  h, w = SIZES[name]
  opt = {'folder': folder, 'height': h, 'width': w}
  return (jprovider.get(name, opt, split=split),
          provider.get(name, opt, split=split))


def _assert_batches_equal(got, want):
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    v, g = np.asarray(v), np.asarray(got[k])
    assert g.dtype == v.dtype and g.shape == v.shape, k
    np.testing.assert_array_equal(g, v, err_msg=k)


def _read_both_ways(jds, pds):
  """Every variable of the JAX and the port dataset of one file, equal."""
  n = jds.get_dataset_size()
  assert pds.get_dataset_size() == n
  np.testing.assert_array_equal(pds.img_ids, jds.img_ids)
  idx = np.arange(n)
  _assert_batches_equal(pds.get_batch(idx, variables=VARIABLES),
                        jds.get_batch(idx, variables=VARIABLES))
  for i in range(n):
    full = {'y_gt_full', 'x_full'}
    _assert_batches_equal(pds.get_batch([i], variables=full),
                          jds.get_batch([i], variables=full))
  for a, b in zip(pds.get_full_size_labels(pds.img_ids),
                  jds.get_full_size_labels(jds.img_ids)):
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
  # One class: both index past c_gt_idx's one channel.
  for ds in (jds, pds):
    with pytest.raises(IndexError):
      ds.get_batch(idx, variables={'c_gt_idx', 'y_gt'})


def test_jax_reads_the_port_assembled_files_to_the_ports_arrays(assembled):
  for split in SPLITS[assembled['dataset']]:
    _read_both_ways(*_datasets(assembled, assembled['port'], split))


def test_the_port_reads_the_jax_assembled_files_to_jaxs_arrays(assembled):
  for split in SPLITS[assembled['dataset']]:
    _read_both_ways(*_datasets(assembled, assembled['jax'], split))


def _decoded(tree):
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out[k] = _decoded(v)
    elif v.dtype == np.uint8 and v.ndim == 1 and v[:4].tobytes() == \
        b'\x89PNG':
      out[k] = png.decode(v, png.IMREAD_UNCHANGED)
    else:
      out[k] = v
  return out


def test_both_packages_assemble_the_same_objects_and_pixels(assembled):
  """Files compared decoded (zlib's bytes may differ): the same tree, the
  same arrays, but for x's cubic-resize residual (at most 2 values, one
  level each)."""
  name = assembled['dataset']
  h, w = SIZES[name]
  for split in SPLITS[name]:
    fname = f'{split}_{h}x{w}.h5'
    got = _decoded(h5.read(os.path.join(assembled['port'], fname)))
    want = _decoded(h5.read(os.path.join(assembled['jax'], fname)))
    differ = 0

    def compare(g, wt, where):
      nonlocal differ
      assert sorted(g) == sorted(wt), where
      for k, v in wt.items():
        if isinstance(v, dict):
          compare(g[k], v, f'{where}/{k}')
        elif k == 'input':
          d = np.abs(g[k].astype(int) - v.astype(int))
          assert d.max() <= 1, where
          differ += int((d > 0).sum())
        else:
          assert g[k].dtype == v.dtype, (where, k)
          np.testing.assert_array_equal(g[k], v, err_msg=f'{where}/{k}')
    compare(got, want, split)
    assert differ <= 2
  if name == 'cvppp':
    for split in ('train', 'valid', 'all'):
      with open(os.path.join(assembled['port'], f'{split}.txt')) as f, \
          open(os.path.join(assembled['jax'], f'{split}.txt')) as g:
        assert f.read() == g.read()


def test_c_gt_idx_of_two_classes_reads_as_jax(tmp_path):
  p = str(tmp_path / 'two.h5')
  make_synthetic_h5(p, height=32, width=48, num_examples=5, seed=9,
                    num_semantic_classes=2)
  jds, pds = JSynthetic(p, num_semantic_classes=2), SyntheticH5(
      p, num_semantic_classes=2)
  v = VARIABLES | {'c_gt_idx'}
  _assert_batches_equal(pds.get_batch(np.arange(5), variables=v),
                        jds.get_batch(np.arange(5), variables=v))


def test_the_committed_jax_file_has_the_card_gates_digest_in_both():
  """chip_smoke.JAX_SYNTH_DIGEST, the card's gate on the JAX-written
  tests/fixtures/synth_valid_64x64.h5, is what the JAX package's own
  reader gives (get_batch and get_full_size_labels), and the port's reader
  gives it too; its control (the channels reversed) does not."""
  jds, pds = JSynthetic(cs.JAX_SYNTH_H5), SyntheticH5(cs.JAX_SYNTH_H5)
  assert cs.jax_h5_digest(jds) == cs.JAX_SYNTH_DIGEST
  assert cs.jax_h5_digest(pds) == cs.JAX_SYNTH_DIGEST
  assert cs.jax_h5_digest(jds, channels_reversed=True) != cs.JAX_SYNTH_DIGEST
  assert cs.jax_h5_digest(pds, channels_reversed=True) != cs.JAX_SYNTH_DIGEST


def _maps(rng, h, w, t):
  """Maps of every k/255, the floats between them and values outside
  [0, 1]."""
  def one(shape):
    a = rng.randint(-20, 276, shape) / 255.0
    a[..., ::3] += rng.rand(*a[..., ::3].shape) / 255.0
    return a.astype(np.float32)
  return {'foreground': one((h, w, 1)), 'orientation': one((h, w, 8)),
          'instance': one((t, h, w)),
          'score': rng.rand(t).astype(np.float32)}


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_packs_read_the_same_in_both_packages(assembled, writer, tmp_path):
  name = assembled['dataset']
  h, w = SIZES[name]
  src = os.path.join(assembled['port'], f'valid_{h}x{w}.h5')
  path = str(tmp_path / 'packed.h5')
  shutil.copy(src, path)
  jds = jdataset.InsSegDataset(path)
  t = 4
  rng = np.random.RandomState(5)
  maps = {sid: _maps(rng, h, w, t) for sid in jds.img_ids}
  if writer == 'port':
    pdataset.pack_predictions(path, maps)
  else:
    for sid, m in maps.items():
      jdataset.pack_predictions(path, sid, **m)
  jds = (jprovider.get(name, {'folder': None, 'height': h, 'width': w},
                       h5_fname=path))
  pds = provider.get(name, {'height': h, 'width': w}, h5_fname=path)
  v = {'y_out', 'd_out', 'y_out_ins', 's_out', 'idx_map'}
  idx = np.arange(jds.get_dataset_size())
  got = pds.get_batch(idx, timespan=t, variables=v)
  _assert_batches_equal(got, jds.get_batch(idx, timespan=t, variables=v))
  want_y = np.stack([(np.clip(maps[s]['foreground'], 0, 1) * 255).astype(
      'uint8') for s in jds.img_ids]) / np.float32(255)
  np.testing.assert_array_equal(got['y_out'], want_y.astype(np.float32))
  # The default variables carry the packed maps where the file holds them.
  assert {'y_out', 'd_out'} <= set(pds.get_batch(idx[:1]))


def test_the_provider_names_files_and_folders_as_jax():
  assert {k: v for k, v in provider.DEFAULT_FOLDERS.items()} == (
      jprovider.DEFAULT_FOLDERS)
  cfg = C.data_config_for('kitti')
  assert provider.h5_path('kitti', cfg, 'valid') == os.path.join(
      'data/kitti', 'valid_128x448.h5')
  assert provider.h5_path('cvppp', C.data_config_for('cvppp'), 'test') == (
      os.path.join('data/cvppp_test/A1', 'test_224x224.h5'))
  with pytest.raises(FileNotFoundError, match='setup_dataset'):
    provider.get('cityscapes', C.data_config_for('cityscapes'))
  with pytest.raises(ValueError, match='Unknown'):
    provider.get('coco', cfg)
  for dataset, err in (('cityscapes', FileNotFoundError),
                       ('synth', ValueError)):
    with pytest.raises(err, match=dataset):
      setup_dataset.main(['--dataset', dataset, '--folder', 'x'])
  jax_file = os.path.join(REPO, 'tests', 'fixtures', 'synth_valid_64x64.h5')
  ds = provider.get('synth', C.data_config_for('synth'), split='valid',
                    h5_fname=jax_file)
  assert ds.get_dataset_size() == 8 and ds.get_name() == 'synth'


CHIP_FIXTURES = {'cvppp': dict(count=10, height=60, width=50, seed=20),
                 'kitti': dict(counts={'train': 6, 'valid': 3, 'test': 3},
                               height=40, width=124, seed=21)}


@pytest.mark.parametrize('dataset', ['cvppp', 'kitti'])
def test_chip_smoke_h5_pipeline_phase_on_cpu(dataset):
  with small_models(dataset):
    out, failures = cs.h5_pipeline_phase(
        torch, gk, torch.device('cpu'), dataset,
        fixture=CHIP_FIXTURES[dataset], size=(64, 64))
  assert failures == []
  gated = [out['codec_gate'], out['jax_h5']['gate'], out['files_gate'],
           out['eval_step']['gate']]
  if dataset == 'kitti':
    gated.append(out['pack']['gate'])
  for g in gated:
    assert g['failures'] == [] and g['control_failures']
  stages = ('fg', 'box', 'full') if dataset == 'kitti' else ('box', 'full')
  for stage in stages:
    assert sorted(out[stage]['step_ms_at_log']) == [cs.H5_PIPELINE_STEPS]
    assert out['launches_per_step'][stage] is not None
  assert sorted(out['assemble']) == list(sorted(cs.H5_SPLITS[dataset]))
  assert out['eval_batches'] > 0 and out['decode']['input']['median_ms'] > 0
  # On the CPU the kernel glimpses are the plain ones: nothing launches.
  assert not any(out['eval_launches']['launches'].values())
  assert 'launch_gate' not in out


@pytest.mark.slow
def test_the_cvppp_layout_at_its_real_size(tmp_path):
  """128 plants at 530x500 (chip_smoke.py's fixture, palette labels), a
  103/25 split at 224x224, assembled by both packages and read both
  ways."""
  raw = str(tmp_path / 'raw')
  cs.cvppp_fixture(raw, **cs.CVPPP_FIXTURE)
  out = {'dataset': 'cvppp'}
  for who in ('port', 'jax'):
    folder = str(tmp_path / who)
    shutil.copytree(raw, folder)
    argv = ['--dataset', 'cvppp', '--folder', folder]
    (setup_dataset.main if who == 'port' else _jax_setup)(argv)
    out[who] = folder
  for who in ('port', 'jax'):
    for split, n in (('train', 103), ('valid', 25)):
      opt = {'folder': out[who], 'height': 224, 'width': 224}
      jds, pds = (jprovider.get('cvppp', opt, split=split),
                  provider.get('cvppp', opt, split=split))
      assert pds.get_dataset_size() == n
      _read_both_ways(jds, pds)
