"""The in-memory pack against the JAX package's H5 pack.

The JAX chain writes the fg model's maps into the dataset's H5 file with
``pack_predictions`` (uint8 PNGs of ``clip(a, 0, 1) * 255``, truncated) and
its dataset reads them back as ``uint8 / 255``.  ``cli.pack`` keeps the
bytes in memory; the maps its ``PackedDataset`` gives must equal, bit for
bit, what the JAX dataset reads back from its H5 file for the same float
maps: crafted maps (every multiple of 1/255 as float32 gives it, the floats
next to them, values outside [0, 1]) and the maps of a tiny fg model, run
through ``pack_fg``.
"""

import os

import numpy as np
import jax
import pytest
import torch

from rec_attend_tpu import config as JC
from rec_attend_tpu.data.dataset import pack_predictions
from rec_attend_tpu.data.synthetic import make_synthetic_h5
from rec_attend_tpu.engine.saver import Saver
from rec_attend_tpu.models import fg_model as JG
from rec_attend_tpu.parallel.train_step import make_optimizer
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.cli import pack
from rec_attend_tpu_torch.engine.experiment import EvalExperiment

torch.set_num_threads(1)

N, H, W = 3, 24, 32


class PortView:
  """A JAX package dataset seen through the port's dataset interface."""

  def __init__(self, ds):
    self.ds = ds

  def get_dataset_size(self):
    return self.ds.get_dataset_size()

  def get_batch(self, idx, timespan=None):
    return self.ds.get_batch(idx, timespan=timespan,
                             variables={'x', 's_gt', 'idx_map'})

  def get_full_size_labels(self, ids, timespan=None):
    return self.ds.get_full_size_labels(ids, timespan=timespan)


def _jax_pack(ds, d_out, y_out):
  """What the JAX dataset reads back after pack_predictions wrote each
  example's maps into its H5 file."""
  for i, sid in enumerate(ds.img_ids):
    pack_predictions(ds.h5_fname, sid, foreground=y_out[i],
                     orientation=d_out[i])
  ds.clear_cache()
  return ds.get_batch(np.arange(len(ds.img_ids)), timespan=4,
                      variables={'d_out', 'y_out'})


def _crafted_maps():
  """[N,H,W,8] and [N,H,W,1] float32 maps: every k/255 (as float32 and as
  the float32 quotient k/255), the floats next to them, values below 0 and
  above 1, and random values."""
  k = np.arange(256, dtype=np.float32)
  exact = np.concatenate([k / np.float32(255),
                          (np.arange(256) / 255).astype(np.float32)])
  vals = np.concatenate([
      exact, np.nextafter(exact, np.float32(2)),
      np.nextafter(exact, np.float32(-1)),
      np.float32([-1.0, -1e-8, 0.0, 1.0, 1.0 + 1e-7, 1.5, 255.0, 1e30])])
  rng = np.random.RandomState(0)
  flat = np.concatenate([vals, rng.rand(N * H * W * 9 - len(vals)).astype(
      np.float32) * 1.2 - 0.1])
  flat = flat[rng.permutation(len(flat))].reshape(N, H, W, 9)
  return flat[..., :8].copy(), flat[..., 8:].copy()


def _assert_bits_equal(got, want):
  assert got.dtype == want.dtype == np.float32
  np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_packed_maps_equal_the_jax_h5_pack(tmp_path):
  ds = make_synthetic_h5(str(tmp_path / 'valid.h5'), height=H, width=W,
                         num_examples=N, seed=1)
  d_out, y_out = _crafted_maps()
  want = _jax_pack(ds, d_out, y_out)
  packed = pack.PackedDataset(
      PortView(ds), pack.quantise(torch.from_numpy(d_out)).numpy(),
      pack.quantise(torch.from_numpy(y_out)).numpy())
  got = packed.get_batch(np.arange(N), timespan=4)
  for k in ('d_out', 'y_out'):
    _assert_bits_equal(got[k], want[k])
  assert set(np.unique(got['y_out'] * 255).round()) >= {0.0, 1.0, 254.0,
                                                         255.0}
  # The batch of the dataset underneath is passed through.
  np.testing.assert_array_equal(got['x'], PortView(ds).get_batch(
      np.arange(N), timespan=4)['x'])
  assert list(got['idx_map']) == list(ds.img_ids)
  sub = packed.get_batch([2, 0], timespan=4)
  _assert_bits_equal(sub['d_out'], want['d_out'][[2, 0]])


@pytest.fixture(scope='module')
def tiny_fg(tmp_path_factory):
  """A tiny fg model with its orientation head, saved as the JAX trainer
  saves it (parameters and the momentum state), weights scaled up so that
  the maps spread over [0, 1]."""
  jcfg = JC.tiny_fg_config(inp_height=H, inp_width=W, add_orientation=True,
                           dcnn_depth=(8, 4, 9), optimizer='momentum')
  rng = np.random.RandomState(0)
  params = JG.init_fg_model(jax.random.PRNGKey(0), jcfg)
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) * (1 + 60 * rng.rand(*a.shape)).astype(
          np.float32) if a.ndim >= 2 else np.asarray(a), params)
  folder = str(tmp_path_factory.mktemp('pack') / 'fg_model_tiny')
  opt_state = make_optimizer(jcfg).init(params)
  Saver(folder, model_opt=jcfg).save({'params': params,
                                      'opt_state': opt_state}, 7)
  return folder


def test_pack_fg_equals_the_jax_h5_pack_of_its_maps(tiny_fg, tmp_path):
  ds = make_synthetic_h5(str(tmp_path / 'valid.h5'), height=H, width=W,
                         num_examples=N, seed=2)
  exp = EvalExperiment(tiny_fg, device='cpu', spec='fg')
  assert exp.step == 7
  maps = [out for _, _, out in exp.iterate_split(PortView(ds), 2)]
  d_out = torch.cat([m['d_out'] for m in maps]).numpy()
  y_out = torch.cat([m['y_out'] for m in maps]).numpy()
  assert d_out.shape == (N, H, W, 8) and y_out.shape == (N, H, W, 1)
  assert y_out.std() > 0.05
  timings = {}
  packed = pack.pack_fg(exp, PortView(ds), batch_size=2, timings=timings)
  assert {k: len(v) for k, v in timings.items()} == {'forward': 2, 'pack': 2}
  want = _jax_pack(ds, d_out, y_out)
  got = packed.get_batch(np.arange(N), timespan=4)
  for k in ('d_out', 'y_out'):
    _assert_bits_equal(got[k], want[k])
  assert packed.get_dataset_size() == N


def test_pack_fg_refuses_what_it_cannot_pack(tmp_path):
  folder = str(tmp_path / 'fg_model_no_orientation')
  jcfg = JC.tiny_fg_config()
  Saver(folder, model_opt=jcfg).save(
      {'params': JG.init_fg_model(jax.random.PRNGKey(0), jcfg)}, 1)
  exp = EvalExperiment(folder, device='cpu', spec='fg')
  ds = PortView(make_synthetic_h5(str(tmp_path / 'v.h5'), height=64,
                                  width=64, num_examples=1, seed=2))
  with pytest.raises(ValueError, match='orientation'):
    pack.pack_fg(exp, ds, 1)
  with pytest.raises(TypeError, match='FGModelConfig'):
    EvalExperiment(folder, cfg=C.tiny_full_config(), device='cpu',
                   spec='fg')
  with pytest.raises(ValueError, match='spec'):
    EvalExperiment(folder, device='cpu', spec='box')
  assert os.path.exists(os.path.join(folder, 'model_opt.yaml'))
