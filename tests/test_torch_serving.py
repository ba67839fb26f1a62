"""The port's InstanceSegmenter against the JAX InstanceSegmenter.

Both load the same JAX checkpoint folder (a tiny config; the weights scaled
up from the 0.01 init so that masks and counts are not trivially empty).
Masks and counts must be equal, scores and soft masks close (atol 1e-4, as
in test_torch_full_model.py: float32 forwards that differ in summation
order); the test also checks that no soft value lies within 1e-4 of a
threshold, where equality of the hard masks would be luck.
"""

import numpy as np
import jax
import pytest
import torch

from rec_attend_tpu import config as JC
from rec_attend_tpu import serving as jserving
from rec_attend_tpu.engine.saver import Saver
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu_torch import serving
from rec_attend_tpu_torch.ops.cuda import glimpse as gk

torch.set_num_threads(1)

SIZE = 32
THRESHOLD = 0.3
REMOVE_TINY = 4


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
  cfg = JC.tiny_full_config(timespan=4, inp_height=SIZE, inp_width=SIZE,
                            filter_height=8, filter_width=8)
  rng = np.random.RandomState(0)
  params = JF.init_full_model(jax.random.PRNGKey(0), cfg)
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) * (1 + 40 * rng.rand(*a.shape)).astype(
          np.float32) if a.ndim >= 2 else np.asarray(a), params)
  path = str(tmp_path_factory.mktemp('serve') / 'full_model_test')
  Saver(path, model_opt=cfg).save({'params': params}, 3)
  return path


@pytest.fixture(scope='module')
def images():
  rng = np.random.RandomState(1)
  return (rng.rand(3, SIZE, SIZE, 3) * 255).astype(np.uint8)


# The reference stores conf_threshold and never reads it: it hardens the
# scores at 0.5 whatever the value.  0.4 (the flagship's calibrated score
# threshold) lies below one of the JAX scores of these inputs that are under
# 0.5, so a port that hardened at conf_threshold would count that slot.
CONF_THRESHOLDS = [0.5, 0.4]


@pytest.mark.parametrize('conf_threshold', CONF_THRESHOLDS)
def test_predict_matches_jax(folder, images, conf_threshold):
  kw = dict(threshold=THRESHOLD, remove_tiny=REMOVE_TINY,
            conf_threshold=conf_threshold)
  want = jserving.InstanceSegmenter.from_checkpoint(folder, **kw).predict(
      images)
  seg = serving.InstanceSegmenter.from_checkpoint(folder, device='cpu', **kw)
  got = seg.predict(images)
  assert np.abs(want['soft_masks'] - THRESHOLD).min() > 1e-4
  assert np.abs(want['scores'] - 0.5).min() > 1e-4
  if conf_threshold != 0.5:
    between = (want['scores'] > conf_threshold) & (want['scores'] < 0.5)
    assert between.any()
  assert want['masks'].sum() > 0 and want['counts'].sum() > 0
  np.testing.assert_array_equal(got['masks'], want['masks'])
  np.testing.assert_array_equal(got['counts'], want['counts'])
  np.testing.assert_allclose(got['scores'], want['scores'], atol=1e-4)
  np.testing.assert_allclose(got['soft_masks'], want['soft_masks'],
                             atol=1e-4)
  assert got['masks'].dtype == np.uint8
  assert got['counts'].shape == (3,)


def test_predict_single_image_and_launch_counts(folder, images):
  seg = serving.InstanceSegmenter.from_checkpoint(folder, device='cpu')
  gk.reset_launch_counts()
  out = seg.predict(images[0].astype(np.float32) / 255.0)
  assert out['masks'].shape == (1, 4, SIZE, SIZE)
  assert set(np.unique(out['masks'])) <= {0, 1}
  assert gk.launch_counts() == {'glimpse_extract': 0, 'glimpse_paste': 0}


def test_predict_refuses_other_sizes(folder):
  seg = serving.InstanceSegmenter.from_checkpoint(folder, device='cpu')
  with pytest.raises(NotImplementedError, match='later slice'):
    seg.predict(np.zeros((1, 48, 56, 3), np.float32))


@pytest.mark.parametrize('remove_tiny', [0, 16, 200])
def test_postprocess_chain_matches_jax(remove_tiny):
  """The tensor postprocess against the JAX package's numpy chain."""
  from rec_attend_tpu.utils import postprocess as jpp
  from rec_attend_tpu_torch.utils import postprocess as pp
  rng = np.random.RandomState(remove_tiny)
  y_out = rng.rand(2, 5, 20, 20).astype(np.float32) ** 3
  s_out = rng.rand(2, 5).astype(np.float32)
  y, conf = jpp.apply_confidence(y_out, s_out)
  y = jpp.apply_one_label(y)
  masks = jpp.apply_threshold(y, 0.1)
  masks, conf = jpp.remove_tiny(masks, conf, threshold=remove_tiny)
  ty, tconf = pp.apply_confidence(torch.from_numpy(y_out),
                                  torch.from_numpy(s_out))
  ty = pp.apply_one_label(ty)
  tmasks = pp.apply_threshold(ty, 0.1)
  tmasks, tconf = pp.remove_tiny(tmasks, tconf, threshold=remove_tiny)
  np.testing.assert_allclose(ty.numpy(), np.stack(y), rtol=1e-6)
  np.testing.assert_array_equal(tmasks.numpy(), np.stack(masks))
  np.testing.assert_array_equal(tconf.numpy(), conf)
