"""The port's cv2-free postprocess against the JAX package's cv2 chain.

``upsample`` (bilinear resize, then the 5x10x10 bilateral filter) is held
against ``rec_attend_tpu.utils.postprocess.upsample`` on soft maps with
sharp, near-constant, constant and all-zero channels.  Both run in float32
and the port sums the filter's taps in cv2's groups, but not always in
cv2's order: at the model's size they agree to atol 1e-6; resized, where
the resize's rounding adds to the filter's, to atol 1e-6 as well (measured:
at most 2.4e-7 here).  Constant channels must come back unchanged, as cv2
returns them.  ``morph``, ``mask_foreground`` and the per-image list forms
are exact.
"""

import numpy as np
import pytest
import torch

from rec_attend_tpu.utils import postprocess as jpp
from rec_attend_tpu_torch.utils import postprocess as pp

torch.set_num_threads(1)

ATOL = 1e-6


def _soft_maps(rng, t, h, w):
  """[t, h, w] float32: soft discs of random radius, sharpness and weight,
  one near-constant channel, one constant and the rest all-zero."""
  y = np.zeros((t, h, w), np.float32)
  yy, xx = np.mgrid[:h, :w]
  for k in range(t - 4):
    cy, cx = rng.rand() * h, rng.rand() * w
    r = (0.1 + 0.3 * rng.rand()) * min(h, w)
    sharp = 0.2 + 3 * rng.rand()
    dist = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    y[k] = rng.rand() / (1 + np.exp(np.minimum(sharp * (dist - r), 50)))
  y[t - 4] = 0.3 + 1e-5 * rng.rand(h, w)
  y[t - 3] = 0.25
  return y      # channels t-2 and t-1 stay all-zero


SIZES = {
    'same_224': ((224, 224), (224, 224)),
    'up_530x500': ((224, 224), (530, 500)),
    'down_100x150': ((224, 224), (100, 150)),
    'up_small': ((32, 32), (48, 56)),
    'down_small': ((32, 32), (20, 40)),
}


@pytest.mark.parametrize('name', list(SIZES))
def test_upsample_matches_cv2(name):
  (h, w), (big_h, big_w) = SIZES[name]
  rng = np.random.RandomState(len(name))
  y = np.stack([_soft_maps(rng, 8, h, w) for _ in range(2)])
  want = jpp.upsample(y, [np.zeros((8, big_h, big_w))] * 2)
  got = pp.upsample(torch.from_numpy(y), [(big_h, big_w)] * 2)
  assert tuple(got.shape) == (2, 8, big_h, big_w)
  for g, wnt in zip(got.numpy(), want):
    np.testing.assert_allclose(g, wnt, rtol=0, atol=ATOL)
    # Constant and all-zero channels come back as cv2 returns them.
    np.testing.assert_array_equal(g[5:], wnt[5:])


def test_upsample_per_image_sizes():
  """Images of one batch with their own sizes come back as a list, each as
  cv2 gives it."""
  rng = np.random.RandomState(3)
  y = np.stack([_soft_maps(rng, 6, 32, 32) for _ in range(3)])
  sizes = [(32, 32), (48, 40), (20, 36)]
  want = jpp.upsample(y, [np.zeros((6,) + s) for s in sizes])
  got = pp.upsample(torch.from_numpy(y), sizes)
  assert isinstance(got, list)
  for g, wnt in zip(got, want):
    np.testing.assert_allclose(g.numpy(), wnt, rtol=0, atol=ATOL)


def test_bilateral_filter_of_a_constant_image_is_the_image():
  img = torch.full((3, 17, 19), 0.7)
  img[1] = 0.0
  assert torch.equal(pp.bilateral_filter(img), img)


def test_resize_of_images_matches_cv2():
  """The serving input resize: [B,H,W,3] images (channels resized alike)."""
  import cv2
  rng = np.random.RandomState(4)
  for (h, w), (big_h, big_w) in [((48, 56), (32, 32)), ((20, 40), (32, 32)),
                                 ((530, 500), (224, 224))]:
    im = rng.rand(h, w, 3).astype(np.float32)
    want = cv2.resize(im, (big_w, big_h))
    got = pp.resize(torch.from_numpy(im).permute(2, 0, 1), (big_h, big_w))
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize('as_list', [False, True])
def test_morph_and_mask_foreground_are_exact(as_list):
  rng = np.random.RandomState(5)
  y = ((rng.rand(2, 4, 30, 41) > 0.97) * rng.rand(2, 4, 30, 41)).astype(
      np.float32)
  fg = (rng.rand(2, 30, 41) > 0.3).astype(np.float32)
  want = jpp.mask_foreground(jpp.morph(list(y)), list(fg))
  ty = torch.from_numpy(y)
  if as_list:
    ty = list(ty)
  got = pp.mask_foreground(pp.morph(ty), list(torch.from_numpy(fg)))
  for g, wnt in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), wnt)


def test_chain_on_per_image_lists_matches_jax():
  """One-label, threshold and remove-tiny on a per-image list of maps of
  different sizes, against the JAX package's list chain."""
  rng = np.random.RandomState(6)
  y = [rng.rand(5, 20 + 3 * i, 25).astype(np.float32) ** 3 for i in range(3)]
  conf = (rng.rand(3, 5) > 0.3).astype(np.float32)
  masks, want_conf = jpp.remove_tiny(
      jpp.apply_threshold(jpp.apply_one_label(y), 0.1), conf.copy(),
      threshold=40)
  got, got_conf = pp.remove_tiny(
      pp.apply_threshold(pp.apply_one_label([torch.from_numpy(a)
                                             for a in y]), 0.1),
      torch.from_numpy(conf), threshold=40)
  for g, wnt in zip(got, masks):
    np.testing.assert_array_equal(g.numpy(), wnt)
  np.testing.assert_array_equal(got_conf.numpy(), want_conf)
