"""The colour jitter of the training augmentation (``rnd_colour``) in the port
against the JAX package's ``ops/image_ops.py:23-78`` and ``:167-174``, on
numpy-seeded float32 images.

Both sides compute the same float32 arithmetic element by element, so the
HSV round trip is held at atol 1e-6 (an HSV component is in [0, 1]); the
whole jitter at atol 2e-6, its contrast step taking a per-image mean that
XLA and PyTorch sum in other orders.  The port is handed the draws JAX makes
from its key (the split of ``image_ops.py:141``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rec_attend_tpu.ops import image_ops as JI
from rec_attend_tpu_torch.ops import image_ops as TI

torch.set_num_threads(1)

HSV_ATOL = 1e-6
JITTER_ATOL = 2e-6


def jax_colour_draws(k_aug):
  """The colour draws of JAX ``random_transformation`` under ``k_aug``, in
  the port's 'colour' form (Python floats of JAX's float32 draws)."""
  keys = jax.random.split(k_aug, 8)[4:]
  return {name: float(jax.random.uniform(k, (), minval=lo, maxval=hi))
          for k, (name, lo, hi) in zip(keys, TI.COLOUR_RANGES)}


def _pixels(seed=0, n=400):
  """Random colours, greys (r = g = b, hue 0), black, ties for the maximum
  (r = g, g = b, r = b) and red-dominant pixels whose hue wraps below 0."""
  rng = np.random.RandomState(seed)
  px = [rng.rand(n, 3)]
  grey = rng.rand(20, 1)
  px.append(np.repeat(grey, 3, axis=1))
  px.append(np.zeros((1, 3)))
  tie = rng.rand(30, 2) * 0.5 + 0.5
  low = rng.rand(30, 1) * 0.4
  px += [np.concatenate([tie, low], 1), np.concatenate([low, tie], 1),
         np.stack([tie[:, 0], low[:, 0], tie[:, 0]], 1)]
  px.append(np.stack([0.5 + 0.5 * rng.rand(30), 0.2 * rng.rand(30),
                      0.2 + 0.2 * rng.rand(30)], 1))    # b > g: h < 0
  return np.concatenate(px).astype(np.float32)


def test_rgb_to_hsv_matches_jax():
  px = _pixels()
  want = np.asarray(JI.rgb_to_hsv(jnp.asarray(px)))
  got = TI.rgb_to_hsv(torch.from_numpy(px)).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=HSV_ATOL)
  grey = px[400:420]
  assert (got[400:421, :2] == 0).all()              # greys and black
  np.testing.assert_array_equal(got[400:420, 2], grey[:, 0])
  assert (got[:, 0] >= 0).all() and (got[:, 0] <= 1).all()


def test_hsv_to_rgb_matches_jax_at_the_sector_edges():
  """Hues at every sector edge, exactly 1 (sector 6 is 0) and just below."""
  rng = np.random.RandomState(1)
  h = np.concatenate([np.arange(7) / 6.0, [1.0, np.nextafter(1.0, 0.0)],
                      rng.rand(200)])
  hsv = np.stack([h, rng.rand(h.size), rng.rand(h.size)], 1).astype(
      np.float32)
  want = np.asarray(JI.hsv_to_rgb(jnp.asarray(hsv)))
  got = TI.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=HSV_ATOL)
  one = hsv[h == 1.0]
  np.testing.assert_allclose(got[h == 1.0],
                             TI.hsv_to_rgb(torch.from_numpy(
                                 one * [0, 1, 1])).numpy(), atol=HSV_ATOL)


@pytest.mark.parametrize('delta', [0.1, -0.1, 0.0999])
def test_adjust_hue_wraps_as_jax(delta):
  """A shift that carries hues across 1 (or below 0) wraps them by a floor
  modulo."""
  px = _pixels(2).reshape(1, -1, 1, 3)
  want = np.asarray(JI.adjust_hue(jnp.asarray(px), jnp.float32(delta)))
  got = TI.adjust_hue(torch.from_numpy(px),
                      torch.tensor(delta, dtype=torch.float32)).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=HSV_ATOL)
  hue = TI.rgb_to_hsv(torch.from_numpy(px))[..., 0]
  assert bool(((hue + delta > 1) | (hue + delta < 0)).any())


@pytest.mark.parametrize('seed', range(4))
def test_colour_jitter_with_jax_draws(seed):
  """The whole train branch with rnd_colour and the flips, on JAX's draws."""
  rng = np.random.RandomState(seed)
  x = rng.rand(2, 20, 20, 3).astype(np.float32)
  x[0, :4, :4] = 0.5                                 # a grey patch
  y = (rng.rand(2, 3, 20, 20) > 0.5).astype(np.float32)
  key = jax.random.PRNGKey(seed)
  want = JI.random_transformation(key, jnp.asarray(x), 4, True,
                                  rnd_colour=True, y=jnp.asarray(y))
  k_off, k_h, k_v, k_t = jax.random.split(key, 8)[:4]
  off = np.asarray(jax.random.randint(k_off, (2,), 0, 8))
  draws = {'offset': (int(off[0]), int(off[1])),
           'hflip': bool(jax.random.uniform(k_h) < 0.5),
           'vflip': bool(jax.random.uniform(k_v) < 0.5),
           'transpose': bool(jax.random.uniform(k_t) < 0.5),
           'colour': jax_colour_draws(key)}
  got = TI.random_transformation(torch.from_numpy(x), 4, draws,
                                 rnd_colour=True, y=torch.from_numpy(y))
  np.testing.assert_allclose(got['x'].numpy(), np.asarray(want['x']),
                             rtol=0, atol=JITTER_ATOL)
  np.testing.assert_array_equal(got['y'].numpy(), np.asarray(want['y']))
  assert np.abs(got['x'].numpy() - x).max() > 1e-3   # the jitter moved x
