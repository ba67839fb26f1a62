"""Ground-truth boxes and the training augmentation of the port against the
JAX package (``ops/boxes.py``, the train branch of
``ops/image_ops.random_transformation``), on numpy-seeded masks.

Boxes: exact (min/max reductions of the same values, then the same
arithmetic) up to rtol 1e-6.  Augmentation: exact; the port is handed the
draws JAX makes from its key (``image_ops.py:141-146``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rec_attend_tpu.ops import boxes as JB
from rec_attend_tpu.ops import image_ops as JI
from rec_attend_tpu_torch.ops import boxes as TB
from rec_attend_tpu_torch.ops import image_ops as TI

torch.set_num_threads(1)


def _masks(seed=0, b=2, t=5, h=24, w=30):
  rng = np.random.RandomState(seed)
  y = np.zeros((b, t, h, w), np.float32)
  for i in range(b):
    for k in range(t - 1):
      y0, x0 = rng.randint(0, h - 4), rng.randint(0, w - 4)
      y[i, k, y0:y0 + rng.randint(2, 10), x0:x0 + rng.randint(2, 12)] = 1
  y[0, 1] *= rng.rand(h, w).astype(np.float32)      # a soft mask
  return y                                           # slot t-1 stays empty


@pytest.mark.parametrize('noisy', [False, True])
def test_gt_attn_matches_jax(noisy):
  y = _masks()
  b, t = y.shape[:2]
  rng = np.random.RandomState(1)
  pad = (rng.rand(b, t, 1) * 0.2 + 0.1).astype(np.float32) if noisy else 0.2
  shift = ((rng.rand(b, t, 2) - 0.5) * 0.1).astype(np.float32) if noisy \
      else 0.0
  want = JB.get_gt_attn(jnp.asarray(y), 8, 6, padding_ratio=pad,
                        center_shift_ratio=shift, min_padding=5.0)
  as_t = (lambda v: torch.from_numpy(v)) if noisy else (lambda v: v)
  got = TB.get_gt_attn(torch.from_numpy(y), 8, 6, padding_ratio=as_t(pad),
                       center_shift_ratio=as_t(shift), min_padding=5.0)
  names = ('ctr', 'size', 'lg_var', 'lg_gamma', 'box', 'top_left',
           'bot_right')
  for name, g, w in zip(names, got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                               atol=1e-6, err_msg=name)


def _jax_draws(key, padding):
  k_off, k_h, k_v, k_t = jax.random.split(key, 8)[:4]
  off = np.asarray(jax.random.randint(k_off, (2,), 0, max(2 * padding, 1)))
  return {'offset': (int(off[0]), int(off[1])),
          'hflip': bool(jax.random.uniform(k_h) < 0.5),
          'vflip': bool(jax.random.uniform(k_v) < 0.5),
          'transpose': bool(jax.random.uniform(k_t) < 0.5)}


@pytest.mark.parametrize('seed', range(6))
def test_random_transformation_matches_jax(seed):
  rng = np.random.RandomState(seed)
  x = rng.rand(2, 20, 20, 3).astype(np.float32)
  y = (rng.rand(2, 3, 20, 20) > 0.5).astype(np.float32)
  key = jax.random.PRNGKey(seed)
  want = JI.random_transformation(key, jnp.asarray(x), 4, True,
                                  y=jnp.asarray(y))
  draws = _jax_draws(key, 4)
  got = TI.random_transformation(torch.from_numpy(x), 4, draws,
                                 y=torch.from_numpy(y))
  np.testing.assert_array_equal(got['x'].numpy(), np.asarray(want['x']))
  np.testing.assert_array_equal(got['y'].numpy(), np.asarray(want['y']))


def test_random_transformation_flags_and_limits():
  x = torch.rand(1, 8, 10, 3)
  draws = {'offset': (2, 3), 'hflip': True, 'vflip': True,
           'transpose': True}
  got = TI.random_transformation(x, 2, draws, rnd_hflip=False,
                                 rnd_vflip=False, rnd_transpose=False)
  padded = torch.nn.functional.pad(x, (0, 0, 2, 2, 2, 2))
  assert torch.equal(got['x'], padded[:, 2:10, 3:13])
  with pytest.raises(ValueError, match='square'):
    TI.random_transformation(x, 2, draws)
  with pytest.raises(NotImplementedError, match='rnd_colour'):
    TI.random_transformation(x, 2, draws, rnd_transpose=False,
                             rnd_colour=True)
  draws = TI.draw_transformation(2, torch.Generator().manual_seed(0))
  assert all(0 <= o < 4 for o in draws['offset'])
