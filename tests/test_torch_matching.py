"""The port's host Hungarian matching against the JAX package's.

The port builds its own copy of the host solver (``csrc/hungarian.cc``) and
calls it through its own ctypes wrapper (``ops/native.py``); on the same
weights it must give exactly the matching and covers of the JAX package's
native solver (``ops/native.py``, ``matcher='native'``), ties included.
Against the JAX package's default solver (``matcher='jax'``) only the
total weight must agree (rtol 1e-6): both are optimal, but on ties they
may choose different matchings (``rec_attend_tpu/ops/hungarian.py:22-25``).
The port's counterpart of that default solver is held to it in
``test_torch_hungarian.py``.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rec_attend_tpu.ops import matching as JM
from rec_attend_tpu.ops import native as JN
from rec_attend_tpu_torch.ops import matching as M
from rec_attend_tpu_torch.ops import native as H
from rec_attend_tpu_torch.ops.cuda import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _weights(kind, seed=0):
  rng = np.random.RandomState(seed)
  if kind == 'random':
    return rng.rand(6, 21, 21).astype(np.float32)
  if kind == 'ties':           # rounded to a few levels: many exact ties
    return (np.round(rng.rand(6, 8, 8) * 3) / 3).astype(np.float32)
  if kind == 'rectangular':
    return rng.rand(3, 5, 9).astype(np.float32)
  if kind == 'uniform':        # every matching is optimal
    return np.full((2, 7, 7), 1e-5, np.float32)
  raise ValueError(kind)


def _code(path):
  """The lines of a C++ file below its leading comment block."""
  with open(path) as f:
    lines = f.read().splitlines()
  i = 0
  while i < len(lines) and (lines[i].startswith('//') or not lines[i]):
    i += 1
  return lines[i:]


def test_the_solver_source_is_the_native_solvers_code():
  """The port's csrc/hungarian.cc differs from native/hungarian.cc in its
  leading comment only: a fix to one solver must be made to both."""
  ours = _code(build.SOURCES['hungarian'])
  theirs = _code(os.path.join(REPO, 'native', 'hungarian.cc'))
  assert len(ours) > 200
  assert ours == theirs


@pytest.mark.parametrize('kind', ['random', 'ties', 'rectangular',
                                  'uniform'])
def test_hungarian_equals_the_native_solver(kind):
  w = _weights(kind)
  m, cx, cy, capped = H.hungarian_native(w)
  jm, jcx, jcy = JN.hungarian_native(w)
  assert capped == 0
  np.testing.assert_array_equal(m, jm)
  np.testing.assert_array_equal(cx, jcx[..., 0])
  np.testing.assert_array_equal(cy, jcy[:, 0, :])
  # A matching that saturates the smaller side.
  assert (m.sum(axis=(1, 2)) == min(w.shape[1:])).all()


def test_hungarian_takes_one_problem():
  w = _weights('random')[0]
  m, _, _, _ = H.hungarian_native(w)
  np.testing.assert_array_equal(m, JN.hungarian_native(w)[0])


@pytest.mark.parametrize('seed', [0, 1])
def test_segm_match_equals_jax_native_and_weighs_as_jax(seed):
  """The stacked [2B, T, T] problem of the full model's loss, with absent
  ground truth."""
  rng = np.random.RandomState(seed)
  t = 21
  iou = rng.rand(8, t, t).astype(np.float32) * 0.9
  s_gt = np.zeros((8, t), np.float32)
  for b in range(8):
    s_gt[b, :rng.randint(1, t + 1)] = 1
  got = M.f_segm_match(torch.from_numpy(iou), torch.from_numpy(s_gt),
                       matcher='native')
  want = np.asarray(JM.f_segm_match(jnp.asarray(iou), jnp.asarray(s_gt),
                                    matcher='native'))
  np.testing.assert_array_equal(got.numpy(), want)
  on_device = np.asarray(JM.f_segm_match(jnp.asarray(iou),
                                         jnp.asarray(s_gt), matcher='jax'))
  w = np.round(iou * s_gt[:, None] * s_gt[:, :, None] * 1e6) / 1e6 + 1e-5
  np.testing.assert_allclose((w * got.numpy()).sum(axis=(1, 2)),
                             (w * on_device).sum(axis=(1, 2)), rtol=1e-6)


def test_segm_match_carries_no_gradient():
  iou = torch.rand(2, 4, 4, requires_grad=True)
  got = M.f_segm_match(iou, torch.ones(2, 4))
  assert not got.requires_grad


def test_identity_match_matches_jax():
  s_gt = np.array([[1, 1, 0, 0], [1, 1, 1, 1]], np.float32)
  np.testing.assert_array_equal(
      M.get_identity_match(4, torch.from_numpy(s_gt)).numpy(),
      np.asarray(JM.get_identity_match(4, jnp.asarray(s_gt))))
