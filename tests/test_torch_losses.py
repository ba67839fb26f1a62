"""The port's loss and metric primitives, values and gradients, against the
JAX package's ``ops/losses.py`` on the same numpy-seeded inputs.

Tolerances: values rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6
(float32 on both sides, other summation orders in the reductions).  The
cumulative min/max gradients are compared on ties, where ``torch.cummin``
would route the gradient otherwise than JAX.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rec_attend_tpu.ops import losses as JL
from rec_attend_tpu_torch.ops import losses as L

torch.set_num_threads(1)

B, N, M, H, W = 2, 5, 4, 12, 10


def _data(seed=0):
  rng = np.random.RandomState(seed)
  y_out = rng.rand(B, N, H, W).astype(np.float32)
  y_out2 = rng.rand(B, N, H, W).astype(np.float32)
  y_gt = (rng.rand(B, M, H, W) > 0.6).astype(np.float32)
  y_gt[1, 3] = 0                                       # an empty instance
  match = np.zeros((B, N, M), np.float32)
  for b in range(B):
    for n, m in enumerate(rng.permutation(M)[:3]):
      match[b, n, m] = 1
  s_out = rng.rand(B, N).astype(np.float32)
  s_out[0, 1:3] = s_out[0, 0]                          # ties
  s_out[1, :2] = 1.0                                   # saturated ties
  return {'y_out': y_out, 'y_out2': y_out2, 'y_gt': y_gt, 'match': match, 's_out': s_out,
          's_gt': (rng.rand(B, N) > 0.4).astype(np.float32),
          'params': rng.randn(B, N, 4).astype(np.float32),
          'params_gt': rng.randn(B, M, 4).astype(np.float32) * 2,
          'params2': rng.randn(B, N, 4).astype(np.float32) * 2,
          'tl': (rng.rand(B, N, 2) * 20).astype(np.float32),
          'tl_gt': (rng.rand(B, M, 2) * 20).astype(np.float32),
          'size': (rng.rand(B, N, 2) * 20 + 1).astype(np.float32),
          'size_gt': (rng.rand(B, M, 2) * 20 + 1).astype(np.float32)}


def _both(name, jfn, tfn, args, grad_args):
  """Value and gradient (of the sum, weighted by fixed random weights)
  with respect to ``grad_args`` on both sides."""
  d = _data()
  jx = [jnp.asarray(d[a]) for a in args]
  tx = [torch.from_numpy(d[a].copy()).requires_grad_(a in grad_args)
        for a in args]
  want = np.asarray(jfn(*jx))
  got = tfn(*tx)
  np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                             atol=1e-6, err_msg=name)
  wts = np.asarray(np.random.RandomState(1).rand(*want.shape), np.float32)
  idx = [i for i, a in enumerate(args) if a in grad_args]

  def jloss(*g):
    full = list(jx)
    for i, v in zip(idx, g):
      full[i] = v
    return jnp.sum(jfn(*full) * wts)
  jgrads = jax.grad(jloss, argnums=tuple(range(len(idx))))(
      *[jx[i] for i in idx])
  (got * torch.from_numpy(wts)).sum().backward()
  for i, jg in zip(idx, jgrads):
    np.testing.assert_allclose(tx[i].grad.numpy(), np.asarray(jg),
                               rtol=1e-4, atol=1e-6,
                               err_msg=f'{name} d/d{args[i]}')


CASES = {
    'cum_min': (JL.f_cum_min, L.f_cum_min, ['s_out'], ['s_out']),
    'cum_max': (JL.f_cum_max, L.f_cum_max, ['s_out'], ['s_out']),
    'inter': (JL.f_inter, L.f_inter, ['y_out', 'y_out2'], ['y_out']),
    'union': (JL.f_union, L.f_union, ['y_out', 'y_out2'], ['y_out']),
    'iou': (JL.f_iou, L.f_iou, ['y_out', 'y_out2'], ['y_out']),
    'iou_pairwise': (lambda a, b: JL.f_iou(a, b, pairwise=True),
                     lambda a, b: L.f_iou(a, b, pairwise=True),
                     ['y_out', 'y_gt'], ['y_out']),
    'dice': (JL.f_dice, L.f_dice, ['y_out', 'y_out2'], ['y_out']),
    'dice_pairwise': (lambda a, b: JL.f_dice(a, b, pairwise=True),
                      lambda a, b: L.f_dice(a, b, pairwise=True),
                      ['y_out', 'y_gt'], ['y_out']),
    'iou_box': (lambda tl, s, tlg, sg: JL.f_iou_box(
        tl[:, :, None], (tl + s)[:, :, None], tlg[:, None], (tlg + sg)[:,
                                                                    None]),
                lambda tl, s, tlg, sg: L.f_iou_box(
        tl[:, :, None], (tl + s)[:, :, None], tlg[:, None], (tlg + sg)[:,
                                                                    None]),
                ['tl', 'size', 'tl_gt', 'size_gt'], ['tl', 'size']),
    'weighted_coverage': (
        lambda a, b: JL.f_weighted_coverage(JL.f_iou(a, b, pairwise=True), b),
        lambda a, b: L.f_weighted_coverage(L.f_iou(a, b, pairwise=True), b),
        ['y_out', 'y_gt'], ['y_out']),
    'unweighted_coverage': (
        lambda a, b: JL.f_unweighted_coverage(
            JL.f_iou(a, b, pairwise=True), jnp.array([3.0, 2.0])),
        lambda a, b: L.f_unweighted_coverage(
            L.f_iou(a, b, pairwise=True), torch.tensor([3.0, 2.0])),
        ['y_out', 'y_gt'], ['y_out']),
    'bce': (JL.f_bce, L.f_bce, ['y_out', 'y_out2'], ['y_out']),
    'bce_minmax': (lambda s, m: JL.f_bce_minmax(
        JL.f_cum_min(s), JL.f_cum_max(s), jnp.sum(m, 2)),
                   lambda s, m: L.f_bce_minmax(
        L.f_cum_min(s), L.f_cum_max(s), torch.sum(m, 2)),
                   ['s_out', 'match'], ['s_out']),
    'conf_loss': (JL.f_conf_loss, L.f_conf_loss, ['s_out', 'match'],
                  ['s_out']),
    'conf_loss_no_cum_min': (
        lambda s, m: JL.f_conf_loss(s, m, use_cum_min=False),
        lambda s, m: L.f_conf_loss(s, m, use_cum_min=False),
        ['s_out', 'match'], ['s_out']),
    'match_loss_bce': (
        lambda a, b, m: JL.f_match_loss(a, b, m, JL.f_bce),
        lambda a, b, m: L.f_match_loss(a, b, m, L.f_bce),
        ['y_out', 'y_gt', 'match'], ['y_out']),
    'match_loss_huber': (
        lambda a, b, m: JL.f_match_loss(a, b, m, JL.f_huber),
        lambda a, b, m: L.f_match_loss(a, b, m, L.f_huber),
        ['params', 'params_gt', 'match'], ['params']),
    'match_loss_squared': (
        lambda a, b, m: JL.f_match_loss(a, b, m, JL.f_squared_err),
        lambda a, b, m: L.f_match_loss(a, b, m, L.f_squared_err),
        ['params', 'params_gt', 'match'], ['params']),
    'huber': (JL.f_huber, L.f_huber, ['params', 'params2'], ['params']),
    'squared_err': (JL.f_squared_err, L.f_squared_err,
                    ['params', 'params2'], ['params']),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_loss_and_gradient_match_jax(name):
  jfn, tfn, args, grad_args = CASES[name]
  _both(name, jfn, tfn, args, grad_args)


def test_huber_is_symmetric():
  err = torch.tensor([-3.0, -0.5, 0.5, 3.0])
  got = L.f_huber(err, torch.zeros(4))
  assert torch.equal(got, got.flip(0))
  np.testing.assert_allclose(got.numpy(),
                             np.asarray(JL.f_huber(jnp.asarray(err.numpy()),
                                                   jnp.zeros(4))))


def test_union_adds_eps_per_pixel():
  a = torch.zeros(1, 1, H, W)
  assert float(L.f_union(a, a)) == pytest.approx(L.EPS * H * W, rel=1e-5)


def test_greedy_match_splits_exact_ties():
  score = np.array([[0.2, 0.7, 0.7, 0.1], [0.9, 0.3, 0.9, 0.9],
                    [0.5, 0.5, 0.5, 0.5]], np.float32)
  matched = np.array([[0, 0, 0, 0], [0, 0, 1, 0], [1, 0, 0, 0]], np.float32)
  got = L.f_greedy_match(torch.from_numpy(score), torch.from_numpy(matched))
  want = np.asarray(JL.f_greedy_match(jnp.asarray(score),
                                      jnp.asarray(matched)))
  np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(want[0], [0, 0.5, 0.5, 0])


def test_counting_metrics_match_jax():
  d = _data()
  s_out, s_gt = d['s_out'], d['s_gt']
  for jfn, tfn in ((JL.f_count_acc, L.f_count_acc), (JL.f_dic, L.f_dic),
                   (lambda a, b: JL.f_dic(a, b, abs=True),
                    lambda a, b: L.f_dic(a, b, abs=True))):
    assert float(tfn(torch.from_numpy(s_out), torch.from_numpy(s_gt))) == \
        pytest.approx(float(jfn(jnp.asarray(s_out), jnp.asarray(s_gt))))
