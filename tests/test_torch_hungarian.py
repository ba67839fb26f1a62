"""The port's Hungarian solver against JAX's default matcher.

JAX's losses match with ``matcher='jax'`` by default: the shortest-
augmenting-path solver of ``rec_attend_tpu/ops/hungarian.py``, run in-graph
under ``vmap``.  The port's ``ops/hungarian.py`` is its counterpart: the
kernel ``csrc/hungarian.cu`` on the card, ``hungarian_plain`` (the same
algorithm in PyTorch operations) on the CPU.  Held here, on the CPU:

  hungarian_plain against JAX's jitted ``hungarian``, the matching, c_x and
    c_y with the same bits (float32 viewed as int32, NaN included), on the
    sets of ``chip_smoke.hungarian_cases`` (those the card's hungarian
    phase holds the kernel to the plain version on: weights as the steps
    make them at every step shape, ties, a rectangular set, JAX's reference
    matrices, a problem that reaches the iteration cap) and on one problem
    given as a matrix;
  ``f_segm_match`` with its default against JAX's default, exactly;
  the fault of ROADMAP C.18: on the IoU that JAX's loss matches on in the
    T=10 batches below, JAX's two matchers choose different matchings (so
    the ties are exercised); the port's default gives JAX's default
    matchings and the port's 'native' JAX's 'native' ones;
  one train step of the full model (T=10, knob off and knob on with
    remat) and of the box model on those batches, with the port's default
    matcher against JAX's default ``make_train_step``, at the tolerances of
    ``test_torch_train_step.py``; on one more knob-off batch, where JAX's
    jitted and op-by-op runs give one gradient leaf 1.5e-2 apart, the
    port's step against JAX's op-by-op loss at those tolerances
    (ROADMAP C.19);
  a lane-level numpy model of the kernel's Dijkstra step (u by row
    through the inverse map q, the used bit mask, the argmin as a
    reduction of order keys) against JAX's solver, bit for bit, on every
    set of ``hungarian_cases`` and on random problems up to n = 70, with
    the invariant the u update rests on (no row r >= 1 named twice)
    asserted on every state; the keys against ``jnp.argmin`` (controls:
    -0.0 below +0.0, NaN last); the u update against ``np.add.at``
    (control: a state that names a row twice); the model's citations of
    the kernel's lines.
"""

import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rec_attend_tpu import config as JC
from rec_attend_tpu.models import box_model as JB
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu.ops import hungarian as JH
from rec_attend_tpu.ops import losses as JL
from rec_attend_tpu.ops import matching as JM
from rec_attend_tpu.parallel import train_step as JT
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch import train_step as TS
from rec_attend_tpu_torch.models import box_model as TB
from rec_attend_tpu_torch.models import full_model as TF
from rec_attend_tpu_torch.ops import hungarian as H
from rec_attend_tpu_torch.ops import matching as M
from rec_attend_tpu_torch.ops.cuda import build
from rec_attend_tpu_torch.ops.cuda import hungarian as hk
import test_hungarian as jax_tests
import test_torch_box_model as box_t
import test_torch_train_step as full_t
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

CASES = cs.hungarian_cases(np)
T = 10
# (model, variant, params seed, batch seed, key): batches at T=10 on which
# JAX's two matchers choose different matchings.  In the box case they
# match a different number of present instances (8 of 9 against 9 in
# example 0), so the two losses differ (0.3690 against 0.3792).
TIE_CASES = {
    'full_knob_off': ('full', 'knob_off', 2, 2, 1),
    'full_knob_off_xla_gap': ('full', 'knob_off', 0, 2, 2),
    'full_knob_on_remat': ('full', 'knob_on_remat', 0, 1, 2),
    'box_flips_iou_box': ('box', 'flips_iou_box', 0, 2, 2),
}
# On this tie batch JAX's jitted step and JAX run op by op
# (``jax.disable_jit``, the same float32 operations in other fusions and
# summation orders) give ctrl_cnn.0.w gradients 1.46e-2 of the leaf's
# largest magnitude apart (in its canvas-channel slice [:, :, 3, 3]),
# while every other leaf and both matchings agree; the port lies within
# 1.2e-5 of the op-by-op run on every leaf.  ROADMAP C.19.
XLA_GAP_CASE = 'full_knob_off_xla_gap'
STEP_CASES = sorted(set(TIE_CASES) - {XLA_GAP_CASE})


def _bits(*arrays):
  return [np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)
          for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_hungarian():
  return jax.jit(JH.hungarian)


def _assert_same_bits(got, want, what):
  got = [t.numpy() for t in got]
  want = [np.asarray(a) for a in want]
  for name, g, w in zip(('matching', 'c_x', 'c_y'), got, want):
    assert g.shape == w.shape, (what, name, g.shape, w.shape)
    np.testing.assert_array_equal(*_bits(g, w), err_msg=f'{what} {name}')


def test_the_reference_matrices_are_jaxs_tests():
  """chip_smoke's copy of JAX's reference matrices has their bits."""
  assert sorted(cs.HUNGARIAN_REFERENCE) == sorted(
      ['W1', 'W2', 'W3', 'WR1', 'WR2', 'WR3', 'WR4', 'WR5', 'WR6'])
  for name, w in cs.HUNGARIAN_REFERENCE.items():
    np.testing.assert_array_equal(*_bits(np.asarray(w, np.float32),
                                         getattr(jax_tests, name)),
                                  err_msg=name)


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_equals_jax_bit_for_bit(case):
  w = CASES[case]
  _assert_same_bits(H.hungarian_plain(torch.from_numpy(w)),
                    _jax_hungarian()(jnp.asarray(w)), case)


def test_the_cases_cover_the_step_shapes_ties_and_the_cap():
  for b, t in cs.HUNGARIAN_STEP_SHAPES:
    w = CASES[f'step_{b}x{t}x{t}']
    assert w.shape == (b, t, t)
    # Ties: weights equal to another of the same problem.
    assert all(len(np.unique(p)) < p.size // 2 for p in w)
  w = torch.from_numpy(CASES['nan_capped'])
  n = w.shape[-1]
  assert int(H.dijkstra_steps(w).max()) == n + 2
  assert bool(torch.isnan(w - w).any())
  # Elsewhere no row reaches the cap: row i visits at most i columns.
  steps = H.dijkstra_steps(torch.from_numpy(CASES['step_64x21x21']))
  assert (steps <= torch.arange(1, 22)).all()


@pytest.mark.parametrize('name', ['W2', 'WR1'])
def test_one_problem_has_jaxs_shapes_and_bits(name):
  w = getattr(jax_tests, name)
  got = H.hungarian(torch.from_numpy(w))
  want = JH.hungarian(jnp.asarray(w))
  assert got[1].shape == (w.shape[0], 1) and got[2].shape == (1, w.shape[1])
  _assert_same_bits(got, want, name)


def test_hungarian_solves_a_cpu_tensor_with_the_plain_version():
  w = torch.from_numpy(CASES['thirds'])
  for a, b in zip(H.hungarian(w), H.hungarian_plain(w)):
    assert torch.equal(a, b)
  # float64 weights are cast to float32, as JAX casts them.
  for a, b in zip(H.hungarian(w.double()), H.hungarian_plain(w)):
    assert a.dtype == torch.float32 and torch.equal(a, b)


def test_the_kernel_binding_refuses_what_it_does_not_take():
  with pytest.raises(ValueError, match='CUDA tensor'):
    hk.hungarian(torch.zeros(2, 3, 3))
  with pytest.raises(ValueError, match='no solver'):
    H.hungarian(torch.zeros(2, 3, 3, device='meta'))


def test_the_kernel_is_built_by_nvcc_for_sm_90a(monkeypatch):
  monkeypatch.setattr(build, 'find_nvcc', lambda: 'fake-nvcc')
  cmd = build._command('hungarian_cuda', 'out.so')
  assert cmd[0] == 'fake-nvcc' and cmd[-1].endswith('hungarian.cu')
  assert 'arch=compute_90a,code=sm_90a' in cmd and '-v' in cmd
  assert build._command('hungarian', 'out.so')[0] != 'fake-nvcc'


def test_matching_weight_is_jaxs():
  """Within float32 rounding: XLA and PyTorch sum the 441 products in
  other orders."""
  w = CASES['step_16x21x21']
  m = H.hungarian_plain(torch.from_numpy(w))[0]
  np.testing.assert_allclose(
      H.matching_weight(torch.from_numpy(w), m).numpy(),
      np.asarray(JH.matching_weight(jnp.asarray(w), jnp.asarray(m.numpy()))),
      rtol=1e-6)


def _iou_and_presence(seed, b=16, t=21):
  """Pairwise IoU with 70 % zeros and present counts drawn per example:
  the ties of predicted boxes that miss most instances."""
  rng = np.random.RandomState(seed)
  iou = rng.rand(b, t, t).astype(np.float32) * 0.9
  iou[rng.rand(b, t, t) < 0.7] = 0
  s_gt = (np.arange(t) < rng.randint(1, t + 1, (b, 1))).astype(np.float32)
  return iou, s_gt


@pytest.mark.parametrize('seed', [0, 1])
def test_segm_match_default_is_jaxs_default(seed):
  iou, s_gt = _iou_and_presence(seed)
  got = M.f_segm_match(torch.from_numpy(iou), torch.from_numpy(s_gt))
  want = np.asarray(JM.f_segm_match(jnp.asarray(iou), jnp.asarray(s_gt)))
  np.testing.assert_array_equal(got.numpy(), want)
  native = np.asarray(JM.f_segm_match(jnp.asarray(iou), jnp.asarray(s_gt),
                                      matcher='native'))
  assert (native != want).any()
  np.testing.assert_array_equal(
      M.f_segm_match(torch.from_numpy(iou), torch.from_numpy(s_gt),
                     matcher='native').numpy(), native)


def test_segm_match_refuses_an_unknown_matcher():
  with pytest.raises(ValueError, match='matcher'):
    M.f_segm_match(torch.ones(1, 2, 2), torch.ones(1, 2), matcher='scipy')


# ---------------------------------------------------------------------------
# The steps on the tie batches
# ---------------------------------------------------------------------------

def _case(name):
  """(jcfg, cfg, params, batch, key, step, module) of a TIE_CASES entry."""
  model, variant, params_seed, batch_seed, key = TIE_CASES[name]
  if model == 'full':
    over = dict(full_t.AUG, **full_t.VARIANTS[variant][0])
    jcfg = JC.tiny_full_config(timespan=T, **over)
    cfg = C.tiny_full_config(timespan=T, **over)
    return (jcfg, cfg, full_t._params(jcfg, params_seed),
            full_t._batch(cfg, batch_seed), jax.random.PRNGKey(key),
            full_t.VARIANTS[variant][1], full_t)
  jcfg, cfg = box_t._configs(variant, timespan=T)
  return (jcfg, cfg, box_t._params(jcfg, params_seed),
          box_t._batch(cfg, batch_seed), jax.random.PRNGKey(key), 0.0, box_t)


@functools.lru_cache(maxsize=None)
def _jax_fns(name):
  """(step, tx) of a case: step(params, opt_state, batch, key, step),
  jitted, gives ((loss, aux), grads) and the outputs of
  ``make_train_step``'s step, both with JAX's default matcher."""
  jcfg = _case(name)[0]
  loss_fn = (JF.full_model_loss if TIE_CASES[name][0] == 'full'
             else JB.box_model_loss)
  grad_fn = jax.value_and_grad(
      lambda p, b, k, s: loss_fn(p, b, jcfg, True, k, s), has_aux=True)
  step_fn, tx = JT.make_train_step(loss_fn, jcfg, jit=False)
  return jax.jit(lambda p, o, b, k, s: (grad_fn(p, b, k, s),
                                        step_fn(p, o, b, k, s))), tx


@functools.lru_cache(maxsize=None)
def _jax_step(name):
  """JAX's default step of a case from its parameters."""
  _, _, params, batch, key, step, _ = _case(name)
  fn, tx = _jax_fns(name)
  return fn(params, tx.init(params), batch, key,
            jnp.asarray(step, jnp.float32))


def _port(name):
  """(model, torch batch, draws, loss function) of a case."""
  jcfg, cfg, params, batch, key, step, mod = _case(name)
  model = mod._port_model(cfg, params)
  tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
  if mod is full_t:
    draws = full_t.to_torch(full_t.jax_draws(key, jcfg, full_t.B))
    return model, tbatch, draws, TF.full_model_loss
  return model, tbatch, box_t.box_jax_draws(key, jcfg, box_t.B), \
      TB.box_model_loss


MATCHES = {'full': ('match', 'match_box'), 'box': ('match_box',)}


@pytest.mark.parametrize('name', sorted(TIE_CASES))
def test_the_matchers_disagree_and_the_port_follows_each(name):
  """The fault (ROADMAP C.18): on the IoU that JAX's loss matches on
  (the full model's box and mask IoU stacked to [2B, T, T], the box
  model's [B, T, T]), JAX's two matchers pick different matchings; the
  port's default picks JAX's default's, its 'native' JAX's 'native'.  The
  port's own forward rounds a few weights to the other side of 1e-6, so
  both sides match the same IoU here; the step test below matches the
  port's."""
  ((_, j_aux), _), _ = _jax_step(name)
  out = j_aux['outputs']
  s_gt = np.array(out['s_gt'])
  iou = np.array(out['iou_soft_box_t'])
  if TIE_CASES[name][0] == 'full':
    iou = np.concatenate([iou, np.asarray(JL.f_iou(
        out['y_out'], out['y_gt_trans'], pairwise=True))])
    s_gt = np.concatenate([s_gt, s_gt])
  want = {m: np.asarray(JM.f_segm_match(jnp.asarray(iou), jnp.asarray(s_gt),
                                        matcher=m))
          for m in ('jax', 'native')}
  # JAX's default is what its loss matched with.
  np.testing.assert_array_equal(want['jax'], np.concatenate([
      np.asarray(j_aux[k]) for k in MATCHES[TIE_CASES[name][0]][::-1]]))
  assert (want['jax'] != want['native']).any()
  for m in ('jax', 'native'):
    got = M.f_segm_match(torch.from_numpy(iou), torch.from_numpy(s_gt),
                         matcher=m)
    np.testing.assert_array_equal(got.numpy(), want[m], err_msg=m)


@pytest.mark.parametrize('name', STEP_CASES)
def test_one_step_with_the_default_matcher_matches_jax(name):
  """One step of the port's defaults against JAX's default
  ``make_train_step``: loss and metrics rtol 1e-4, atol 1e-5; the
  matchings equal; every gradient rtol 1e-3, atol 1e-4 of the leaf's
  largest magnitude (the zero-gradient biases below 1e-4 of their weight's
  gradient); the BatchNorm EMA, Adam's moments and the updated parameters
  as ``test_torch_train_step.py`` holds them."""
  _, cfg, _, _, _, step, mod = _case(name)
  ((j_loss, j_aux), j_grads), (j_params, j_opt, j_metrics) = _jax_step(name)
  model, tbatch, draws, _ = _port(name)
  zero = full_t._zero_grad_leaves(model)
  loss, aux, grads = TS.loss_and_grads(model, tbatch, draws, step)
  np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-4,
                             atol=1e-5)
  metric_keys = TF.METRIC_KEYS if mod is full_t else TB.METRIC_KEYS
  for k in metric_keys:
    np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-4,
                               atol=1e-5, err_msg=k)
  for k in MATCHES[TIE_CASES[name][0]]:
    np.testing.assert_array_equal(aux[k].numpy(), np.asarray(j_aux[k]))
  j_grads = full_t._flat(j_grads)
  for k, g in grads.items():
    g = g.numpy()
    if k in zero:
      limit = 1e-4 * float(np.abs(j_grads[zero[k]]).max())
      assert np.abs(g).max() <= limit, k
      assert np.abs(j_grads[k]).max() <= limit, k
    else:
      full_t._close(g, j_grads[k], 1e-3, f'grad {k}')

  old = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
  port_opt, metrics = TS.train_step(model, TS.init_opt_state(model), tbatch,
                                    draws, step)
  np.testing.assert_allclose(float(metrics['loss']), float(j_metrics['loss']),
                             rtol=1e-4, atol=1e-5)
  new_jax = full_t._flat(j_params)
  new_port = {k: v.detach().numpy() for k, v in model.state_dict().items()}
  for k in new_jax:
    if k.endswith(('ema_mean', 'ema_var')):
      full_t._close(new_port[k], new_jax[k], 1e-4, k)
  full_t._assert_updates_agree(old, new_port, new_jax, j_grads, zero,
                               TF.learn_rate(cfg, 0), name)
  j_opt = convert.opt_state_from_jax(j_opt, cfg)
  assert port_opt['count'] == j_opt['count'] == 1
  for k in port_opt['mu']:
    if k in zero:
      continue
    full_t._close(port_opt['mu'][k].numpy(), j_opt['mu'][k].numpy(), 1e-3,
                  f'mu {k}')
    full_t._close(port_opt['nu'][k].numpy(), j_opt['nu'][k].numpy(), 2e-3,
                  f'nu {k}')


def test_the_xla_gap_batch_matches_jax_run_op_by_op():
  """ROADMAP C.19: on XLA_GAP_CASE the port's default step (matchings,
  loss, every gradient) is held at the step test's tolerances to JAX's
  default loss run op by op, and to JAX's jitted one on every leaf but
  ctrl_cnn.0.w, which JAX's two runs give more than 1e-2 apart (so the
  gap is JAX's own, not the port's)."""
  jcfg, _, params, batch, key, step, _ = _case(XLA_GAP_CASE)
  ((j_loss, j_aux), jit_grads), _ = _jax_step(XLA_GAP_CASE)
  jit_grads = full_t._flat(jit_grads)
  with jax.disable_jit():
    (o_loss, o_aux), op_grads = jax.value_and_grad(
        lambda p: JF.full_model_loss(p, batch, jcfg, True, key,
                                     jnp.asarray(step, jnp.float32)),
        has_aux=True)(params)
  op_grads = full_t._flat(op_grads)
  gap = np.abs(jit_grads['ctrl_cnn.0.w'] - op_grads['ctrl_cnn.0.w']).max()
  assert gap > 1e-2 * np.abs(op_grads['ctrl_cnn.0.w']).max()

  model, tbatch, draws, _ = _port(XLA_GAP_CASE)
  zero = full_t._zero_grad_leaves(model)
  loss, aux, grads = TS.loss_and_grads(model, tbatch, draws, step)
  for want in (j_loss, o_loss):
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4,
                               atol=1e-5)
  for k in MATCHES['full']:
    np.testing.assert_array_equal(aux[k].numpy(), np.asarray(j_aux[k]))
    np.testing.assert_array_equal(aux[k].numpy(), np.asarray(o_aux[k]))
  for k, g in grads.items():
    if k in zero:
      limit = 1e-4 * float(np.abs(op_grads[zero[k]]).max())
      assert np.abs(g.numpy()).max() <= limit, k
      continue
    full_t._close(g.numpy(), op_grads[k], 1e-3, f'grad {k} (op by op)')
    if k != 'ctrl_cnn.0.w':
      full_t._close(g.numpy(), jit_grads[k], 1e-3, f'grad {k} (jit)')


# ---------------------------------------------------------------------------
# The kernel's Dijkstra step, modelled lane by lane
# ---------------------------------------------------------------------------
# csrc/hungarian.cu reformulates JAX's step for a warp: u by row through the
# inverse map q, used as a bit mask, the argmin as a reduction of keys.
# There is no nvcc here, so the reformulation is held to JAX in numpy.

F32 = np.float32
KEY_EMPTY = 0xFFFFFFFF
Q_NONE = 255
SIGN = 0x80000000


def kernel_cpl(n):
  """The CPL that ``hungarian_solve_cuda`` launches at n = max(n_x, n_y)."""
  cpl = (n + 32) // 32
  return cpl if cpl <= 2 else 4 if cpl <= 4 else 8


def order_key(mm):
  """``order_key`` of the kernel: float32 values to uint32 keys in
  jnp.argmin's order (NaN 0, -0.0 and +0.0 one key, the sign-flip map)."""
  bits = (mm + F32(0)).astype(F32).view(np.uint32)  # -0.0 -> +0.0
  flip = ((bits.view(np.int32) >> 31).view(np.uint32) | np.uint32(SIGN))
  return np.where(np.isnan(mm), np.uint32(0), bits ^ flip)


def warp_argmin(keys):
  """The kernel's argmin of keys [32 CPL], slot j = lane + 32 c: each
  lane's first slot at its least key, ``__reduce_min_sync`` of the keys,
  then at CPL = 1 the first lane of the ballot, at CPL > 1 a second
  ``__reduce_min_sync`` over the offered indices."""
  by_lane = keys.reshape(-1, 32)
  lanes = np.arange(32)
  first = by_lane.argmin(0)
  best = by_lane[first, lanes]
  least = best.min()
  if by_lane.shape[0] == 1:
    return int(np.flatnonzero(best == least)[0])
  return int(np.where(best == least, lanes + 32 * first, KEY_EMPTY).min())


def build_q(p, n1):
  """q [32 CPL]: a column that names each row (Q_NONE if none; of several,
  the last), as the kernel builds it once a row."""
  q = np.full(p.size, Q_NONE)
  for j in range(n1):
    q[p[j]] = j
  return q


def named_twice(p, n1):
  """The rows r >= 1 that more than one of the columns 0..n names."""
  counts = np.bincount(p[:n1], minlength=p.size)
  return np.flatnonzero(counts[1:] > 1) + 1


def update_u(u, q, used, delta):
  """The kernel's u.at[p].add(where(used, delta, 0)): lane by lane, u[r] +=
  used[q[r]] ? delta : +0.0 for every row that a column names."""
  u = u.copy()
  rows = q != Q_NONE
  u[rows] = u[rows] + np.where(used[q[rows]], delta, F32(0))
  return u


# The parts of ``kernel_model`` by the lines of csrc/hungarian.cu that each
# mirrors: (part, first line, last line, a text those lines hold).
KERNEL_LINES = [
    ('key', 116, 121, 'unsigned order_key(float x)'),
    ('fill', 167, 180, 'cost[(r0 + k + 1) * n + c] = -x[k]'),
    ('q build', 199, 213, 'q_sh[p[c]] = (unsigned char)(lane + 32 * c)'),
    ('u[i0] and used', 222, 226, 'entry(u, i0)'),
    ('cur, minv, mm, keys', 230, 246, 'order_key(mm[c])'),
    ('reduction, delta, p[j1]', 247, 255, '__reduce_min_sync(kFull, best)'),
    ('u update', 259, 264, 'bit(used, q[c])'),
    ('v and minv', 265, 270, 'v[c] = __fsub_rn(v[c]'),
    ('augmentation', 274, 278, 'entry(way, j0)'),
    ('outputs', 281, 303, '= -u[c]'),
]


def kernel_model(w, cpl=None):
  """The kernel's solve of one problem w [n_x, n_y] in numpy float32, lane
  by lane: (matching, c_x, c_y).

  Mirrors ``csrc/hungarian.cu:hungarian_kernel`` (``KERNEL_LINES``): the
  fill (:167-180: cost = -w, -0.0 in the padding, columns 1..n, rows 0..n
  with row 0 zeros); per row p[0] = i and the q build (:199-213), where
  the model asserts the invariant the u update rests on: no row r >= 1
  named twice; the step: u[i0] and the used bit mask (:222-226), cur,
  minv, mm and the keys (:230-246, ``order_key`` :116-121), their
  reduction, delta and p[j1] (:247-255, ``warp_argmin``), the u update
  (:259-264, ``update_u``; the model also asserts that no used column has
  p = 0, the premise of row 0's one addition), v and minv (:265-270); the
  augmentation along way (:274-278); the outputs (:281-303)."""
  n_x, n_y = w.shape
  n = max(n_x, n_y)
  n1 = n + 1
  slots = 32 * (cpl or kernel_cpl(n))
  assert slots >= n1
  cost = np.full((n + 1, n), -0.0, F32)
  cost[0] = 0.0
  cost[1:n_x + 1, :n_y] = -w
  j_all = np.arange(slots)
  real = j_all < n1
  inf = F32(1e30)
  u = np.zeros(slots, F32)
  v = np.zeros(slots, F32)
  p = np.zeros(slots, np.int64)
  for i in range(1, n + 1):
    p[0] = i
    q = build_q(p, n1)
    assert not named_twice(p, n1).size, (i, p[:n1])
    minv = np.full(slots, inf)
    way = np.zeros(slots, np.int64)
    words = np.zeros(slots // 32, np.uint32)
    j0, i0, it = 0, i, 0
    while it < n + 2 and i0 != 0:
      ui0 = u[i0]
      words[j0 >> 5] |= np.uint32(1 << (j0 & 31))
      used = ((words[j_all >> 5] >> (j_all & 31)) & 1).astype(bool)
      crow = np.zeros(slots, F32)
      crow[1:n1] = cost[i0]
      cur = (crow - ui0) - v
      upd = (cur < minv) & ~used & (j_all >= 1)
      minv = np.where(upd, cur, minv)
      way = np.where(upd, j0, way)
      mm = np.where(used | (j_all == 0), inf, minv)
      j1 = warp_argmin(np.where(real, order_key(mm), np.uint32(KEY_EMPTY)))
      delta, i1 = mm[j1], p[j1]
      assert not (used & real & (p == 0)).any(), (i, p[:n1])
      u = update_u(u, q, used, delta)
      v = v - np.where(used, delta, F32(0))
      minv = np.where(used, minv, minv - delta)
      j0, i0, it = j1, i1, it + 1
    it = 0
    while it < n + 2 and j0 != 0:
      j1 = way[j0]
      p[j0] = p[j1]
      j0, it = j1, it + 1
  matching = (p[1:n_y + 1][None, :] - 1 == np.arange(n_x)[:, None])
  return matching.astype(F32), -u[1:n_x + 1], -v[1:n_y + 1]


def model_solve(w, cpl=None):
  """kernel_model over a batch w [B, n_x, n_y], in JAX hungarian's
  shapes."""
  with np.errstate(invalid='ignore'):  # NaN made on purpose (nan_capped)
    out = [kernel_model(x, cpl) for x in w]
  return (np.stack([o[0] for o in out]), np.stack([o[1] for o in out])[..., None],
          np.stack([o[2] for o in out])[:, None, :])


def _model_weights(shape, seed):
  """Weights as f_segm_match makes them, 70 % zero IoU (many ties)."""
  rng = np.random.RandomState(seed)
  iou = rng.rand(*shape).astype(F32)
  iou[rng.rand(*shape) < 0.7] = 0
  return (np.round(iou * 1e6) / 1e6 + 1e-5).astype(F32)


# (B, n_x, n_y) up to n = 70: CPL 3 at n + 1 > 64 (the kernel launches 4).
MODEL_SHAPES = [(2, 70, 70), (2, 64, 41), (3, 33, 40), (4, 7, 12)]


def _model_sets():
  sets = {f'case_{k}': (v, None) for k, v in sorted(CASES.items())}
  for seed in (0, 1):
    for shape in MODEL_SHAPES:
      w = _model_weights(shape, seed)
      n1 = max(shape[1:]) + 1
      for cpl in sorted({(n1 + 31) // 32, kernel_cpl(n1 - 1)}):
        sets[f'seed{seed}_{"x".join(map(str, shape))}_cpl{cpl}'] = (w, cpl)
  return sets


MODEL_SETS = _model_sets()


@pytest.mark.parametrize('name', sorted(MODEL_SETS))
def test_the_kernels_step_model_is_jaxs_bit_for_bit(name):
  """The model, which asserts on every state that no row r >= 1 is named
  twice and no used column has p = 0, gives JAX's bits."""
  w, cpl = MODEL_SETS[name]
  _assert_same_bits([torch.from_numpy(a) for a in model_solve(w, cpl)],
                    _jax_hungarian()(jnp.asarray(w)), name)


def test_the_kernel_model_cites_the_kernels_lines():
  """Each part of the model names the lines of csrc/hungarian.cu that it
  mirrors, in KERNEL_LINES and in kernel_model's docstring, and those
  lines hold the part's text: an edit that moves the kernel's lines fails
  here until the model is read against it again."""
  path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
      __file__))), 'rec_attend_tpu_torch', 'csrc', 'hungarian.cu')
  with open(path) as f:
    lines = f.read().split('\n')
  doc = ' '.join(kernel_model.__doc__.split())
  for part, first, last, text in KERNEL_LINES:
    assert text in '\n'.join(lines[first - 1:last]), (part, first, last)
    assert f':{first}-{last}' in doc, part


# Vectors for the argmin: NaN, -0.0 before +0.0 and after it, +-inf, ties
# at 1e30 (JAX's _INF, mm[0] and every used column), longer than a warp.
ARGMIN_VECTORS = [
    [1e30, 1e30, 1e30],
    [1e30, 0.5, np.nan, 0.2, np.nan],
    [1e30, 0.0, -0.0, 3.0],
    [1e30, -0.0, 0.0, 3.0],
    [1e30, 1.0, 1.0, np.nan],
    [1e30, np.inf, -np.inf, 5.0, -np.inf],
    [1e30, 2.0, 1e30, -1e30, -1e30],
    [-np.nan, 1e30, 4.0],
    [1e30] * 40 + [-0.0, 7.0, 0.0],
    [1e30] * 33 + [0.0] + [1e30] * 10 + [-0.0],
    [1e30] * 65 + [np.nan, 1.0],
]


def _argmin_vectors():
  rng = np.random.RandomState(0)
  # Normal numbers only: XLA on the CPU ranks subnormals as zero.
  pool = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1e30, 1e30, 1.5,
                   -1.5, 2e-38, -2e-38], F32)
  extra = [pool[rng.randint(0, pool.size, rng.randint(1, 97))]
           for _ in range(200)]
  return [np.asarray(v, F32) for v in ARGMIN_VECTORS] + extra


def _kernel_argmin(mm, key):
  """The kernel's argmin of mm with key, over the slots of the CPL that a
  problem of mm.size columns launches with (the rest empty)."""
  slots = 32 * kernel_cpl(mm.size - 1)
  keys = np.full(slots, KEY_EMPTY, np.uint32)
  keys[:mm.size] = key(mm)
  return warp_argmin(keys)


def _key_apart(mm):
  """Control: -0.0 below +0.0."""
  bits = mm.view(np.uint32)
  key = np.where(bits & SIGN, ~bits, bits | SIGN).astype(np.uint32)
  return np.where(np.isnan(mm), np.uint32(0), key)


def _key_nan_last(mm):
  """Control: NaN after every number (but before an empty slot)."""
  return np.where(np.isnan(mm), np.uint32(KEY_EMPTY - 1), order_key(mm))


def test_the_kernels_argmin_keys_are_jnp_argmins_order():
  vectors = _argmin_vectors()
  want = [int(jnp.argmin(jnp.asarray(v))) for v in vectors]
  assert [_kernel_argmin(v, order_key) for v in vectors] == want
  # The order itself: NaN first, -0.0 == +0.0, then by value.
  keys = order_key(np.array([np.nan, -np.inf, -1e30, -1e-45, -0.0, 0.0,
                             1e-45, 1e30, np.inf], F32))
  assert keys[0] == 0 and keys[4] == keys[5]
  assert (np.diff(keys[[0, 1, 2, 3, 4, 6, 7, 8]].astype(np.int64)) > 0).all()
  assert keys.max() < KEY_EMPTY
  for control in (_key_apart, _key_nan_last):
    got = [_kernel_argmin(v, control) for v in vectors]
    assert got != want, control.__name__


def _u_states(seed, n1, twice):
  """(u, p, used, delta) states as the solver holds them: rows matched to
  columns, the rest 0, column 0 the current row, used only where p != 0
  (a column is used only while it names a row), some u at -0.0, delta
  +-0.0, 1e30 or a number; with ``twice``, p names one row r >= 1 twice
  (both columns used in a third of the states)."""
  rng = np.random.RandomState(seed)
  slots = 32 * kernel_cpl(n1 - 1)
  states = []
  for k in range(60):
    p = np.zeros(slots, np.int64)
    rows = rng.permutation(np.arange(1, n1))[:rng.randint(2, n1)]
    p[0] = rows[0]
    p[rng.permutation(np.arange(1, n1))[:rows.size - 1]] = rows[1:]
    a = rng.choice(np.flatnonzero(p[:n1]))
    b = rng.choice(np.delete(np.arange(n1), a))
    if twice:
      p[b] = p[a]
    used = (p != 0) & (rng.rand(slots) < 0.5)
    if twice and k % 3 == 0:
      used[[a, b]] = True
    used[n1:] = False
    u = rng.randn(slots).astype(F32)
    u[rng.rand(slots) < 0.2] = -0.0
    delta = F32(rng.choice([rng.randn(), 0.0, -0.0, 1e30]))
    states.append((u, p, used, delta))
  return states


@pytest.mark.parametrize('n1', [22, 71])
def test_the_kernels_u_update_routes_are_npaddat(n1):
  """The kernel's u update, one lane-local addition a row through q, gives
  np.add.at's bits (one addition a column, in column order) on states as
  the solver holds them; on states that name a row twice it does not,
  which is why the kernel rests on the invariant that the model asserts."""
  for u, p, used, delta in _u_states(n1, n1, twice=False):
    assert not named_twice(p, n1).size
    want = u.copy()
    np.add.at(want, p[:n1], np.where(used[:n1], delta, F32(0)))
    got = update_u(u, build_q(p, n1), used, delta)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
  differs = False
  for u, p, used, delta in _u_states(n1, n1, twice=True):
    assert named_twice(p, n1).size == 1
    want = u.copy()
    np.add.at(want, p[:n1], np.where(used[:n1], delta, F32(0)))
    got = update_u(u, build_q(p, n1), used, delta)
    differs |= not np.array_equal(got.view(np.int32), want.view(np.int32))
  assert differs
