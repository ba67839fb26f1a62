"""The train-step gates of chip_smoke.py, run on the CPU at a tiny size.

chip_smoke.py holds a train step with the kernel glimpses against the step
with the plain einsums, from the same state, batch and draws.  Where the two
steps' Hungarian matchings differ, the gate compares the step taken with the
reference's matching pinned.  Here, on the CPU, the 'kernel' glimpses run
the Functions' plain contractions, so the gates must pass them; the step
whose glimpse backward drops the filter gradients must fail them; and a
pinned step must use the matching it is given.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

from rec_attend_tpu_torch import train_step as ts
from rec_attend_tpu_torch.config import tiny_full_config
from rec_attend_tpu_torch.data.synthetic import synthetic_instances
from rec_attend_tpu_torch.engine.trainer import Trainer
from rec_attend_tpu_torch.models.full_model import draw_train_randoms
from rec_attend_tpu_torch.models.full_model import learn_rate
from rec_attend_tpu_torch.ops import matching
from rec_attend_tpu_torch.ops.cuda import glimpse as gk

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)
BATCH = 4


@pytest.fixture(scope='module')
def setup():
  cfg = tiny_full_config(use_knob=True, remat=True)
  trainer = Trainer(cfg, device='cpu')
  batch = synthetic_instances(BATCH, cfg.inp_height, cfg.inp_width,
                              cfg.timespan, seed=3)
  draws = draw_train_randoms(cfg, BATCH, torch.Generator().manual_seed(1))
  return trainer, batch, draws, learn_rate(cfg, 0)


def _step(setup, glimpse, pinned=None, step=0):
  trainer, batch, draws, _ = setup
  return cs.one_step(torch, ts, matching, trainer.model, trainer.opt_state,
                     batch, draws, step, glimpse, pinned)


@pytest.mark.parametrize('step', [0, 30000])
def test_gates_pass_the_kernel_step_and_fail_the_control(setup, step):
  trainer, batch, draws, lr = setup
  gates, failures = cs.step_gates(torch, ts, matching, gk, trainer.model,
                                  trainer.opt_state, batch, draws, step, lr,
                                  cs.STEP_LIMITS)
  assert failures == []
  assert gates['kernel_vs_plain']['failed'] == []
  assert 'grad_rel_l2_max' in (
      gates['dropped_filter_grads_vs_plain_pinned']['failed'])
  assert gates['kernel_vs_plain']['matches_differ'] == {
      'match': 0, 'match_box': 0, 'grd_match': 0}
  assert gates['kernel_vs_plain']['forward']['s_out_max'] < 1e-5


def test_a_control_that_passes_the_limits_is_a_failure(setup):
  """At this tiny size the control's error of all gradients at once (about
  0.02) is within the flagship's step-30000 limit (0.1), so step_gates must
  report that the gate passes it."""
  trainer, batch, draws, lr = setup
  gates, failures = cs.step_gates(torch, ts, matching, gk, trainer.model,
                                  trainer.opt_state, batch, draws, 30000, lr,
                                  cs.OWN_CANVAS_LIMITS)
  control = gates['dropped_filter_grads_vs_plain_pinned']
  assert control['failed'] == []
  assert failures == ['dropped_filter_grads_vs_plain_pinned: the gradient '
                      "gates ['grad_rel_l2_all'] pass it"]


def test_a_pinned_step_uses_the_given_matching(setup):
  _, batch, _, _ = setup
  m = _step(setup, 'plain')[4]['solved']
  other = m.flip(2)
  got = _step(setup, 'kernel', pinned=other)[4]
  s_gt = batch['s_gt'].float()
  mask = s_gt[:, None, :] * s_gt[:, :, None]
  np.testing.assert_array_equal(got['match_box'].numpy(),
                                (other[:BATCH] * mask).numpy())
  np.testing.assert_array_equal(got['match'].numpy(),
                                (other[BATCH:] * mask).numpy())
  assert not torch.equal(got['match'], m[BATCH:] * mask)


def test_a_step_whose_matching_differs_is_gated_pinned(setup):
  """The reference's matching is changed: the step as it solves is reported
  ungated, the step pinned to the reference's answer is gated."""
  _, _, _, lr = setup
  trainer = setup[0]
  plain = _step(setup, 'plain')
  matches = dict(plain[4], match=1 - plain[4]['match'])
  want = plain[:4] + (matches,)
  held = list(cs.held_steps(torch, trainer.model,
                            lambda pinned: _step(setup, 'kernel', pinned),
                            want, lr, cs.STEP_LIMITS))
  assert [(name, gated) for name, _, gated in held] == [
      ('', False), ('_pinned', True)]
  assert held[0][1]['matches_differ']['match'] == BATCH
  assert held[1][1]['failed'] == []


@pytest.mark.parametrize('option', ['fixed_order', 'rnd_colour'])
def test_the_other_training_options_pass_the_gates(option):
  """chip_smoke.py's bf16 phase gates one step of each: the kernel step
  passes, the dropped-filter-gradient control fails."""
  cfg = tiny_full_config(use_knob=True, remat=True, **{option: True})
  trainer = Trainer(cfg, device='cpu')
  batch = synthetic_instances(BATCH, cfg.inp_height, cfg.inp_width,
                              cfg.timespan, seed=3)
  draws = draw_train_randoms(cfg, BATCH, torch.Generator().manual_seed(1))
  assert ('colour' in draws['aug']) == (option == 'rnd_colour')
  gates, failures = cs.step_gates(torch, ts, matching, gk, trainer.model,
                                  trainer.opt_state, batch, draws, 0,
                                  learn_rate(cfg, 0), cs.STEP_LIMITS)
  assert failures == []
  assert 'grad_rel_l2_max' in (
      gates['dropped_filter_grads_vs_plain_pinned']['failed'])


# The statistics of the bf16 step gate against float64 held to their floor
# at the tiny size.  Only the worst leaf is gated among the gradients: at
# this size the dropped filter gradients move one leaf alone (ctrl_mlp.0.b,
# 0.49 from float64 where the bfloat16 step's worst leaf reads 0.09), so
# all gradients at once and the median leaf read as much as the roundings
# do.
TINY_FLOOR_GATES = ('loss_rel_diff', 'grad_rel_l2_max', 'update_rel_l2_max')


def test_the_bf16_gates_pass_the_step_and_fail_the_control():
  """chip_smoke.py's bf16 train gates at a tiny size on the CPU, where the
  'card' is the CPU: kernel against plain passes STEP_LIMITS and the step
  against the float32 model's in float64 passes twice its floor in
  TINY_FLOOR_GATES; the dropped-filter-gradient controls fail both.  The
  floor's two steps are the CPU's own step here, so they read what the
  gated step reads."""
  cfg = tiny_full_config(use_knob=True, remat=True, dtype='bfloat16')
  trainer = Trainer(cfg, device='cpu')
  batch = synthetic_instances(BATCH, cfg.inp_height, cfg.inp_width,
                              cfg.timespan, seed=3)
  draws = draw_train_randoms(cfg, BATCH, torch.Generator().manual_seed(1))
  small = draw_train_randoms(cfg, cs.TRAIN_CPU_BATCH,
                             torch.Generator().manual_seed(2))
  gates, failures = cs.bf16_step_gates(torch, ts, matching, gk, trainer,
                                       batch, draws, small, learn_rate(cfg, 0),
                                       cs.STEP_LIMITS, TINY_FLOOR_GATES)
  nb = cs.TRAIN_CPU_BATCH
  assert failures == []
  assert gates['kernel_vs_plain']['failed'] == []
  assert gates[f'card_vs_float64_b{nb}']['failed'] == []
  limits = gates[f'card_vs_float64_limits_b{nb}']
  assert set(limits) == {*TINY_FLOOR_GATES, 'zero_grad_share_max',
                         'zero_update_in_lr_max'}
  assert limits['loss_rel_diff'] == (
      cs.BF16_FLOOR_FACTOR * gates[f'cpu_vs_float64_b{nb}']['loss_rel_diff'])
  for name in ('cpu', 'card_cudnn_off'):
    assert gates[f'{name}_vs_float64_b{nb}']['grad_rel_l2_all'] == (
        gates[f'card_vs_float64_b{nb}']['grad_rel_l2_all'])
  for name in ('dropped_filter_grads_vs_plain_pinned',
               f'dropped_filter_grads_vs_float64_b{nb}'):
    assert 'grad_rel_l2_max' in gates[name]['failed'], name


def test_float64_step_is_the_float32_step_to_its_rounding():
  """The float64 step that the bf16 gate holds the card to: the float32
  model's step run in float64 agrees with its float32 step within
  float32's rounding, and the bfloat16 step lies far from both."""
  cfg = tiny_full_config(use_knob=True, remat=True)
  trainer = Trainer(cfg, device='cpu')
  batch = synthetic_instances(2, cfg.inp_height, cfg.inp_width,
                              cfg.timespan, seed=3)
  draws = draw_train_randoms(cfg, 2, torch.Generator().manual_seed(2))
  f32 = cs.one_step(torch, ts, matching, trainer.model, trainer.opt_state,
                    batch, draws, 0, 'kernel')
  exact = cs.float64_step(torch, ts, matching, trainer.model,
                          trainer.opt_state, batch, draws, 0,
                          f32[4]['solved'])
  assert all(v.dtype == torch.float32 for v in exact[1].values())
  lr = learn_rate(cfg, 0)
  stats = cs.step_diff(torch, trainer.model, f32, exact, lr)
  assert cs.step_gate_failures(stats, cs.STEP_LIMITS) == [], stats
  assert stats['grad_rel_l2_all'] < 1e-5, stats
  twin = copy.deepcopy(trainer.model)
  twin.cfg = cfg.replace(dtype='bfloat16')
  bf16 = cs.one_step(torch, ts, matching, twin, trainer.opt_state, batch,
                     draws, 0, 'kernel', f32[4]['solved'])
  assert cs.step_diff(torch, trainer.model, bf16, exact,
                      lr)['grad_rel_l2_all'] > 1e-3


def test_the_bf16_layer_gates_pass_the_layers_and_fail_the_control():
  """chip_smoke.py's bf16 layer gates on the CPU at a tiny size, where the
  'card' is the CPU: every layer passes, its dtypes are the bf16 model's
  (bfloat16 results, float32 weight gradients), and each control (every
  weight 2 % off) fails."""
  cfg = tiny_full_config(dtype='bfloat16')
  gates, failures = cs.bf16_layer_gates(torch, cfg, torch.device('cpu'),
                                        batch=2)
  assert failures == []
  assert set(gates) == {'conv_float32_input', 'conv', 'conv_transpose',
                        'batch_norm_train', 'lstm', 'mlp'}
  for name, g in gates.items():
    assert all(v == 0.0 for v in g['errors'].values()), name
    assert g['dtypes']['out0'] == ('float32' if name == 'lstm'
                                   else 'bfloat16'), name
    assert all(g['dtypes'][k] == 'float32' for k in g['dtypes']
               if k.startswith(('d_w', 'd_gamma', 'd_beta'))), name


def test_a_layer_one_bf16_step_off_fails_the_layer_gate():
  """A bfloat16 result one rounding step off everywhere lies beyond
  BF16_LAYER_LIMIT."""
  cfg = tiny_full_config(dtype='bfloat16')
  name, inputs, fn = cs.bf16_layer_cases(torch, cfg, torch.device('cpu'),
                                         batch=2)[1]
  ref = cs.layer_results(torch, inputs, fn)
  off = cs.layer_results(torch, inputs, lambda p: [
      o * (1 + 2.0 ** -7) for o in fn(p)])
  assert off['out0'].dtype == torch.bfloat16
  err = float((off['out0'].double() - ref['out0'].double()).norm()
              / ref['out0'].double().norm())
  assert err > cs.BF16_LAYER_LIMIT, (name, err)
