"""The train-step gates of chip_smoke.py, run on the CPU at a tiny size.

chip_smoke.py holds a train step with the kernel glimpses against the step
with the plain einsums, from the same state, batch and draws.  Where the two
steps' Hungarian matchings differ, the gate compares the step taken with the
reference's matching pinned.  Here, on the CPU, the 'kernel' glimpses run
the Functions' plain contractions, so the gates must pass them; the step
whose glimpse backward drops the filter gradients must fail them; and a
pinned step must use the matching it is given.
"""

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
  m, cx, cy, capped = _step(setup, 'plain')[4]['solved']
  other = (np.ascontiguousarray(m[:, ::-1]), cx, cy, capped)
  got = _step(setup, 'kernel', pinned=other)[4]
  s_gt = batch['s_gt'].float()
  mask = s_gt[:, None, :] * s_gt[:, :, None]
  np.testing.assert_array_equal(got['match_box'].numpy(),
                                (torch.from_numpy(other[0][:BATCH])
                                 * mask).numpy())
  np.testing.assert_array_equal(got['match'].numpy(),
                                (torch.from_numpy(other[0][BATCH:])
                                 * mask).numpy())


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
