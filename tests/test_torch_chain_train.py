"""chip_smoke.py's chain_train phase, run on the CPU at a tiny size.

On the card the phase trains the synth3 chain's three stages at the KITTI
presets from the committed checkpoints.  Here it runs the same code on tiny
configs of the same shape (the fg model with its orientation head and
momentum, the box model on the packed channels, the full model on them)
from checkpoints that the JAX package's ``Saver`` writes, each with a
random optimizer state (a momentum trace of zeros would make the
trace-reset control a no-op).  On the CPU the kernel glimpses are their
plain versions, so every gate must pass and every control must fail them;
no launch is counted.
"""

import os
import sys

import numpy as np
import jax
import pytest
import torch

from rec_attend_tpu import config as JC
from rec_attend_tpu.engine.saver import Saver
from rec_attend_tpu.models import box_model as JB
from rec_attend_tpu.models import fg_model as JG
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu.parallel.train_step import make_optimizer
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch.ops.cuda import glimpse as gk

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

PACKED = dict(add_d_out=True, add_y_out=True, dynamic_var=True, remat=True)
JCFGS = (
    JC.tiny_fg_config(add_orientation=True, dcnn_depth=(8, 4, 9),
                      optimizer='momentum', segm_loss_fn='bce'),
    JC.tiny_box_config(**PACKED),
    JC.tiny_full_config(use_knob=True, ctrl_add_inp=True,
                        ctrl_add_canvas=True, **PACKED),
)


# The full stage's limits on the card rest on its float32 floor at the
# KITTI preset.  At this size the dropped-filter control moves all gradients
# by 5e-4 and the median leaf by 1.4e-3 only (here the confidence loss,
# which reaches the controller without the filters, outweighs the box
# loss), inside those limits, while the tiny step's floor (reordered plain
# against plain, CPU) is 3.0e-7 and 1.3e-7.  So here those two gates are
# held to 1e-5, tighter than on the card, and the control must fail them.
TINY_FULL_LIMITS = {**cs.FULL_STEP_LIMITS, 'grad_rel_l2_all': 1e-5,
                    'grad_rel_l2_median': 1e-5}


def _save(folder, jcfg, init_fn, step, seed):
  rng = np.random.RandomState(seed)
  params = init_fn(jax.random.PRNGKey(seed), jcfg)
  # Random moments or trace; the update counts at the checkpoint's step.
  opt_state = jax.tree_util.tree_map(
      lambda a: (rng.rand(*a.shape) * 1e-3).astype(np.float32)
      if a.ndim else np.asarray(step, a.dtype),
      make_optimizer(jcfg).init(params))
  Saver(folder, model_opt=jcfg).save({'params': params,
                                      'opt_state': opt_state}, step)


@pytest.fixture(scope='module')
def phase(tmp_path_factory):
  root = tmp_path_factory.mktemp('chain')
  dirs = tuple(str(root / name) for name in ('fg', 'box', 'full'))
  for i, (folder, jcfg, init_fn, step) in enumerate(zip(
      dirs, JCFGS, (JG.init_fg_model, JB.init_box_model, JF.init_full_model),
      (30, 40, 50))):
    _save(folder, jcfg, init_fn, step, seed=i)
  cfgs = (C.FGModelConfig.from_dict(JCFGS[0].to_dict()),
          C.BoxModelConfig.from_dict(JCFGS[1].to_dict()),
          C.FullModelConfig.from_dict(JCFGS[2].to_dict()))
  assert cfgs[1].ccnn_inp_depth == cfgs[2].ccnn_inp_depth == 13
  return cs.chain_train_phase(torch, gk, torch.device('cpu'), cfgs=cfgs,
                              dirs=dirs, n_steps=(2, 2, 1, 1), batch=2,
                              examples=4, limits=(cs.FG_STEP_LIMITS,
                                                  cs.BOX_STEP_LIMITS,
                                                  TINY_FULL_LIMITS))


def test_gates_pass_and_controls_fail(phase):
  out, failures = phase
  assert failures == []
  fg = out['fg']['gates']
  assert fg['card_vs_cpu_b2']['failed'] == []
  assert 'update_rel_l2_max' in fg['trace_reset_vs_cpu']['failed']
  assert 'grad_rel_l2_max' in fg['no_orientation_ce_vs_cpu']['failed']
  for stage in ('box', 'full'):
    gates = out[stage]['gates']
    assert gates['kernel_vs_plain']['failed'] == [], stage
    assert 'grad_rel_l2_max' in gates[
        'dropped_filter_grads_vs_plain_pinned']['failed'], stage
  assert 'grad_rel_l2_median' in out['full']['gates'][
      'dropped_filter_grads_vs_plain_pinned']['failed']
  assert out['box']['gates']['card_vs_cpu_b2']['failed'] == []


def test_every_stage_trains_from_its_checkpoint(phase):
  out, _ = phase
  assert out['fg']['momentum_count'] == 32
  assert [s['step'] for s in out['fg']['steps']] == [30, 31]
  assert [s['step'] for s in out['box']['steps']] == [40, 41]
  assert [s['step'] for s in out['full']['from_box']['steps']] == [0]
  assert [s['step'] for s in out['full']['restored']['steps']] == [50]
  for summary in (out['fg'], out['box'], out['full']['from_box'],
                  out['full']['restored']):
    for s in summary['steps']:
      assert np.isfinite(s['metrics']['loss'])
      assert s['ms'] is None     # no device time on the CPU
  assert out['pack']['examples'] == 4
