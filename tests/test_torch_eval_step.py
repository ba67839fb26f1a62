"""The port's eval step (the loss in eval mode) against the JAX package's
``make_eval_step`` for the full, box and fg models.

Tiny configs (64x64, T=4), the JAX parameters with the weights scaled up
and the numpy-seeded batches of ``test_torch_train_step.py``,
``test_torch_box_model.py`` and ``test_torch_fg_train.py``; in eval only
the box model draws (the noise of the ground truth it paints into its
canvas), and the test rebuilds JAX's draws from the key.  Both sides match
with JAX's default matcher (in the port ``hungarian_plain`` on the CPU, the
same bits).  Every metric of the port's step
(``metric_keys``) is compared at rtol 1e-4, atol 1e-5, the float32
allowance of the train-step tests (XLA's jit reassociates sums, and
``1 - s + eps`` in the confidence BCE).  A train-mode control (the train
loss on the same batch) must differ, so the eval branch is not the train
one by accident.
"""

import jax
import numpy as np
import pytest
import torch

from rec_attend_tpu.models import box_model as JB
from rec_attend_tpu.models import fg_model as JG
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu.parallel import train_step as JT
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch import train_step as TS
from rec_attend_tpu_torch.models.box_model import BoxModel
from rec_attend_tpu_torch.models.family import family
from rec_attend_tpu_torch.models.fg_model import FGModel
from rec_attend_tpu_torch.models.full_model import FullModel
import test_torch_box_model as box_t
import test_torch_fg_train as fg_t
import test_torch_train_step as full_t

torch.set_num_threads(1)

CASES = {
    'full_knob': (full_t, 'knob_on_remat', FullModel,
                  JF.full_model_loss),
    'full_no_knob': (full_t, 'no_knob_canvas_grad', FullModel,
                     JF.full_model_loss),
    'box_packed': (box_t, 'packed_remat', BoxModel,
                   JB.box_model_loss),
    'fg_orientation': (fg_t, 'orientation_momentum', FGModel,
                       JG.fg_model_loss),
    'fg_softmax3': (fg_t, 'softmax3_momentum', FGModel, JG.fg_model_loss),
}


def _port_batch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(mod, batch, jcfg):
  return fg_t._jax_batch(batch, jcfg) if mod is fg_t else batch


@pytest.mark.parametrize('case', sorted(CASES))
def test_eval_step_matches_jax(case):
  mod, variant, model_class, loss_fn = CASES[case]
  jcfg, cfg = mod._configs(variant)
  params = mod._params(jcfg)
  batch = mod._batch(cfg, seed=3)
  key = jax.random.PRNGKey(11)
  want = JT.make_eval_step(loss_fn, jcfg)(params, _jax_batch(mod, batch,
                                                              jcfg), key)
  model = model_class(cfg, device='cpu')
  model.load_state_dict(convert.params_from_jax(params))
  draws = box_t.box_jax_draws(key, jcfg, box_t.B) if mod is box_t else None
  got = TS.eval_step(model, _port_batch(batch), draws)
  keys = family(cfg).metric_keys(cfg)
  assert sorted(got) == sorted(keys)
  assert set(keys) <= set(want)
  for k in keys:
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               rtol=1e-4, atol=1e-5, err_msg=k)
  # BatchNorm's EMA is read, not written, in eval.
  for k, v in convert.params_from_jax(params).items():
    assert torch.equal(model.state_dict()[k], v), k

  # Control: the train loss of the same batch is another number.
  train_draws = (box_t.box_jax_draws(key, jcfg, box_t.B) if mod is box_t
                 else fg_t.fg_jax_draws(key, jcfg) if mod is fg_t
                 else full_t.to_torch(full_t.jax_draws(key, jcfg, full_t.B)))
  with torch.no_grad():
    train_loss, _ = family(cfg).loss(model, TS.decode_batch(
        _port_batch(batch)), train_draws, 0, 'kernel')
  assert abs(float(train_loss) - float(got['loss'])) > 1e-4
