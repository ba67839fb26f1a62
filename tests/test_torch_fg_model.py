"""The port's fg model against the JAX package's ``fg_model_forward``
(eval).

1. The skip plan of the DCNN equals JAX ``_dcnn_skip_plan`` for the tiny,
   KITTI and Cityscapes presets.
2. Tiny configs: JAX ``init_fg_model`` parameters, the weights scaled up so
   that the activations leave the near-constant regime of the 0.01 init,
   through ``params_from_jax``; 'y_out' and 'd_out' at rtol 1e-4 / atol
   1e-5 (float32 conv stacks that sum in other orders in XLA and oneDNN).
3. The committed synth3 checkpoint, read by ``params_from_checkpoint``
   (its parameters after the momentum state), equals the JAX ``Saver``'s
   restore leaf for leaf, and its forward at b2, 128x448, matches JAX's at
   atol 1e-5 on 'y_out' and 'd_out' (measured 1.3e-6 and 3.7e-6); the
   KITTI preset equals the folder's ``model_opt.yaml``.
"""

import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from rec_attend_tpu import config as JC
from rec_attend_tpu.engine.saver import Saver
from rec_attend_tpu.models import fg_model as JG
from rec_attend_tpu.parallel.train_step import make_optimizer
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch.data.synthetic import synthetic_images
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.models import fg_model as TG

torch.set_num_threads(1)

FG_SYNTH3 = os.path.join(os.path.dirname(__file__), '..', 'results',
                         'fg_model_synth3-20260818a')
VARIANTS = {
    'tiny': {},
    'orientation': dict(add_orientation=True, dcnn_depth=(8, 4, 9)),
    'semantic_classes': dict(num_semantic_classes=3, dcnn_depth=(8, 4, 3)),
    'skip_masks': dict(cnn_skip_mask=(0, 1, 1), dcnn_skip_mask=(1, 0, 0),
                       add_orientation=True, dcnn_depth=(8, 4, 9)),
    'no_skip': dict(add_skip_conn=False),
}


def _port_cfg(jcfg):
  return C.FGModelConfig.from_dict(jcfg.to_dict())


def _jax_forward(params, jcfg, x):
  y_gt = np.zeros(x.shape[:3] + (jcfg.num_semantic_classes,), np.float32)
  batch = {'x': x, 'y_gt': y_gt}
  out, _ = jax.jit(lambda p, b: JG.fg_model_forward(
      p, b, jcfg, False, jax.random.PRNGKey(1)))(params, batch)
  return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize('preset', ['tiny_fg_config', 'kitti_fg_config',
                                    'cityscapes_fg_config'])
def test_dcnn_skip_plan_matches_jax(preset):
  jcfg = getattr(JC, preset)()
  want_src, want_ch = JG._dcnn_skip_plan(jcfg)
  got_src, got_ch = TG._dcnn_skip_plan(_port_cfg(jcfg))
  assert list(got_src) == list(want_src)
  assert got_ch == (None if want_ch is None else list(want_ch))


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_tiny_forward_matches_jax(variant):
  jcfg = JC.tiny_fg_config(**VARIANTS[variant])
  cfg = _port_cfg(jcfg)
  rng = np.random.RandomState(0)
  params = JG.init_fg_model(jax.random.PRNGKey(0), jcfg)
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) * (1 + 60 * rng.rand(*a.shape)).astype(
          np.float32) if a.ndim >= 2 else np.asarray(a), params)
  x = rng.rand(2, cfg.inp_height, cfg.inp_width, 3).astype(np.float32)
  want = _jax_forward(params, jcfg, x)
  model = TG.FGModel(cfg, device='cpu')
  model.load_state_dict(convert.params_from_jax(params))
  got = model(torch.from_numpy(x))
  keys = ['y_out'] + (['d_out'] if jcfg.add_orientation else [])
  assert sorted(got) == sorted(keys)
  for k in keys:
    assert got[k].shape == want[k].shape
    np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4, atol=1e-5,
                               err_msg=k)
    # The scaled weights give outputs that are not constant.
    assert want[k].std() > 1e-3, k


def test_forward_rejects_bad_inputs():
  model = TG.FGModel(C.tiny_fg_config(), device='cpu')
  with pytest.raises(ValueError, match='takes'):
    model(torch.zeros(1, 32, 64, 3))
  with pytest.raises(ValueError, match='heads'):
    TG.FGModel(C.tiny_fg_config(add_orientation=True), device='cpu')


def test_kitti_preset_matches_the_synth3_folder():
  """Every field of the KITTI fg preset (the fields that shape the
  forward) equals the committed model_opt.yaml's."""
  want = C.FGModelConfig.from_yaml(os.path.join(FG_SYNTH3, 'model_opt.yaml'))
  got = C.kitti_fg_config()
  for fld in dataclasses.fields(C.FGModelConfig):
    assert getattr(got, fld.name) == getattr(want, fld.name), fld.name
  assert dataclasses.asdict(_port_cfg(JC.kitti_fg_config())) == (
      dataclasses.asdict(got))


def test_synth3_checkpoint_matches_jax():
  cfg, jcfg = C.kitti_fg_config(), JC.kitti_fg_config()
  state = convert.params_from_checkpoint(saver.latest_checkpoint(FG_SYNTH3),
                                         cfg)
  # The JAX trainer's restore: params and the momentum state.
  params = JG.init_fg_model(jax.random.PRNGKey(0), jcfg)
  tree, step = Saver(FG_SYNTH3).restore(
      {'params': params, 'opt_state': make_optimizer(jcfg).init(params)})
  assert step == 3000
  want = convert.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                     tree['params']))
  assert sorted(want) == sorted(state) and len(state) == 170
  for k, v in want.items():
    np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)

  x = synthetic_images(2, 128, 448, seed=3).numpy()
  want = _jax_forward(tree['params'], jcfg, x)
  model = TG.FGModel(cfg, device='cpu')
  model.load_state_dict(state)
  got = model(torch.from_numpy(x))
  assert got['y_out'].shape == (2, 128, 448, 1)
  assert got['d_out'].shape == (2, 128, 448, 8)
  for k in ('y_out', 'd_out'):
    np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-5,
                               err_msg=k)
  # The trained model marks foreground and background in these images.
  y = got['y_out'].numpy()
  assert 0.05 < (y > 0.5).mean() < 0.95
