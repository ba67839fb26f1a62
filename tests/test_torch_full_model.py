"""The port's eval forward against JAX full_model_forward(train=False).

Tiny configs: JAX init_full_model params (weights scaled up so that the
activations leave the near-constant regime of the 0.01 init) go through
params_from_jax into the port; each output is compared at rtol 1e-4 and an
atol of 1e-4 times its largest magnitude (at least 1): float32 conv stacks
sum in different orders in XLA and oneDNN, the decoder's patch logits reach
1e3, and the recurrence over T carries the differences forward.

Full width: the flagship CVPPP checkpoint, batch 4.  Differences of 1e-7
pass through 21 canvas feedbacks and the steep output sigmoid
sigmoid(e^2 * y - 5), whose logits reach 300: at mask edges a few pixels
move by up to 0.2 while the rest agree.  So y_out is held by its mean
(1e-5) and by the share of pixels beyond 1e-3 (1e-3), s_out to atol 1e-4:
the limits chip_smoke.py holds the card to.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rec_attend_tpu import config as JC
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch.data.synthetic import synthetic_images
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.models import full_model as TF
from rec_attend_tpu_torch.ops.cuda import glimpse as gk

torch.set_num_threads(1)

FLAGSHIP = os.path.join(os.path.dirname(__file__), '..', 'results',
                        'full_model_synth-20260816104712')
COMPARED = ('y_out', 's_out', 'canvas', 'attn_box', 'y_out_patch',
            'attn_ctr', 'attn_size', 'attn_ctr_norm', 'attn_lg_size',
            'attn_lg_gamma', 'attn_box_lg_gamma', 'y_out_lg_gamma')

VARIANTS = {
    'tiny': {},
    'free_gamma_dynamic_var': dict(fixed_gamma=False, dynamic_var=True,
                                   squash_ctrl_params=False),
    'no_skip_fixed_var': dict(add_skip_conn=False, disable_overwrite=False,
                              fixed_var=True),
}


def _jax_forward(params, cfg, x):
  b = x.shape[0]
  batch = {'x': jnp.asarray(x),
           'y_gt': jnp.zeros((b, cfg.timespan, cfg.inp_height,
                              cfg.inp_width)),
           's_gt': jnp.zeros((b, cfg.timespan))}
  out, _ = jax.jit(lambda p, bt: JF.full_model_forward(
      p, bt, cfg, False, jax.random.PRNGKey(1)))(params, batch)
  return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize('use_pallas', [False, True])
@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_tiny_forward_matches_jax(variant, use_pallas):
  over = VARIANTS[variant]
  jcfg = JC.tiny_full_config(use_pallas=use_pallas, **over)
  cfg = C.tiny_full_config(**over)
  rng = np.random.RandomState(0)
  params = JF.init_full_model(jax.random.PRNGKey(0), jcfg)
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) * (1 + 30 * rng.rand(*a.shape)).astype(
          np.float32) if a.ndim >= 2 else np.asarray(a), params)
  b, h, w = 2, cfg.inp_height, cfg.inp_width
  x = rng.rand(b, h, w, 3).astype(np.float32)
  want = _jax_forward(params, jcfg, x)

  model = TF.FullModel(cfg, device='cpu')
  model.load_state_dict(convert.params_from_jax(params))
  for glimpse in ('kernel', 'plain'):
    got = TF.full_model_forward(model, torch.from_numpy(x), glimpse=glimpse)
    for k in COMPARED:
      scale = max(1.0, float(np.abs(want[k]).max()))
      np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                 atol=1e-4 * scale, err_msg=f'{k} ({glimpse})')


def test_forward_shapes_and_launch_free_cpu_run():
  cfg = C.tiny_full_config()
  model = TF.FullModel(cfg, seed=3, device='cpu')
  x = torch.from_numpy(np.random.RandomState(1).rand(3, 64, 64, 3)
                       .astype(np.float32))
  gk.reset_launch_counts()
  out = TF.full_model_forward(model, x)
  assert out['y_out'].shape == (3, cfg.timespan, 64, 64)
  assert out['s_out'].shape == (3, cfg.timespan)
  assert out['canvas'].shape == (3, 64, 64)
  assert out['y_out_patch'].shape == (3, cfg.timespan, 16, 16)
  assert out['attn_ctr'].shape == (3, cfg.timespan, 2)
  assert all(bool(torch.isfinite(v).all()) for v in out.values())
  assert gk.launch_counts() == {'glimpse_extract': 0, 'glimpse_paste': 0}


def test_forward_rejects_bad_inputs():
  cfg = C.tiny_full_config()
  model = TF.FullModel(cfg, device='cpu')
  with pytest.raises(ValueError):
    TF.full_model_forward(model, torch.zeros(1, 32, 64, 3))
  with pytest.raises(ValueError):
    TF.full_model_forward(model, torch.zeros(1, 64, 64, 3), glimpse='pallas')
  # A config that reads the packed maps refuses a forward without them.
  for over in (dict(add_d_out=True), dict(add_y_out=True)):
    packed = TF.FullModel(C.tiny_full_config(**over), device='cpu')
    with pytest.raises(ValueError, match='is missing'):
      TF.full_model_forward(packed, torch.zeros(1, 64, 64, 3))


def test_flagship_forward_matches_jax():
  """The committed CVPPP checkpoint at full width, batch 4."""
  cfg = C.cvppp_full_config()
  jcfg = JC.cvppp_full_config()
  state = convert.params_from_checkpoint(saver.latest_checkpoint(FLAGSHIP),
                                         cfg)
  params = JF.init_full_model(jax.random.PRNGKey(0), jcfg)
  names = [jax.tree_util.keystr(p, simple=True, separator='.')
           for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
  treedef = jax.tree_util.tree_structure(params)
  params = jax.tree_util.tree_unflatten(
      treedef, [state[n].numpy() for n in names])
  x = synthetic_images(4, 224, 224, seed=5).numpy()
  want = _jax_forward(params, jcfg, x)
  model = TF.FullModel(cfg, device='cpu')
  model.load_state_dict(state)
  got = TF.full_model_forward(model, torch.from_numpy(x))
  assert got['y_out'].shape == (4, 21, 224, 224)
  for k in ('y_out', 'canvas'):
    dy = np.abs(got[k].numpy() - want[k])
    assert dy.mean() < 1e-5, (k, dy.mean())
    assert (dy > 1e-3).mean() < 1e-3, (k, (dy > 1e-3).mean())
  np.testing.assert_allclose(got['s_out'].numpy(), want['s_out'], atol=1e-4,
                             rtol=0)
  # The trained model finds objects in these images and stops after them.
  s = got['s_out'].numpy()
  assert (s[:, 0] > 0.5).all() and (s[:, -1] < 0.5).all()
