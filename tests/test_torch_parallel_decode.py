"""The parallel decode of the full model (JAX full_model.py:519-541, the
``vmap`` over independent timesteps) in the port: the T timesteps as one
pass over T·B rows, BatchNorm copy t for timestep t's rows.

Held, on tiny configs with one thread:
  - the port's parallel forward against JAX's parallel forward, at
    ``test_torch_full_model.py``'s tolerances (rtol 1e-4, atol 1e-4 times
    the output's largest magnitude, at least 1), with the plain and the
    Pallas (interpret mode) glimpses on the JAX side;
  - the port's parallel forward against its serial one, at JAX's own
    test's rtol 1e-4 / atol 1e-5 (``tests/test_parallel_decode.py``);
  - the path taken: the rule against JAX's (whose serial path holds a
    ``scan`` in its jaxpr), and in the port by the glimpse calls (one
    extract and two pastes over T·B rows, or T and 2T over B);
  - the split of a pass into whole timesteps where T·B passes the
    kernels' batch limit (the limit patched small), equal to one pass;
  - one train step without the knob, remat on and off, against JAX's
    ``make_train_step`` (``test_torch_train_step.py``'s harness and
    tolerances: loss, metrics, gradients, per-timestep EMA, Adam state
    and updated parameters).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_train_step as TTS
from rec_attend_tpu import config as JC
from rec_attend_tpu.models import full_model as JF
from rec_attend_tpu_torch import config as C
from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch import train_step as TS
from rec_attend_tpu_torch.models import full_model as TF
from rec_attend_tpu_torch.ops import attention
from rec_attend_tpu_torch.ops.cuda import glimpse as gk

torch.set_num_threads(1)

INDEPENDENT = dict(ctrl_add_inp=True, ctrl_add_canvas=False,
                   attn_add_inp=True, attn_add_canvas=False,
                   disable_overwrite=False, use_knob=False)
VARIANTS = {
    'independent': {},
    # The knob draws nothing in eval: the eval forward stays parallel.
    'knob_eval': dict(use_knob=True),
    'free_gamma_dynamic_var': dict(fixed_gamma=False, dynamic_var=True,
                                   squash_ctrl_params=False),
    'packed_multiclass': dict(add_d_out=True, add_y_out=True,
                              num_semantic_classes=3),
}
COMPARED = ('y_out', 's_out', 'canvas', 'attn_box', 'y_out_patch',
            'attn_ctr', 'attn_size', 'attn_ctr_norm', 'attn_lg_size',
            'attn_lg_gamma', 'attn_box_lg_gamma', 'y_out_lg_gamma')


def _params(jcfg, seed=0, scale=30):
  rng = np.random.RandomState(seed)
  params = JF.init_full_model(jax.random.PRNGKey(seed), jcfg)
  return jax.tree_util.tree_map(
      lambda a: np.asarray(a) * (1 + scale * rng.rand(*a.shape)).astype(
          np.float32) if a.ndim >= 2 else np.asarray(a), params)


def _inputs(cfg, b, seed=1):
  rng = np.random.RandomState(seed)
  h, w = cfg.inp_height, cfg.inp_width
  out = {'x': rng.rand(b, h, w, 3).astype(np.float32)}
  if cfg.add_d_out:
    out['d_in'] = rng.rand(b, h, w, 8).astype(np.float32)
  if cfg.add_y_out:
    out['y_in'] = rng.rand(b, h, w, cfg.num_semantic_classes).astype(
        np.float32)
  return out


def _jax_batch(cfg, inputs):
  b = inputs['x'].shape[0]
  batch = {k: jnp.asarray(v) for k, v in inputs.items()}
  batch.update(y_gt=jnp.zeros((b, cfg.timespan, cfg.inp_height,
                               cfg.inp_width)),
               s_gt=jnp.zeros((b, cfg.timespan)))
  return batch


def _port(cfg, params):
  model = TF.FullModel(cfg, device='cpu')
  model.load_state_dict(convert.params_from_jax(params))
  return model


def _forward(model, inputs, glimpse='kernel'):
  return TF.full_model_forward(
      model, torch.from_numpy(inputs['x']), glimpse=glimpse,
      **{k: torch.from_numpy(v) for k, v in inputs.items() if k != 'x'})


class Counting:
  """A glimpse pair that records the batch of every call."""

  def __init__(self):
    self.calls = []

  def pair(self):
    def extract(x, f_y, f_x):
      self.calls.append(('extract', x.shape[0]))
      return attention.extract_patch(x, f_y, f_x)

    def paste(p, f_y, f_x):
      self.calls.append(('paste', p.shape[0]))
      return attention.paste_patch(p, f_y, f_x)
    return extract, paste


@pytest.mark.parametrize('use_pallas', [False, True])
@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_parallel_forward_matches_jax(variant, use_pallas):
  over = dict(INDEPENDENT, **VARIANTS[variant])
  jcfg = JC.tiny_full_config(use_pallas=use_pallas, **over)
  cfg = C.tiny_full_config(**over)
  assert TF.parallel_decode(cfg)
  params = _params(jcfg)
  inputs = _inputs(cfg, 2)
  out, _ = jax.jit(lambda p, bt: JF.full_model_forward(
      p, bt, jcfg, False, jax.random.PRNGKey(1)))(params,
                                                  _jax_batch(cfg, inputs))
  model = _port(cfg, params)
  for glimpse in ('kernel', 'plain'):
    got = _forward(model, inputs, glimpse)
    for k in COMPARED:
      want = np.asarray(out[k])
      scale = max(1.0, float(np.abs(want).max()))
      np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-4,
                                 atol=1e-4 * scale, err_msg=f'{k} ({glimpse})')


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_parallel_matches_serial(variant):
  over = dict(INDEPENDENT, **VARIANTS[variant])
  cfg = C.tiny_full_config(**over)
  params = _params(JC.tiny_full_config(**over))
  inputs = _inputs(cfg, 3)
  par = _port(cfg, params)
  ser = _port(cfg.replace(parallel_decode=False), params)
  assert TF.parallel_decode(par.cfg) and not TF.parallel_decode(ser.cfg)
  got, want = _forward(par, inputs), _forward(ser, inputs)
  assert got.keys() == want.keys()
  for k in want:
    assert got[k].shape == want[k].shape and got[k].is_contiguous(), k
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=k)


# (config overrides, train) -> whether JAX decodes in parallel.
RULE_CASES = [
    (dict(use_knob=False), False),                      # canvas: serial
    (dict(INDEPENDENT), False),
    (dict(INDEPENDENT), True),
    (dict(INDEPENDENT, use_knob=True), False),
    (dict(INDEPENDENT, use_knob=True), True),           # knob trains
    (dict(INDEPENDENT, parallel_decode=False), False),
    (dict(INDEPENDENT, parallel_decode=True), True),
    (dict(use_knob=False, parallel_decode=True), False),  # canvas wins
    (dict(INDEPENDENT, disable_overwrite=True), False),
    (dict(INDEPENDENT, attn_add_canvas=True), False),
    (dict(INDEPENDENT, ctrl_add_canvas=True), True),
    (dict(INDEPENDENT, ctrl_add_canvas=None, add_d_out=True), False),
]


@pytest.mark.parametrize('case', range(len(RULE_CASES)))
def test_the_path_is_jax_path(case):
  over, train = RULE_CASES[case]
  jcfg = JC.tiny_full_config(timespan=2, **over)
  cfg = C.tiny_full_config(timespan=2, **over)
  assert cfg.parallel_decode == jcfg.parallel_decode
  params = JF.init_full_model(jax.random.PRNGKey(0), jcfg)
  inputs = _inputs(cfg, 1)
  jaxpr = jax.make_jaxpr(lambda p, bt: JF.full_model_forward(
      p, bt, jcfg, train, jax.random.PRNGKey(1), 0.0))(
          params, _jax_batch(cfg, inputs))
  jax_parallel = 'scan' not in str(jaxpr)
  assert TF.parallel_decode(cfg, train) == jax_parallel
  # The port's forward takes the same path: its glimpse calls.
  model = TF.FullModel(cfg, device='cpu')
  counting = Counting()
  tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
  b, t = 1, cfg.timespan
  if train:
    draws = TF.draw_train_randoms(cfg, b, torch.Generator().manual_seed(0))
    TF.full_model_train_forward(
        model, tin.pop('x'), torch.zeros(b, t, 64, 64), torch.zeros(b, t),
        draws, 0, glimpse=counting.pair(), **tin)
  else:
    _forward(model, inputs, counting.pair())
  rows = t * b if jax_parallel else b
  n = 1 if jax_parallel else t
  want = ([('paste', rows), ('extract', rows), ('paste', rows)]) * n
  assert counting.calls == want


@pytest.mark.parametrize('limit', [6, 2, 1])
@pytest.mark.parametrize('train', [False, True])
def test_passes_split_into_whole_timesteps(limit, train, monkeypatch):
  """With the kernels' batch limit at 6 rows, B=2 and T=4: passes of
  timesteps {0,1,2} and {3}; at 2 or 1 (below B), one timestep a pass.
  Each equals the one pass, the BatchNorm statistics included."""
  cfg = C.tiny_full_config(**INDEPENDENT)
  params = _params(JC.tiny_full_config(**INDEPENDENT), scale=10)
  batch = {k: torch.from_numpy(v)
           for k, v in TTS._batch(cfg, seed=3).items()}
  b, t = batch['x'].shape[0], cfg.timespan
  draws = TF.draw_train_randoms(cfg, b, torch.Generator().manual_seed(0))

  def run():
    counting = Counting()
    outputs, new_bn = TF.full_model_train_forward(
        _port(cfg, params), batch['x'], batch['y_gt'], batch['s_gt'],
        draws, 0, glimpse=counting.pair(), train=train)
    return outputs, new_bn, counting.calls

  want, want_bn, calls = run()
  assert calls == [('paste', t * b), ('extract', t * b), ('paste', t * b)]
  monkeypatch.setattr(gk, 'MAX_BATCH', limit)
  groups = TF.timestep_groups(t, b)
  assert groups == ([[0, 1, 2], [3]] if limit == 6 else
                    [[0], [1], [2], [3]])
  got, got_bn, calls = run()
  assert [c[1] for c in calls] == [
      len(g) * b for g in groups for _ in range(3)]
  assert got.keys() == want.keys() and got_bn.keys() == want_bn.keys()
  for k in want:
    if torch.is_tensor(want[k]):
      np.testing.assert_allclose(got[k].detach().numpy(),
                                 want[k].detach().numpy(),
                                 rtol=1e-5, atol=1e-6, err_msg=k)
  for k in want_bn:
    assert want_bn[k].shape[0] == t
    np.testing.assert_allclose(got_bn[k].numpy(), want_bn[k].numpy(),
                               rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize('remat', [True, False])
def test_no_knob_train_step_matches_jax(remat, monkeypatch):
  """One train step of an independent config: JAX vmaps its timesteps,
  the port runs them as one pass (remat: one checkpoint over it)."""
  name = f'parallel_decode_remat_{remat}'
  over = dict(INDEPENDENT, remat=remat, segm_weight_alpha=0.5)
  monkeypatch.setitem(TTS.VARIANTS, name, (over, 0.0))
  jcfg, cfg = TTS._configs(name)
  assert TF.parallel_decode(cfg, train=True)
  # The step takes the parallel path: one extract and two pastes of T·B
  # rows, then the recomputed pass under remat.
  model = TTS._port_model(cfg, TTS._params(jcfg))
  counting = Counting()
  batch = {k: torch.from_numpy(v) for k, v in TTS._batch(cfg, 10).items()}
  draws = TF.draw_train_randoms(cfg, TTS.B, torch.Generator().manual_seed(0))
  loss, _ = TF.full_model_loss(model, batch, draws, 0,
                               glimpse=counting.pair())
  loss.backward()
  rows = cfg.timespan * TTS.B
  one_pass = [('paste', rows), ('extract', rows), ('paste', rows)]
  assert counting.calls == one_pass * (2 if remat else 1)
  TTS._run_steps(name, 1)


def test_ema_write_back_per_timestep():
  """The EMA of each timestep's BatchNorm copy moves by its own rows'
  statistics: the attention nets, whose glimpses differ by timestep,
  write T different new rows, each the serial step's."""
  cfg = C.tiny_full_config(**INDEPENDENT)
  params = _params(JC.tiny_full_config(**INDEPENDENT), scale=10)
  batch = {k: torch.from_numpy(v) for k, v in TTS._batch(cfg, 4).items()}
  draws = TF.draw_train_randoms(cfg, TTS.B, torch.Generator().manual_seed(1))
  news = []
  for c in (cfg, cfg.replace(parallel_decode=False)):
    model = _port(c, params)
    opt = TS.init_opt_state(model)
    TS.train_step(model, opt, batch, draws, 0)
    news.append({k: v.numpy() for k, v in model.state_dict().items()
                 if k.endswith(('ema_mean', 'ema_var'))})
  for k, want in news[1].items():
    np.testing.assert_allclose(news[0][k], want, rtol=1e-4, atol=1e-6,
                               err_msg=k)
    if k.startswith('attn_'):
      assert len({tuple(row) for row in want.round(6)}) == cfg.timespan, k


def test_chip_smoke_phase_on_the_cpu():
  """chip_smoke.py's parallel_decode phase at a tiny config on the CPU:
  its gates pass, and each control fails them."""
  import os
  import sys
  sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
  import chip_smoke as cs
  cfg = C.tiny_full_config(remat=True, **INDEPENDENT)
  out, failures = cs.parallel_decode_phase(torch, gk, torch.device('cpu'),
                                           cfg=cfg, batches=(2,),
                                           train_batch=2)
  assert failures == []
  fwd = out['forwards']['b2']
  assert fwd['parallel_vs_serial']['failed'] == []
  assert fwd['control_bn_copy0_vs_serial']['failed']
  train = out['train']
  assert train['parallel_vs_float64']['failed'] == []
  assert train['control_bn_copy0_vs_float64']['failed']
  assert train['ema_stats_rel_l2_max'][1] <= cs.EMA_STATS_LIMIT
  assert train['control_ema_stats_rel_l2_max'][1] > cs.EMA_STATS_LIMIT
