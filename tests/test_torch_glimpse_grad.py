"""The glimpse Functions' backward passes on the CPU against JAX's VJPs.

``glimpse_extract``/``glimpse_paste`` (``ExtractPatch``/``PastePatch``) run
their own backward formulas on the CPU (d_x = paste(g), d_p = extract(g),
and the filter-gradient einsums), the formulas their CUDA path runs with
the kernels.  They are held against ``jax.vjp`` of the JAX package's Pallas
ops (``glimpse.extract_patch``/``paste_patch``, interpret mode, as
tests/test_pallas_glimpse.py runs them) and of its einsum forms
(``attention.extract_patch``/``paste_patch``), on the same numpy-seeded
inputs and cotangents.

Tolerance: rtol 1e-3 / atol 1e-4 times the gradient's largest magnitude,
the gradient tolerance of ROADMAP B (float32 on both sides; the
contractions sum in other orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rec_attend_tpu.ops import attention as jatt
from rec_attend_tpu.ops.pallas import glimpse as jgk
from rec_attend_tpu_torch.ops import attention as att
from rec_attend_tpu_torch.ops.cuda import glimpse as gk

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-4

# (B, H, W, D, FH, FW): the CVPPP train step's two shapes cut down (D=4 for
# extract's input, D=1 for the pasted mask), KITTI's 13 channels with
# FH != FW, and odd sizes.
SHAPES = [(2, 32, 40, 4, 8, 8), (2, 32, 40, 1, 8, 8), (1, 24, 36, 13, 6, 10),
          (2, 33, 45, 3, 7, 9)]


def _inputs(shape, seed=0):
  b, h, w, d, fh, fw = shape
  rng = np.random.RandomState(seed)

  def bank(length, taps):
    ctr = jnp.asarray((rng.rand(b) * length).astype(np.float32))
    size = jnp.asarray((rng.rand(b) * length / 2 + 4).astype(np.float32))
    return np.array(jatt.get_gaussian_filter(
        ctr, size, jnp.log(size / taps), length, taps))
  return {'x': rng.rand(b, h, w, d).astype(np.float32),
          'p': rng.rand(b, fh, fw, d).astype(np.float32),
          'f_y': bank(h, fh), 'f_x': bank(w, fw),
          'g_patch': rng.randn(b, fh, fw, d).astype(np.float32),
          'g_image': rng.randn(b, h, w, d).astype(np.float32)}


def _jax_vjp(fn, a, f_y, f_x, g):
  _, vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(f_y), jnp.asarray(f_x))
  return [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _port_vjp(fn, a, f_y, f_x, g):
  ts = [torch.from_numpy(v.copy()).requires_grad_() for v in (a, f_y, f_x)]
  fn(*ts).backward(torch.from_numpy(g))
  return [t.grad.numpy() for t in ts]


def _assert_grads_close(got, want, what):
  for name, a, b in zip(('d_operand', 'd_f_y', 'd_f_x'), got, want):
    np.testing.assert_allclose(a, b, rtol=RTOL,
                               atol=ATOL * float(np.abs(b).max()),
                               err_msg=f'{what} {name}')


@pytest.mark.parametrize('reference', ['pallas', 'einsum'])
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_extract_grads_match_jax(shape, reference):
  v = _inputs(shape)
  fn = jgk.extract_patch if reference == 'pallas' else jatt.extract_patch
  want = _jax_vjp(fn, v['x'], v['f_y'], v['f_x'], v['g_patch'])
  got = _port_vjp(gk.glimpse_extract, v['x'], v['f_y'], v['f_x'],
                  v['g_patch'])
  _assert_grads_close(got, want, f'extract {shape} vs {reference}')


@pytest.mark.parametrize('reference', ['pallas', 'einsum'])
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_paste_grads_match_jax(shape, reference):
  v = _inputs(shape)
  fn = jgk.paste_patch if reference == 'pallas' else jatt.paste_patch
  want = _jax_vjp(fn, v['p'], v['f_y'], v['f_x'], v['g_image'])
  got = _port_vjp(gk.glimpse_paste, v['p'], v['f_y'], v['f_x'],
                  v['g_image'])
  _assert_grads_close(got, want, f'paste {shape} vs {reference}')


def test_grads_match_a_channel_block_that_does_not_divide(monkeypatch):
  """The Pallas ops with a 2-channel block over 3 channels (a padded last
  block, as Cityscapes' 21 channels in blocks of 8)."""
  shape = (2, 33, 45, 3, 7, 9)
  v = _inputs(shape)
  monkeypatch.setattr(jgk, '_VMEM_BLOCK_BUDGET', 2 * 33 * 45 * 4)
  assert jgk._channel_block(3, 33, 45) == 2
  for jfn, tfn, a, g in ((jgk.extract_patch, gk.glimpse_extract, v['x'],
                          v['g_patch']),
                         (jgk.paste_patch, gk.glimpse_paste, v['p'],
                          v['g_image'])):
    want = _jax_vjp(jfn, a, v['f_y'], v['f_x'], g)
    got = _port_vjp(tfn, a, v['f_y'], v['f_x'], g)
    _assert_grads_close(got, want, jfn.__name__)


def test_plain_autograd_agrees_with_the_functions():
  """glimpse='plain' (torch autograd through the einsums) is the reference
  the Functions' formulas are held against on the card."""
  v = _inputs(SHAPES[0])
  for fn, plain, a, g in ((gk.glimpse_extract, att.extract_patch, v['x'],
                           v['g_patch']),
                          (gk.glimpse_paste, att.paste_patch, v['p'],
                           v['g_image'])):
    _assert_grads_close(_port_vjp(fn, a, v['f_y'], v['f_x'], g),
                        _port_vjp(plain, a, v['f_y'], v['f_x'], g),
                        fn.__name__)


def test_backward_computes_only_the_gradients_asked_for(monkeypatch):
  """needs_input_grad decides: an operand that needs no gradient costs no
  kernel call, a filter bank that needs none no einsum."""
  calls = []
  for name in ('_extract', '_paste'):
    real = getattr(gk, name)
    monkeypatch.setattr(gk, name, lambda *a, _r=real, _n=name, **kw: (
        calls.append(_n), _r(*a, **kw))[1])
  v = _inputs(SHAPES[0])
  x = torch.from_numpy(v['x'])                       # no gradient
  f_y = torch.from_numpy(v['f_y']).requires_grad_()
  f_x = torch.from_numpy(v['f_x'])
  gk.glimpse_extract(x, f_y, f_x).sum().backward()
  assert calls == ['_extract']                       # the forward only
  assert f_y.grad is not None
  calls.clear()
  p = torch.from_numpy(v['p']).requires_grad_()
  gk.glimpse_paste(p, torch.from_numpy(v['f_y']), f_x).sum().backward()
  assert calls == ['_paste', '_extract']             # forward, then d_p
  calls.clear()
  with torch.no_grad():
    gk.glimpse_paste(p, f_y, f_x)
  assert calls == ['_paste']


def test_cpu_tensors_launch_nothing():
  v = _inputs(SHAPES[1])
  gk.reset_launch_counts()
  _port_vjp(gk.glimpse_paste, v['p'], v['f_y'], v['f_x'], v['g_image'])
  _port_vjp(gk.glimpse_extract, v['x'], v['f_y'], v['f_x'], v['g_patch'])
  assert gk.launch_counts() == {'glimpse_extract': 0, 'glimpse_paste': 0}
